"""The port's CLI device flags and the quiet evaluation, on the CPU.

* ``--device gpu`` (any case) means ``cuda:<--id>``, as in the reference's
  command lines (``--device gpu --id N``); ``cuda`` the same; ``cpu`` the
  CPU; anything else exits with an error. Without a card a CUDA device
  raises: nothing falls back to the CPU.
* ``Trainer.test`` with ``echo_logs=False`` writes its log and prints
  nothing.
"""

import pathlib
import shutil
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import ode_start_checkpoint  # noqa: E402
from py_psnode_tpu_torch.cli.common import device_name, main  # noqa: E402
from py_psnode_tpu_torch.data.synthetic import write_avr_dataset  # noqa: E402
from py_psnode_tpu_torch.train import TrainConfig, Trainer  # noqa: E402


@pytest.mark.parametrize("device,index,expect", [
    ("gpu", 1, "cuda:1"), ("GPU", 0, "cuda:0"), ("Gpu", 3, "cuda:3"),
    ("cuda", 2, "cuda:2"), ("CUDA", 0, "cuda:0"), ("cpu", 5, "cpu"), ("CPU", 0, "cpu"),
])
def test_device_name_maps_gpu_to_cuda(device, index, expect):
    assert device_name(device, index) == expect


@pytest.mark.parametrize("device", ["tpu", "mps", "gpu0", ""])
def test_device_name_refuses_other_devices(device):
    with pytest.raises(SystemExit, match='"--device" is illegal'):
        device_name(device, 0)


def test_cli_refuses_tpu_and_does_not_fall_back(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match='"--device" is illegal'):
        main("ode_no_encode", ["--testing", "--device", "tpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main("ode_no_encode", ["--testing", "--device", "gpu", "--id", "1", "--model",
                               str(tmp_path / "m"), "--test_data", str(tmp_path / "t.npz")])


@pytest.fixture
def small_run(tmp_path):
    """A tiny AVR test set and a starting checkpoint at h=8."""
    _, test = write_avr_dataset(tmp_path / "data", n_train=2, n_test=3, n_steps=11, seed=0)
    ode_start_checkpoint(tmp_path / "model_checkpoint.0", (2, 2), 8, seed=0)
    return test, tmp_path / "model_checkpoint.0"


@pytest.mark.parametrize("echo", [False, True])
def test_trainer_test_echoes_only_when_asked(small_run, capsys, echo):
    test, ckpt = small_run
    cfg = TrainConfig(variant="ode_no_encode", test_data=str(test), model=str(ckpt), hidden=8,
                      echo_logs=echo, device="cpu")
    result = Trainer(cfg).test()
    out = capsys.readouterr().out
    log = (ckpt.parent / "Model_model_checkpoint.0_Evaluation.log").read_text()
    assert "x_loss_total" in log and len(result) == 2
    if echo:
        assert out.splitlines() == log.splitlines()
    else:
        assert out == ""


def test_dae_trainer_test_is_quiet(tmp_path, capsys):
    """The DAE evaluation on the motor checkpoint 200, one sample cut to 11
    steps, with ``echo_logs=False``."""
    run = REPO / "benchmarks/h2h_work_prod_s0"
    shutil.copy(run / "ours_dae_motor/model_checkpoint.200", tmp_path / "model_checkpoint.200")
    cfg = TrainConfig(variant="dae_no_encode", test_data=str(run / "data_dae_motor/testing.npz"),
                      model=str(tmp_path / "model_checkpoint.200"), step=11, echo_logs=False,
                      device="cpu")
    Trainer(cfg).test()
    assert capsys.readouterr().out == ""
    assert "i_loss_total" in (tmp_path / "Model_model_checkpoint.200_Evaluation.log").read_text()
