"""The port's channel-wise slice end to end on the CPU, against the JAX
package run live in the same session, at a small width.

Both channel-wise variants, each through the port's CLI and the JAX
package's, from one numpy starting checkpoint (``chip_smoke.
cw_start_checkpoint``, seed 0) at h=16 and T=101:

* ``ode_channelwise`` on the port's AVR data (16 training and 8 test
  samples, seed 0);
* ``dae_channelwise`` on the committed motor data cut to 101 steps.

Held: ``--testing --fused`` against the JAX CLI's ``--testing``
(``x_loss_total`` and, for the DAE, ``i_loss_total``) at rtol 1e-5; one
epoch of ``--training`` (batch 8, two steps, Euler, a fresh Adam at lr 5e-3,
seed 0), fused and plain, against the JAX ``Trainer``: step 1 (forward and
backward before any update) at loss rtol 1e-5 and gradient norm rtol 1e-4,
step 2 and the epoch-1 eval at rtol 1e-3.

``python tests/test_torch_cw_slice.py [euler rk4]`` derives the full-width
anchors that ``chip_smoke.CW_ANCHORS`` holds (h=128, T=1001; the ODE on
128/32 AVR samples with batch 64, the DAE on 16 motor training samples with
batch 8, whose readout keeps the JAX step's memory at a few GB on the CPU).
``python tests/test_torch_cw_slice.py conditioning`` prints, without JAX,
how far the port's float32 plain rollout lies from a float64 one at full
width on both test sets from the starting checkpoints (the card's bars
rest on it).
"""

import json
import pathlib
import shutil
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import TEST_DATA, TRAIN_DATA, cw_start_checkpoint  # noqa: E402
from py_psnode_tpu_torch.data.synthetic import write_avr_dataset  # noqa: E402

DIMS = {"ode_channelwise": (2, 2), "dae_channelwise": (3, 1, 2, 2)}
SMALL = dict(hidden=16, step=101, num=16, batch=8, n_test=8)
# full width: the card's configuration (chip_smoke.CW_ANCHORS)
FULL = {"ode_channelwise": dict(hidden=128, step=1001, num=128, batch=64, n_test=32),
        "dae_channelwise": dict(hidden=128, step=1001, num=16, batch=8, n_test=32)}


def make_inputs(root: pathlib.Path, variant, size):
    """``(train, test, start checkpoint)`` under ``root``: the AVR set for
    the ODE, the motor set for the DAE, and the numpy starting weights."""
    root.mkdir(parents=True, exist_ok=True)
    if variant == "ode_channelwise":
        train, test = write_avr_dataset(root, n_train=size["num"], n_test=size["n_test"],
                                        n_steps=size["step"], seed=0)
    else:
        train, test = TRAIN_DATA, TEST_DATA
    start = cw_start_checkpoint(root / "start.ckpt", variant, DIMS[variant], size["hidden"], seed=0)
    return pathlib.Path(train), pathlib.Path(test), start


def run_config(inputs, root: pathlib.Path, variant, size, solver="euler", **kw):
    """TrainConfig keywords (shared by both packages) for one epoch from a
    copy of the starting checkpoint, logging every step."""
    train, test, start = inputs
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(start, root / "ws.ckpt")
    return dict(variant=variant, train_data=str(train), test_data=str(test), model=str(root / "run"),
                num=size["num"], batch=size["batch"], epoch=200, hidden=size["hidden"],
                step=size["step"], larger_than=None, seed=0, warm_start=str(root / "ws.ckpt"),
                stop_after=1, loss_record_iter=1, solver=solver, echo_logs=False, **kw)


def eval_argv(inputs, root: pathlib.Path, size, batch):
    """``--testing`` flags on a copy of the starting checkpoint (the eval
    writes its log next to the checkpoint)."""
    _, test, start = inputs
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(start, root / "model_checkpoint.0")
    return ["--testing", "--model", str(root / "model_checkpoint.0"), "--test_data", str(test),
            "--hidden", str(size["hidden"]), "--step", str(size["step"]), "--batch", str(batch)]


def read_metrics(run_dir):
    recs = [json.loads(line) for line in (pathlib.Path(run_dir) / "train_metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if r["kind"] == "train"]
    (ev,) = [r for r in recs if r["kind"] == "eval"]
    return train, ev


def jax_run(inputs, root: pathlib.Path, variant, size, solver="euler", eval_batch=None):
    """The JAX package on the CPU (the non-fused XLA path): its Trainer's
    step records and epoch-1 eval, and its CLI's ``--testing`` losses on
    the starting checkpoint."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from py_psnode_tpu.cli.common import main as jax_main
    from py_psnode_tpu.train.trainer import TrainConfig, Trainer

    cfg = run_config(inputs, root / "train", variant, size, solver, fused=False)
    _, run_dir = Trainer(TrainConfig(**cfg)).train()
    argv = eval_argv(inputs, root / "test", size, eval_batch or size["batch"])
    jax_main(variant, argv + ["--solver", solver])
    with np.load(root / "test" / "evaluation.npz", allow_pickle=True) as f:
        losses = [float(v) for v in f["eval"][: 2 if variant == "dae_channelwise" else 1]]
    return read_metrics(run_dir), losses


@pytest.fixture
def few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(DIMS))
def slice_run(request, tmp_path_factory):
    """Per variant: its inputs and the JAX package's runs (Euler)."""
    variant = request.param
    root = tmp_path_factory.mktemp(variant)
    inputs = make_inputs(root / "data", variant, SMALL)
    return variant, inputs, jax_run(inputs, root / "jax", variant, SMALL)


@pytest.mark.parametrize("fused", [True, False])
def test_port_trainer_matches_jax(slice_run, tmp_path, fused, few_threads):
    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    variant, inputs, (((j1, j2), j_ev), _) = slice_run
    cfg = run_config(inputs, tmp_path, variant, SMALL, fused=fused, device="cpu")
    _, run_dir = Trainer(TrainConfig(**cfg)).train()
    train, ev = read_metrics(run_dir)
    assert [r["batch"] for r in train] == [1, 2]
    np.testing.assert_allclose(train[0]["loss"], j1["loss"], rtol=1e-5)
    np.testing.assert_allclose(train[0]["x_loss"], j1["x_loss"], rtol=1e-5)
    np.testing.assert_allclose(train[0]["grad_norm"], j1["grad_norm"], rtol=1e-4)
    keys = ("x_loss", "i_loss") if variant == "dae_channelwise" else ("x_loss",)
    np.testing.assert_allclose([train[1]["loss"], train[1]["grad_norm"]] + [ev[k] for k in keys],
                               [j2["loss"], j2["grad_norm"]] + [j_ev[k] for k in keys], rtol=1e-3)
    assert (run_dir / "model_checkpoint.1").exists()


def test_port_cli_testing_matches_jax_cli(slice_run, tmp_path, few_threads):
    from py_psnode_tpu_torch.cli.common import main as port_main

    variant, inputs, (_, jax_losses) = slice_run
    argv = eval_argv(inputs, tmp_path, SMALL, SMALL["batch"])
    res = port_main(variant, argv + ["--fused", "--device", "cpu"])
    np.testing.assert_allclose([float(v) for v in res[: len(jax_losses)]], jax_losses, rtol=1e-5)
    log = (tmp_path / "Model_model_checkpoint.0_Evaluation.log").read_text()
    assert f"x_loss_total: {float(res[0]):14.10f}" in log
    assert (tmp_path / "evaluation.npz").exists()


def test_channelwise_refuses_teacher_forcing():
    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    for variant in DIMS:
        with pytest.raises(ValueError, match="no teacher forcing"):
            Trainer(TrainConfig(variant=variant, device="cpu", input_true_x=True))
    with pytest.raises(ValueError, match="channel-wise variants only"):
        Trainer(TrainConfig(variant="ode_no_encode", device="cpu", channel_impl="blockdiag")).build_model(
            None, init=False)


def test_dae_eval_batch_is_capped_at_the_training_batch():
    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    class Set:
        def __len__(self):
            return 320

    assert Trainer(TrainConfig(variant="dae_channelwise", device="cpu", batch=64))._eval_batch_size(Set()) == 64
    assert Trainer(TrainConfig(variant="ode_channelwise", device="cpu", batch=64))._eval_batch_size(Set()) == 320


def conditioning(root: pathlib.Path):
    """Per variant and solver: max |float32 - float64| / max(1, |float64|)
    of the plain fused rollout at full width (B=32, the test set)."""
    import torch

    from py_psnode_tpu_torch.bridge import load_params, load_params_npz
    from py_psnode_tpu_torch.data import DaeSamples, OdeSamples
    from py_psnode_tpu_torch.models import ChannelWiseDAEModel, ChannelWiseODEModel
    from py_psnode_tpu_torch.ops import fused_channelwise as FC
    from py_psnode_tpu_torch.ops.fused_model import cw_rollout_inputs

    for variant, dims in DIMS.items():
        _, test, start = make_inputs(root / variant, variant, FULL[variant])
        cls = ChannelWiseODEModel if variant == "ode_channelwise" else ChannelWiseDAEModel
        model = load_params(cls(*dims, hidden_dim=128, device="meta"), load_params_npz(start))
        ds = OdeSamples.load(str(test)) if variant == "ode_channelwise" else DaeSamples.load(
            str(test), cut_length=1001)
        keys = ("t", "x", "z", "event_t", "z_jump") + (("v",) if variant == "dae_channelwise" else ())
        with torch.no_grad():
            streams, w, x0, dt = cw_rollout_inputs(model.requires_grad_(False),
                                                   {k: torch.as_tensor(getattr(ds, k)) for k in keys})
            d = lambda a: a.double()
            w64 = FC.unflatten_weights([d(a) for a in FC.flatten_weights(w)])
            for solver in ("euler", "rk4"):
                r32 = FC.fused_cw_rollout_plain(streams, w, x0, dt, solver)
                r64 = FC.fused_cw_rollout_plain({k: d(v) for k, v in streams.items()}, w64, d(x0), dt, solver)
                err = ((r32.double() - r64).abs() / r64.abs().clamp(min=1)).max().item()
                print(variant, solver, f"max|float64| {r64.abs().max().item():.4f}, float32 against "
                      f"float64 {err:.3e}", flush=True)


if __name__ == "__main__":
    import tempfile

    if sys.argv[1:] == ["conditioning"]:
        with tempfile.TemporaryDirectory() as tmp:
            conditioning(pathlib.Path(tmp))
        sys.exit(0)
    for solver in sys.argv[1:] or ["euler", "rk4"]:
        for variant in sorted(DIMS):
            size = FULL[variant]
            with tempfile.TemporaryDirectory() as tmp:
                tmp = pathlib.Path(tmp)
                inputs = make_inputs(tmp / "data", variant, size)
                (train, ev), losses = jax_run(inputs, tmp, variant, size, solver, eval_batch=8)
            for r in train:
                print(variant, solver, f"step {r['batch']}: loss {r['loss']:.8g} gradient_norm "
                      f"{r['grad_norm']:.8g}", flush=True)
            ev_keys = ("x_loss", "i_loss") if variant == "dae_channelwise" else ("x_loss",)
            print(variant, solver, "epoch-1 eval:", " ".join(f"{k} {ev[k]:.8g}" for k in ev_keys),
                  "; --testing:", " ".join(f"{v:.8g}" for v in losses), flush=True)
