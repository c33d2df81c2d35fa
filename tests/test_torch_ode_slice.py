"""The port's ODE slice end to end on the CPU, at full width.

Data and weights are made here, reproducibly on every machine: the port's
AVR generator writes 128 training and 32 test samples (T=1001, seed 0), and
``chip_smoke.ode_start_checkpoint`` draws the starting weights of the ODE
no-encode model at h=128 with numpy (seed 0).

* Training: the port's ``Trainer`` warm-started from that checkpoint
  (batch 64, Euler, a fresh Adam at lr 5e-3, ``--larger_than none``, seed 0)
  trains one epoch, two steps, through the fused route (the plain forward
  and backward walks behind the ``autograd.Function``) and through the
  non-fused ``ODEModel``. Both are held to the JAX package's ``Trainer``
  run in the same test session on the same inputs (CPU, float32, the
  non-fused XLA path): step 1 (forward and backward before any update) at
  loss rtol 1e-5 and gradient norm rtol 1e-4; step 2 and the epoch-1 eval,
  after Adam's first, sign-like update, at rtol 1e-3.
* Evaluation: the port's CLI ``--testing --fused --device cpu`` on the
  starting checkpoint against the JAX CLI ``--testing``: ``x_loss_total``
  at rtol 1e-5.

``chip_smoke.ODE_ANCHORS`` holds the JAX runs' numbers, written down
because ``chip_smoke.py`` holds the card to them (the card's machine has no
JAX); a test here checks that the JAX runs still give them. ``python
tests/test_torch_ode_slice.py`` prints them again.
"""

import json
import pathlib
import shutil
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import ODE_ANCHORS, ode_start_checkpoint  # noqa: E402
from py_psnode_tpu_torch.data.synthetic import write_avr_dataset  # noqa: E402

HIDDEN = 128


def make_inputs(root: pathlib.Path):
    """The AVR data set and the starting checkpoint under ``root``."""
    write_avr_dataset(root, n_train=128, n_test=32, n_steps=1001, seed=0)
    ode_start_checkpoint(root / "start.ckpt", (2, 2), HIDDEN, seed=0)
    return root


def run_config(data: pathlib.Path, root: pathlib.Path, solver="euler", **kw):
    """TrainConfig keywords (shared by both packages) for one epoch from a
    copy of the starting checkpoint, logging every step."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(data / "start.ckpt", root / "ws.ckpt")
    return dict(variant="ode_no_encode", train_data=str(data / "training.npz"),
                test_data=str(data / "testing.npz"), model=str(root / "run"), num=128,
                batch=64, epoch=200, hidden=HIDDEN, larger_than=None, seed=0,
                warm_start=str(root / "ws.ckpt"), stop_after=1, loss_record_iter=1,
                solver=solver, echo_logs=False, **kw)


def eval_argv(data: pathlib.Path, root: pathlib.Path):
    """``--testing`` flags on a copy of the starting checkpoint (the eval
    writes its log next to the checkpoint)."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(data / "start.ckpt", root / "model_checkpoint.0")
    return ["--testing", "--model", str(root / "model_checkpoint.0"), "--test_data",
            str(data / "testing.npz")]


def read_metrics(run_dir):
    recs = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if r["kind"] == "train"]
    (ev,) = [r for r in recs if r["kind"] == "eval"]
    return train, ev


def jax_anchors(data: pathlib.Path, root: pathlib.Path, solver="euler"):
    """The JAX package on the CPU (the non-fused XLA path): its Trainer's
    step records and epoch-1 eval, and its CLI's ``--testing`` x_loss_total
    on the starting checkpoint."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from py_psnode_tpu.cli.common import main as jax_main
    from py_psnode_tpu.train.trainer import TrainConfig, Trainer

    _, run_dir = Trainer(TrainConfig(**run_config(data, root / "train", solver, fused=False))).train()
    jax_main("ode_no_encode", eval_argv(data, root / "test") + ["--solver", solver])
    with np.load(root / "test" / "evaluation.npz", allow_pickle=True) as f:
        test_x = float(f["eval"][0])
    return read_metrics(run_dir), test_x


@pytest.fixture
def few_threads():
    """Two intra-op threads: the suite runs several workers at once, and a
    worker whose torch takes every core slows them all."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("avr"))


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """The JAX package's runs (Euler), once for this file."""
    return jax_anchors(data, tmp_path_factory.mktemp("jax"), "euler")


def test_jax_runs_give_the_written_anchors(jax_run):
    """Step 1 and the evaluation to 1e-6. Step 2 and the epoch-1 eval to
    1e-4: after Adam's first, sign-like update the JAX run moves by a few
    1e-6 between a standalone process (where the numbers were written down)
    and a test session, whose XLA CPU setup splits reductions otherwise."""
    ((s1, s2), ev), test_x = jax_run
    a = ODE_ANCHORS["euler"]
    np.testing.assert_allclose([s1["loss"], s1["grad_norm"], test_x],
                               [*a["step1"], a["test_x_loss"]], rtol=1e-6)
    np.testing.assert_allclose([s2["loss"], s2["grad_norm"], ev["x_loss"]],
                               [*a["step2"], a["eval1_x_loss"]], rtol=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_port_trainer_matches_jax(data, tmp_path, fused, few_threads, jax_run):
    from py_psnode_tpu_torch.ops import fused_ode as F
    from py_psnode_tpu_torch.ops import fused_ode_vjp as V
    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    ((j1, j2), j_ev), _ = jax_run
    launches = (F.fused_ode_rollout.launches, V.fused_ode_rollout_bwd.launches)
    _, run_dir = Trainer(TrainConfig(**run_config(data, tmp_path, fused=fused, device="cpu"))).train()
    # on the CPU the plain versions run: no kernel launch is counted
    assert (F.fused_ode_rollout.launches, V.fused_ode_rollout_bwd.launches) == launches
    train, ev = read_metrics(run_dir)
    assert [r["batch"] for r in train] == [1, 2]
    for k in ("loss", "x_loss"):
        np.testing.assert_allclose(train[0][k], j1[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(train[0]["grad_norm"], j1["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose([train[1]["loss"], train[1]["grad_norm"], ev["x_loss"]],
                               [j2["loss"], j2["grad_norm"], j_ev["x_loss"]], rtol=1e-3)
    assert (run_dir / "model_checkpoint.1").exists()
    assert "Output testing loss variant" in (run_dir / "testing.log").read_text()


def test_port_cli_testing_matches_jax_cli(data, tmp_path, few_threads, jax_run):
    from py_psnode_tpu_torch.cli.common import main as port_main

    _, jax_x = jax_run
    argv = eval_argv(data, tmp_path)
    res = port_main("ode_no_encode", argv + ["--fused", "--device", "cpu"])
    np.testing.assert_allclose(res[0], jax_x, rtol=1e-5)
    log = (tmp_path / "Model_model_checkpoint.0_Evaluation.log").read_text()
    assert f"x_loss_total: {res[0]:14.10f}." in log
    assert (tmp_path / "evaluation.npz").exists()


if __name__ == "__main__":
    import tempfile

    for solver in sys.argv[1:] or ["euler", "rk4"]:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            (train, ev), test_x = jax_anchors(make_inputs(tmp / "data"), tmp, solver)
        for r in train:
            print(solver, f"step {r['batch']}: loss {r['loss']:.8g} gradient_norm {r['grad_norm']:.8g}")
        print(solver, f"epoch-1 eval: x_loss {ev['x_loss']:.8g}; --testing x_loss_total {test_x:.8g}")
