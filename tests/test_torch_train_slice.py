"""The port's training slice end to end on the CPU, at full width.

The port's ``Trainer`` warm-started from the trained motor checkpoint 200
(h=128, T=1001, 128 training samples, batch 64, Euler, a fresh Adam at lr
5e-3, ``--larger_than none``, seed 0) trains one epoch, two steps, through
the fused route (the plain forward and backward walks behind the
``autograd.Function``) and through the non-fused ``DAEModel``. Both are
held to the JAX package's ``Trainer`` run in the same test session on the
same inputs (CPU, float32, the non-fused XLA path):

* step 1, pure forward and backward before any update: loss rtol 1e-5,
  gradient norm rtol 1e-4;
* step 2 and the epoch-1 eval, after Adam's first update: rtol 1e-3.
  That update is about lr * sign(g) per parameter, so gradients near zero
  can flip it: these two anchors are more sensitive than step 1.

``STEP1``/``STEP2``/``EVAL1`` are that run's numbers, written down because
``chip_smoke.py`` holds the card to them (the card's machine has no JAX);
a test here checks that the JAX run still gives them.
``python tests/test_torch_train_slice.py`` prints them again.
"""

import json
import pathlib
import shutil
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
RUN = REPO / "benchmarks/h2h_work_prod_s0"
CKPT = RUN / "ours_dae_motor/model_checkpoint.200"
DATA = RUN / "data_dae_motor"
# JAX package, CPU, float32: step 1 (loss, x_loss, i_loss, gradient_norm),
# step 2 (loss, gradient_norm), epoch-1 eval (x_loss, i_loss); the same
# numbers stand in chip_smoke.py
STEP1 = {"loss": 0.20542581, "x_loss": 0.10088433, "i_loss": 0.10040008,
         "grad_norm": 87.125443}
STEP2 = {"loss": 194.80251, "grad_norm": 178.17818}
EVAL1 = {"x_loss": 0.40475863, "i_loss": 12.474731}


def run_config(root: pathlib.Path, solver="euler", **kw):
    """TrainConfig keywords (shared by both packages) for one epoch from a
    copy of checkpoint 200, logging every step."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(CKPT, root / "ws.200")
    return dict(variant="dae_no_encode", train_data=str(DATA / "training.npz"),
                test_data=str(DATA / "testing.npz"), model=str(root / "run"), num=128,
                batch=64, epoch=200, hidden=128, larger_than=None, seed=0,
                warm_start=str(root / "ws.200"), stop_after=1, loss_record_iter=1,
                solver=solver, echo_logs=False, **kw)


@pytest.fixture
def few_threads():
    """Two intra-op threads: the suite runs several workers at once, and a
    worker whose torch takes every core slows them all."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def read_metrics(run_dir):
    recs = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if r["kind"] == "train"]
    (ev,) = [r for r in recs if r["kind"] == "eval"]
    return train, ev


def jax_anchors(root: pathlib.Path, solver="euler"):
    """Step-1, step-2 and epoch-1 eval numbers of the JAX package's Trainer
    (CPU, the non-fused XLA path) under the same settings."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from py_psnode_tpu.train.trainer import TrainConfig, Trainer

    _, run_dir = Trainer(TrainConfig(**run_config(root, solver, fused=False))).train()
    return read_metrics(run_dir)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's one-epoch run (Euler), once for this file."""
    return jax_anchors(tmp_path_factory.mktemp("jax_train"), "euler")


def test_jax_trainer_gives_the_written_anchors(jax_run):
    """Step 1 to 1e-6. Step 2 and the eval to 1e-4: after Adam's first,
    sign-like update the JAX run itself moves by up to 8.5e-6 between a
    standalone process (where the numbers were written down) and this test
    session, whose XLA CPU setup splits reductions otherwise."""
    train, ev = jax_run
    assert [r["batch"] for r in train] == [1, 2]
    np.testing.assert_allclose([train[0][k] for k in STEP1], list(STEP1.values()), rtol=1e-6)
    np.testing.assert_allclose([train[1][k] for k in STEP2] + [ev[k] for k in EVAL1],
                               [*STEP2.values(), *EVAL1.values()], rtol=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_port_trainer_matches_jax_anchors(tmp_path, fused, few_threads, jax_run):
    from py_psnode_tpu_torch.ops import fused_dae as F
    from py_psnode_tpu_torch.ops import fused_dae_vjp as V
    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    (j1, j2), j_ev = jax_run
    launches = (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches)
    cfg = TrainConfig(**run_config(tmp_path, fused=fused, device="cpu"))
    _, run_dir = Trainer(cfg).train()
    assert (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches) == launches
    train, ev = read_metrics(run_dir)
    assert [r["batch"] for r in train] == [1, 2]
    for k in ("loss", "x_loss", "i_loss"):
        np.testing.assert_allclose(train[0][k], j1[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(train[0]["grad_norm"], j1["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(train[1]["loss"], j2["loss"], rtol=1e-3)
    np.testing.assert_allclose(train[1]["grad_norm"], j2["grad_norm"], rtol=1e-3)
    np.testing.assert_allclose([ev["x_loss"], ev["i_loss"]], [j_ev["x_loss"], j_ev["i_loss"]],
                               rtol=1e-3)
    assert (run_dir / "model_checkpoint.1").exists()


if __name__ == "__main__":
    import tempfile

    sys.path.insert(0, str(REPO))
    for solver in sys.argv[1:] or ["euler", "rk4"]:
        with tempfile.TemporaryDirectory() as tmp:
            train, ev = jax_anchors(pathlib.Path(tmp), solver)
        for r in train:
            print(solver, f"step {r['batch']}: loss {r['loss']:.8g} x_loss {r['x_loss']:.8g} "
                  f"i_loss {r['i_loss']:.8g} gradient_norm {r['grad_norm']:.8g}")
        print(solver, f"epoch-1 eval: x_loss {ev['x_loss']:.8g} i_loss {ev['i_loss']:.8g}")
