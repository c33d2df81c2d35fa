"""The port's teacher-forced training at full width on the CPU, against the
JAX package.

The motor DAE warm-started from checkpoint 200 (h=128, T=1001, 128
training samples, batch 64, Euler, a fresh Adam at lr 5e-3, ``--larger_than
none``, seed 0) trains one epoch, two steps, with ``input_true_x``: the JAX
package's ``Trainer`` (CPU, float32, the non-fused XLA path) once for this
file, and the port's ``Trainer`` through the fused route (on the CPU the
plain versions of kernels 1-2 in their TF-x mode behind the
``autograd.Function``). The JAX run must give the anchors written into
``chip_smoke.py`` (``TF_ANCHORS``), and the port's step 1 its losses at
rtol 1e-5 (gradient norm 1e-4); step 2 at 1e-4 and the teacher-forced
epoch-1 eval at 1e-3: both follow Adam's first update, about lr * sign(g)
a parameter, which gradients near zero can flip (the port lay 2.6e-5 /
1.7e-4 from JAX there, the JAX run 1.2e-5 from itself in another process;
``test_torch_train_slice.py`` holds its step 2 and eval at 1e-3 for the
same reason). The port's CLI ``--testing --fused --input_true_x`` on the
checkpoint it wrote gives the eval's losses again.

``python tests/test_torch_tf_slice.py anchors`` prints the JAX package's
numbers for every teacher-forced combination the port dispatches (the
motor DAE and the direct-encode DAE with TF-x, TF-i and both; the ODEs on
the AVR set with TF-x), the ``TF_ANCHORS`` of ``chip_smoke.py``.
"""

import pathlib
import sys
import tempfile

import numpy as np
import pytest

import test_torch_dae_encode as dae_encode
import test_torch_ode_encode as ode_encode
import test_torch_ode_slice as ode_slice
from test_torch_train_slice import few_threads, read_metrics  # noqa: F401
from test_torch_train_slice import run_config as motor_config

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import TF_ANCHORS  # noqa: E402

# the combinations the JAX package's dispatch serves: flags "x" (TF-x), "i"
# (TF-i) and "xi" (both); the ODEs take TF-x only
COMBOS = [("dae_no_encode", f) for f in ("x", "i", "xi")] + [("dae_encode", f) for f in ("x", "i", "xi")] + [
    ("ode_no_encode", "x"), ("ode_encode", "x")]


def make_data(variant: str, root: pathlib.Path):
    """The variant's data and starting checkpoint under ``root`` (None for
    the motor DAE: its set and checkpoint 200 are committed)."""
    if variant == "dae_no_encode":
        return None
    return {"dae_encode": dae_encode, "ode_no_encode": ode_slice, "ode_encode": ode_encode}[variant].make_inputs(root)


def tf_config(variant: str, flags: str, data, root: pathlib.Path, **kw):
    """TrainConfig keywords (shared by both packages): the variant's one
    epoch of two steps (Euler) with the teacher-forcing flags."""
    kw.update(input_true_x="x" in flags, input_true_i="i" in flags)
    if variant == "dae_no_encode":
        return motor_config(root, "euler", **kw)
    return {"dae_encode": dae_encode, "ode_no_encode": ode_slice, "ode_encode": ode_encode}[variant].run_config(
        data, root, "euler", **kw)


def jax_tf_run(variant: str, flags: str, root: pathlib.Path):
    """The JAX package's Trainer (CPU, the non-fused XLA path): its step
    records and epoch-1 eval."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from py_psnode_tpu.train.trainer import TrainConfig, Trainer

    data = make_data(variant, root / "data")
    _, run_dir = Trainer(TrainConfig(**tf_config(variant, flags, data, root / "train", fused=False))).train()
    return read_metrics(run_dir)


def anchors_of(run):
    """A run's numbers in the layout of ``chip_smoke.TF_ANCHORS``."""
    train, ev = run
    return dict(step1=(train[0]["loss"], train[0]["grad_norm"]), step2=(train[1]["loss"], train[1]["grad_norm"]),
                eval1=tuple(ev[k] for k in ("x_loss", "i_loss") if k in ev))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's motor DAE run with TF-x, once for this file."""
    return jax_tf_run("dae_no_encode", "x", tmp_path_factory.mktemp("jax_tf"))


def test_jax_tf_run_gives_the_written_anchors(jax_run):
    """Step 1 to 1e-6; step 2 and the eval, after Adam's first update, to
    1e-4 (as ``test_torch_train_slice.py`` holds its anchors)."""
    got, want = anchors_of(jax_run), TF_ANCHORS["dae_no_encode"]["x"]
    assert [r["batch"] for r in jax_run[0]] == [1, 2]
    np.testing.assert_allclose(got["step1"], want["step1"], rtol=1e-6)
    np.testing.assert_allclose(got["step2"] + got["eval1"], want["step2"] + want["eval1"], rtol=1e-4)


def test_port_fused_tf_trainer_matches_jax(tmp_path, few_threads, jax_run):  # noqa: F811
    """The port's fused TF-x epoch against the JAX run (the module
    docstring's bars); then the CLI ``--testing --fused --input_true_x`` on
    its checkpoint, teacher-forced like the Trainer's eval, gives the
    eval's losses."""
    from py_psnode_tpu_torch.cli.common import main as port_main
    from py_psnode_tpu_torch.ops import fused_dae as F
    from py_psnode_tpu_torch.ops import fused_dae_vjp as V
    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    launches = (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches)
    cfg = TrainConfig(**tf_config("dae_no_encode", "x", None, tmp_path, fused=True, device="cpu"))
    _, run_dir = Trainer(cfg).train()
    assert (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches) == launches  # no kernel on the CPU
    (j1, j2), j_ev = jax_run
    train, ev = read_metrics(run_dir)
    assert [r["batch"] for r in train] == [1, 2]
    for got, want, rtol in ((train[0], j1, 1e-5), (train[1], j2, 1e-4)):
        for k in ("loss", "x_loss", "i_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose([ev["x_loss"], ev["i_loss"]], [j_ev["x_loss"], j_ev["i_loss"]], rtol=1e-3)
    res = port_main("dae_no_encode", ["--testing", "--fused", "--input_true_x", "--device", "cpu", "--model",
                                      str(run_dir / "model_checkpoint.1"), "--test_data", cfg.test_data])
    np.testing.assert_allclose([float(res[0]), float(res[1])], [ev["x_loss"], ev["i_loss"]], rtol=1e-6)


if __name__ == "__main__" and sys.argv[1:] == ["anchors"]:
    for variant, flags in COMBOS:
        with tempfile.TemporaryDirectory() as tmp:
            a = anchors_of(jax_tf_run(variant, flags, pathlib.Path(tmp)))
        print(f"{variant} {flags}: " + ", ".join(f"{k}={tuple(float(f'{v:.8g}') for v in a[k])}" for k in a),
              flush=True)
