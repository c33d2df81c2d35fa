"""The port's multiple shooting at full width on the CPU, against the JAX
package.

The motor DAE warm-started from checkpoint 200 (h=128, T=1001, 128
training samples, batch 64, Euler, a fresh Adam at lr 5e-3, ``--larger_than
none``, seed 0) trains one epoch, two steps, with ``n_windows=20`` (windows
of 50 steps, the folded batch 20 x 64 = 1 280 rows) and ``gap_weight=0.3``:
the JAX package's ``Trainer`` (CPU, float32, the non-fused XLA path) once for
this file, and the port's ``Trainer`` through the fused route (on the CPU
the plain versions of kernels 1-2 behind their ``autograd.Function``). The
JAX run must give the anchors written into ``chip_smoke.py``
(``MS_ANCHORS``), and the port its step 1 and step 2 at rtol 1e-5 (gradient
norms 1e-4) and the full-rollout epoch-1 eval (the evaluations are not
windowed) at 1e-4: after Adam's first, sign-like update the JAX run itself
moves by up to 1.6e-5 there between a standalone process and a test
session (2.709034 / 22.047993 against 2.709077 / 22.048302; the port's
2.709033 / 22.048052).

``python tests/test_torch_ms_slice.py anchors`` prints the JAX package's
numbers for all six variants (the motor DAE from checkpoint 200, the
direct-encode DAE on the motor set, both ODEs on the AVR set, the
channel-wise variants as ``test_torch_cw_slice.py`` sets them up), the
``MS_ANCHORS`` of ``chip_smoke.py``.
"""

import pathlib
import sys
import tempfile

import numpy as np
import pytest

import test_torch_cw_slice as cw_slice
import test_torch_dae_encode as dae_encode
import test_torch_ode_encode as ode_encode
import test_torch_ode_slice as ode_slice
from test_torch_train_slice import few_threads, read_metrics  # noqa: F401
from test_torch_train_slice import run_config as motor_config

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import MS_ANCHORS, MS_GAP_WEIGHT, MS_WINDOWS  # noqa: E402

VARIANTS = ("dae_no_encode", "dae_encode", "ode_no_encode", "ode_encode", "ode_channelwise", "dae_channelwise")
_MODULES = {"dae_encode": dae_encode, "ode_no_encode": ode_slice, "ode_encode": ode_encode}


def make_data(variant: str, root: pathlib.Path):
    """The variant's data and starting checkpoint under ``root`` (None for
    the motor DAE: its set and checkpoint 200 are committed)."""
    if variant == "dae_no_encode":
        return None
    if variant in _MODULES:
        return _MODULES[variant].make_inputs(root)
    return cw_slice.make_inputs(root, variant, cw_slice.FULL[variant])


def ms_config(variant: str, data, root: pathlib.Path, **kw):
    """TrainConfig keywords (shared by both packages): the variant's one
    epoch of two steps (Euler) with K=20 windows and gap weight 0.3."""
    kw.update(n_windows=MS_WINDOWS, gap_weight=MS_GAP_WEIGHT)
    if variant == "dae_no_encode":
        return motor_config(root, "euler", **kw)
    if variant in _MODULES:
        return _MODULES[variant].run_config(data, root, "euler", **kw)
    return cw_slice.run_config(data, root, variant, cw_slice.FULL[variant], "euler", **kw)


def jax_ms_run(variant: str, root: pathlib.Path):
    """The JAX package's Trainer (CPU, the non-fused XLA path): its step
    records and epoch-1 eval."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from py_psnode_tpu.train.trainer import TrainConfig, Trainer

    data = make_data(variant, root / "data")
    _, run_dir = Trainer(TrainConfig(**ms_config(variant, data, root / "train", fused=False))).train()
    return read_metrics(run_dir)


def anchors_of(run):
    """A run's numbers in the layout of ``chip_smoke.MS_ANCHORS``."""
    train, ev = run
    return dict(step1=(train[0]["loss"], train[0]["grad_norm"]), step2=(train[1]["loss"], train[1]["grad_norm"]),
                eval1=tuple(ev[k] for k in ("x_loss", "i_loss") if k in ev))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's motor DAE multishoot run, once for this file."""
    return jax_ms_run("dae_no_encode", tmp_path_factory.mktemp("jax_ms"))


def test_jax_ms_run_gives_the_written_anchors(jax_run):
    """Step 1 to 1e-6; step 2 and the eval, after Adam's first update, to
    1e-4 (as ``test_torch_train_slice.py`` holds its anchors)."""
    got, want = anchors_of(jax_run), MS_ANCHORS["dae_no_encode"]
    assert [r["batch"] for r in jax_run[0]] == [1, 2]
    np.testing.assert_allclose(got["step1"], want["step1"], rtol=1e-6)
    np.testing.assert_allclose(got["step2"] + got["eval1"], want["step2"] + want["eval1"], rtol=1e-4)


def test_port_fused_ms_trainer_matches_jax(tmp_path, few_threads, jax_run):  # noqa: F811
    """The port's fused multishoot epoch against the JAX run (the module
    docstring's bars), no kernel launched on the CPU."""
    from py_psnode_tpu_torch.ops import fused_dae as F
    from py_psnode_tpu_torch.ops import fused_dae_vjp as V
    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    launches = (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches)
    _, run_dir = Trainer(TrainConfig(**ms_config("dae_no_encode", None, tmp_path, fused=True, device="cpu"))).train()
    assert (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches) == launches
    (j1, j2), j_ev = jax_run
    train, ev = read_metrics(run_dir)
    assert [r["batch"] for r in train] == [1, 2]
    for got, want in ((train[0], j1), (train[1], j2)):
        for k in ("loss", "x_loss", "i_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose([ev["x_loss"], ev["i_loss"]], [j_ev["x_loss"], j_ev["i_loss"]], rtol=1e-4)


if __name__ == "__main__" and sys.argv[1:2] == ["anchors"]:
    for variant in sys.argv[2:] or VARIANTS:
        with tempfile.TemporaryDirectory() as tmp:
            a = anchors_of(jax_ms_run(variant, pathlib.Path(tmp)))
        print(f"{variant}: " + ", ".join(f"{k}={tuple(float(f'{v:.8g}') for v in a[k])}" for k in a), flush=True)
