"""The port's serving slice end to end on the CPU, at full width.

``--testing --fused`` of the DAE no-encode CLI on a temporary copy of the
trained motor checkpoint 200 (h=128, T=1001, 32 test samples), through the
JAX package and through ``py_psnode_tpu_torch`` (``--device cpu``), for
Euler (the CLI default) and RK4. The five per-dim losses must agree to
rtol 1e-5, and both are cross-checked against the recorded float32 anchors
of the JAX package.
"""

import pathlib
import re
import shutil

import numpy as np
import pytest

from py_psnode_tpu.cli.common import main as jax_main

from py_psnode_tpu_torch.cli.common import main as port_main
from py_psnode_tpu_torch.ops import fused_dae as F

REPO = pathlib.Path(__file__).resolve().parents[1]
RUN = REPO / "benchmarks/h2h_work_prod_s0"
CKPT = RUN / "ours_dae_motor/model_checkpoint.200"
TEST_DATA = RUN / "data_dae_motor/testing.npz"
# per-dim losses (x_0..x_2, i_0, i_1) and totals of the JAX package on the
# CPU in float32 (Euler), and the totals with RK4
ANCHOR_DIMS_EULER = (0.0052277320, 0.0067790253, 0.0104969693, 0.0253921114, 0.0603277087)
ANCHOR_TOTALS = {"euler": (0.0225037, 0.0857198), "rk4": (0.0225467, 0.0859806)}
RTOL = 1e-5
DIM_LINE = re.compile(r": ([xi])_loss_dim_(\d+):\s+([0-9.eE+-]+)\.")


def _run(main, root: pathlib.Path, solver):
    """Run one CLI on its own copy of the checkpoint; returns the
    ``[x_loss, i_loss, x_per_sample, i_per_sample]`` of its evaluation.npz
    and the five per-dim losses of its evaluation log."""
    root.mkdir()
    shutil.copy(CKPT, root / CKPT.name)
    main("dae_no_encode", ["--testing", "--fused", "--solver", solver, "--device", "cpu",
                           "--model", str(root / CKPT.name), "--test_data", str(TEST_DATA)])
    log = (root / f"Model_{CKPT.name}_Evaluation.log").read_text()
    dims = [float(m.group(3)) for m in DIM_LINE.finditer(log)]
    assert len(dims) == 5, log
    with np.load(root / "evaluation.npz", allow_pickle=True) as f:
        res = f["eval"]
    return res, np.array(dims)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_cli")
    return {s: _run(jax_main, root / s, s) for s in ("euler", "rk4")}


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_port_cli_matches_jax_cli(jax_runs, tmp_path, solver):
    ref, ref_dims = jax_runs[solver]
    before = F.fused_dae_rollout.launches
    got, got_dims = _run(port_main, tmp_path / "port", solver)
    assert F.fused_dae_rollout.launches == before  # CPU: the plain rollout
    np.testing.assert_allclose(got_dims, ref_dims, rtol=RTOL)
    np.testing.assert_allclose([got[0], got[1]], [ref[0], ref[1]], rtol=RTOL)
    np.testing.assert_allclose(got[2], ref[2], rtol=RTOL)  # per-sample x losses
    np.testing.assert_allclose(got[3], ref[3], rtol=RTOL)  # per-sample i losses
    np.testing.assert_allclose([got[0], got[1]], ANCHOR_TOTALS[solver], rtol=RTOL)
    if solver == "euler":
        np.testing.assert_allclose(got_dims, ANCHOR_DIMS_EULER, rtol=RTOL)
        np.testing.assert_allclose(ref_dims, ANCHOR_DIMS_EULER, rtol=RTOL)


def test_port_plain_path_matches_the_fused_one(jax_runs, tmp_path):
    """The non-fused port path (``DAEModel`` step by step) on the same
    checkpoint lands on the same losses."""
    root = tmp_path / "plain"
    root.mkdir()
    shutil.copy(CKPT, root / CKPT.name)
    res = port_main("dae_no_encode", ["--testing", "--device", "cpu", "--model",
                                      str(root / CKPT.name), "--test_data", str(TEST_DATA)])
    ref = jax_runs["euler"][0]
    np.testing.assert_allclose([res[0], res[1]], [ref[0], ref[1]], rtol=RTOL)


def test_port_cli_refuses_what_is_not_ported(tmp_path):
    train = ["--training", "--device", "cpu", "--train_data", str(TEST_DATA), "--test_data",
             str(TEST_DATA), "--model", str(tmp_path / "run")]
    for extra in (["--checkpointer", "orbax"], ["--auto_resume"], ["--devices", "2"],
                  ["--n_windows", "20", "--remat", "sqrt"], ["--remat", "sqrt"], ["--input_true_x", "--remat", "sqrt"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            port_main("dae_no_encode", train + extra)
    assert not (tmp_path / "run").exists()
    with pytest.raises(NotImplementedError, match="not ported"):
        port_main("dae_no_encode", ["--saving", "--device", "cpu", "--checkpointer", "orbax"])
    # the direct-encode variants, their teacher forcing and their
    # multishoot are served, their remat is not
    with pytest.raises(NotImplementedError, match="not ported"):
        port_main("dae_encode", train + ["--n_windows", "20", "--remat", "sqrt"])
    with pytest.raises(SystemExit):
        port_main("dae_no_encode", ["--testing", "--device", "tpu"])
