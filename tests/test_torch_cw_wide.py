"""The channel-wise slice at a width above 128 (h=136: the kernels' wide
layout, ``csrc/cw_wide.cuh``), against the JAX package on the CPU.

* The port's plain rollout and its plain reverse walk (the CPU route of the
  kernels' wrappers) against the JAX ``fused_cw_rollout_diff`` with its
  Pallas kernels in interpret mode, on the same seeded inputs (B=2, T=5),
  for both variants' channels and each solver: the forward at rtol 1e-5 /
  atol 1e-6, the VJP (every input's cotangent) at rtol 2e-3 / atol 2e-4,
  the JAX package's fused-against-XLA bars
  (``tests/test_fused_channelwise.py``).
* One Trainer epoch of each variant at ``hidden=136`` (the ``SMALL`` set of
  ``test_torch_cw_slice.py`` with its width changed: T=101, 16 samples,
  batch 8, Euler), fused, against the JAX package's Trainer: step 1 at loss
  rtol 1e-5 and gradient norm rtol 1e-4, step 2 and the epoch-1 eval at
  rtol 1e-3.
* The widths the kernels take: the forward up to 724 and the backward up to
  572, the JAX package's widest (its block choice fails past them), and a
  ``ValueError`` naming the width and the limit past each.

``python tests/test_torch_cw_wide.py anchors [euler rk4]`` derives
``chip_smoke.CW_WIDE_ANCHORS``: the JAX Trainer and CLI on the CPU at
h=256 (``WIDE``: both sets at 16 training samples in batches of 8, cut to
T=201, 8 test samples), from ``chip_smoke.cw_start_checkpoint`` (seed 0);
it is run by hand, not in tier-1 (several minutes).
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from py_psnode_tpu.ops import fused_channelwise as JF  # noqa: E402

from py_psnode_tpu_torch.ops import fused_channelwise as FC  # noqa: E402
from py_psnode_tpu_torch.ops import fused_channelwise_vjp as VC  # noqa: E402

from test_torch_cw_slice import DIMS, SMALL, jax_run, make_inputs, read_metrics, run_config  # noqa: E402
from test_torch_fused_cw import FWD_TOL, GRAD_TOL, rollout_inputs, to_jax  # noqa: E402

H = 136  # above 128: the wide kernels' width (two 128-wide blocks, the second mostly padding)
WIDE_SMALL = dict(SMALL, hidden=H)
# the card's anchors (chip_smoke.CW_WIDE_ANCHORS): h=256 on small sets
WIDE = dict(hidden=256, step=201, num=16, batch=8, n_test=8)


def to_port_grads(g_streams, g_weights, g_x0, B, h):
    """The JAX VJP's cotangents in the port's layout: ``[g_fz, g_s_constV,
    g_x0, *flatten_weights]``."""
    t = lambda a: torch.tensor(np.asarray(a))
    # per channel (W0, b0 [1, h], W1, b1 [1, h]) -> stacks [xd, h, h], [xd, h]
    stack = lambda tups: tuple(torch.stack([t(tup[k]) if k % 2 == 0 else t(tup[k])[0] for tup in tups])
                               for k in range(4))
    w = dict(a=t(g_weights["a"]), vert=[(t(W), t(b)[0]) for W, b in g_weights["vert"]],
             ext=stack(g_weights["ext"]), head=stack(g_weights["head"]))
    return [t(g_streams["fz"]).permute(0, 2, 1, 3), t(g_streams["s_constV"]).reshape(B, h, h),
            t(g_x0).transpose(0, 1)] + FC.flatten_weights(w)


@pytest.mark.parametrize("xd,zd", [(2, 2), (3, 1)])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_wide_plain_rollout_and_walk_match_jax_interpret(solver, xd, zd):
    streams, weights, x0, dt = rollout_inputs(B=2, Tm1=4, h=H, xd=xd, zd=zd, seed=H + xd)
    js, jw, jx0, jdt = to_jax(streams, weights, x0, dt)
    sol_j, vjp = jax.vjp(lambda s, w, x: JF.fused_cw_rollout_diff(s, w, x, jdt, solver, True), js, jw, jx0)
    rows = FC.fused_cw_rollout(streams, weights, x0, dt, solver)  # CPU tensors: the plain version
    ref = np.transpose(np.asarray(sol_j), (0, 2, 1, 3))  # [T, xd, B, h] -> [T, B, xd, h]
    np.testing.assert_allclose(rows.numpy(), ref[1:], **FWD_TOL)

    sol = torch.cat([x0[None], rows])
    cot = torch.tensor(np.random.default_rng(H).standard_normal(tuple(sol.shape)).astype(np.float32))
    g_s, g_w, g_x0 = VC.fused_cw_rollout_bwd(streams, weights, dt, sol, cot, solver)
    got = [g_s["fz"], g_s["s_constV"], g_x0 + cot[0]] + FC.flatten_weights(g_w)
    want = to_port_grads(*vjp(jnp.asarray(cot.permute(0, 2, 1, 3).numpy())), B=2, h=H)
    for k, (g, r) in enumerate(zip(got, want)):
        assert g.shape == r.shape, k
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=str(k), **GRAD_TOL)


@pytest.mark.parametrize("variant", sorted(DIMS))
def test_wide_trainer_matches_jax(variant, tmp_path):
    from py_psnode_tpu.train.trainer import TrainConfig as JaxTrainConfig, Trainer as JaxTrainer

    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    try:
        inputs = make_inputs(tmp_path / "data", variant, WIDE_SMALL)
        cfg = run_config(inputs, tmp_path / "jax", variant, WIDE_SMALL, fused=False)
        (j1, j2), j_ev = read_metrics(JaxTrainer(JaxTrainConfig(**cfg)).train()[1])
        cfg = run_config(inputs, tmp_path / "port", variant, WIDE_SMALL, fused=True, device="cpu")
        _, run_dir = Trainer(TrainConfig(**cfg)).train()
    finally:
        torch.set_num_threads(n)
    train, ev = read_metrics(run_dir)
    assert [r["batch"] for r in train] == [1, 2]
    np.testing.assert_allclose(train[0]["loss"], j1["loss"], rtol=1e-5)
    np.testing.assert_allclose(train[0]["grad_norm"], j1["grad_norm"], rtol=1e-4)
    keys = ("x_loss", "i_loss") if variant == "dae_channelwise" else ("x_loss",)
    np.testing.assert_allclose([train[1]["loss"], train[1]["grad_norm"]] + [ev[k] for k in keys],
                               [j2["loss"], j2["grad_norm"]] + [j_ev[k] for k in keys], rtol=1e-3)


@pytest.mark.parametrize("backward,most", [(False, 724), (True, 572)])
def test_kernels_take_the_jax_packages_widths(backward, most):
    for h in (129, most):
        FC.check_width(h, backward)
    with pytest.raises(ValueError, match=f"h <= {most}.*h={most + 1}"):
        FC.check_width(most + 1, backward)
    # the wrappers' input check runs it before anything else of the card:
    # on CPU tensors the width is refused, a width they take meets the
    # device check
    for h, match in ((most + 1, f"h <= {most}"), (most, "CUDA tensors")):
        streams, weights, x0, dt = rollout_inputs(B=1, Tm1=1, h=h, xd=2, zd=1, seed=1)
        with pytest.raises(ValueError, match=match):
            FC.check_inputs(streams, weights, x0, dt, backward=backward)


def test_the_limits_are_where_the_jax_block_choice_fails():
    for h, backward in ((724, False), (572, True)):
        assert JF.choose_cw_blocks(8, h, backward=backward)[0] >= 1
        with pytest.raises(ZeroDivisionError):
            JF.choose_cw_blocks(8, h + 1, backward=backward)
    assert (FC.MAX_HIDDEN_FWD, FC.MAX_HIDDEN_BWD) == (724, 572)


if __name__ == "__main__":
    import tempfile

    if sys.argv[1:2] != ["anchors"]:
        sys.exit("usage: python tests/test_torch_cw_wide.py anchors [euler rk4]")
    for solver in sys.argv[2:] or ["euler", "rk4"]:
        for variant in sorted(DIMS):
            with tempfile.TemporaryDirectory() as tmp:
                tmp = pathlib.Path(tmp)
                inputs = make_inputs(tmp / "data", variant, WIDE)
                (train, ev), losses = jax_run(inputs, tmp, variant, WIDE, solver)
            ev_keys = ("x_loss", "i_loss") if variant == "dae_channelwise" else ("x_loss",)
            print(f'"{variant}" "{solver}": dict(step1=({train[0]["loss"]:.8g}, {train[0]["grad_norm"]:.8g}), '
                  f'step2=({train[1]["loss"]:.8g}, {train[1]["grad_norm"]:.8g}), '
                  f'eval1=({", ".join(f"{ev[k]:.8g}" for k in ev_keys)},), '
                  f'test=({", ".join(f"{v:.8g}" for v in losses)},))', flush=True)
