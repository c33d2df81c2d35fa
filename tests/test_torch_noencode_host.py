"""The no-encode backward pair's own sources (kernels 2 and 4), built for the
host, against their plain PyTorch versions on the CPU. The forward pair's
cases (kernels 1 and 3) are in ``test_torch_noencode_host_fwd.py`` and
``test_torch_noencode_host_fwd_wide.py``: three files, so that the suite's
workers build and run them at once.

``py_psnode_tpu_torch.utils.host_build`` compiles
``csrc/fused_{dae,ode}_rollout{,_bwd}.cu`` (with ``csrc/noencode_bwd.cuh``
and ``csrc/mma_tile.cuh``) with g++ against a host model of the CUDA subset
and of the Hopper instructions they use (the mma.sync fragment layout, TF32
rounding, cp.async, warp shuffles), on NaN-poisoned shared memory and
buffers. The card's tolerances (``tests/test_torch_kernel.py``): the whole
backward per output tensor within ``1e-4 * max|plain|`` of the
float64 plain walk, bit-identical on relaunch; the recompute's buffers
within ``1e-4 * max(1, |plain|)`` of :func:`recompute_plain`; the
contraction within ``1e-5 * max|plain|`` of :func:`contract_plain` in
float64. The TF-x mode of kernel 2 (teacher forcing of x) is held the same
way, on seeded true states. Skips where no g++ is on the PATH.
"""

import shutil

import numpy as np
import pytest
import torch

from py_psnode_tpu_torch.ops import fused_dae as F
from py_psnode_tpu_torch.ops import fused_dae_vjp as V
from py_psnode_tpu_torch.ops import fused_ode as FO
from py_psnode_tpu_torch.ops import fused_ode_vjp as VO
from py_psnode_tpu_torch.utils import host_build
from py_psnode_tpu_torch.utils.noencode_inputs import dae_inputs, ode_inputs, true_states


def need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")


# (B, Tm1, h, solver): one row and three, h=40 and an odd h=19 (rows not
# 16-byte aligned: 4-byte cp.async), each solver; h=136 and 200, the wide
# kernels (padded width 256: two 128-wide chunks of every layer);
# dae_inputs puts events in the walk's first step of row 0 and in step
# Tm1 // 3 of row 1
DAE_CASES = [(3, 4, 40, "rk4"), (1, 3, 19, "midpoint"), (3, 3, 19, "euler"), (3, 11, 40, "midpoint"),
             (2, 3, 136, "rk4"), (1, 3, 200, "midpoint")]


@pytest.mark.parametrize("B,Tm1,h,solver", DAE_CASES)
def test_host_dae_backward_matches_float64_walk(B, Tm1, h, solver):
    need_gxx()
    got = host_build.noencode_bwd_check("dae", B, Tm1, h, solver)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0


# (B, Tm1, h, solver): the direct-encode DAE's latent shape (xd = id = h,
# one tail layer a net; kin = 2h), at h=16 and at h=136 (the wide
# kernels, padded width 384)
DAE_ENCODE_CASES = [(3, 4, 16, "rk4"), (2, 3, 136, "euler")]


@pytest.mark.parametrize("B,Tm1,h,solver", DAE_ENCODE_CASES)
def test_host_dae_backward_matches_float64_walk_at_the_encode_shape(B, Tm1, h, solver):
    need_gxx()
    got = host_build.noencode_bwd_check("dae", B, Tm1, h, solver, xd=h, n_tail=1, idim=h)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0


# (B, Tm1, h, xd, n_tail, solver): the AVR no-encode shape and the
# direct-encode latent shape (xd = h, one tail layer), each also at h=136
# (the wide kernels; the encode shape's first layer and readout 136 wide)
ODE_CASES = [(3, 4, 40, 2, 3, "rk4"), (1, 3, 19, 2, 3, "midpoint"), (3, 3, 40, 2, 3, "euler"),
             (3, 3, 40, 40, 1, "rk4"), (2, 3, 19, 19, 1, "euler"), (2, 3, 136, 2, 3, "euler"),
             (2, 3, 136, 136, 1, "rk4")]


@pytest.mark.parametrize("B,Tm1,h,xd,n_tail,solver", ODE_CASES)
def test_host_ode_backward_matches_float64_walk(B, Tm1, h, xd, n_tail, solver):
    need_gxx()
    got = host_build.noencode_bwd_check("ode", B, Tm1, h, solver, xd, n_tail)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0


# the wide walk with its vectors in global memory (where H floats eleven
# times over do not fit a block's shared memory, h above about 5 000),
# reached at h=136 by a build that always takes that path
@pytest.mark.parametrize("family,xd,n_tail,solver", [("dae", 3, 3, "euler"), ("ode", 136, 1, "midpoint")])
def test_host_wide_backward_with_walk_vectors_in_global_memory(family, xd, n_tail, solver):
    need_gxx()
    got = host_build.noencode_bwd_check(family, 2, 3, 136, solver, xd, n_tail, defines=("NE_WIDE_VEC_GMEM=1",))
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0


def _close(got, ref, tol):
    """got within tol * max(1, |ref|) of ref wherever ref is defined."""
    assert got.shape == ref.shape
    assert torch.all((got.double() - ref.double()).abs() <= tol * ref.double().abs().clamp(min=1.0))


@pytest.mark.parametrize("solver,h", [("euler", 40), ("rk4", 40), ("rk4", 136)])
def test_host_dae_recompute_matches_plain(solver, h):
    need_gxx()
    args = dae_inputs(3, 4, h, seed=5)
    packed = F.fused_dae_rollout_packed_plain(*args, solver)
    cot = torch.zeros(5, 3, 5)
    _, bufs = host_build.dae_rollout_bwd(*args, packed, cot, solver, stages=1)
    res, xin = V.recompute_plain(*args, packed, solver)
    E, L, R, h = res.shape
    got_res, got_xin = bufs["res"].view(E, L, R, h), bufs["xin"].view(E, R, -1)
    ev = args[4][..., 1].reshape(R) > 0
    # the stages (input (x, i_in)), the AE at t+1 (input x), and the AE at
    # the event on event rows
    _close(got_res[:-1], res[:-1], 1e-4)
    _close(got_xin[:-2], xin[:-2], 1e-4)
    _close(got_xin[-2, :, :3], xin[-2, :, :3], 1e-4)
    assert bool(ev.any())
    _close(got_res[-1][:, ev], res[-1][:, ev], 1e-4)
    _close(got_xin[-1][ev, :3], xin[-1][ev, :3], 1e-4)


# the no-encode shape at h=40 and the wide encode shape (xd = h = 136)
@pytest.mark.parametrize("h,xd,n_tail", [(40, 2, 3), (136, 136, 1)])
def test_host_ode_recompute_matches_plain(h, xd, n_tail):
    need_gxx()
    s_de, weights, x0, dt = ode_inputs(3, 4, h, xd, n_tail, seed=6)
    sol = torch.cat([x0[None], FO.fused_ode_rollout_plain(s_de, weights, x0, dt, "rk4")])
    _, bufs = host_build.ode_rollout_bwd(s_de, weights, dt, sol, torch.zeros_like(sol), "rk4", stages=1)
    res, xin = VO.recompute_plain(s_de, weights, dt, sol, "rk4")
    _close(bufs["res"].view(res.shape), res, 1e-4)
    _close(bufs["xin"].view(xin.shape), xin, 1e-4)


def _random_bufs(bufs, seed):
    """The buffers of a backward filled with seeded normal values."""
    rng = np.random.default_rng(seed)
    return {k: torch.tensor(rng.standard_normal(v.numel()).astype(np.float32)) if k != "parts" else v
            for k, v in bufs.items()}


def _worst(got, ref):
    return max(((g.double() - r.double()).abs().max() / r.double().abs().max()).item()
               for g, r in zip(got, ref))


# h=40, and h=200: the wide contraction's 128 x 128 output tiles (two a
# side of every h x h job, the narrow jobs' 128-wide column tiles)
@pytest.mark.parametrize("h", [40, 200])
def test_host_dae_contraction_matches_plain(h):
    need_gxx()
    args = dae_inputs(3, 4, h, seed=7)
    packed = F.fused_dae_rollout_packed_plain(*args, "midpoint")
    cot = torch.zeros(5, 3, 5)
    _, bufs = host_build.dae_rollout_bwd(*args, packed, cot, "midpoint", stages=0)
    bufs = _random_bufs(bufs, 8)
    (_, g_w, _, _), _ = host_build.dae_rollout_bwd(*args, packed, cot, "midpoint", stages=4, bufs=bufs)
    R, E = 12, 4
    ev = args[4][..., 1].reshape(R) > 0
    ref = V.contract_plain(bufs["res"].view(E, 3, R, h).double(), bufs["gres"].view(E, 3, R, h).double(),
                           bufs["gy"].view(E, R, 3).double(), bufs["xin"].view(E, R, 5).double(), ev,
                           (3, 3), 3, 2)
    assert _worst(V.flatten_weights(g_w)[0], V.flatten_weights(ref)[0]) <= 1e-5


# h=19, and the wide encode shape xd = h = 136 (one tail layer: its first
# layer and readout 136 x 136 jobs of four tiles)
@pytest.mark.parametrize("h,xd,n_tail", [(19, 2, 3), (136, 136, 1)])
def test_host_ode_contraction_matches_plain(h, xd, n_tail):
    need_gxx()
    s_de, weights, x0, dt = ode_inputs(3, 4, h, xd, n_tail, seed=9)
    sol = torch.zeros(5, 3, xd)
    _, bufs = host_build.ode_rollout_bwd(s_de, weights, dt, sol, sol, "rk4", stages=0)
    bufs = _random_bufs(bufs, 10)
    (_, g_w, _), _ = host_build.ode_rollout_bwd(s_de, weights, dt, sol, sol, "rk4", stages=4, bufs=bufs)
    R, S = 12, 4
    ref = VO.contract_plain(bufs["res"].view(S, n_tail, R, h).double(),
                            bufs["gres"].view(S, n_tail, R, h).double(), bufs["gy"].view(S, R, xd).double(),
                            bufs["xin"].view(S, R, xd).double(), n_tail, xd)
    assert _worst(VO.flatten_weights(g_w), VO.flatten_weights(ref)) <= 1e-5


# The TF-x mode (teacher forcing of x, seeded true states, the events of
# dae_inputs); the direct-encode latent shape xd = id = h with one tail
# layer
ENCODE = dict(xd=16, n_tail=1, idim=16)
# (B, Tm1, h, solver, the true states' cotangents, shape): with and without
# g_xt / g_xt1; h=136 the wide kernels; the encode shape
DAE_TFX_BWD_CASES = [(3, 4, 16, "rk4", True, {}), (3, 4, 16, "midpoint", False, {}), (2, 3, 136, "euler", True, {}),
                     (2, 3, 16, "euler", True, ENCODE)]


@pytest.mark.parametrize("B,Tm1,h,solver,g_true,shape", DAE_TFX_BWD_CASES)
def test_host_dae_tfx_backward_matches_float64_walk(B, Tm1, h, solver, g_true, shape):
    need_gxx()
    got = host_build.noencode_bwd_check("dae", B, Tm1, h, solver, tfx=True, g_true=g_true, **shape)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0


def test_host_dae_tfx_recompute_matches_plain():
    """The TF-x recompute's buffers: the stages from x_true[t], the AE at
    t+1 at x_true[t+1] (both into xin, the contraction's operand), the AE
    at the event at the rolled x_t."""
    need_gxx()
    args = dae_inputs(3, 4, 40, seed=5)
    x_true = true_states(4, 3, 3, seed=5)
    packed = F.fused_dae_rollout_packed_plain(*args, "rk4", x_true)
    _, bufs = host_build.dae_rollout_bwd(*args, packed, torch.zeros(5, 3, 5), "rk4", stages=1, x_true=x_true)
    res, xin = V.recompute_plain(*args, packed, "rk4", x_true)
    E, L, R, h = res.shape
    got_res, got_xin = bufs["res"].view(E, L, R, h), bufs["xin"].view(E, R, -1)
    ev = args[4][..., 1].reshape(R) > 0
    _close(got_res[:-1], res[:-1], 1e-4)
    _close(got_xin[:-2], xin[:-2], 1e-4)
    _close(got_xin[-2, :, :3], xin[-2, :, :3], 1e-4)
    assert torch.equal(xin[0, :, :3], x_true[:-1].reshape(R, 3))  # the plain version's own rule
    _close(got_res[-1][:, ev], res[-1][:, ev], 1e-4)
    _close(got_xin[-1][ev, :3], xin[-1][ev, :3], 1e-4)
