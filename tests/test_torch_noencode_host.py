"""The no-encode backward kernels' own sources (kernels 2 and 4), built for
the host, against their plain PyTorch versions on the CPU.

``py_psnode_tpu_torch.utils.host_build`` compiles
``csrc/fused_dae_rollout_bwd.cu`` and ``csrc/fused_ode_rollout_bwd.cu``
(with ``csrc/noencode_bwd.cuh`` and ``csrc/mma_tile.cuh``) with g++ against a
host model of the CUDA subset and of the Hopper instructions they use (the
mma.sync fragment layout, TF32 rounding, cp.async, warp shuffles), on
NaN-poisoned buffers. The card's tolerances (``tests/test_torch_kernel.py``):
the whole backward per output tensor within ``1e-4 * max|plain|`` of the
float64 plain walk, bit-identical on relaunch; the recompute's buffers
within ``1e-4 * max(1, |plain|)`` of :func:`recompute_plain`; the
contraction within ``1e-5 * max|plain|`` of :func:`contract_plain` in
float64. Skips where no g++ is on the PATH.
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
from py_psnode_tpu_torch.utils.noencode_inputs import dae_inputs, ode_inputs


def need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")


# (B, Tm1, h, solver): one row and three, h=40 and an odd h=19 (rows not
# 16-byte aligned: 4-byte cp.async), each solver; dae_inputs puts events in
# the walk's first step of row 0 and in step Tm1 // 3 of row 1
DAE_CASES = [(3, 4, 40, "rk4"), (1, 3, 19, "midpoint"), (3, 3, 19, "euler"), (3, 11, 40, "midpoint")]


@pytest.mark.parametrize("B,Tm1,h,solver", DAE_CASES)
def test_host_dae_backward_matches_float64_walk(B, Tm1, h, solver):
    need_gxx()
    got = host_build.noencode_bwd_check("dae", B, Tm1, h, solver)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0


# (B, Tm1, h, xd, n_tail, solver): the AVR no-encode shape and the
# direct-encode latent shape (xd = h, one tail layer)
ODE_CASES = [(3, 4, 40, 2, 3, "rk4"), (1, 3, 19, 2, 3, "midpoint"), (3, 3, 40, 2, 3, "euler"),
             (3, 3, 40, 40, 1, "rk4"), (2, 3, 19, 19, 1, "euler")]


@pytest.mark.parametrize("B,Tm1,h,xd,n_tail,solver", ODE_CASES)
def test_host_ode_backward_matches_float64_walk(B, Tm1, h, xd, n_tail, solver):
    need_gxx()
    got = host_build.noencode_bwd_check("ode", B, Tm1, h, solver, xd, n_tail)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0


def _close(got, ref, tol):
    """got within tol * max(1, |ref|) of ref wherever ref is defined."""
    assert got.shape == ref.shape
    assert torch.all((got.double() - ref.double()).abs() <= tol * ref.double().abs().clamp(min=1.0))


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_host_dae_recompute_matches_plain(solver):
    need_gxx()
    args = dae_inputs(3, 4, 40, seed=5)
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


def test_host_ode_recompute_matches_plain():
    need_gxx()
    s_de, weights, x0, dt = ode_inputs(3, 4, 40, seed=6)
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


def test_host_dae_contraction_matches_plain():
    need_gxx()
    args = dae_inputs(3, 4, 40, seed=7)
    packed = F.fused_dae_rollout_packed_plain(*args, "midpoint")
    cot = torch.zeros(5, 3, 5)
    _, bufs = host_build.dae_rollout_bwd(*args, packed, cot, "midpoint", stages=0)
    bufs = _random_bufs(bufs, 8)
    (_, g_w, _, _), _ = host_build.dae_rollout_bwd(*args, packed, cot, "midpoint", stages=4, bufs=bufs)
    R, h, E = 12, 40, 4
    ev = args[4][..., 1].reshape(R) > 0
    ref = V.contract_plain(bufs["res"].view(E, 3, R, h).double(), bufs["gres"].view(E, 3, R, h).double(),
                           bufs["gy"].view(E, R, 3).double(), bufs["xin"].view(E, R, 5).double(), ev,
                           (3, 3), 3, 2)
    assert _worst(V.flatten_weights(g_w)[0], V.flatten_weights(ref)[0]) <= 1e-5


def test_host_ode_contraction_matches_plain():
    need_gxx()
    s_de, weights, x0, dt = ode_inputs(3, 4, 19, seed=9)
    sol = torch.zeros(5, 3, 2)
    _, bufs = host_build.ode_rollout_bwd(s_de, weights, dt, sol, sol, "rk4", stages=0)
    bufs = _random_bufs(bufs, 10)
    (_, g_w, _), _ = host_build.ode_rollout_bwd(s_de, weights, dt, sol, sol, "rk4", stages=4, bufs=bufs)
    R, h, S = 12, 19, 4
    ref = VO.contract_plain(bufs["res"].view(S, 3, R, h).double(), bufs["gres"].view(S, 3, R, h).double(),
                            bufs["gy"].view(S, R, 2).double(), bufs["xin"].view(S, R, 2).double(), 3, 2)
    assert _worst(VO.flatten_weights(g_w), VO.flatten_weights(ref)) <= 1e-5
