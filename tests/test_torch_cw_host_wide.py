"""The channel-wise kernels' wide layout (h > 128, ``csrc/cw_wide.cuh``),
their own sources built for the host, against the plain PyTorch versions on
the CPU; and the host model's two schedulers held bit for bit.

``py_psnode_tpu_torch.utils.host_build`` compiles ``csrc/fused_cw_rollout.cu``
and ``csrc/fused_cw_rollout_bwd.cu`` with g++ against the host model
(``csrc/host/``: a cluster's CUDA threads as fibers on one OS thread, the
mma.sync fragment layout, TF32 rounding, cp.async made at its wait, the
cluster barrier, NaN-poisoned shared memory and scratch). Small shapes at
h=136 and an odd h=145 (the weights' rows not 16-byte aligned: 4-byte
cp.async), each cluster size, the card's tolerances
(``tests/test_torch_kernel.py``): the forward within ``1e-4 * max(1,
|plain|)`` per element, bit-identical on relaunch; the backward per output
tensor within ``1e-4 * max|plain|`` of the float64 plain walk, the (u, v)
pairs within 1e-5 of their scale, and a cluster giving the bits of one
block; the contraction within 1e-5 of its scale against the float64 plain
sum. The launchers take the JAX package's widest h (724 forward, 572
backward) and refuse the next. Skips where no g++ is on the PATH.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from py_psnode_tpu_torch.ops import fused_channelwise as FC
from py_psnode_tpu_torch.ops import fused_channelwise_vjp as VC
from py_psnode_tpu_torch.ops import fused_dae as F
from py_psnode_tpu_torch.ops import fused_dae_vjp as V
from py_psnode_tpu_torch.utils import host_build
from py_psnode_tpu_torch.utils.cw_inputs import seeded_inputs
from py_psnode_tpu_torch.utils.noencode_inputs import dae_inputs


def need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")


def flat(g_s, g_w, g_x0):
    return [g_s["fz"], g_s["s_constV"], g_x0] + FC.flatten_weights(g_w)


# (B, Tm1, h, xd, zd, solver, cluster); cluster 0: the launcher's choice (4
# at h=136: one 128 x 128 output block a rank); B=2 in the backward's
# cases
@pytest.mark.parametrize("B,Tm1,h,xd,zd,solver,cluster", [(1, 2, 136, 2, 2, "rk4", 0),
                                                          (1, 3, 145, 3, 1, "midpoint", 2),
                                                          (1, 2, 136, 3, 1, "euler", 1)])
def test_host_wide_forward_matches_plain(B, Tm1, h, xd, zd, solver, cluster):
    need_gxx()
    args = seeded_inputs(B, Tm1, h, xd, zd, seed=h + cluster)
    ref = FC.fused_cw_rollout_plain(*args, solver)
    got = host_build.rollout(*args, solver, cluster=cluster)
    assert torch.all((got - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0))
    assert torch.equal(got, host_build.rollout(*args, solver, cluster=cluster))


# (B, Tm1, h, xd, zd, solver, cluster, other): the backward at `cluster`
# blocks a row, and at `other` for its bits
@pytest.mark.parametrize("B,Tm1,h,xd,zd,solver,cluster,other", [(1, 1, 136, 2, 2, "rk4", 4, 2),
                                                                (2, 1, 145, 3, 1, "midpoint", 2, 1)])
def test_host_wide_backward_matches_float64_walk(B, Tm1, h, xd, zd, solver, cluster, other):
    need_gxx()
    streams, weights, x0, dt = seeded_inputs(B, Tm1, h, xd, zd, seed=h + 10)
    sol = torch.cat([x0[None], FC.fused_cw_rollout_plain(streams, weights, x0, dt, solver)])
    cot = torch.tensor(np.random.default_rng(h).standard_normal(tuple(sol.shape)).astype(np.float32))
    *got, pairs = host_build.rollout_bwd(streams, weights, dt, sol, cot, solver, cluster=cluster)
    *alt, pairs_alt = host_build.rollout_bwd(streams, weights, dt, sol, cot, solver, cluster=other)
    w64 = FC.unflatten_weights([a.double() for a in FC.flatten_weights(weights)])
    ref = VC.fused_cw_rollout_bwd_plain({k: v.double() for k, v in streams.items()}, w64, dt,
                                        sol.double(), cot.double(), solver)
    for k, (g, g1, r) in enumerate(zip(flat(*got), flat(*alt), flat(*ref))):
        assert r.abs().max() > 0, k
        assert (g.double() - r).abs().max() <= 1e-4 * r.abs().max(), k
        # the ranks of a cluster deal out each product's blocks, not their sums
        assert torch.equal(g, g1), k
    assert torch.equal(pairs, pairs_alt)
    plain_pairs = VC.channel_pairs_plain(streams, weights, dt, sol, cot, solver)
    assert (pairs - plain_pairs).abs().max() <= 1e-5 * plain_pairs.abs().max()


@pytest.mark.parametrize("rows,xd,h", [(5, 3, 145), (1, 2, 572)])
def test_host_wide_contraction_matches_plain(rows, xd, h):
    need_gxx()
    pairs = torch.tensor(np.random.default_rng(rows).standard_normal((rows, 4, 2, xd, h)).astype(np.float32))
    for g, r in zip(host_build.contract_pairs(pairs), VC.contract_channel_pairs_plain(pairs.double())):
        assert g.shape == r.shape
        assert (g.double() - r).abs().max() <= 1e-5 * r.abs().max()


def test_host_launchers_take_the_jax_packages_widest_h():
    need_gxx()
    fwd, _, scratch_floats = FC.bind_rollout(host_build.load("fused_cw_rollout"))
    walk, _, contract, _ = VC.bind_rollout_bwd(host_build.load("fused_cw_rollout_bwd"))
    w = (ctypes.c_void_p * 15)()
    # a forward of no step checks its arguments and launches nothing
    for h, rc in ((724, 0), (725, 1)):
        assert fwd(None, None, None, None, w, None, None, 0, 1, h, 2, 2, 0, 0, None) == rc, h
    assert scratch_floats(3, 724) == 3 * 2 * 768 * 768 and scratch_floats(3, 128) == 0
    assert walk(*[None] * 5, w, w, *[None] * 8, 1, 1, 573, 2, 2, 0, 0, None) == 1
    assert contract(None, 1, 573, 2, None, None, None) == 1


def test_host_schedulers_give_the_same_bits():
    """The fibers' run of a channel-wise forward (a cluster of two blocks,
    RK4) and of a no-encode DAE backward against one OS thread a CUDA
    thread (``psn_host_os_threads``), bit for bit: the code between
    barriers runs in a fixed order under the fibers, in any order under
    OS threads."""
    need_gxx()
    cw = seeded_inputs(1, 1, 40, 2, 2, seed=5)
    args = dae_inputs(1, 2, 19, 3, 2, seed=19)
    packed = F.fused_dae_rollout_packed_plain(*args, "euler")
    cot = torch.tensor(np.random.default_rng(6).standard_normal((3, 1, 5)).astype(np.float32))

    def run():
        fwd = host_build.rollout(*cw, "rk4", cluster=2)
        (g_s, g_w, g_x0, g_i0), _ = host_build.dae_rollout_bwd(*args, packed, cot, "euler")
        return [fwd, *g_s.values(), g_x0, g_i0] + V.flatten_weights(g_w)[0]

    fibers = run()
    libs = [host_build.load(n) for n in ("fused_cw_rollout", "fused_dae_rollout_bwd")]
    for lib in libs:
        lib.psn_host_os_threads(1)
    try:
        threads = run()
    finally:
        for lib in libs:
            lib.psn_host_os_threads(0)
    assert len(fibers) == len(threads) > 3
    for k, (a, b) in enumerate(zip(fibers, threads)):
        assert torch.isfinite(a).all(), k
        assert torch.equal(a, b), k
