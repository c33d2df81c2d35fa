"""The channel-wise CUDA kernels' own sources, built for the host, against
their plain PyTorch versions on the CPU.

``py_psnode_tpu_torch.utils.host_build`` compiles ``csrc/fused_cw_rollout.cu``
and ``csrc/fused_cw_rollout_bwd.cu`` with g++ against a host model of the
CUDA subset and of the Hopper instructions they use (the mma.sync fragment
layout, TF32 rounding, cp.async, the cluster's barrier and shared-memory
map). Small shapes, each cluster size (blocks per batch row), the card's
tolerances (``tests/test_torch_kernel.py``): forward ``1e-4 * max(1,
|plain|)`` per element; backward ``1e-4 * max|plain|`` per tensor against
the float64 plain walk, the (u, v) pairs at 1e-5 of their scale, and a
cluster giving the bits of one block; the contraction at 1e-5 of its scale
against the float64 plain sum. Skips where no g++ is on the PATH.
"""

import shutil

import numpy as np
import pytest
import torch

from py_psnode_tpu_torch.ops import fused_channelwise as FC
from py_psnode_tpu_torch.ops import fused_channelwise_vjp as VC
from py_psnode_tpu_torch.utils import host_build
from py_psnode_tpu_torch.utils.cw_inputs import seeded_inputs


def need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")


def flat(g_s, g_w, g_x0):
    return [g_s["fz"], g_s["s_constV"], g_x0] + FC.flatten_weights(g_w)


# h=19: rows of W not 16-byte aligned (4-byte cp.async) and an odd s_constV
# row (scalar loads)
@pytest.mark.parametrize("cluster,h", [(1, 40), (2, 40), (4, 40), (2, 19)])
def test_host_forward_matches_plain(cluster, h):
    need_gxx()
    args = seeded_inputs(2, 3, h, 3, 1, seed=cluster)
    ref = FC.fused_cw_rollout_plain(*args, "rk4")
    got = host_build.rollout(*args, "rk4", cluster=cluster)
    assert torch.all((got - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0))


@pytest.mark.parametrize("cluster", [2, 4])
def test_host_backward_matches_plain(cluster):
    need_gxx()
    streams, weights, x0, dt = seeded_inputs(2, 2, 16, 2, 2, seed=10 + cluster)
    sol = torch.cat([x0[None], FC.fused_cw_rollout_plain(streams, weights, x0, dt, "midpoint")])
    cot = torch.tensor(np.random.default_rng(cluster).standard_normal(tuple(sol.shape)).astype(np.float32))
    *got, pairs = host_build.rollout_bwd(streams, weights, dt, sol, cot, "midpoint", cluster=cluster)
    *one, pairs_one = host_build.rollout_bwd(streams, weights, dt, sol, cot, "midpoint", cluster=1)
    w64 = FC.unflatten_weights([a.double() for a in FC.flatten_weights(weights)])
    ref = VC.fused_cw_rollout_bwd_plain({k: v.double() for k, v in streams.items()}, w64, dt,
                                        sol.double(), cot.double(), "midpoint")
    for k, (g, g1, r) in enumerate(zip(flat(*got), flat(*one), flat(*ref))):
        assert (g.double() - r).abs().max() <= 1e-4 * r.abs().max(), k
        assert torch.equal(g, g1), k
    assert torch.equal(pairs, pairs_one)
    plain_pairs = VC.channel_pairs_plain(streams, weights, dt, sol, cot, "midpoint")
    assert (pairs - plain_pairs).abs().max() <= 1e-5 * plain_pairs.abs().max()


def test_host_contraction_matches_plain():
    need_gxx()
    pairs = torch.tensor(np.random.default_rng(3).standard_normal((100, 4, 2, 3, 40)).astype(np.float32))
    for g, r in zip(host_build.contract_pairs(pairs), VC.contract_channel_pairs_plain(pairs.double())):
        assert g.shape == r.shape
        assert (g.double() - r).abs().max() <= 1e-5 * r.abs().max()
