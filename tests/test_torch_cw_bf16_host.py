"""The bf16 compute mode of the channel-wise kernels (5-6) and of the TF-x
rollout (kernels 1-2), their own sources built for the host, against their
plain bf16 PyTorch versions on the CPU.

``py_psnode_tpu_torch.utils.host_build`` compiles the sources with g++
against a host model of the CUDA subset (the bf16 builds with
``-DPSN_BF16`` where a source builds that mode apart).
``host_build.cw_bf16_check`` runs kernel 5, kernel 6 (the walk and the
contraction) or the contraction alone in the bf16 mode on seeded inputs
rounded by ``cast_cw``; ``host_build.bf16_check`` kernels 1-2 in their TF-x
mode on seeded true states (the backward with the true states'
cotangents). Every output tensor is held by the discrimination bar of
``test_torch_bf16_host.py``: rel-L2(kernel - plain bf16) at most 0.1 x
rel-L2(plain bf16 - plain float32). A channel-wise step rounds thousands
of values, and the summation orders of the kernel and the plain version
flip one now and then, carried over the rollout: where a tensor lies above
the bar, every tensor is held to max(0.25, 2 x its floor) instead (the same
ratio of the plain bf16 version in float64 arithmetic between the same
rounding points; ``host_build.bf16_excess``, the rule of ``chip_smoke.py``
phases 21 and 23). Kernels 1-2's TF-x mode restarts x from the true
states at every step and carries no flip of x: each of its tensors lies
within the bar of the plain bf16 version in float32 arithmetic or of the
same version in float64 arithmetic (at h=136 the float32 plain forward's
own sums flip roundings that the kernel and the float64 version do not:
0.134 against the one, 4.4e-5 against the other, RK4). A relaunch must give the
same bits. Narrow h=16 at every cluster size and the wide layout at h=136
(kernels 5-6 and the contraction); kernels 1-2's TF-x mode at one row a
block, a tile of rows, h=136 (the forward's 128-wide chunks), and the
backward's wide kernels (the direct-encode shape, padded width 256).
Skips where no g++ is on the PATH.
"""

import shutil

import pytest

from py_psnode_tpu_torch.utils import host_build


def need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")


# (kind, B, Tm1, h, xd, zd, solver, cluster): the narrow layout at the AVR
# ODE's channels and the motor DAE's with each cluster size, then the wide
# layout (h=136: two 128-wide blocks)
CW_CASES = [("fwd", 2, 3, 16, 2, 2, "rk4", 0), ("fwd", 2, 3, 16, 3, 1, "midpoint", 2),
            ("bwd", 2, 3, 16, 2, 2, "rk4", 0), ("bwd", 2, 3, 16, 3, 1, "euler", 4),
            ("contract", 3, 5, 16, 2, 1, "euler", 0),
            ("fwd", 2, 2, 136, 2, 2, "euler", 0), ("bwd", 2, 2, 136, 3, 1, "euler", 0),
            ("contract", 3, 5, 136, 2, 1, "euler", 0)]


@pytest.mark.parametrize("kind,B,Tm1,h,xd,zd,solver,cluster", CW_CASES)
def test_host_cw_bf16(kind, B, Tm1, h, xd, zd, solver, cluster):
    need_gxx()
    got = host_build.cw_bf16_check(kind, B, Tm1, h, xd, zd, solver, cluster)
    assert got["excess"] <= 1.0, got
    assert got["identical"] == 1.0, got
    if kind == "contract":  # the same products of the same rounded operands
        assert got["worst"] <= 1e-5, got


# (kind, B, Tm1, h, solver, rows, shape): the motor shape at one row a block,
# in a tile of 2 rows and at h=136 (the forward's 128-wide chunks); the backward at the motor shape and at the
# direct-encode latent shape (xd = id = h = 70, one tail layer: padded width
# 256, the wide recompute and walk)
TFX_CASES = [("fwd", 2, 3, 40, "rk4", None, {}), ("fwd", 2, 3, 19, "euler", 2, {}), ("fwd", 3, 9, 136, "rk4", None, {}),
             ("bwd", 2, 3, 40, "rk4", None, {}), ("bwd", 2, 2, 70, "euler", None, dict(xd=70, idim=70, n_tail=1))]


@pytest.mark.parametrize("kind,B,Tm1,h,solver,rows,shape", TFX_CASES)
def test_host_dae_tfx_bf16(kind, B, Tm1, h, solver, rows, shape):
    need_gxx()
    got = host_build.bf16_check("dae", kind, B, Tm1, h, solver, rows, tfx=True, **shape)
    assert min(got["ratio"], got["exact"]) <= host_build.BF16_BAR, got
    assert got["identical"] == 1.0, got
