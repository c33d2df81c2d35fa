"""The bf16 compute mode of the no-encode kernels' own sources (kernels 1-4),
built for the host, against their plain bf16 PyTorch versions on the CPU.

``py_psnode_tpu_torch.utils.host_build`` compiles the sources with g++
against a host model of the CUDA subset (``csrc/host/cuda_bf16.h`` models
``__nv_bfloat16`` and its two conversions, round to nearest even and the
exact widening). ``host_build.bf16_check`` runs a kernel in its bf16 mode on
seeded inputs rounded by ``cast_compute`` / ``cast_ode`` and holds every
output tensor by the discrimination bar: rel-L2(kernel - plain bf16) at
most 0.1 x rel-L2(plain bf16 - plain float32), which shows that the kernel
rounds where the plain version rounds, not merely that it lands near
float32; and a relaunch must give the same bits. Small widths only (h <=
40), one build a kernel (the default one); the card holds the wide cases
(``chip_smoke.py`` phase 21). Skips where no g++ is on the PATH.
"""

import shutil

import pytest

from py_psnode_tpu_torch.utils import host_build


def need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")


def held(got):
    assert got["ratio"] <= host_build.BF16_BAR, got
    assert got["identical"] == 1.0


# (B, Tm1, h, solver, rows, shape): one row a block (the folded readouts),
# a tile of 2 rows at an odd width (rows not 16-byte aligned), and the
# direct-encode latent shape (xd = id = h, one tail layer a net: the wide
# first layer and readout)
DAE_FWD = [(2, 3, 40, "rk4", None, {}), (2, 3, 19, "midpoint", 2, {}),
           (2, 3, 16, "euler", None, dict(xd=16, idim=16, n_tail=1))]


@pytest.mark.parametrize("B,Tm1,h,solver,rows,shape", DAE_FWD)
def test_host_dae_forward_bf16(B, Tm1, h, solver, rows, shape):
    need_gxx()
    held(host_build.bf16_check("dae", "fwd", B, Tm1, h, solver, rows, **shape))


# (B, Tm1, h, xd, n_tail, solver, rows): the AVR shape folded, and the
# direct-encode latent shape (xd = h, one tail layer) in a tile of 2 rows
ODE_FWD = [(2, 3, 40, 2, 3, "rk4", None), (2, 3, 16, 16, 1, "midpoint", 2)]


@pytest.mark.parametrize("B,Tm1,h,xd,n_tail,solver,rows", ODE_FWD)
def test_host_ode_forward_bf16(B, Tm1, h, xd, n_tail, solver, rows):
    need_gxx()
    held(host_build.bf16_check("ode", "fwd", B, Tm1, h, solver, rows, xd=xd, n_tail=n_tail))


# (B, Tm1, h, solver, shape): the motor shape with events (the AE at the
# event's VJP), and the direct-encode latent shape at an odd width
DAE_BWD = [(2, 3, 40, "rk4", {}), (2, 3, 19, "midpoint", dict(xd=19, idim=19, n_tail=1))]


@pytest.mark.parametrize("B,Tm1,h,solver,shape", DAE_BWD)
def test_host_dae_backward_bf16(B, Tm1, h, solver, shape):
    need_gxx()
    held(host_build.bf16_check("dae", "bwd", B, Tm1, h, solver, **shape))


# (B, Tm1, h, xd, n_tail, solver): the AVR shape and the direct-encode
# latent shape at an odd width
ODE_BWD = [(2, 3, 40, 2, 3, "rk4"), (2, 3, 19, 19, 1, "euler")]


@pytest.mark.parametrize("B,Tm1,h,xd,n_tail,solver", ODE_BWD)
def test_host_ode_backward_bf16(B, Tm1, h, xd, n_tail, solver):
    need_gxx()
    held(host_build.bf16_check("ode", "bwd", B, Tm1, h, solver, xd=xd, n_tail=n_tail))
