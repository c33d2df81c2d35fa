"""The no-encode forward pair's own sources (kernels 1 and 3), built for the
host, against their plain PyTorch versions on the CPU: the DAE and ODE
forwards at the motor, AVR and direct-encode shapes, at one row a block and
in tiles of 2-8 rows, and kernel 1's TF-x mode (teacher forcing of x) on
seeded true states.

``py_psnode_tpu_torch.utils.host_build`` compiles
``csrc/fused_{dae,ode}_rollout.cu`` (with ``csrc/noencode_bwd.cuh``) with
g++ against a host model of the CUDA subset and of the Hopper instructions
they use, on NaN-poisoned shared memory and buffers. The card's tolerance
(``tests/test_torch_kernel.py``): within ``1e-4 * max(1, |plain|)`` per
element, bit-identical on relaunch. The weight placements and the widths
beyond shared memory are in ``test_torch_noencode_host_fwd_wide.py``, the
backward pair in ``test_torch_noencode_host.py``: three files, so that the
suite's workers build and run them at once. Skips where no g++ is on the
PATH.
"""

import shutil

import pytest

from py_psnode_tpu_torch.utils import host_build


def need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")


# (B, Tm1, h, solver, rows a block): one row and three; h=19 (rows not
# 16-byte aligned), 40 and 136 (two 128-wide chunks, weights from L2); each
# solver; one row a block (the folded readout) and tiles of 2, 4 and 8 rows
# (the tile path, rows past the batch among them); dae_inputs puts events
# in rows 1 and 3 (modulo B) at step 2 and in row 0 at the last step
DAE_FWD_CASES = [(1, 3, 19, "euler", None), (3, 4, 40, "rk4", None), (3, 3, 136, "midpoint", None),
                 (3, 4, 40, "midpoint", 2), (3, 3, 19, "rk4", 4), (1, 3, 136, "euler", 8)]


@pytest.mark.parametrize("B,Tm1,h,solver,rows", DAE_FWD_CASES)
def test_host_dae_forward_matches_plain(B, Tm1, h, solver, rows):
    need_gxx()
    got = host_build.noencode_fwd_check("dae", B, Tm1, h, solver, rows)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0


# (B, Tm1, h, solver, rows a block): the direct-encode DAE's latent shape,
# xd = id = h with one tail layer a net (the DE's first layer 2h wide, both
# readouts h wide: nothing folds), at h=16 in a tile of two rows and at
# h=136 (the first layer three 128-wide chunks) with one row a block
DAE_ENCODE_FWD_CASES = [(2, 3, 16, "rk4", 2), (1, 3, 136, "midpoint", None)]


@pytest.mark.parametrize("B,Tm1,h,solver,rows", DAE_ENCODE_FWD_CASES)
def test_host_dae_forward_matches_plain_at_the_encode_shape(B, Tm1, h, solver, rows):
    need_gxx()
    got = host_build.noencode_fwd_check("dae", B, Tm1, h, solver, rows, xd=h, n_tail=1, idim=h)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0


# (B, Tm1, h, xd, n_tail, solver, rows a block): the AVR no-encode shape
# and the direct-encode latent shape (xd = h, one tail layer: the wide
# first layer and readout), as above
ODE_FWD_CASES = [(1, 3, 19, 2, 3, "midpoint", None), (3, 4, 40, 2, 3, "rk4", None),
                 (3, 3, 136, 2, 3, "euler", None), (3, 4, 40, 2, 3, "rk4", 8),
                 (3, 3, 40, 40, 1, "rk4", None), (2, 3, 19, 19, 1, "euler", 2),
                 (2, 3, 40, 2, 3, "euler", None)]


@pytest.mark.parametrize("B,Tm1,h,xd,n_tail,solver,rows", ODE_FWD_CASES)
def test_host_ode_forward_matches_plain(B, Tm1, h, xd, n_tail, solver, rows):
    need_gxx()
    got = host_build.noencode_fwd_check("ode", B, Tm1, h, solver, rows, xd, n_tail)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0


# The TF-x mode (teacher forcing of x, seeded true states, the events of
# dae_inputs). (B, Tm1, h, solver, rows a block, shape): the motor shape at
# h=16 with one row a block (the tile path: TF-x never folds) and at h=136
# (two 128-wide chunks) in tiles of two rows, and the direct-encode latent
# shape xd = id = h with one tail layer
ENCODE = dict(xd=16, n_tail=1, idim=16)
DAE_TFX_FWD_CASES = [(3, 4, 16, "rk4", None, {}), (3, 3, 136, "midpoint", 2, {}), (2, 3, 16, "euler", None, ENCODE)]


@pytest.mark.parametrize("B,Tm1,h,solver,rows,shape", DAE_TFX_FWD_CASES)
def test_host_dae_tfx_forward_matches_plain(B, Tm1, h, solver, rows, shape):
    need_gxx()
    got = host_build.noencode_fwd_check("dae", B, Tm1, h, solver, rows, tfx=True, **shape)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0
