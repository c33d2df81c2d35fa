"""The no-encode forward pair's own sources (kernels 1 and 3), built for the
host, at the builds and widths that take longest: kernel 1 at each weight
placement (each a build of its own with ``-D``) and both forwards at
widths whose buffers do not fit a block's shared memory (h = 300, 1500 and
3000), against their plain PyTorch versions on the CPU within ``1e-4 *
max(1, |plain|)`` per element, bit-identical on relaunch (the card's
tolerance, ``tests/test_torch_kernel.py``). The other forward cases are in
``test_torch_noencode_host_fwd.py``. Skips where no g++ is on the PATH.
"""

import shutil

import pytest

from py_psnode_tpu_torch.utils import host_build


def need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")


# (regs, slots, fold warps), each a build with -D: every hidden weight from
# L2 with every warp folding; one of the DE's in registers, one in shared
# memory, one warp; the DE's both in shared memory and the AE's first, two
# warps (the placements phase_clock's [ne-fwd-slots] sweep times)
@pytest.mark.parametrize("place", [(0, 0, 16), (1, 1, 1), (0, 3, 2)])
def test_host_dae_forward_at_each_weight_placement(place):
    need_gxx()
    defines = tuple(f"{k}={v}" for k, v in zip(("NE_FWD_REGS", "NE_FWD_SLOTS", "NE_FWD_FOLD_WARPS"), place))
    got = host_build.noencode_fwd_check("dae", 2, 3, 40, "rk4", None, defines=defines)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0


# widths whose buffers do not fit a block's shared memory at the rows asked
# for: the DAE at h=300 with 8 rows a block asked (the kernel takes 4), at
# h=1500 with one row (its buffers in global memory, the folded readout),
# the ODE at h=3000 (likewise)
@pytest.mark.parametrize("family,B,h,solver,rows", [("dae", 9, 300, "rk4", 8), ("dae", 1, 1500, "euler", 1),
                                                    ("ode", 1, 3000, "midpoint", 1)])
def test_host_forward_runs_widths_beyond_shared_memory(family, B, h, solver, rows):
    need_gxx()
    got = host_build.noencode_fwd_check(family, B, 2, h, solver, rows)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0
