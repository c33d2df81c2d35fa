"""The no-encode DAE backward (kernel 2), built for the host, at the two
widest DAE cases: the wide kernels (padded width 256: two 128-wide chunks of
every layer), against the float64 plain walk per output tensor within
``1e-4 * max|plain|``, bit-identical on relaunch (the card's tolerance,
``tests/test_torch_kernel.py``). The other backward cases are in
``test_torch_noencode_host.py``: the two take most of that file's time, and
a file of their own lets another worker of the suite run them. Skips where
no g++ is on the PATH.
"""

import shutil

import pytest

from py_psnode_tpu_torch.utils import host_build


def need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")


# (B, Tm1, h, solver): h=136 and 200, the wide kernels; dae_inputs puts
# events in the walk's first step of row 0 and in step Tm1 // 3 of row 1
DAE_CASES = [(2, 3, 136, "rk4"), (1, 3, 200, "midpoint")]


@pytest.mark.parametrize("B,Tm1,h,solver", DAE_CASES)
def test_host_dae_backward_matches_float64_walk(B, Tm1, h, solver):
    need_gxx()
    got = host_build.noencode_bwd_check("dae", B, Tm1, h, solver)
    assert got["worst"] <= 1e-4, got
    assert got["identical"] == 1.0
