"""Where the channel-wise kernels' time goes, by ``clock64()`` marks.

Built with ``-DCW_PHASE_CLOCK``, ``csrc/cw_tile.cuh`` has thread 0 of block
0 (the lead block of batch row 0) note ``clock64()`` at each phase boundary
of an evaluation in the middle step (marks 0-9) and of a stage's VJP in the
backward (marks 16-26). This developer tool builds both channel-wise
sources so into ``_build/phase_clock/``, apart from the builds the port
uses (which never carry the clock), launches each on seeded inputs (h=128,
Euler) with one block a row and with the launcher's choice, and prints the
cycles of each phase:

    python -m py_psnode_tpu_torch.utils.phase_clock [B Tm1 xd zd]

The defaults, 64 100 2 2, are the AVR ODE channel-wise shape at its
training batch; 64 100 3 1 is the motor DAE's. It needs the card and nvcc.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import subprocess
import sys
from typing import List

import torch

from py_psnode_tpu_torch.ops import fused_channelwise as FC
from py_psnode_tpu_torch.ops import fused_channelwise_vjp as VC
from py_psnode_tpu_torch.utils.cuda_build import BUILD_DIR, NVCC_FLAGS, SOURCE_DIR, find_nvcc
from py_psnode_tpu_torch.utils.cw_inputs import seeded_inputs

# the phases between consecutive marks of an evaluation (marks 0-9) and of
# a stage's VJP in the backward (marks 16-26)
PHASES = ("ext layer 0", "ext layer 1", "first layer", "a0 store", "W1 product", "W2 product",
          "readout", "head layer 0", "head layer 1")
BWD_PHASES = ("the evaluation again", "head cotangents", "W3's grads and g_P2", "dW2 product",
              "g_P1 product", "a0 again", "dW1 product", "g_P0 product", "a's grads and gft",
              "ext cotangents and pairs")


def build(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built anew with the phase clock, loaded."""
    out = BUILD_DIR / "phase_clock" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-DCW_PHASE_CLOCK", "-o", str(out), str(SOURCE_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu with the phase clock:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(out))


def cycles(lib: ctypes.CDLL, backward: bool) -> List[int]:
    """The cycles of each of :data:`PHASES` (or, with ``backward``,
    :data:`BWD_PHASES`) in the last launch of ``lib``; synchronises the
    device."""
    marks = (ctypes.c_longlong * 32)()
    rc = lib.psn_cw_phase_clock(marks)
    if rc != 0:
        raise RuntimeError(f"reading the phase clock failed: CUDA error {rc}")
    first, n = (16, len(BWD_PHASES)) if backward else (0, len(PHASES))
    return [marks[first + i + 1] - marks[first + i] for i in range(n)]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    B, Tm1, xd, zd = map(int, argv) if argv else (64, 100, 2, 2)
    h = FC.MAX_HIDDEN
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[cw-split] card: {smi}", flush=True)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fwd_lib, bwd_lib = pool.map(build, ("fused_cw_rollout", "fused_cw_rollout_bwd"))
    fwd, bwd = FC.bind_rollout(fwd_lib), VC.bind_rollout_bwd(bwd_lib)
    choose = fwd_lib.psn_fused_cw_cluster
    choose.argtypes = [ctypes.c_int] * 4
    streams, weights, x0, dt = seeded_inputs(B, Tm1, h, xd, zd)
    streams = {k: v.cuda() for k, v in streams.items()}
    weights = FC.unflatten_weights([a.cuda() for a in FC.flatten_weights(weights)])
    x0, dt = x0.cuda(), dt.cuda()
    sol = torch.cat([x0[None], FC._launch(streams, weights, x0, dt, "euler", 0, fwd)])
    cot = torch.full_like(sol, 0.01)
    for cluster in (1, 0):
        how = "one block a row" if cluster == 1 else f"the launcher's choice ({choose(B, h, xd, zd)} a row)"
        FC._launch(streams, weights, x0, dt, "euler", cluster, fwd)
        splits = [("kernel 5, an evaluation", PHASES, cycles(fwd_lib, False))]
        VC._launch_bwd(streams, weights, dt, sol, cot, "euler", cluster, bwd)
        splits.append(("kernel 6, a stage's VJP", BWD_PHASES, cycles(bwd_lib, True)))
        for kernel, names, got in splits:
            total = sum(got)
            print(f"[cw-split] xd={xd} zd={zd} {kernel}, B={B} T-1={Tm1} h={h} euler, {how}: {total} cycles; "
                  + ", ".join(f"{name} {c} ({c / total:.0%})" for name, c in zip(names, got)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
