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

Built with ``-DNE_PHASE_CLOCK``, the no-encode backward walks
(``csrc/fused_dae_rollout_bwd.cu``, ``csrc/fused_ode_rollout_bwd.cu``) mark
the phases of the middle step of batch row 0 the same way:

    python -m py_psnode_tpu_torch.utils.phase_clock noencode [B Tm1 solver]

(defaults 64 100 rk4: the training batch and solver, h=128, the motor DAE's
xd=3, id=2 and the AVR ODE's xd=2) prints ``[ne-split]``: each family's
cycles per phase of that step of the walk, beside the times by CUDA events
of the whole backward and of each of its three kernels (the recompute, the
walk, the contraction) launched alone, and ``[ne-slots]``: the walk's time
with 0, 1, ... of its hidden weights resident in shared memory, the rest
read from L2 (the launcher keeps the DE's: all of the ODE's, two of the
DAE's four).
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


# the phases between consecutive marks of a step of a no-encode backward walk
NE_PHASES = {
    "dae": ("AE_next VJP", "DE stages VJP", "event route"),
    "ode": ("stages VJP",),
}
NE_KERNELS = ((1, "recompute"), (2, "walk"), (4, "contraction"))


def build(name: str, define: str = "CW_PHASE_CLOCK") -> ctypes.CDLL:
    """``csrc/<name>.cu`` built anew with the phase clock ``-D<define>``, loaded."""
    out = BUILD_DIR / "phase_clock" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [find_nvcc(), *NVCC_FLAGS, f"-D{define}", "-o", str(out), str(SOURCE_DIR / f"{name}.cu")]
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


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def ms_per_launch(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def noencode(B: int, Tm1: int, solver: str) -> int:
    """The ``[ne-split]`` of both no-encode backward kernels."""
    from py_psnode_tpu_torch.ops import fused_dae as F
    from py_psnode_tpu_torch.ops import fused_dae_vjp as V
    from py_psnode_tpu_torch.ops import fused_ode as FO
    from py_psnode_tpu_torch.ops import fused_ode_vjp as VO
    from py_psnode_tpu_torch.utils.noencode_inputs import dae_inputs, ode_inputs

    print(f"[ne-split] card: {card()}", flush=True)
    names = ("fused_dae_rollout_bwd", "fused_ode_rollout_bwd")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = dict(zip(names, pool.map(lambda n: build(n, "NE_PHASE_CLOCK"), names)))
    cuda = lambda tree: (tree.cuda() if isinstance(tree, torch.Tensor) else
                         {k: cuda(v) for k, v in tree.items()} if isinstance(tree, dict) else
                         [tuple(cuda(a) for a in pair) for pair in tree])
    args = [cuda(a) for a in dae_inputs(B, Tm1, 128)]
    packed = F.fused_dae_rollout_packed(*args, solver)
    cot = torch.full((Tm1 + 1, B, 5), 0.01, device="cuda")
    dae = V.bind_rollout_bwd(libs[names[0]])
    dae_bufs = V._launch_bwd(*args, packed, cot, solver, dae)[1]
    runs = [("dae", libs[names[0]], 3,
             lambda st, slots=-1: V._launch_bwd(*args, packed, cot, solver, dae, st, dae_bufs, slots=slots))]
    s_de, weights, x0, dt = [cuda(a) for a in ode_inputs(B, Tm1, 128)]
    sol = torch.cat([x0[None], FO.fused_ode_rollout(s_de, weights, x0, dt, solver)])
    ode_cot = torch.full_like(sol, 0.01)
    ode = VO.bind_rollout_bwd(libs[names[1]])
    ode_bufs = VO._launch_bwd(s_de, weights, dt, sol, ode_cot, solver, ode)[1]
    runs.append(("ode", libs[names[1]], 2,
                 lambda st, slots=-1: VO._launch_bwd(s_de, weights, dt, sol, ode_cot, solver, ode, st, ode_bufs,
                                                     slots=slots)))
    for family, lib, most, launch in runs:
        ms = ms_per_launch(lambda: launch(7))
        marks = (ctypes.c_longlong * 16)()
        rc = lib.psn_ne_phase_clock(marks)
        if rc != 0:
            raise RuntimeError(f"reading the phase clock failed: CUDA error {rc}")
        got = [marks[i + 1] - marks[i] for i in range(len(NE_PHASES[family]))]
        total = sum(got)
        alone = ", ".join(f"{name} {ms_per_launch(lambda: launch(bit)):.3f} ms" for bit, name in NE_KERNELS)
        print(f"[ne-split] {family} backward B={B} T-1={Tm1} h=128 {solver}: {ms:.3f} ms a launch ({alone}); "
              f"the walk's step {Tm1 // 2} of row 0: {total} cycles; "
              + ", ".join(f"{n} {c} ({c / total:.0%})" for n, c in zip(NE_PHASES[family], got)), flush=True)
        # the walk with fewer of its hidden weights resident in shared memory
        # (the rest read from L2): the evidence for the launcher's placement
        sweep = ", ".join(f"{q} {ms_per_launch(lambda: launch(2, q)):.3f} ms" for q in range(most + 1))
        print(f"[ne-slots] {family} walk B={B} T-1={Tm1} {solver}, by resident weights: {sweep}", flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "noencode":
        rest = argv[1:]
        return noencode(int(rest[0]) if rest else 64, int(rest[1]) if len(rest) > 1 else 100,
                        rest[2] if len(rest) > 2 else "rk4")
    B, Tm1, xd, zd = map(int, argv) if argv else (64, 100, 2, 2)
    h = FC.MAX_HIDDEN
    print(f"[cw-split] card: {card()}", flush=True)
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
