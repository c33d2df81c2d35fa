"""Where the channel-wise kernels' time goes, by ``clock64()`` marks.

Built with ``-DCW_PHASE_CLOCK``, ``csrc/cw_tile.cuh`` has thread 0 of block
0 (the lead block of batch row 0) note ``clock64()`` at each phase boundary
of an evaluation in the middle step (marks 0-9) and of a stage's VJP in the
backward (marks 16-26). This developer tool builds both channel-wise
sources so into ``_build/phase_clock/``, apart from the builds the port
uses (which never carry the clock), launches each on seeded inputs (h=128 unless given,
Euler) with one block a row and with the launcher's choice, and prints the
cycles of each phase:

    python -m py_psnode_tpu_torch.utils.phase_clock [B Tm1 xd zd [h]]

The defaults, 64 100 2 2 (h=128), are the AVR ODE channel-wise shape at its
training batch; 64 100 3 1 is the motor DAE's. Above h=128 the wide kernels
mark the same phases (``csrc/cw_wide.cuh``: there "first layer" is the wait
for the tile, "a0 store" the first layer with its store). It needs the card
and nvcc.

Built with ``-DNE_PHASE_CLOCK``, the no-encode backward walks
(``csrc/fused_dae_rollout_bwd.cu``, ``csrc/fused_ode_rollout_bwd.cu``) mark
the phases of the middle step of batch row 0 the same way:

    python -m py_psnode_tpu_torch.utils.phase_clock noencode [B Tm1 solver]

(defaults 64 100 rk4: the training batch and solver, h=128, the motor DAE's
xd=3, id=2 and the AVR ODE's xd=2) prints, for the forward kernels
(``csrc/fused_{dae,ode}_rollout.cu``), ``[ne-fwd-split]``: the cycles of
the middle step of row 0 by phase (the step's loads, the AE at the event,
each stage's first layer, hidden layers and readout, the stage updates, the
AE at t+1, the solution's write), ``[ne-fwd-slots]``: the forward's
time by where its hidden weights sit (registers, shared memory, or L1 and
L2; each placement a build with ``-DNE_FWD_REGS`` and ``-DNE_FWD_SLOTS``),
and ``[ne-fwd-fold]``: by the warps that fold a readout
(``-DNE_FWD_FOLD_WARPS``); then, for the backward walks, ``[ne-split]``:
each family's
cycles per phase of that step of the walk, beside the times by CUDA events
of the whole backward and of each of its three kernels (the recompute, the
walk, the contraction) launched alone, and ``[ne-slots]``: the walk's time
with 0, 1, ... of its hidden weights resident in shared memory, the rest
read from L2 (the launcher keeps the DE's: all of the ODE's, two of the
DAE's four).

Three comparisons across checkouts, for a change's effect on one card:

    python -m py_psnode_tpu_torch.utils.phase_clock sass-ab OTHER_CSRC

builds the four no-encode sources and the two channel-wise ones from
``OTHER_CSRC`` and from this checkout (no card needed, only nvcc) and says
of each kernel of the other
build whether this build has one of the same SASS (``[ne-sass-ab]``): a
kernel template that gained a trailing ``bool`` (the bf16 mode's
``kBf16``), or a kernel that became a template of one, is matched at
``false``, ``pack_nets`` at ``pack_nets<float>``; a source whose bf16 mode
builds apart (``cuda_build.SPLIT_BF16``) counts both its builds.

    python -m py_psnode_tpu_torch.utils.phase_clock bwd-ab OTHER_CSRC [B Tm1]

builds both no-encode backward sources from ``OTHER_CSRC`` (another
checkout's ``py_psnode_tpu_torch/csrc``; its C interface must be this
one's) and from this checkout, times each whole backward and its three
kernels at B=64 for each solver in the order other, this, this, other
(``[ne-bwd-ab]``), and says of each kernel whether its SASS
(``cuobjdump -sass``, resource lines and constant-bank offsets left out)
is the same in both builds. And

    python -m py_psnode_tpu_torch.utils.phase_clock calls [CHECKOUT ...]

prints ``[ne-fwd-calls]`` for the package of each checkout in turn (a
process each, this file's code on that checkout's package; none given:
this one): the host's milliseconds a call of each
no-encode forward wrapper takes on seeded inputs (B=32, T-1=1000, Euler),
beside the card's, and, on the motor checkpoint 200 and its test set, the
milliseconds of the ``--testing --fused`` forward (``fused_dae_apply`` at
B=32, Euler, synchronised) and of a fused training step (B=64, RK4).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Sequence

import torch

from py_psnode_tpu_torch.ops import fused_channelwise as FC
from py_psnode_tpu_torch.ops import fused_channelwise_vjp as VC
from py_psnode_tpu_torch.utils.cuda_build import BF16_DEFINE, BUILD_DIR, NVCC_FLAGS, SOURCE_DIR, find_nvcc, library_path
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
# (registers, shared-memory slots) of the forward sweep: the DAE's four
# hidden weights (two DE, two AE), the ODE's two
NE_FWD_PLACES = {"dae": ((0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2), (1, 3)),
                 "ode": ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0))}
NE_FWD_FOLDS = (1, 2, 4, 8, 16)  # folding warps of the forward sweep
# the phases the no-encode forward kernels mark (csrc/fused_{dae,ode}_rollout.cu)
NE_FWD_PHASES = (("step loads", "AE at the event")
                 + tuple(f"stage {q + 1} {p}" for q in range(4) for p in ("first layer", "hidden layers", "readout"))
                 + ("stage updates", "AE at t+1", "solution write"))


def build(name: str, define: str = "CW_PHASE_CLOCK", extra: Sequence[str] = (),
          source_dir: pathlib.Path = SOURCE_DIR) -> ctypes.CDLL:
    """``csrc/<name>.cu`` (of ``source_dir``) built with ``-D`` of
    ``define`` (none when empty: the port's build) and of each of ``extra``,
    loaded; a build of the same sources and defines is reused."""
    defines = ([define] if define else []) + list(extra)
    tag = "".join(f"-{d}" for d in defines)
    if source_dir != SOURCE_DIR:
        tag += "-" + re.sub(r"\W", "_", str(source_dir))
    out = BUILD_DIR / "phase_clock" / f"{library_path(name).stem}{tag}.so"
    if not out.exists() or source_dir != SOURCE_DIR:
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [find_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(out),
               str(source_dir / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu with {defines}:\n{res.stdout}{res.stderr}")
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


def fwd_cycles(lib: ctypes.CDLL) -> List[int]:
    """The cycles of each of :data:`NE_FWD_PHASES` in the middle step of
    the last launch of a forward built with the phase clock; synchronises
    the device."""
    marks, bins, n = (ctypes.c_longlong * 64)(), (ctypes.c_int * 64)(), ctypes.c_int()
    rc = lib.psn_ne_fwd_clock(marks, bins, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"reading the phase clock failed: CUDA error {rc}")
    got = [0] * len(NE_FWD_PHASES)
    for i in range(1, n.value):
        got[bins[i]] += marks[i] - marks[i - 1]
    return got


def noencode_fwd(B: int, Tm1: int, solver: str, cuda) -> None:
    """The ``[ne-fwd-split]`` of both no-encode forward kernels, then their
    ``[ne-fwd-slots]`` and ``[ne-fwd-fold]`` sweeps (a build each)."""
    from py_psnode_tpu_torch.ops import fused_dae as F
    from py_psnode_tpu_torch.ops import fused_ode as FO
    from py_psnode_tpu_torch.utils.noencode_inputs import dae_inputs, ode_inputs

    names = {"dae": "fused_dae_rollout", "ode": "fused_ode_rollout"}
    # the clock's builds, then every placement and fold of the sweeps
    jobs = [(f, "NE_PHASE_CLOCK", ()) for f in names]
    jobs += [(f, "", (f"NE_FWD_REGS={r}", f"NE_FWD_SLOTS={q}")) for f in names for r, q in NE_FWD_PLACES[f]]
    jobs += [(f, "", (f"NE_FWD_FOLD_WARPS={w}",)) for f in names for w in NE_FWD_FOLDS]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: build(names[j[0]], j[1], j[2]), jobs)))
    dae_args = [cuda(a) for a in dae_inputs(B, Tm1, 128)]
    ode_args = [cuda(a) for a in ode_inputs(B, Tm1, 128)]
    launchers = {"dae": lambda lib: F._launch(*dae_args, solver, None, F.bind_rollout(lib)),
                 "ode": lambda lib: FO._launch(*ode_args, solver, None, FO.bind_rollout(lib))}
    for family, launch in launchers.items():
        lib = libs[(family, "NE_PHASE_CLOCK", ())]
        ms = ms_per_launch(lambda: launch(lib))
        got = fwd_cycles(lib)
        total = sum(got)
        print(f"[ne-fwd-split] {family} forward B={B} T-1={Tm1} h=128 {solver}: {ms:.3f} ms a launch; "
              f"step {Tm1 // 2} of row 0: {total} cycles; "
              + ", ".join(f"{n} {c} ({c / total:.0%})" for n, c in zip(NE_FWD_PHASES, got) if c), flush=True)
        # the hidden weights in registers, in shared memory or through L1 and
        # L2, and the warps that fold a readout: the evidence for the
        # launchers' choice (the DAE's registers 1 and shared memory 3, the
        # ODE's registers 2, each solver; 4 warps)
        sweep = ", ".join(
            f"regs {r} smem {q} "
            f"{ms_per_launch(lambda: launch(libs[(family, '', (f'NE_FWD_REGS={r}', f'NE_FWD_SLOTS={q}'))])):.3f} ms"
            for r, q in NE_FWD_PLACES[family])
        print(f"[ne-fwd-slots] {family} forward B={B} T-1={Tm1} {solver}, by where the hidden weights sit: {sweep}",
              flush=True)
        sweep = ", ".join(f"{w} {ms_per_launch(lambda: launch(libs[(family, '', (f'NE_FWD_FOLD_WARPS={w}',))])):.3f} ms"
                          for w in NE_FWD_FOLDS)
        print(f"[ne-fwd-fold] {family} forward B={B} T-1={Tm1} {solver}, by warps that fold: {sweep}", flush=True)


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
    noencode_fwd(B, Tm1, solver, cuda)
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


def sass(lib: pathlib.Path, demangle: bool = False) -> Dict[str, str]:
    """Each kernel's SASS in ``lib`` (``cuobjdump -sass``), without the
    lines and operands that name resources or constant-bank offsets (a
    change of a kernel's parameter block moves those alone), by name with
    the build's own anonymous-namespace tag left out (``demangle``: by its
    demangled name, ``cu++filt``)."""
    text = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    if demangle:
        filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
        text = subprocess.run([filt], input=text, capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (.+?)\s*$", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?_cu)_[0-9a-f]{8}", r"_GLOBAL__N__\1", m.group(1))
            out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            out[name].append(re.sub(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]", "c[..]", line.split(";")[0]))
    return {k: "\n".join(v) for k, v in out.items()}


def sass_ab(other: pathlib.Path) -> int:
    """``[ne-sass-ab]``: the four no-encode sources and the two
    channel-wise ones built from ``other`` and from this checkout; of each
    kernel of the other build, whether this build has one of the same SASS.
    Returns 0 when every one has."""
    names = ("fused_dae_rollout", "fused_dae_rollout_bwd", "fused_ode_rollout", "fused_ode_rollout_bwd",
             "fused_cw_rollout", "fused_cw_rollout_bwd")
    # each source's builds: with the bf16 define too where a checkout builds
    # that mode apart (its source reads PSN_BF16)
    modes = lambda n, d: [()] + ([(BF16_DEFINE,)] if BF16_DEFINE in (d / f"{n}.cu").read_text() else [])
    jobs = [(n, d, m) for n in names for d in (other, SOURCE_DIR) for m in modes(n, d)]
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: build(j[0], "", j[2], j[1]), jobs)))
    # a template that gained a trailing bool, and a kernel that became a
    # template of one bool, at false; pack_nets at <float> (cu++filt writes
    # a template's arguments as (bool)0 and its return type)
    norm = lambda n: re.sub(r"^void (.*?)<\(bool\)0>\(", r"\1(", re.sub(
        r"^void (.*)pack_nets<float>", r"\1pack_nets", re.sub(r", \(bool\)0>", ">", n)))

    def kernels(name, d):  # every build of the source, the float32 one's name first
        out = {}
        for m in reversed(modes(name, d)):
            out.update(sass(pathlib.Path(libs[(name, d, m)]._name), demangle=True))
        return out

    differ = 0
    for name in names:
        a, b = kernels(name, other), kernels(name, SOURCE_DIR)
        b_by = {norm(n): text for n, text in b.items()}
        missing, changed, same = [], [], 0
        for n, text in a.items():
            got = b.get(n, b_by.get(n))
            if got is None:
                missing.append(n)
            elif got != text:
                changed.append(n)
            else:
                same += 1
        differ += len(missing) + len(changed)
        print(f"[ne-sass-ab] {name}: {same} of {len(a)} kernels of the other build have the same SASS here"
              + (f"; changed: {changed}" if changed else "") + (f"; not found: {missing}" if missing else "")
              + f"; this build has {len(b)} kernels", flush=True)
    return 1 if differ else 0


def bwd_ab(other: pathlib.Path, B: int, Tm1: int) -> int:
    """``[ne-bwd-ab]``: both no-encode backwards built from ``other`` and
    from this checkout, timed in the order other, this, this, other."""
    from py_psnode_tpu_torch.ops import fused_dae as F
    from py_psnode_tpu_torch.ops import fused_dae_vjp as V
    from py_psnode_tpu_torch.ops import fused_ode as FO
    from py_psnode_tpu_torch.ops import fused_ode_vjp as VO
    from py_psnode_tpu_torch.utils.noencode_inputs import dae_inputs, ode_inputs

    print(f"[ne-bwd-ab] card: {card()}", flush=True)
    names = ("fused_dae_rollout_bwd", "fused_ode_rollout_bwd")
    jobs = [(n, d) for n in names for d in (other, SOURCE_DIR)]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: build(j[0], "", (), j[1]), jobs)))
    for name in names:
        a, b = (sass(pathlib.Path(libs[(name, d)]._name)) for d in (other, SOURCE_DIR))
        same = [k for k in a if a.get(k) == b.get(k)]
        print(f"[ne-bwd-ab] {name}: SASS the same in both builds for {len(same)} of {len(a)} kernels"
              + (f" (differ: {', '.join(k for k in a if k not in same)})" if len(same) < len(a) else ""), flush=True)
    cuda = lambda tree: (tree.cuda() if isinstance(tree, torch.Tensor) else
                         {k: cuda(v) for k, v in tree.items()} if isinstance(tree, dict) else
                         [tuple(cuda(a) for a in pair) for pair in tree])
    dae_args = [cuda(a) for a in dae_inputs(B, Tm1, 128)]
    s_de, weights, x0, dt = [cuda(a) for a in ode_inputs(B, Tm1, 128)]
    for solver in ("euler", "midpoint", "rk4"):
        packed = F.fused_dae_rollout_packed(*dae_args, solver)
        cot = torch.full((Tm1 + 1, B, 5), 0.01, device="cuda")
        sol = torch.cat([x0[None], FO.fused_ode_rollout(s_de, weights, x0, dt, solver)])
        ode_cot = torch.full_like(sol, 0.01)
        runs = {}
        for d in (other, SOURCE_DIR):
            dl = V.bind_rollout_bwd(libs[(names[0], d)])
            ol = VO.bind_rollout_bwd(libs[(names[1], d)])
            db = V._launch_bwd(*dae_args, packed, cot, solver, dl)[1]
            ob = VO._launch_bwd(s_de, weights, dt, sol, ode_cot, solver, ol)[1]
            runs[d] = {"dae": lambda st, dl=dl, db=db: V._launch_bwd(*dae_args, packed, cot, solver, dl, st, db),
                       "ode": lambda st, ol=ol, ob=ob: VO._launch_bwd(s_de, weights, dt, sol, ode_cot, solver, ol,
                                                                       st, ob)}
        for family in ("dae", "ode"):
            for bits, kernel in ((7, "backward"),) + NE_KERNELS:
                got = {other: [], SOURCE_DIR: []}
                for d in (other, SOURCE_DIR, SOURCE_DIR, other):
                    got[d].append(ms_per_launch(lambda: runs[d][family](bits), reps=5))
                print(f"[ne-bwd-ab] {family} {kernel} B={B} T-1={Tm1} {solver}: other "
                      f"{' '.join(f'{v:.4f}' for v in got[other])} ms, this "
                      f"{' '.join(f'{v:.4f}' for v in got[SOURCE_DIR])} ms "
                      f"({statistics.mean(got[SOURCE_DIR]) / statistics.mean(got[other]) - 1:+.2%})", flush=True)
    return 0


def calls(checkouts: Sequence[str] = ()) -> int:
    """``[ne-fwd-calls]``: host and card milliseconds of the no-encode
    forward wrappers' calls, the ``--testing --fused`` forward and a fused
    training step, for the package as imported or, given ``checkouts``, for
    each one's package in turn (this file run in a process whose working
    directory is the checkout, so that its package comes first)."""
    for checkout in checkouts:
        code = f"import runpy, sys; sys.argv = ['phase_clock', 'calls']; runpy.run_path({__file__!r}, run_name='__main__')"
        subprocess.run([sys.executable, "-c", code], cwd=checkout, check=True)
    if checkouts:
        return 0
    import py_psnode_tpu_torch
    from py_psnode_tpu_torch.bridge import load_params
    from py_psnode_tpu_torch.data import DaeSamples
    from py_psnode_tpu_torch.models import DAEModel
    from py_psnode_tpu_torch.ops import fused_dae as F
    from py_psnode_tpu_torch.ops import fused_ode as FO
    from py_psnode_tpu_torch.ops.fused_model import fused_dae_apply
    from py_psnode_tpu_torch.train.checkpoints import load_checkpoint_params
    from py_psnode_tpu_torch.train.losses import dae_no_encode_loss
    from py_psnode_tpu_torch.train.optim import make_optimizer
    from py_psnode_tpu_torch.utils.noencode_inputs import dae_inputs, ode_inputs

    where = pathlib.Path(py_psnode_tpu_torch.__file__).resolve().parents[1]
    print(f"[ne-fwd-calls] package of {where}; card: {card()}", flush=True)
    cuda = lambda tree: (tree.cuda() if isinstance(tree, torch.Tensor) else
                         {k: cuda(v) for k, v in tree.items()} if isinstance(tree, dict) else
                         [tuple(cuda(a) for a in pair) for pair in tree])

    def host_and_card(fn, n=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        return host, ms_per_launch(fn, reps=10)

    dae_args = [cuda(a) for a in dae_inputs(32, 1000, 128)]
    ode_args = [cuda(a) for a in ode_inputs(32, 1000, 128)]
    for family, fn in (("dae", lambda: F.fused_dae_rollout_packed_cuda(*dae_args, "euler")),
                       ("ode", lambda: FO.fused_ode_rollout_cuda(*ode_args, "euler"))):
        host, dev = host_and_card(fn)
        print(f"[ne-fwd-calls] {family} forward wrapper B=32 T-1=1000 euler: host {host:.4f} ms a call, "
              f"card {dev:.4f} ms a call", flush=True)
    bench = pathlib.Path(__file__).resolve().parents[2] / "benchmarks" / "h2h_work_prod_s0"
    ckpt = bench / "ours_dae_motor" / "model_checkpoint.200"
    for data, B, solver in (("testing.npz", 32, "euler"), ("training.npz", 64, "rk4")):
        ds = DaeSamples.load(str(bench / "data_dae_motor" / data), cut_length=1001)
        dims = (ds.x.shape[-1], ds.z.shape[-1], ds.v.shape[-1], ds.i.shape[-1])
        model = DAEModel(*dims, hidden_dim=128, solver=solver, device="meta")
        load_params(model, load_checkpoint_params(ckpt), device=torch.device("cuda"))
        batch = {k: torch.as_tensor(getattr(ds, k)[:B], device="cuda")
                 for k in ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump", "mask")}
        if solver == "euler":
            model.requires_grad_(False)

            def run():
                with torch.no_grad():
                    x, i = fused_dae_apply(model, batch)
                torch.cuda.synchronize()
            what = "--testing --fused forward (fused_dae_apply, synchronised)"
        else:
            opt = make_optimizer(model.parameters(), 5e-3, epochs=1, steps_per_epoch=1)

            def run():
                opt.adam.zero_grad()
                loss, _ = dae_no_encode_loss(fused_dae_apply(model, batch), batch)
                loss.backward()
                opt.step()
                torch.cuda.synchronize()
            what = "fused training step (forward, loss, backward, Adam; synchronised)"
        run()
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"[ne-fwd-calls] motor checkpoint 200, B={B} {solver}: {what} median {statistics.median(walls):.4f} "
              f"ms of 20 (min {min(walls):.4f})", flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "sass-ab":
        return sass_ab(pathlib.Path(argv[1]).resolve())
    if argv and argv[0] == "bwd-ab":
        rest = argv[2:]
        return bwd_ab(pathlib.Path(argv[1]).resolve(), int(rest[0]) if rest else 64,
                      int(rest[1]) if len(rest) > 1 else 1000)
    if argv and argv[0] == "calls":
        return calls(argv[1:])
    if argv and argv[0] == "noencode":
        rest = argv[1:]
        return noencode(int(rest[0]) if rest else 64, int(rest[1]) if len(rest) > 1 else 100,
                        rest[2] if len(rest) > 2 else "rk4")
    B, Tm1, xd, zd, h = (list(map(int, argv)) + [128])[:5] if argv else (64, 100, 2, 2, 128)
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
