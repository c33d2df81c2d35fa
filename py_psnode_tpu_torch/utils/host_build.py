"""Build the port's CUDA kernels for the host and run them on CPU tensors.

A CUDA kernel has no CPU mode, and this package's CPU runs never reach the
kernels. To check a kernel's source before it meets the card, this module
compiles ``csrc/<name>.cu`` with ``g++ -std=c++20`` against a host model of
the CUDA subset it uses (``csrc/host/cuda_host.h``: one OS thread per CUDA
thread, barriers, warp shuffles, clusters run a cluster at a time,
NaN-poisoned shared memory; ``csrc/host/hopper_ops.cuh``: TF32 rounding,
the mma.sync fragment layout, cp.async made at its wait, the cluster
barrier and shared-memory map) and calls its C launchers through ``ctypes``
with CPU pointers. The model runs every block's 512 threads as OS threads
and every mma through a barrier of its warp, so it takes seconds an
evaluation: keep shapes small. It builds the channel-wise pair
(``fused_cw_rollout{,_bwd}.cu``) and the no-encode forward and backward
pairs (``fused_{dae,ode}_rollout{,_bwd}.cu``).

    python -m py_psnode_tpu_torch.utils.host_build fwd|bwd|contract B Tm1 h xd zd solver [cluster]
    python -m py_psnode_tpu_torch.utils.host_build dae-bwd B Tm1 h [xd id n_tail] solver
    python -m py_psnode_tpu_torch.utils.host_build ode-bwd B Tm1 h xd n_tail solver

(every width: above 128 the backward runs its wide kernels; the DAE's
default shape is the motor model's, xd=3, id=2, three tail layers, and
``xd id n_tail`` = ``h h 1`` the direct-encode latent shape)
    python -m py_psnode_tpu_torch.utils.host_build dae-fwd B Tm1 h [xd id n_tail] solver [rows]
    python -m py_psnode_tpu_torch.utils.host_build ode-fwd B Tm1 h xd n_tail solver [rows]

holds the host build against the plain PyTorch version on seeded inputs
(the card tests' kind) and prints the distance; ``dae-fwd-tfx`` and
``dae-bwd-tfx`` (the same arguments as ``dae-fwd`` / ``dae-bwd``) hold
kernels 1-2 in their TF-x mode on seeded true states, the backward with the
true states' cotangents. Builds land in
``py_psnode_tpu_torch/_build/host/`` (ignored by git).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from py_psnode_tpu_torch.ops import fused_channelwise as FC
from py_psnode_tpu_torch.ops import fused_channelwise_vjp as VC
from py_psnode_tpu_torch.ops import fused_dae as F
from py_psnode_tpu_torch.ops import fused_dae_vjp as V
from py_psnode_tpu_torch.ops import fused_ode as FO
from py_psnode_tpu_torch.ops import fused_ode_vjp as VO
from py_psnode_tpu_torch.ops.fused_dae import _SOLVER_CODE
from py_psnode_tpu_torch.ops.fused_ode import pointer_array
from py_psnode_tpu_torch.utils.cuda_build import BUILD_DIR, SOURCE_DIR
from py_psnode_tpu_torch.utils.cw_inputs import seeded_inputs
from py_psnode_tpu_torch.utils.noencode_inputs import dae_inputs, ode_inputs, true_states, with_first_step_events

HOST_DIR = SOURCE_DIR / "host"
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>\(")


def host_text(text: str) -> str:
    """A source or header as g++ takes it: every ``<<<...>>>`` launch a call
    of ``host_launch_plain`` and the dynamic shared memory the block's
    buffer."""
    text = _LAUNCH.sub(r"host_launch_plain(\1, \2, \3, \4, \5, ", text)
    return text.replace("extern __shared__ __align__(16) float smem[];", "float* smem = host_t.smem;")


def host_source(name: str) -> str:
    """``csrc/<name>.cu`` as g++ takes it (:func:`host_text`)."""
    return host_text((SOURCE_DIR / f"{name}.cu").read_text())


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ was not found on the PATH: the host build of the kernels needs it")
    return gxx


@functools.lru_cache(maxsize=None)
def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The host build of ``csrc/<name>.cu`` with ``-D`` of each of
    ``defines`` (as ``"NAME=value"``), compiled first unless the current one
    exists (the key covers the source, the headers, the host model and the
    defines)."""
    source = host_source(name)
    h = hashlib.sha256(source.encode() + " ".join(defines).encode())
    headers = {f.name: host_text(f.read_text()) for f in sorted(SOURCE_DIR.glob("*.cuh"))}
    headers.update({f.name: f.read_text() for f in sorted(HOST_DIR.glob("*"))})  # the models win
    for key in sorted(headers):
        h.update(key.encode() + headers[key].encode())
    out = BUILD_DIR / "host" / h.hexdigest()[:16]
    lib = out / f"lib{name}.so"
    if not lib.exists():
        # each process writes and compiles in a directory of its own, then
        # moves the library into place: concurrent builds never share a file
        work = out / f"work-{os.getpid()}"
        work.mkdir(parents=True, exist_ok=True)
        for key, text in headers.items():
            (work / key).write_text(text)
        (work / "cuda_runtime.h").write_text("// cuda_host.h, included ahead of the source, stands in\n")
        (work / f"{name}.cpp").write_text(source)
        tmp = work / lib.name
        cmd = [find_gxx(), "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w", f"-I{work}",
               *(f"-D{d}" for d in defines), "-include", str(work / "cuda_host.h"), "-o", str(tmp),
               str(work / f"{name}.cpp")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {name}.cu for the host:\n{res.stderr[-8000:]}")
        tmp.replace(lib)
        shutil.rmtree(work, ignore_errors=True)
    return ctypes.CDLL(str(lib))


def _fwd():
    return FC.bind_rollout(load("fused_cw_rollout"))[0]


def _bwd():
    return VC.bind_rollout_bwd(load("fused_cw_rollout_bwd"))[:3]


def _nan(*shape):
    return torch.full(shape, float("nan"))


def rollout(streams: Dict, weights: Dict, x0, dt, solver: str = "euler", cluster: int = 0):
    """Kernel 5's host build on contiguous float32 CPU tensors (the
    arguments of ``fused_cw_rollout_cuda``); returns the rows ``[T-1, B,
    xd, h]``."""
    fz, sV = streams["fz"], streams["s_constV"]
    Tm1, B, zd, h = fz.shape
    xd = x0.shape[1]
    sol = _nan(Tm1, B, xd, h)
    rc = _fwd()(fz.data_ptr(), dt.data_ptr(), sV.data_ptr(), x0.data_ptr(),
                pointer_array(FC.flatten_weights(weights)), sol.data_ptr(), Tm1, B, h, xd, zd,
                _SOLVER_CODE[solver], cluster, None)
    if rc != 0:
        raise RuntimeError(f"host launch of fused_cw_rollout failed: error {rc}")
    return sol


def rollout_bwd(streams: Dict, weights: Dict, dt, sol, cot, solver: str = "euler",
                cluster: int = 0):
    """Kernel 6's host build on CPU tensors (the arguments of
    ``fused_cw_rollout_bwd_cuda``); returns ``(g_streams, g_weights, g_x0,
    pairs)``, the last the walk's (u, v) pairs ``[T-1, S, B, 4, 2, xd,
    h]``."""
    fz, sV = streams["fz"], streams["s_constV"]
    Tm1, B, zd, h = fz.shape
    xd = sol.shape[2]
    fn, sizes, _ = _bwd()
    layout, total = VC.grad_layout(weights)
    n_w, n_dense, n_pairs, n_parts = VC.bwd_sizes(sizes, Tm1, B, h, xd, zd, solver)
    assert n_w == total
    g_fz, g_sV, g_flat, g_x0 = _nan(Tm1, B, zd, h), _nan(B, h, h), _nan(total), _nan(B, xd, h)
    partial, pairs, parts = torch.zeros(B, n_dense), _nan(n_pairs), _nan(n_parts)
    wts = VC.transposed_weights(weights)
    rc = fn(fz.data_ptr(), dt.data_ptr(), sV.data_ptr(), sol.data_ptr(), cot.data_ptr(),
            pointer_array(FC.flatten_weights(weights)), pointer_array(wts), g_fz.data_ptr(),
            g_sV.data_ptr(), partial.data_ptr(), g_flat.data_ptr(), g_x0.data_ptr(),
            pairs.data_ptr(), parts.data_ptr(), Tm1, B, h, xd, zd, _SOLVER_CODE[solver], cluster,
            None)
    if rc != 0:
        raise RuntimeError(f"host launch of fused_cw_rollout_bwd failed: error {rc}")
    S = {"euler": 1, "midpoint": 2, "rk4": 4}[solver]
    g_list = [g_flat[off:off + math.prod(shape)].view(shape) for off, shape in layout]
    return (dict(fz=g_fz, s_constV=g_sV), FC.unflatten_weights(g_list), g_x0,
            pairs.view(Tm1, S, B, 4, 2, xd, h))


def contract_pairs(pairs):
    """The contraction's host build on ``pairs [..., 4, 2, xd, h]``;
    returns ``(dW, db)``."""
    *_, P, _, xd, h = pairs.shape
    rows = pairs.numel() // (8 * xd * h)
    _, sizes, contract = _bwd()
    parts = _nan(VC.bwd_sizes(sizes, rows, 1, h, xd, 1, "euler")[3])
    out = _nan(4 * xd * h * (h + 1))
    rc = contract(pairs.data_ptr(), rows, h, xd, parts.data_ptr(), out.data_ptr(), None)
    if rc != 0:
        raise RuntimeError(f"host launch of the pair contraction failed: error {rc}")
    n = 4 * xd * h * h
    return out[:n].view(4, xd, h, h), out[n:].view(4, xd, h)


def _nan_bufs(n_res, n_gy, n_xin, n_parts) -> Dict:
    return dict(res=_nan(n_res), gres=_nan(n_res), gy=_nan(n_gy), xin=_nan(n_xin), parts=_nan(n_parts))


def dae_rollout_bwd(streams: Dict, weights: Dict, x0, i0, aux, packed, cot, solver: str = "rk4",
                    stages: int = 7, bufs=None, defines: Tuple[str, ...] = (), x_true=None, g_true=False):
    """Kernel 2's host build (with ``defines``, :func:`load`) on CPU tensors
    (the arguments of ``fused_dae_rollout_bwd_cuda``, ``x_true`` its TF-x
    mode), on NaN-poisoned buffers unless ``bufs`` are given; returns
    ``((g_streams, g_weights, g_x0, g_i0[, (g_xt, g_xt1)]), bufs)`` as
    ``fused_dae_vjp._launch_bwd`` does."""
    launcher = V.bind_rollout_bwd(load("fused_dae_rollout_bwd", defines))
    if bufs is None:
        Tm1, B, h = streams["s_de"].shape
        n_tails = (len(weights["de_tail"]), len(weights["ae_tail"]))
        sizes = V.bwd_sizes(launcher[1], Tm1, B, h, x0.shape[-1], i0.shape[-1], n_tails, solver)
        bufs = _nan_bufs(*sizes[1:5])
    return V._launch_bwd(streams, weights, x0, i0, aux, packed, cot, solver, launcher, stages, bufs, host=True,
                         x_true=x_true, g_true=g_true)


def ode_rollout_bwd(s_de, weights: Dict, dt, sol, cot, solver: str = "euler", stages: int = 7, bufs=None,
                    defines: Tuple[str, ...] = ()):
    """Kernel 4's host build (with ``defines``) on CPU tensors (the
    arguments of ``fused_ode_rollout_bwd_cuda``), on NaN-poisoned buffers
    unless ``bufs`` are given; returns ``((g_s_de, g_weights, g_x0), bufs)``
    as ``fused_ode_vjp._launch_bwd`` does."""
    launcher = VO.bind_rollout_bwd(load("fused_ode_rollout_bwd", defines))
    if bufs is None:
        Tm1, B, h = s_de.shape
        sizes = VO.bwd_sizes(launcher[1], Tm1, B, h, sol.shape[-1], len(weights["de_tail"]), solver)
        bufs = _nan_bufs(*sizes[1:5])
    return VO._launch_bwd(s_de, weights, dt, sol, cot, solver, launcher, stages, bufs, host=True)


def dae_rollout(streams: Dict, weights: Dict, x0, i0, aux, solver: str = "rk4", rows=None,
                defines: Tuple[str, ...] = (), x_true=None):
    """Kernel 1's host build (with ``defines``, :func:`load`) on CPU tensors
    (the arguments of ``fused_dae_rollout_packed_cuda``, at most ``rows``
    rows a block, ``x_true`` its TF-x mode); returns the packed rows ``[T-1,
    B, xd + id]``."""
    launcher = F.bind_rollout(load("fused_dae_rollout", defines))
    return F._launch(streams, weights, x0, i0, aux, solver, rows, launcher, host=True, x_true=x_true)


def ode_rollout(s_de, weights: Dict, x0, dt, solver: str = "euler", rows=None, defines: Tuple[str, ...] = ()):
    """Kernel 3's host build on CPU tensors (the arguments of
    ``fused_ode_rollout_cuda``); returns the rows ``[T-1, B, xd]``."""
    launcher = FO.bind_rollout(load("fused_ode_rollout", defines))
    return FO._launch(s_de, weights, x0, dt, solver, rows, launcher, host=True)


def noencode_fwd_check(family: str, B: int, Tm1: int, h: int, solver: str, rows=None, xd=None,
                       n_tail: int = 3, defines: Tuple[str, ...] = (), idim: int = 2,
                       tfx: bool = False) -> Dict[str, float]:
    """Kernel 1 (``family`` "dae": ``xd`` (3 by default), ``idim`` and
    ``n_tail``, by default the motor shape, events in some rows; ``tfx``
    its TF-x mode on seeded true states) or 3 ("ode", ``xd`` (2 by default)
    and ``n_tail``, the readout at lecun scale) built for the host with
    ``defines``, on seeded inputs, against its plain version: ``worst``,
    the largest |kernel - plain| / max(1, |plain|), and ``identical``, 1.0
    when a relaunch gave the same bits."""
    if family == "dae":
        args = dae_inputs(B, Tm1, h, xd or 3, idim, seed=h, n_tail=n_tail)
        x_true = true_states(Tm1, B, xd or 3, seed=h) if tfx else None
        ref = F.fused_dae_rollout_packed_plain(*args, solver, x_true)
        run = lambda: dae_rollout(*args, solver, rows, defines, x_true)
    else:
        args = ode_inputs(B, Tm1, h, xd or 2, n_tail, seed=h, readout=1.0)
        ref = FO.fused_ode_rollout_plain(*args, solver)
        run = lambda: ode_rollout(*args, solver, rows, defines)
    got, again = run(), run()
    worst = ((got.double() - ref.double()).abs() / ref.double().abs().clamp(min=1.0)).max().item()
    return dict(worst=worst, identical=float(torch.equal(got, again)))


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tuple(_f64(a) for a in pair) for pair in tree]
    return tree.double()


def noencode_bwd_check(family: str, B: int, Tm1: int, h: int, solver: str, xd=None,
                       n_tail: int = 3, defines: Tuple[str, ...] = (), idim: int = 2,
                       tfx: bool = False, g_true: bool = True) -> Dict[str, float]:
    """Kernel 2 (``family`` "dae": ``xd`` (3 by default), ``idim`` and
    ``n_tail``, by default the motor shape; ``tfx`` its TF-x mode on seeded
    true states, with their cotangents ``g_xt``/``g_xt1`` where
    ``g_true``) or 4 ("ode", ``xd`` (2 by default) and ``n_tail``) built
    for the host with ``defines``, on seeded inputs with unit-scale
    cotangents, against the float64 plain walk: ``worst``, the largest
    max|d| / max|plain| of any output tensor (the float32 plain walk's
    beside it as ``float32``), and ``identical``, 1.0 when a relaunch gave
    the same bits."""
    rng = np.random.default_rng(B + Tm1 + h)
    if family == "dae":
        xd = xd or 3
        args = dae_inputs(B, Tm1, h, xd, idim, seed=h, n_tail=n_tail)
        x_true = None
        if tfx:  # events at step 0 too, so that g_x0 holds the event route
            x_true = true_states(Tm1, B, xd, seed=h)
            args = (*args[:4], with_first_step_events(args[4]))
        g_true = g_true and tfx
        packed = F.fused_dae_rollout_packed_plain(*args, solver, x_true)
        cot = torch.tensor(rng.standard_normal((Tm1 + 1, B, xd + idim)).astype(np.float32))
        flat = lambda g: [*g[0].values(), g[2], g[3]] + V.flatten_weights(g[1])[0] + (list(g[4]) if g_true else [])
        run = lambda: flat(dae_rollout_bwd(*args, packed, cot, solver, defines=defines, x_true=x_true,
                                           g_true=g_true)[0])
        streams, weights, x0, i0, aux = args
        ref = flat(V.fused_dae_rollout_bwd_plain(_f64(streams), _f64(weights), x0.double(), i0.double(),
                                                 aux, packed.double(), cot.double(), solver,
                                                 None if x_true is None else x_true.double(), g_true))
        f32 = flat(V.fused_dae_rollout_bwd_plain(*args, packed, cot, solver, x_true, g_true))
    else:
        s_de, weights, x0, dt = ode_inputs(B, Tm1, h, xd or 2, n_tail, seed=h)
        sol = torch.cat([x0[None], FO.fused_ode_rollout_plain(s_de, weights, x0, dt, solver)])
        cot = torch.tensor(rng.standard_normal(tuple(sol.shape)).astype(np.float32))
        flat = lambda g: [g[0], g[2]] + VO.flatten_weights(g[1])
        run = lambda: flat(ode_rollout_bwd(s_de, weights, dt, sol, cot, solver, defines=defines)[0])
        ref = flat(VO.fused_ode_rollout_bwd_plain(s_de.double(), _f64(weights), dt, sol.double(),
                                                  cot.double(), solver))
        f32 = flat(VO.fused_ode_rollout_bwd_plain(s_de, weights, dt, sol, cot, solver))
    got, again = run(), run()
    return dict(worst=_worst(got, ref), float32=_worst(f32, ref),
                identical=float(all(torch.equal(g, g2) for g, g2 in zip(got, again))))


def _worst(got: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    return max(((g.double() - r.double()).abs().max() / r.double().abs().max()).item()
               for g, r in zip(got, ref))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tfx = argv[0].endswith("-tfx")
    if tfx:
        argv = [argv[0][:-4]] + argv[1:]
    if argv[0] in ("dae-fwd", "ode-fwd", "dae-bwd", "ode-bwd"):
        family = argv[0][:3]
        n_dims = next(k for k, a in enumerate(argv[1:]) if not a.isdigit())  # the solver ends the sizes
        dims = list(map(int, argv[1:1 + n_dims]))
        solver, rest = argv[1 + n_dims], argv[2 + n_dims:]
        # the DAE: B Tm1 h [xd id n_tail]; the ODE: B Tm1 h xd n_tail
        shape = (dict(xd=dims[3], idim=dims[4], n_tail=dims[5]) if family == "dae" and len(dims) == 6
                 else dict(xd=dims[3], n_tail=dims[4]) if family == "ode" else {})
    if argv[0] in ("dae-fwd", "ode-fwd"):
        got = noencode_fwd_check(family, *dims[:3], solver, int(rest[0]) if rest else None, tfx=tfx, **shape)
        print(f"{argv[0]}: worst |d| / max(1, |plain|) {got['worst']:.2e}; bit-identical on relaunch: "
              f"{bool(got['identical'])}")
        return 0 if got["worst"] <= 1e-4 and got["identical"] else 1
    if argv[0] in ("dae-bwd", "ode-bwd"):
        got = noencode_bwd_check(family, *dims[:3], solver, tfx=tfx, **shape)
        print(f"{argv[0]}: worst max|d|/max|float64 walk| {got['worst']:.2e} (the float32 plain walk "
              f"{got['float32']:.2e}); bit-identical on relaunch: {bool(got['identical'])}")
        return 0 if got["worst"] <= 1e-4 and got["identical"] else 1
    what, (B, Tm1, h, xd, zd), solver = argv[0], map(int, argv[1:6]), argv[6]
    cluster = int(argv[7]) if len(argv) > 7 else 0
    streams, weights, x0, dt = seeded_inputs(B, Tm1, h, xd, zd)
    if what == "fwd":
        ref = FC.fused_cw_rollout_plain(streams, weights, x0, dt, solver)
        got = rollout(streams, weights, x0, dt, solver, cluster)
        d = (got - ref).abs()
        print(f"fwd: max|d| {d.max().item():.3e}, max|plain| {ref.abs().max().item():.3f}")
        return 0 if bool((d <= 1e-4 * ref.abs().clamp(min=1.0)).all()) else 1
    if what == "bwd":
        sol = torch.cat([x0[None], FC.fused_cw_rollout_plain(streams, weights, x0, dt, solver)])
        cot = torch.tensor(np.random.default_rng(1).standard_normal(tuple(sol.shape)).astype(np.float32))
        flat = lambda g_s, g_w, g_x0: [g_s["fz"], g_s["s_constV"], g_x0] + FC.flatten_weights(g_w)
        g_s, g_w, g_x0, pairs = rollout_bwd(streams, weights, dt, sol, cot, solver, cluster)
        w64 = FC.unflatten_weights([a.double() for a in FC.flatten_weights(weights)])
        ref = flat(*VC.fused_cw_rollout_bwd_plain({k: v.double() for k, v in streams.items()}, w64, dt,
                                                  sol.double(), cot.double(), solver))
        f32 = flat(*VC.fused_cw_rollout_bwd_plain(streams, weights, dt, sol, cot, solver))
        worst = _worst(flat(g_s, g_w, g_x0), ref)
        pairs_d = _worst([pairs], [VC.channel_pairs_plain(streams, weights, dt, sol, cot, solver)])
        print(f"bwd: worst max|d|/max|float64 walk| {worst:.2e} (the float32 plain walk "
              f"{_worst(f32, ref):.2e}); pairs against the plain pairs {pairs_d:.2e}")
        return 0 if worst <= 1e-4 else 1
    pairs = torch.tensor(np.random.default_rng(2).standard_normal((B * Tm1, 4, 2, xd, h)).astype(np.float32))
    d = _worst(contract_pairs(pairs), VC.contract_channel_pairs_plain(pairs.double()))
    print(f"contract: worst max|d|/max|plain| {d:.2e}")
    return 0 if d <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
