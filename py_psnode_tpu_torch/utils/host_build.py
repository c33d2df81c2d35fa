"""Build the channel-wise CUDA kernels for the host and run them on CPU tensors.

A CUDA kernel has no CPU mode, and this package's CPU runs never reach the
kernels. To check a kernel's source before it meets the card, this module
compiles ``csrc/<name>.cu`` with ``g++ -std=c++20`` against a host model of
the CUDA subset it uses (``csrc/host/cuda_host.h``: one OS thread per CUDA
thread, barriers, clusters run a cluster at a time, NaN-poisoned shared
memory; ``csrc/host/hopper_ops.cuh``: TF32 rounding, the mma.sync fragment
layout, cp.async made at its wait, the cluster barrier and shared-memory
map) and calls its C launchers through ``ctypes`` with CPU pointers. The
model runs every block's 512 threads as OS threads and every mma through a
barrier of its warp, so it takes seconds an evaluation: keep shapes small.

    python -m py_psnode_tpu_torch.utils.host_build fwd|bwd|contract B Tm1 h xd zd solver [cluster]

holds the host build against the plain PyTorch version on seeded inputs
(the card tests' kind) and prints the distance. Builds land in
``py_psnode_tpu_torch/_build/host/`` (ignored by git).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import re
import shutil
import subprocess
import sys
from typing import Dict, List

import numpy as np
import torch

from py_psnode_tpu_torch.ops import fused_channelwise as FC
from py_psnode_tpu_torch.ops import fused_channelwise_vjp as VC
from py_psnode_tpu_torch.ops.fused_dae import _SOLVER_CODE
from py_psnode_tpu_torch.ops.fused_ode import pointer_array
from py_psnode_tpu_torch.utils.cuda_build import BUILD_DIR, SOURCE_DIR
from py_psnode_tpu_torch.utils.cw_inputs import seeded_inputs

HOST_DIR = SOURCE_DIR / "host"
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>\(")


def host_source(name: str) -> str:
    """``csrc/<name>.cu`` as g++ takes it: every ``<<<...>>>`` launch a call
    of ``host_launch_plain`` and the dynamic shared memory the block's
    buffer."""
    src = _LAUNCH.sub(r"host_launch_plain(\1, \2, \3, \4, \5, ", (SOURCE_DIR / f"{name}.cu").read_text())
    return src.replace("extern __shared__ __align__(16) float smem[];", "float* smem = host_t.smem;")


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ was not found on the PATH: the host build of the kernels needs it")
    return gxx


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The host build of ``csrc/<name>.cu``, compiled first unless the
    current one exists (the key covers the source, the headers and the host
    model)."""
    source = host_source(name)
    h = hashlib.sha256(source.encode())
    headers = {f.name: f.read_text() for f in sorted(SOURCE_DIR.glob("*.cuh"))}
    headers.update({f.name: f.read_text() for f in sorted(HOST_DIR.glob("*"))})  # the models win
    for key in sorted(headers):
        h.update(key.encode() + headers[key].encode())
    out = BUILD_DIR / "host" / h.hexdigest()[:16]
    lib = out / f"lib{name}.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        for key, text in headers.items():
            (out / key).write_text(text)
        (out / "cuda_runtime.h").write_text("// cuda_host.h, included ahead of the source, stands in\n")
        (out / f"{name}.cpp").write_text(source)
        tmp = lib.with_suffix(".tmp")
        cmd = [find_gxx(), "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w", f"-I{out}",
               "-include", str(out / "cuda_host.h"), "-o", str(tmp), str(out / f"{name}.cpp")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {name}.cu for the host:\n{res.stderr[-8000:]}")
        tmp.replace(lib)
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


def _worst(got: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    return max(((g.double() - r.double()).abs().max() / r.double().abs().max()).item()
               for g, r in zip(got, ref))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
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
