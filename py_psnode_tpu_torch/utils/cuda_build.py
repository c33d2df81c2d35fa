"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch header), so
``nvcc`` builds it into a shared library in seconds. The library lands in
``py_psnode_tpu_torch/_build/lib<name><tag>-<hash>.so``, where the hash covers
the source, the shared headers ``csrc/*.cuh`` and the flags (the tag
``_psn_bf16`` marks a bf16 build): a changed source or header is rebuilt on
its next use. The sources listed in :data:`SPLIT_BF16` build twice, once
with ``-D`` :data:`BF16_DEFINE` (their bf16 compute mode's kernels and C
functions) and once without (float32's), so that the two halves compile at
once.
Nothing is built when a module is imported; the first launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
from typing import List, Tuple

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# the sources whose bf16 compute mode is a build of its own, and its define
SPLIT_BF16 = ("fused_dae_rollout", "fused_cw_rollout", "fused_cw_rollout_bwd")
BF16_DEFINE = "PSN_BF16"


def mode_defines(name: str, bf16: bool) -> Tuple[str, ...]:
    """The defines of the build of ``name`` that holds the float32 or (with
    ``bf16``) the bf16 compute mode's kernels."""
    return (BF16_DEFINE,) if bf16 and name in SPLIT_BF16 else ()


def builds() -> List[Tuple[str, bool]]:
    """``[(name, bf16), ...]``: every build of the port's kernels."""
    names = ("fused_dae_rollout", "fused_dae_rollout_bwd", "fused_ode_rollout", "fused_ode_rollout_bwd",
             "fused_cw_rollout", "fused_cw_rollout_bwd")
    return [(n, False) for n in names] + [(n, True) for n in SPLIT_BF16]


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc was not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built on the machine with the card"
    )


def library_path(name: str, bf16: bool = False) -> pathlib.Path:
    defines = mode_defines(name, bf16)
    h = hashlib.sha256((SOURCE_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    if defines:
        h.update(" ".join(defines).encode())
    digest = h.hexdigest()
    tag = "".join("_" + re.sub(r"\W", "", d).lower() for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{digest[:16]}.so"


def build(name: str, bf16: bool = False) -> float:
    """Compile ``csrc/<name>.cu`` (with ``bf16``, the build that holds its
    bf16 compute mode: :func:`mode_defines`) unless the current build
    exists; returns the seconds ``nvcc`` took (0.0 when the build was
    already there)."""
    out = library_path(name, bf16)
    defines = mode_defines(name, bf16)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {res.returncode}):\n"
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    print(f"built {out.name} with nvcc in {seconds:.2f} s", flush=True)
    if res.stderr.strip():
        print(res.stderr.strip(), flush=True)  # ptxas: registers, spills
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str, bf16: bool = False) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (with ``bf16``, the build
    that holds its bf16 compute mode), built first if needed."""
    build(name, bf16)
    return ctypes.CDLL(str(library_path(name, bf16)))
