"""Dependency-free flat binary weight format for the C++ mini-runtime.

Layout (little-endian):

  magic   u32  = 0x50534E57  ("PSNW")
  version u32  = 1
  n_tensors u32
  then per tensor:
    name_len u32, name bytes (utf-8, '/'-joined pytree path)
    ndim u32, dims u32[ndim]
    dtype u32 (0 = float32)
    data  float32[numel]

The consumer is ``native/psnode_infer`` — a small C++ library that evaluates
the exported Dense/ELU submodules inside a host simulator (the PSOPS
embedding role of the reference's TorchScript files, README.md:45).

A copy of ``py_psnode_tpu/export/binfmt.py`` (numpy only; importing the
JAX package's ``export`` imports JAX): the same bytes for the same arrays.
"""

from __future__ import annotations

import pathlib
import struct
from typing import Dict

import numpy as np

MAGIC = 0x50534E57
VERSION = 1
DTYPE_F32 = 0


def write_weights_bin(path, flat: Dict[str, np.ndarray]):
    with open(path, "wb") as f:
        f.write(struct.pack("<III", MAGIC, VERSION, len(flat)))
        for name in sorted(flat):
            arr = np.ascontiguousarray(flat[name], dtype=np.float32)
            nb = name.encode("utf-8")
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<I", arr.ndim))
            f.write(struct.pack(f"<{arr.ndim}I", *arr.shape))
            f.write(struct.pack("<I", DTYPE_F32))
            f.write(arr.tobytes())


def read_weights_bin(path) -> Dict[str, np.ndarray]:
    data = pathlib.Path(path).read_bytes()
    off = 0

    def take(fmt):
        nonlocal off
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, data, off)
        off += size
        return vals

    magic, version, n = take("<III")
    if magic != MAGIC or version != VERSION:
        raise ValueError(f"bad weights file {path}: magic={magic:#x} v={version}")
    out = {}
    for _ in range(n):
        (name_len,) = take("<I")
        name = data[off : off + name_len].decode("utf-8")
        off += name_len
        (ndim,) = take("<I")
        dims = take(f"<{ndim}I")
        (dt,) = take("<I")
        if dt != DTYPE_F32:
            raise ValueError(f"unsupported dtype tag {dt}")
        numel = int(np.prod(dims)) if ndim else 1
        arr = np.frombuffer(data, dtype="<f4", count=numel, offset=off).reshape(dims)
        off += numel * 4
        out[name] = arr.copy()
    return out
