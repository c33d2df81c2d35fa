"""ctypes binding of the C++ inference runtime (``native/psnode_infer.cpp``)
for the port (counterpart of ``py_psnode_tpu/export/native_runtime.py``:
``NativeModule`` and the rollouts of the six variants).

The runtime loads the ``<name>.weights.bin`` files of ``saved model/`` and
evaluates the exported Dense/ELU submodules on the host: the embedding
path of co-simulation (the role of the reference's TorchScript files in
PSOPS). The library is built from ``native/psnode_infer.cpp`` with ``g++``
(the flags of ``native/Makefile``) into ``py_psnode_tpu_torch/_build/``
on first use, under a name that carries the source's hash; ``native/``
itself is only read.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import List

import numpy as np

from py_psnode_tpu_torch.utils.cuda_build import BUILD_DIR

NATIVE_SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "psnode_infer.cpp"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(NATIVE_SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / "native" / f"libpsnode_infer-{h}.so"


def build_library() -> pathlib.Path:
    """The runtime's shared library, compiled first unless the current one
    exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ was not found on the PATH: the native runtime is built with it")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(NATIVE_SOURCE)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build {NATIVE_SOURCE.name}:\n{res.stderr[-8000:]}")
    tmp.replace(out)
    return out


@functools.lru_cache(maxsize=None)
def _get_lib():
    lib = ctypes.CDLL(str(build_library()))
    P, I, fp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
    lib.psnode_load.restype = P
    lib.psnode_load.argtypes = [ctypes.c_char_p]
    lib.psnode_free.argtypes = [P]
    lib.psnode_num_nets.argtypes = [P]
    lib.psnode_num_nets.restype = I
    lib.psnode_net_name.argtypes = [P, I]
    lib.psnode_net_name.restype = ctypes.c_char_p
    lib.psnode_net_in_dim.argtypes = [P, ctypes.c_char_p]
    lib.psnode_net_in_dim.restype = I
    lib.psnode_net_out_dim.argtypes = [P, ctypes.c_char_p]
    lib.psnode_net_out_dim.restype = I
    lib.psnode_forward.argtypes = [P, ctypes.c_char_p, fp, fp, I]
    lib.psnode_forward.restype = I
    lib.psnode_ode_rollout.argtypes = [P, fp, fp, fp, I, I, I, I, ctypes.c_char_p, fp]
    lib.psnode_ode_rollout.restype = I
    lib.psnode_dae_rollout.argtypes = [P, P, P, fp, fp, fp, fp, I, I, I, I, I, I, ctypes.c_char_p, fp, fp]
    lib.psnode_dae_rollout.restype = I
    lib.psnode_ode_encode_rollout.argtypes = [P, P, P, P, fp, fp, fp, I, I, I, I, ctypes.c_char_p, fp]
    lib.psnode_ode_encode_rollout.restype = I
    lib.psnode_dae_encode_rollout.argtypes = [P] * 9 + [fp, fp, fp, fp] + [I] * 6 + [ctypes.c_char_p, fp, fp]
    lib.psnode_dae_encode_rollout.restype = I
    lib.psnode_cw_ode_rollout.argtypes = [P, fp, fp, fp, I, I, I, I, ctypes.c_char_p, fp]
    lib.psnode_cw_ode_rollout.restype = I
    lib.psnode_cw_dae_rollout.argtypes = [P, P, fp, fp, fp, fp, I, I, I, I, I, I, ctypes.c_char_p, fp, fp]
    lib.psnode_cw_dae_rollout.restype = I
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


class NativeModule:
    """A loaded ``<name>.weights.bin`` artifact evaluated by the C++ runtime."""

    def __init__(self, weights_bin_path):
        self._lib = _get_lib()
        self._handle = self._lib.psnode_load(str(weights_bin_path).encode())
        if not self._handle:
            raise RuntimeError(f"failed to load {weights_bin_path}")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.psnode_free(self._handle)
            self._handle = None

    @property
    def nets(self) -> List[str]:
        n = self._lib.psnode_num_nets(self._handle)
        return [self._lib.psnode_net_name(self._handle, k).decode() for k in range(n)]

    def in_dim(self, net: str) -> int:
        return self._lib.psnode_net_in_dim(self._handle, net.encode())

    def out_dim(self, net: str) -> int:
        return self._lib.psnode_net_out_dim(self._handle, net.encode())

    def forward(self, net: str, x: np.ndarray) -> np.ndarray:
        x = _f32(x)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        B, d = x.shape
        din = self.in_dim(net)
        if din < 0:
            raise RuntimeError(f"unknown net {net!r}; have {self.nets}")
        if d != din:
            raise ValueError(f"{net}: expected input dim {din}, got {d}")
        y = np.empty((B, self.out_dim(net)), dtype=np.float32)
        if self._lib.psnode_forward(self._handle, net.encode(), _fptr(x), _fptr(y), B) != 0:
            raise RuntimeError(f"unknown net {net!r}; have {self.nets}")
        return y[0] if squeeze else y


def ode_rollout(de: NativeModule, t, x0, z, solver="euler"):
    """The no-encode ODE rollout in the C++ runtime (no events: feed the
    post-event ``z`` stream). ``t [T]``, ``x0 [B, xd]``, ``z [T, B, zd]``
    (time-major); returns ``x [T, B, xd]``."""
    t, x0, z = _f32(t).reshape(-1), _f32(x0), _f32(z)
    T, (B, xd), zd = t.shape[0], x0.shape, z.shape[-1]
    out = np.empty((T, B, xd), np.float32)
    rc = _get_lib().psnode_ode_rollout(de._handle, _fptr(t), _fptr(x0), _fptr(z), T, B, xd, zd,
                                       solver.encode(), _fptr(out))
    if rc != 0:
        raise RuntimeError(f"psnode_ode_rollout failed rc={rc}")
    return out


def dae_rollout(de: NativeModule, ae: NativeModule, init: NativeModule, t, z, v, i0, solver="euler",
                x_dim=None):
    """The no-encode DAE rollout in the C++ runtime (learned init, lagged
    ``i``, the algebraic net at every time point; no events). ``t [T]``,
    ``z [T, B, zd]``, ``v [T, B, vd]``, ``i0 [B, id]``; returns ``(x [T, B,
    xd], i [T, B, id])``."""
    t, z, v, i0 = _f32(t).reshape(-1), _f32(z), _f32(v), _f32(i0)
    T, B = t.shape[0], i0.shape[0]
    zd, vd, idim = z.shape[-1], v.shape[-1], i0.shape[-1]
    xd = x_dim if x_dim is not None else init.out_dim("init_fun/")
    x_out = np.empty((T, B, xd), np.float32)
    i_out = np.empty((T, B, idim), np.float32)
    rc = _get_lib().psnode_dae_rollout(de._handle, ae._handle, init._handle, _fptr(t), _fptr(z), _fptr(v),
                                       _fptr(i0), T, B, xd, zd, vd, idim, solver.encode(), _fptr(x_out),
                                       _fptr(i_out))
    if rc != 0:
        raise RuntimeError(f"psnode_dae_rollout failed rc={rc}")
    return x_out, i_out


def ode_encode_rollout(de: NativeModule, x_encoder: NativeModule, x_decoder: NativeModule,
                       z_encoder: NativeModule, t, x0, z, solver="euler"):
    """The direct-encode ODE rollout in the C++ runtime: the encoded
    initial state and ``z`` stream, the latent dynamics, every row decoded
    (no events). ``t [T]``, ``x0 [B, xd]``, ``z [T, B, zd]``; returns ``x
    [T, B, xd]``."""
    t, x0, z = _f32(t).reshape(-1), _f32(x0), _f32(z)
    T, (B, xd), zd = t.shape[0], x0.shape, z.shape[-1]
    out = np.empty((T, B, xd), np.float32)
    rc = _get_lib().psnode_ode_encode_rollout(de._handle, x_encoder._handle, x_decoder._handle, z_encoder._handle,
                                              _fptr(t), _fptr(x0), _fptr(z), T, B, xd, zd, solver.encode(),
                                              _fptr(out))
    if rc != 0:
        raise RuntimeError(f"psnode_ode_encode_rollout failed rc={rc}")
    return out


def dae_encode_rollout(de: NativeModule, ae: NativeModule, init: NativeModule, x_encoder: NativeModule,
                       x_decoder: NativeModule, z_encoder, v_encoder: NativeModule, i_encoder: NativeModule,
                       i_decoder: NativeModule, t, z, v, i0, solver="euler"):
    """The direct-encode DAE rollout in the C++ runtime: the raw Init state,
    the latent lagged-``i`` rollout, the decoded outputs with the first row
    of ``x`` the raw Init output (no events). ``z_encoder`` is None where
    ``z`` is zero-wide. ``t [T]``, ``z [T, B, zd]``, ``v [T, B, vd]``, ``i0
    [B, id]``; returns ``(x [T, B, xd], i [T, B, id])``."""
    t, z, v, i0 = _f32(t).reshape(-1), _f32(z), _f32(v), _f32(i0)
    T, B = t.shape[0], i0.shape[0]
    zd, vd, idim = z.shape[-1], v.shape[-1], i0.shape[-1]
    xd = init.out_dim("init_fun/")
    x_out = np.empty((T, B, xd), np.float32)
    i_out = np.empty((T, B, idim), np.float32)
    rc = _get_lib().psnode_dae_encode_rollout(
        de._handle, ae._handle, init._handle, x_encoder._handle, x_decoder._handle,
        None if z_encoder is None else z_encoder._handle, v_encoder._handle, i_encoder._handle,
        i_decoder._handle, _fptr(t), _fptr(z), _fptr(v), _fptr(i0), T, B, xd, zd, vd, idim, solver.encode(),
        _fptr(x_out), _fptr(i_out))
    if rc != 0:
        raise RuntimeError(f"psnode_dae_encode_rollout failed rc={rc}")
    return x_out, i_out


def cw_ode_rollout(de: NativeModule, t, x0, z, solver="euler"):
    """The channel-wise ODE rollout in the C++ runtime (``de`` the
    channel-wise ``de_func`` export, its per-channel-sliced bin; no
    events). ``t [T]``, ``x0 [B, xd]``, ``z [T, B, zd]``; returns ``x [T,
    B, xd]``."""
    t, x0, z = _f32(t).reshape(-1), _f32(x0), _f32(z)
    T, (B, xd), zd = t.shape[0], x0.shape, z.shape[-1]
    out = np.empty((T, B, xd), np.float32)
    rc = _get_lib().psnode_cw_ode_rollout(de._handle, _fptr(t), _fptr(x0), _fptr(z), T, B, xd, zd,
                                          solver.encode(), _fptr(out))
    if rc != 0:
        raise RuntimeError(f"psnode_cw_ode_rollout failed rc={rc}")
    return out


def cw_dae_rollout(de: NativeModule, ae: NativeModule, t, x0, z, v, i_dim, solver="euler"):
    """The channel-wise DAE rollout in the C++ runtime: the latent ODE of
    :func:`cw_ode_rollout` and the channel-wise algebraic readout at every
    time point (no events). ``t [T]``, ``x0 [B, xd]``, ``z [T, B, zd]``,
    ``v [T, B, vd]``; returns ``(x [T, B, xd], i [T, B, i_dim])``."""
    t, x0, z, v = _f32(t).reshape(-1), _f32(x0), _f32(z), _f32(v)
    T, (B, xd), zd, vd = t.shape[0], x0.shape, z.shape[-1], v.shape[-1]
    x_out = np.empty((T, B, xd), np.float32)
    i_out = np.empty((T, B, i_dim), np.float32)
    rc = _get_lib().psnode_cw_dae_rollout(de._handle, ae._handle, _fptr(t), _fptr(x0), _fptr(z), _fptr(v),
                                          T, B, xd, zd, vd, i_dim, solver.encode(), _fptr(x_out),
                                          _fptr(i_out))
    if rc != 0:
        raise RuntimeError(f"psnode_cw_dae_rollout failed rc={rc}")
    return x_out, i_out


def rollout(variant: str, saved, batch, solver: str):
    """The rollout of ``variant``'s exported ``.bin`` files in ``saved`` over
    a batch of the port's layout (``batch["t"|"x"|"z"|...] [B, T, d]``, the
    rows on one time grid; no events), as the port's model would give it:
    ``(x [B, T, xd],)`` for the ODE families, ``(x, i)`` for the DAE ones
    (the first outputs of the model's forward). The direct-encode DAE takes
    no z encoder where ``z`` is zero-wide."""
    saved = pathlib.Path(saved)
    mod = lambda sub: NativeModule(saved / f"{sub}.weights.bin")
    tm = lambda a: np.swapaxes(a, 0, 1)
    t0, x0 = batch["t"][0, :, 0], batch["x"][:, 0]
    if variant == "ode_no_encode":
        out = (ode_rollout(mod("de_func"), t0, x0, tm(batch["z"]), solver),)
    elif variant == "ode_encode":
        out = (ode_encode_rollout(mod("de_func"), mod("x_encoder"), mod("x_decoder"), mod("z_encoder"), t0, x0,
                                  tm(batch["z"]), solver),)
    elif variant == "dae_encode":
        z_enc = mod("z_encoder") if batch["z"].shape[-1] else None
        out = dae_encode_rollout(mod("de_func"), mod("ae_func"), mod("init_func"), mod("x_encoder"),
                                 mod("x_decoder"), z_enc, mod("v_encoder"), mod("i_encoder"), mod("i_decoder"),
                                 t0, tm(batch["z"]), tm(batch["v"]), batch["i"][:, 0], solver)
    elif variant == "dae_no_encode":
        out = dae_rollout(mod("de_func"), mod("ae_func"), mod("init_func"), t0, tm(batch["z"]), tm(batch["v"]),
                          batch["i"][:, 0], solver)
    elif variant == "ode_channelwise":
        out = (cw_ode_rollout(mod("de_func"), t0, x0, tm(batch["z"]), solver),)
    elif variant == "dae_channelwise":
        out = cw_dae_rollout(mod("de_func"), mod("ae_func"), t0, x0, tm(batch["z"]), tm(batch["v"]),
                             batch["i"].shape[-1], solver)
    else:
        raise ValueError(f"no native rollout of variant {variant!r}")
    return tuple(tm(a) for a in out)
