"""Fused forward rollout of the neural ODE (counterpart of
``py_psnode_tpu/ops/fused_ode.py``: ``precompute_ode_streams`` :38,
``_step_fwd`` :84, ``_fwd_kernel`` :125, ``_forward`` :293).

One dynamics net, one carry, and no in-kernel events: an ODE event only
substitutes the exogenous input of one step, so the jumped ``z`` stream is
folded into the precomputed layer-1 stream ``s_de``
(:func:`precompute_ode_streams`). Each step then evaluates
``f(x) = tail(s_de[t] + x @ wx_de)`` once per stage of the Euler, Midpoint
or RK4-3/8 step. Any tail depth runs: the no-encode dynamics (``n_tail`` 3,
``xd`` the state width) and the direct-encode latent dynamics (``n_tail``
1, ``xd = h``).

The loop runs in :func:`fused_ode_rollout`: on CUDA tensors it
launches the hand-written kernel ``csrc/fused_ode_rollout.cu`` (one launch
for the whole rollout), on CPU tensors it runs
:func:`fused_ode_rollout_plain`, the same function as an eager PyTorch
loop. There is no fallback from the kernel to the plain version.

Not ported: the bf16 compute mode (``_cast_ode`` :58), lanes, and the TPU's
time blocking with ``dt == 0`` padding (scheduling that does not change the
result).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from py_psnode_tpu_torch.ops.fused_dae import (
    _ONE_THIRD,
    _SOLVER_CODE,
    MAX_TAIL,
    mlp_tail_fwd,
    mlp_tail_layers,
    normalize_solver,
    split_de_layer1,
)
from py_psnode_tpu_torch.utils import cuda_build


def precompute_ode_streams(
    params: Dict,
    all_initial: torch.Tensor,
    z_step: torch.Tensor,
    x_dim: int,
    de_path: Tuple[str, str] = ("de_func", "x_dot"),
):
    """Lift the initial-state contribution and the ``z`` projections out of
    the loop.

    Args:
      params: flax-layout tree holding the dynamics net at ``de_path``.
      all_initial: ``[B, d_u]``, ``cat(x0, z0)``.
      z_step: event-adjusted inputs ``[T-1, B, zd]``.

    Returns ``(s_de [T-1, B, h], weights)`` with ``weights = {wx_de [xd, h],
    de_tail [(W, b), ...]}``, all contiguous.
    """
    de = params[de_path[0]][de_path[1]]
    d_u = all_initial.shape[-1]
    W1, b1 = de["dense_0"]["kernel"], de["dense_0"]["bias"]
    Winit, Wu, b1 = split_de_layer1(W1, b1, d_u)
    c = all_initial @ Winit + b1
    s_de = c[None] + z_step @ Wu[x_dim:]
    weights = dict(
        wx_de=Wu[:x_dim].contiguous(),
        de_tail=[(W.contiguous(), b.contiguous()) for W, b in mlp_tail_layers(de)],
    )
    return s_de.contiguous(), weights


def _step_fwd(f, x0, dt, solver):
    """One explicit step of the selected tableau (the kernels' arithmetic)."""
    if solver == "euler":
        return x0 + dt * f(x0)
    if solver == "midpoint":
        f0 = f(x0)
        return x0 + dt * f(x0 + f0 * (0.5 * dt))
    if solver == "rk4":  # Kutta's 3/8 rule
        k1 = f(x0)
        k2 = f(x0 + dt * k1 * _ONE_THIRD)
        k3 = f(x0 + dt * (k2 - k1 * _ONE_THIRD))
        k4 = f(x0 + dt * (k1 - k2 + k3))
        return x0 + (k1 + 3.0 * (k2 + k3) + k4) * dt * 0.125
    raise ValueError(solver)


def fused_ode_rollout_plain(s_de, weights: Dict, x0, dt, solver: str = "euler") -> torch.Tensor:
    """The rollout as an eager PyTorch loop on any device and in the
    inputs' dtype: the plain version of the CUDA kernel. Returns the rows
    ``[T-1, B, xd]`` of steps 1..T-1."""
    solver = normalize_solver(solver)
    wx, tail = weights["wx_de"], weights["de_tail"]
    dt = dt.to(s_de.dtype)
    xs, x = [], x0
    for t in range(s_de.shape[0]):
        f = lambda xx, t=t: mlp_tail_fwd(s_de[t] + xx @ wx, tail)
        x = _step_fwd(f, x, dt[t], solver)
        xs.append(x)
    return torch.stack(xs)


def check_inputs(s_de, weights: Dict, x0, dt, device_type: str = "cuda"):
    """Raise unless the rollout's inputs are float32, contiguous, on one
    CUDA device (or, for a host build of the kernels, ``device_type``
    "cpu") and shaped as the kernels take them."""
    if s_de.device.type != device_type:
        raise ValueError(f"the CUDA ODE kernels take CUDA tensors, got {s_de.device}")
    Tm1, B, h = s_de.shape
    xd = x0.shape[-1]
    tail = weights["de_tail"]
    if not 1 <= len(tail) <= MAX_TAIL:
        raise ValueError(f"de_tail must hold 1..{MAX_TAIL} layers, got {len(tail)}")
    expect = {"s_de": (s_de, (Tm1, B, h)), "dt": (dt, (Tm1, B, 1)), "x0": (x0, (B, xd)),
              "wx_de": (weights["wx_de"], (xd, h))}
    for k, (W, b) in enumerate(tail):
        n_out = xd if k == len(tail) - 1 else h
        expect[f"de_tail[{k}].W"] = (W, (h, n_out))
        expect[f"de_tail[{k}].b"] = (b, (n_out,))
    for name, (a, shape) in expect.items():
        if a.device != s_de.device:
            raise ValueError(f"{name} is on {a.device}, s_de on {s_de.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def pointer_array(tensors):
    """A ctypes array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launcher of ``csrc/fused_ode_rollout.cu`` with its signature."""
    lib = cuda_build.load("fused_ode_rollout")
    fn = lib.psn_fused_ode_rollout_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    PP = ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = [
        P, P, P, P,  # s_de, dt, x0, wx_de
        PP, PP, I,  # tail W, b, count
        P,  # sol
        I, I, I, I,  # Tm1, B, h, xd
        I,  # solver
        P,  # stream
    ]
    fn.restype = ctypes.c_int
    err = lib.psn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def fused_ode_rollout_cuda(s_de, weights: Dict, x0, dt, solver: str = "euler") -> torch.Tensor:
    """Launch the CUDA kernel once for the whole rollout, one block per
    batch row; returns the rows ``[T-1, B, xd]``."""
    solver = normalize_solver(solver)
    check_inputs(s_de, weights, x0, dt)
    Tm1, B, h = s_de.shape
    xd = x0.shape[-1]
    fn, err = _launcher()
    sol = torch.empty(Tm1, B, xd, dtype=torch.float32, device=s_de.device)
    tail = weights["de_tail"]
    with torch.cuda.device(s_de.device):
        stream = torch.cuda.current_stream(s_de.device).cuda_stream
        rc = fn(
            s_de.data_ptr(), dt.data_ptr(), x0.data_ptr(), weights["wx_de"].data_ptr(),
            pointer_array([W for W, _ in tail]), pointer_array([b for _, b in tail]), len(tail),
            sol.data_ptr(), Tm1, B, h, xd, _SOLVER_CODE[solver], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_ode_rollout kernel launch failed: CUDA error {rc} ({err(rc).decode()})"
        )
    fused_ode_rollout.launches += 1
    return sol


def fused_ode_rollout(s_de, weights: Dict, x0, dt, solver: str = "euler") -> torch.Tensor:
    """The rollout's rows ``[T-1, B, xd]`` (steps 1..T-1, without ``x0``) on
    the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, an error otherwise.

    Args:
      s_de/weights: from :func:`precompute_ode_streams`.
      x0: ``[B, xd]`` initial state; dt: ``[T-1, B, 1]`` float32 step sizes.

    ``fused_ode_rollout.launches`` counts kernel launches.
    """
    dev = s_de.device
    if dev.type == "cuda":
        return fused_ode_rollout_cuda(s_de, weights, x0, dt, solver)
    if dev.type == "cpu":
        return fused_ode_rollout_plain(s_de, weights, x0, dt, solver)
    raise ValueError(f"fused_ode_rollout runs on cuda or cpu tensors, got {dev}")


fused_ode_rollout.launches = 0
