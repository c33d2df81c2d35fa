"""Reverse-time VJP of the fused channel-wise rollout (counterpart of
``py_psnode_tpu/ops/fused_channelwise.py``: ``_cw_bwd_eval`` :290,
``_bwd_kernel`` :370, ``_vjp_bwd`` :557 and the ``jax.custom_vjp``
``fused_cw_rollout_diff`` :537).

The backward walks the time grid in reverse from the saved solution (the
only residual the forward keeps). At each step it recomputes the step's
evaluations from ``x_t = sol[t]``, backpropagates the Euler / Midpoint /
RK4-3/8 step (the cotangent order of ``fused_channelwise.py:434-471``) and
accumulates:

  * ``g_fz [T-1, B, zd, h]``, the cotangent of each step's z-features;
  * ``g_s_constV [B, h, h]``, summed over steps and stages;
  * the gradients of ``a`` and of every vertical, ``ext`` and ``head``
    weight and bias over all batch rows and steps;
  * the reverse-time carry ``dL/dx_t``, which ends as ``g_x0``.

``dt`` gets a zero gradient; :class:`FusedCwRollout` adds ``g_sol[0]`` to
``g_x0`` (the solution's first row is ``x0``), as ``_vjp_bwd`` does.

:func:`fused_cw_rollout_bwd` runs the hand-written CUDA kernel
``csrc/fused_cw_rollout_bwd.cu`` on CUDA tensors and
:func:`fused_cw_rollout_bwd_plain` on CPU tensors. The plain walk
recomputes one step at a time and takes that step's VJP with autograd, so
its memory is one step's, at any T.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Tuple

import torch

from py_psnode_tpu_torch.ops.fused_channelwise import (
    check_inputs,
    cw_eval,
    flatten_weights,
    fused_cw_rollout,
    unflatten_weights,
)
from py_psnode_tpu_torch.ops.fused_dae import _SOLVER_CODE, normalize_solver
from py_psnode_tpu_torch.ops.fused_ode import _step_fwd, pointer_array
from py_psnode_tpu_torch.utils import cuda_build


def fused_cw_rollout_bwd_plain(streams: Dict, weights: Dict, dt, sol, cot, solver: str = "euler"):
    """The reverse walk in PyTorch on any device, in the inputs' dtype
    (float32 or float64): the plain version of the CUDA kernel.

    Args:
      streams/weights/dt: the forward's inputs.
      sol: the forward's solution ``[T, B, xd, h]`` (row 0 is ``x0``).
      cot: cotangent of the solution ``[T, B, xd, h]``; row 0 is not read.

    Returns ``(g_streams {fz, s_constV}, g_weights, g_x0)``: the weight
    grads in the layout of ``weights``, the carry at t=0 (without
    ``cot[0]``).
    """
    solver = normalize_solver(solver)
    fz, sV = streams["fz"], streams["s_constV"]
    flat = [w.detach() for w in flatten_weights(weights)]
    dt_all = dt.to(sV.dtype)[..., None]  # [T-1, B, 1, 1]
    g_fz = torch.zeros_like(fz)
    g_sV = torch.zeros_like(sV)
    g_w = [torch.zeros_like(w) for w in flat]
    gx = torch.zeros_like(sol[0])
    for t in reversed(range(fz.shape[0])):
        with torch.enable_grad():
            x0 = sol[t].detach().requires_grad_()
            fz_t = fz[t].detach().requires_grad_()
            sV_t = sV.detach().requires_grad_()
            w_t = [w.requires_grad_() for w in (w.detach() for w in flat)]
            wd = unflatten_weights(w_t)
            x1 = _step_fwd(lambda xx: cw_eval(xx, fz_t, sV_t, wd), x0, dt_all[t], solver)
            grads = torch.autograd.grad(x1, [x0, fz_t, sV_t, *w_t], cot[t + 1] + gx)
        gx, g_fz[t] = grads[0], grads[1]
        g_sV += grads[2]
        for acc, g in zip(g_w, grads[3:]):
            acc += g
    return dict(fz=g_fz, s_constV=g_sV), unflatten_weights(g_w), gx


def transposed_weights(weights: Dict) -> List[torch.Tensor]:
    """``[W1^T, W2^T, ext w0^T, ext w1^T, head w0^T, head w1^T]`` (the
    per-channel stacks transposed per channel): the backward kernel's
    cotangent products read these, so that neighbouring threads read
    neighbouring addresses."""
    (W1, _), (W2, _), _ = weights["vert"]
    t = lambda w: w.transpose(-1, -2).contiguous()
    return [t(W1), t(W2), t(weights["ext"][0]), t(weights["ext"][2]),
            t(weights["head"][0]), t(weights["head"][2])]


def grad_layout(weights: Dict) -> Tuple[List[Tuple[int, Tuple[int, ...]]], int]:
    """``([(offset, shape), ...], total)``: where each gradient lies in the
    kernel's flat gradient row, in :func:`flatten_weights` order."""
    out, off = [], 0
    for a in flatten_weights(weights):
        out.append((off, tuple(a.shape)))
        off += math.prod(a.shape)
    return out, off


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launcher of ``csrc/fused_cw_rollout_bwd.cu`` with its
    signature."""
    lib = cuda_build.load("fused_cw_rollout_bwd")
    fn = lib.psn_fused_cw_rollout_bwd_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    PP = ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = [
        P, P, P, P, P,  # fz, dt, s_constV, sol, cot
        PP, PP,  # the 15 weights (flatten_weights order), the 6 transposes
        P, P, P, P, P, P,  # g_fz, g_s_constV, partial, g_w, g_x0, scratch
        I, I, I, I, I,  # Tm1, B, h, xd, zd
        I,  # solver
        P,  # stream
    ]
    fn.restype = ctypes.c_int
    sizes = lib.psn_fused_cw_bwd_sizes
    sizes.argtypes = [I, I, I, ctypes.POINTER(ctypes.c_longlong)]
    sizes.restype = None
    err = lib.psn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, sizes, err


def fused_cw_rollout_bwd_cuda(streams: Dict, weights: Dict, dt, sol, cot, solver: str = "euler"):
    """Launch the CUDA backward (one launch walks all steps, one block per
    batch row; a second small kernel sums the blocks' partial weight grads
    in a fixed order). Same contract as :func:`fused_cw_rollout_bwd_plain`,
    float32."""
    solver = normalize_solver(solver)
    check_inputs(streams, weights, sol[0], dt)
    fz, sV = streams["fz"], streams["s_constV"]
    Tm1, B, zd, h = fz.shape
    xd = sol.shape[2]
    for name, a in (("sol", sol), ("cot", cot)):
        if a.device != sV.device or a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {sV.device}, got {a.dtype} on {a.device}")
        if tuple(a.shape) != (Tm1 + 1, B, xd, h):
            raise ValueError(f"{name} must have shape {(Tm1 + 1, B, xd, h)}, got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fn, sizes, err = _launcher()
    layout, total = grad_layout(weights)
    got = (ctypes.c_longlong * 2)()
    sizes(h, xd, zd, got)
    if got[0] != total:
        raise RuntimeError("gradient layout of the CUDA backward and of its wrapper disagree")
    f32 = dict(dtype=torch.float32, device=sV.device)
    g_fz = torch.empty(Tm1, B, zd, h, **f32)
    g_sV = torch.empty(B, h, h, **f32)
    partial = torch.zeros(B, total, **f32)  # one row per block
    g_flat = torch.empty(total, **f32)
    g_x0 = torch.empty(B, xd, h, **f32)
    scratch = torch.empty(B, got[1], **f32)
    wts = transposed_weights(weights)  # must outlive the launch
    with torch.cuda.device(sV.device):
        stream = torch.cuda.current_stream(sV.device).cuda_stream
        rc = fn(fz.data_ptr(), dt.data_ptr(), sV.data_ptr(), sol.data_ptr(), cot.data_ptr(),
                pointer_array(flatten_weights(weights)), pointer_array(wts),
                g_fz.data_ptr(), g_sV.data_ptr(), partial.data_ptr(), g_flat.data_ptr(),
                g_x0.data_ptr(), scratch.data_ptr(), Tm1, B, h, xd, zd, _SOLVER_CODE[solver],
                stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_cw_rollout_bwd kernel launch failed: CUDA error {rc} ({err(rc).decode()})"
        )
    fused_cw_rollout_bwd.launches += 1
    g_list = [g_flat[off:off + math.prod(shape)].view(shape) for off, shape in layout]
    return dict(fz=g_fz, s_constV=g_sV), unflatten_weights(g_list), g_x0


def fused_cw_rollout_bwd(streams: Dict, weights: Dict, dt, sol, cot, solver: str = "euler"):
    """Reverse walk on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors, an error otherwise."""
    dev = streams["s_constV"].device
    if dev.type == "cuda":
        return fused_cw_rollout_bwd_cuda(streams, weights, dt, sol, cot, solver)
    if dev.type == "cpu":
        return fused_cw_rollout_bwd_plain(streams, weights, dt, sol, cot, solver)
    raise ValueError(f"fused_cw_rollout_bwd runs on cuda or cpu tensors, got {dev}")


fused_cw_rollout_bwd.launches = 0


class FusedCwRollout(torch.autograd.Function):
    """The fused channel-wise rollout with its reverse-time backward.

    Forward: :func:`fused_cw_rollout` (the CUDA kernel on the card); it
    saves the solution, nothing per step. Backward:
    :func:`fused_cw_rollout_bwd`, plus ``g_sol[0]`` into ``g_x0``. Weights
    enter as flat tensor arguments (:func:`flatten_weights`); ``dt`` gets
    no gradient.
    """

    @staticmethod
    def forward(ctx, solver, fz, s_constV, x0, dt, *wflat):
        streams = dict(fz=fz, s_constV=s_constV)
        rows = fused_cw_rollout(streams, unflatten_weights(wflat), x0, dt, solver)
        sol = torch.cat([x0[None], rows], dim=0)
        ctx.solver = solver
        ctx.save_for_backward(fz, s_constV, dt, sol, *wflat)
        return sol

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_sol):
        fz, sV, dt, sol, *wflat = ctx.saved_tensors
        g_s, g_w, g_x0 = fused_cw_rollout_bwd(
            dict(fz=fz, s_constV=sV), unflatten_weights(wflat), dt, sol, g_sol.contiguous(),
            ctx.solver,
        )
        return (None, g_s["fz"], g_s["s_constV"], g_x0 + g_sol[0], None, *flatten_weights(g_w))


def fused_cw_rollout_diff(streams: Dict, weights: Dict, x0, dt, solver: str = "euler"):
    """Differentiable fused rollout (the training entry): ``[T, B, xd, h]``
    including the initial row, with gradients to ``fz``, ``s_constV``,
    ``x0`` and every weight through :class:`FusedCwRollout`; ``dt`` gets
    none."""
    return FusedCwRollout.apply(
        normalize_solver(solver), streams["fz"].contiguous(), streams["s_constV"].contiguous(),
        x0.contiguous(), dt.float().contiguous(), *flatten_weights(weights),
    )
