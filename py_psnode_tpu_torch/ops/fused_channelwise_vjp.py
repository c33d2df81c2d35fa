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

The per-channel nets' weight and bias gradients are sums of rank-one terms
``u^T v`` (a layer's input and its output's cotangent, per channel). The
CUDA walk writes each stage's four (u, v) pairs out (:func:`channel_pairs_plain`
computes the same pairs) and a second kernel contracts them over all
(T-1)·S·B rows after the walk (:func:`contract_channel_pairs_plain` is its
plain version).

:func:`fused_cw_rollout_bwd` runs the hand-written CUDA kernel
``csrc/fused_cw_rollout_bwd.cu`` on CUDA tensors and
:func:`fused_cw_rollout_bwd_plain` on CPU tensors. The plain walk
recomputes one step at a time and takes that step's VJP with autograd, so
its memory is one step's, at any T.

The bf16 compute mode (bfloat16 2-D weights, ``fused_channelwise.cast_cw``;
JAX ``_vjp_fwd`` :551-555 and ``_cw_bwd_eval``'s ``_dot_t`` / ``_dot_nt``
with ``cd`` bfloat16): :class:`FusedCwRollout` casts once in its forward
and keeps the cast weights for the backward, which recomputes what the
forward computed. Every cotangent product rounds its cotangent, every
weight-gradient product both operands (``fused_channelwise.RoundedProduct``
in the plain walk), while each ``elu'`` reads the float32 pre-activation;
the (u, v) pairs are the float32 values, which the contraction rounds as it
multiplies them (its bias sums of the float32 v); ``g_s_constV``, ``g_fz``,
``g_x0`` and every gradient are float32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from py_psnode_tpu_torch.ops.fused_channelwise import (
    MAX_HIDDEN_BWD,
    _round,
    cast_cw,
    check_inputs,
    check_width,
    cw_eval,
    flatten_weights,
    fused_cw_rollout,
    is_bf16_weights,
    kernel_weights,
    unflatten_weights,
    work_weights,
)
from py_psnode_tpu_torch.ops.fused_dae import _SOLVER_CODE, is_bf16, normalize_solver
from py_psnode_tpu_torch.ops.fused_ode import _step_fwd, pointer_array
from py_psnode_tpu_torch.utils import cuda_build


def fused_cw_rollout_bwd_plain(streams: Dict, weights: Dict, dt, sol, cot, solver: str = "euler"):
    """The reverse walk in PyTorch on any device, in the inputs' dtype
    (float32 or float64): the plain version of the CUDA kernel, in the bf16
    compute mode where ``weights`` are bfloat16 (its gradients then in the
    inputs' dtype, not bfloat16).

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
    bf16 = is_bf16_weights(weights)
    flat = [w.detach() for w in flatten_weights(work_weights(weights, sV.dtype))]
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
            x1 = _step_fwd(lambda xx: cw_eval(xx, fz_t, sV_t, wd, bf16=bf16), x0, dt_all[t], solver)
            grads = torch.autograd.grad(x1, [x0, fz_t, sV_t, *w_t], cot[t + 1] + gx)
        gx, g_fz[t] = grads[0], grads[1]
        g_sV += grads[2]
        for acc, g in zip(g_w, grads[3:]):
            acc += g
    return dict(fz=g_fz, s_constV=g_sV), unflatten_weights(g_w), gx


def channel_pairs_plain(streams: Dict, weights: Dict, dt, sol, cot, solver: str = "euler"):
    """The per-channel layers' (u, v) pairs of the reverse walk, as the CUDA
    walk writes them: ``[T-1, S, B, 4, 2, xd, h]``, the stages in the order
    their VJPs are taken (the reverse of their evaluation), the four layers
    in the order head W1, head W0, ext W1, ext W0, ``u`` the layer's input
    and ``v`` the cotangent of its pre-activation output, both as computed
    (in the bf16 compute mode the contraction rounds them). Same arguments
    as :func:`fused_cw_rollout_bwd_plain`; recomputes each step and takes
    its VJP with autograd."""
    solver = normalize_solver(solver)
    fz, sV = streams["fz"], streams["s_constV"]
    bf16 = is_bf16_weights(weights)
    w = unflatten_weights([a.detach() for a in flatten_weights(work_weights(weights, sV.dtype))])
    dt_all = dt.to(sV.dtype)[..., None]  # [T-1, B, 1, 1]
    gx = torch.zeros_like(sol[0])
    steps = []
    for t in reversed(range(fz.shape[0])):
        rec = []  # per evaluation, its four (u, pre-activation output) pairs
        with torch.enable_grad():
            x0 = sol[t].detach().requires_grad_()
            x1 = _step_fwd(lambda xx: cw_eval(xx, fz[t], sV, w, rec, bf16), x0, dt_all[t], solver)
            outs = [o for ev in rec for _, o in ev]
            grads = torch.autograd.grad(x1, [x0, *outs], cot[t + 1] + gx)
        gx, v = grads[0], iter(grads[1:])
        stages = [torch.stack([torch.stack([u.detach(), next(v)]) for u, _ in ev]) for ev in rec]
        # [S, 4, 2, B, xd, h] in evaluation order -> [S, B, 4, 2, xd, h] in VJP order
        steps.append(torch.stack(stages[::-1]).permute(0, 3, 1, 2, 4, 5))
    return torch.stack(steps[::-1])


def contract_channel_pairs_plain(pairs, bf16: bool = False):
    """``(dW [4, xd, h, h], db [4, xd, h])``: the sums over every row of
    ``pairs [..., 4, 2, xd, h]`` of ``u^T v`` and ``v`` per layer and
    channel, in the pairs' dtype and device, as an eager loop of outer
    products 256 rows at a time: the plain version of the CUDA
    contraction. ``bf16``: the bf16 compute mode's, ``u^T v`` of u and v
    rounded to bf16, ``v``'s sums as it is."""
    *_, P, _, xd, h = pairs.shape
    rows = pairs.reshape(-1, P, 2, xd, h)
    dW = rows.new_zeros(P, xd, h, h)
    db = rows.new_zeros(P, xd, h)
    rnd = _round if bf16 else (lambda a: a)
    for r0 in range(0, rows.shape[0], 256):
        u, v = rows[r0:r0 + 256, :, 0], rows[r0:r0 + 256, :, 1]
        dW += (rnd(u)[..., :, None] * rnd(v)[..., None, :]).sum(0)
        db += v.sum(0)
    return dW, db


def transposed_weights(weights: Dict) -> List[torch.Tensor]:
    """``[W1^T, W2^T, ext w0^T, ext w1^T, head w0^T, head w1^T]`` (the
    per-channel stacks transposed per channel) in float32 (the bf16 compute
    mode's widened exactly): the backward kernel's cotangent products read
    these, so that neighbouring threads read neighbouring addresses."""
    (W1, _), (W2, _), _ = weights["vert"]
    t = lambda w: w.transpose(-1, -2).float().contiguous()
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


def bind_rollout_bwd(lib: ctypes.CDLL, bf16: bool = False):
    """``(walk, sizes, contraction, error string)``: the C functions of a
    build of ``csrc/fused_cw_rollout_bwd.cu`` (for the card or, in
    ``utils/host_build.py``, the host) with their signatures, the walk and
    the contraction those of the bf16 compute mode where ``bf16`` (the build
    with ``cuda_build.BF16_DEFINE``)."""
    mode = "bf16" if bf16 else "f32"
    fn = getattr(lib, f"psn_fused_cw_rollout_bwd_{mode}")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    PP = ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = [
        P, P, P, P, P,  # fz, dt, s_constV, sol, cot
        PP, PP,  # the 15 weights (flatten_weights order), the 6 transposes
        P, P, P, P, P,  # g_fz, g_s_constV, partial, g_w, g_x0
        P, P, P,  # pairs, parts, the wide walk's tiles (scratch)
        I, I, I, I, I,  # Tm1, B, h, xd, zd
        I, I,  # solver, cluster (blocks per row; 0: the launcher picks)
        P,  # stream
    ]
    fn.restype = ctypes.c_int
    sizes = lib.psn_fused_cw_bwd_sizes
    sizes.argtypes = [I, I, I, I, I, I, ctypes.POINTER(L)]
    sizes.restype = None
    contract = getattr(lib, f"psn_cw_contract_pairs_{mode}")
    contract.argtypes = [P, L, I, I, P, P, P]  # pairs, rows, h, xd, parts, out, stream
    contract.restype = ctypes.c_int
    err = lib.psn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, sizes, contract, err


@functools.lru_cache(maxsize=None)
def _launcher(bf16: bool = False):
    """The C launchers of ``csrc/fused_cw_rollout_bwd.cu`` in the compute
    mode of ``bf16``, with their signatures (:func:`bind_rollout_bwd`)."""
    return bind_rollout_bwd(cuda_build.load("fused_cw_rollout_bwd", bf16), bf16)


def bwd_sizes(sizes, Tm1, B, h, xd, zd, solver) -> Tuple[int, int, int, int, int]:
    """``(g_w floats, dense partial row floats, pairs floats, parts
    floats, tiles floats)`` of the backward at these shapes, from the C
    function ``sizes`` of :func:`bind_rollout_bwd` (tiles: the wide walk's
    scratch above h=128, else 0)."""
    got = (ctypes.c_longlong * 5)()
    sizes(Tm1, B, h, xd, zd, _SOLVER_CODE[solver], got)
    return tuple(got)


def _launch_bwd(streams: Dict, weights: Dict, dt, sol, cot, solver: str, cluster: int,
                launcher=None, bufs: Optional[Dict] = None):
    """Launch the backward through ``launcher`` (of :func:`bind_rollout_bwd`;
    the default build of the inputs' compute mode when None) with
    ``cluster`` blocks per row (0: the launcher's choice); ``bufs``, a dict
    where given, receives the walk's (u, v) pairs as ``bufs["pairs"]``
    ``[T-1, S, B, 4, 2, xd, h]`` (``channel_pairs_plain``'s layout). Counts
    nothing: :func:`fused_cw_rollout_bwd_cuda` is the entry, and a fixed
    cluster is for timing one choice against another."""
    solver = normalize_solver(solver)
    bf16 = check_inputs(streams, weights, sol[0], dt, backward=True)
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
    fn, sizes, _, err = launcher or _launcher(bf16)
    layout, total = grad_layout(weights)
    n_w, n_dense, n_pairs, n_parts, n_tiles = bwd_sizes(sizes, Tm1, B, h, xd, zd, solver)
    if n_w != total:
        raise RuntimeError("gradient layout of the CUDA backward and of its wrapper disagree")
    f32 = dict(dtype=torch.float32, device=sV.device)
    g_fz = torch.empty(Tm1, B, zd, h, **f32)
    g_sV = torch.empty(B, h, h, **f32)
    partial = torch.zeros(B, n_dense, **f32)  # one row per block
    g_flat = torch.empty(total, **f32)
    g_x0 = torch.empty(B, xd, h, **f32)
    pairs = torch.empty(n_pairs, **f32)
    parts = torch.empty(n_parts, **f32)
    tiles = torch.empty(max(1, n_tiles), **f32)
    wk, wts = kernel_weights(weights), transposed_weights(weights)  # must outlive the launch
    with torch.cuda.device(sV.device):
        stream = torch.cuda.current_stream(sV.device).cuda_stream
        rc = fn(fz.data_ptr(), dt.data_ptr(), sV.data_ptr(), sol.data_ptr(), cot.data_ptr(),
                pointer_array(wk), pointer_array(wts),
                g_fz.data_ptr(), g_sV.data_ptr(), partial.data_ptr(), g_flat.data_ptr(),
                g_x0.data_ptr(), pairs.data_ptr(), parts.data_ptr(), tiles.data_ptr(), Tm1, B, h, xd,
                zd, _SOLVER_CODE[solver], cluster, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_cw_rollout_bwd kernel launch failed: CUDA error {rc} ({err(rc).decode()})"
        )
    if bufs is not None:
        bufs["pairs"] = pairs.view(Tm1, -1, B, 4, 2, xd, h)
    g_list = [g_flat[off:off + math.prod(shape)].view(shape) for off, shape in layout]
    return dict(fz=g_fz, s_constV=g_sV), unflatten_weights(g_list), g_x0


def fused_cw_rollout_bwd_cuda(streams: Dict, weights: Dict, dt, sol, cot, solver: str = "euler"):
    """Launch the CUDA backward: the reverse walk (one launch walks all
    steps, a cluster of blocks per batch row chosen as for
    :func:`fused_cw_rollout_cuda`), the fixed-order sum of the rows' dense
    partial gradients, and the contraction of the per-channel pairs. Same
    contract as :func:`fused_cw_rollout_bwd_plain`, float32. Scratch: the
    pairs buffer of ``(T-1) S B 8 xd h`` floats (2.1 GB at B=64, RK4, xd=2,
    h=128) and, above h=128, the wide walk's tiles (``2 B hp^2`` floats,
    ``hp`` = h rounded up to 128) live until the launch ends. bfloat16 2-D
    weights: the bf16 compute mode (float32 gradients)."""
    out = _launch_bwd(streams, weights, dt, sol, cot, solver, 0)
    fused_cw_rollout_bwd.launches += 1
    return out


def contract_channel_pairs_cuda(pairs, bf16: bool = False):
    """Launch the CUDA contraction alone (``bf16``: the bf16 compute
    mode's) on ``pairs [..., 4, 2, xd, h]`` (float32, contiguous, on the
    card); returns ``(dW, db)`` as :func:`contract_channel_pairs_plain`
    does. The backward launches the same kernels on its own pairs
    buffer."""
    if pairs.device.type != "cuda" or pairs.dtype != torch.float32 or not pairs.is_contiguous():
        raise ValueError(f"pairs must be contiguous float32 on a CUDA device, got {pairs.dtype} on "
                         f"{pairs.device}")
    *_, P, two, xd, h = pairs.shape
    if (P, two) != (4, 2):
        raise ValueError(f"pairs must be [..., 4, 2, xd, h <= {MAX_HIDDEN_BWD}], got {tuple(pairs.shape)}")
    check_width(h, backward=True)
    rows = pairs.numel() // (8 * xd * h)
    _, sizes, contract, err = _launcher(bf16)
    n_parts = bwd_sizes(sizes, rows, 1, h, xd, 1, "euler")[3]
    parts = torch.empty(n_parts, dtype=torch.float32, device=pairs.device)
    out = torch.empty(4 * xd * h * (h + 1), dtype=torch.float32, device=pairs.device)
    with torch.cuda.device(pairs.device):
        stream = torch.cuda.current_stream(pairs.device).cuda_stream
        rc = contract(pairs.data_ptr(), rows, h, xd, parts.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"cw pair contraction launch failed: CUDA error {rc} ({err(rc).decode()})")
    contract_channel_pairs_cuda.launches += 1
    n = 4 * xd * h * h
    return out[:n].view(4, xd, h, h), out[n:].view(4, xd, h)


contract_channel_pairs_cuda.launches = 0


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

    Forward: :func:`fused_cw_rollout` (the CUDA kernel on the card) in the
    compute mode of ``precision`` (``fused_channelwise.cast_cw``); it saves
    the weights as the kernels read them (the 2-D ones bfloat16 in the bf16
    mode) and the solution, nothing per step. Backward:
    :func:`fused_cw_rollout_bwd`, plus ``g_sol[0]`` into ``g_x0``, its
    float32 gradients to the float32 inputs. Weights enter as flat tensor
    arguments (:func:`flatten_weights`); ``dt`` gets no gradient.
    """

    @staticmethod
    def forward(ctx, solver, precision, fz, s_constV, x0, dt, *wflat):
        streams, weights = cast_cw(dict(fz=fz, s_constV=s_constV), unflatten_weights(wflat), precision)
        rows = fused_cw_rollout(streams, weights, x0, dt, solver)
        sol = torch.cat([x0[None], rows], dim=0)
        ctx.solver = solver
        ctx.save_for_backward(fz, s_constV, dt, sol, *flatten_weights(weights))
        return sol

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_sol):
        fz, sV, dt, sol, *wflat = ctx.saved_tensors
        g_s, g_w, g_x0 = fused_cw_rollout_bwd(
            dict(fz=fz, s_constV=sV), unflatten_weights(wflat), dt, sol, g_sol.contiguous(),
            ctx.solver,
        )
        return (None, None, g_s["fz"], g_s["s_constV"], g_x0 + g_sol[0], None, *flatten_weights(g_w))


def fused_cw_rollout_diff(streams: Dict, weights: Dict, x0, dt, solver: str = "euler",
                          precision: str = "default"):
    """Differentiable fused rollout (the training entry): ``[T, B, xd, h]``
    including the initial row, with gradients (float32, also in the bf16
    compute mode of ``precision``) to ``fz``, ``s_constV``, ``x0`` and every
    weight through :class:`FusedCwRollout`; ``dt`` gets none."""
    is_bf16(precision)  # an unknown precision raises here
    return FusedCwRollout.apply(
        normalize_solver(solver), precision, streams["fz"].contiguous(), streams["s_constV"].contiguous(),
        x0.contiguous(), dt.float().contiguous(), *flatten_weights(weights),
    )
