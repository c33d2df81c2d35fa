"""Reverse-time VJP of the fused ODE rollout (counterpart of
``py_psnode_tpu/ops/fused_ode.py``: ``_bwd_kernel`` :171, ``_bwd`` :343 and
the ``jax.custom_vjp`` ``fused_ode_rollout_diff`` :322).

The backward walks the time grid in reverse. At each step it re-evaluates
every stage from the saved state ``x_t = sol[t]`` (the solution is the only
residual the forward keeps), backpropagates the Euler / Midpoint / RK4-3/8
step, and accumulates:

  * the gradients of ``wx_de`` and of every tail weight and bias over all
    batch rows and steps;
  * the per-step cotangent of the layer-1 stream ``g_s_de [T-1, B, h]``,
    which autograd then carries back through the stream precompute;
  * the reverse-time carry ``dL/dx_t``, which ends as ``g_x0``.

``dt`` gets no gradient.

:func:`fused_ode_rollout_bwd` runs the hand-written CUDA backward
``csrc/fused_ode_rollout_bwd.cu`` on CUDA tensors and
:func:`fused_ode_rollout_bwd_plain`, the same walk as an eager PyTorch
loop, on CPU tensors. The CUDA backward is three kernels
(``ops/noencode_bwd.py``): the recompute of every stage at every row-step
at once (:func:`recompute_plain` is its plain version), the reverse walk of
the cotangents, and the contraction of the weight gradients
(:func:`contract_plain`). :class:`FusedOdeRollout` is the
``torch.autograd.Function`` around the forward kernel and this backward.

Not ported: the bf16 compute mode and the TPU's time padding and time
blocking (scheduling that does not change the result).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from py_psnode_tpu_torch.ops.fused_dae import _ONE_THIRD, _SOLVER_CODE, normalize_solver
from py_psnode_tpu_torch.ops.fused_dae_vjp import _tail_bwd, _tail_fwd_res
from py_psnode_tpu_torch.ops.fused_ode import check_inputs, fused_ode_rollout
from py_psnode_tpu_torch.ops.noencode_bwd import STAGES, launch, net_grads_plain, pad_net
from py_psnode_tpu_torch.utils import cuda_build



def flatten_weights(weights: Dict) -> List[torch.Tensor]:
    """``[wx_de, W, b, ...]``: the order of the kernel's gradient row."""
    flat = [weights["wx_de"]]
    for W, b in weights["de_tail"]:
        flat += [W, b]
    return flat


def unflatten_weights(flat) -> Dict:
    return dict(wx_de=flat[0], de_tail=[(flat[k], flat[k + 1]) for k in range(1, len(flat), 2)])


@torch.no_grad()
def fused_ode_rollout_bwd_plain(s_de, weights: Dict, dt, sol, cot, solver: str = "euler"):
    """The reverse walk as an eager PyTorch loop on any device, in the
    inputs' dtype: the plain version of the CUDA kernel.

    Args:
      s_de/weights/dt: the forward's inputs.
      sol: the forward's solution ``[T, B, xd]`` (row 0 is ``x0``).
      cot: cotangent of the solution ``[T, B, xd]``; row 0 is not read.

    Returns ``(g_s_de [T-1, B, h], g_weights, g_x0)``: the weight grads in
    the layout of ``weights``, the carry at t=0 (without ``cot[0]``).
    """
    solver = normalize_solver(solver)
    wx, tail = weights["wx_de"], weights["de_tail"]
    dt_all = dt.to(s_de.dtype)
    z = torch.zeros_like
    g_w = dict(wx_de=z(wx), de_tail=[(z(W), z(b)) for W, b in tail])
    g_s = z(s_de)
    gx = z(sol[0])
    for t in reversed(range(s_de.shape[0])):
        x0, dt = sol[t], dt_all[t]
        gX1 = cot[t + 1] + gx

        def F_fwd(x, t=t):
            out, res = _tail_fwd_res(s_de[t] + x @ wx, tail)
            return out, (x, res)

        def F_bwd(xres, gf):
            """Adds the weight grads; returns (g_x, g_s_de of this stage)."""
            x, res = xres
            gp = _tail_bwd(res, gf, tail, g_w["de_tail"])
            g_w["wx_de"] += x.T @ gp
            return gp @ wx.T, gp

        if solver == "euler":
            _, res = F_fwd(x0)
            g_x, gs_de = F_bwd(res, dt * gX1)
            g_x0 = gX1 + g_x
        elif solver == "midpoint":
            f0, res0 = F_fwd(x0)
            _, res_m = F_fwd(x0 + f0 * (0.5 * dt))
            g_xmid, gp_m = F_bwd(res_m, dt * gX1)
            g_x00, gp_0 = F_bwd(res0, (0.5 * dt) * g_xmid)
            g_x0 = gX1 + g_xmid + g_x00
            gs_de = gp_m + gp_0
        else:  # rk4, Kutta's 3/8 rule; the cotangent order of fused_ode.py:226-264
            k1, res1 = F_fwd(x0)
            k2, res2 = F_fwd(x0 + dt * k1 * _ONE_THIRD)
            k3, res3 = F_fwd(x0 + dt * (k2 - k1 * _ONE_THIRD))
            _, res4 = F_fwd(x0 + dt * (k1 - k2 + k3))
            c = dt * 0.125
            g_k1, g_k2, g_k3, g_k4 = gX1 * c, 3.0 * gX1 * c, 3.0 * gX1 * c, gX1 * c
            g_x0, gs_de = gX1, z(s_de[t])

            g_a4, gp = F_bwd(res4, g_k4)
            g_x0 = g_x0 + g_a4
            g_k1 = g_k1 + dt * g_a4
            g_k2 = g_k2 - dt * g_a4
            g_k3 = g_k3 + dt * g_a4
            gs_de = gs_de + gp

            g_a3, gp = F_bwd(res3, g_k3)
            g_x0 = g_x0 + g_a3
            g_k2 = g_k2 + dt * g_a3
            g_k1 = g_k1 - dt * g_a3 * _ONE_THIRD
            gs_de = gs_de + gp

            g_a2, gp = F_bwd(res2, g_k2)
            g_x0 = g_x0 + g_a2
            g_k1 = g_k1 + dt * g_a2 * _ONE_THIRD
            gs_de = gs_de + gp

            g_a1, gp = F_bwd(res1, g_k1)
            g_x0 = g_x0 + g_a1
            gs_de = gs_de + gp
        g_s[t] = gs_de
        gx = g_x0
    return g_s, g_w, gx


@torch.no_grad()
def recompute_plain(s_de, weights: Dict, dt, sol, solver: str = "euler"):
    """The recompute kernel's buffers as plain PyTorch, in the inputs' dtype:
    ``(res [S, n, R, h], xin [S, R, xd])``, every stage's layer
    pre-activations and input at every row-step ``r = t B + b`` (stages in
    evaluation order; the arguments of :func:`fused_ode_rollout_bwd_plain`)."""
    solver = normalize_solver(solver)
    wx, tail = weights["wx_de"], weights["de_tail"]
    Tm1, B, h = s_de.shape
    xd, R, S = sol.shape[-1], Tm1 * B, STAGES[solver]
    x, s = sol[:-1].reshape(R, xd), s_de.reshape(R, h)
    dtr = dt.reshape(R, 1).to(s_de.dtype)
    res = s_de.new_zeros(S, len(tail), R, h)
    xin = s_de.new_zeros(S, R, xd)

    def f(q, xq):
        xin[q] = xq
        y, (pres, _) = _tail_fwd_res(s + xq @ wx, tail)
        for l, p in enumerate(pres):
            res[q, l] = p
        return y

    k1 = f(0, x)
    if solver == "midpoint":
        f(1, x + k1 * (0.5 * dtr))
    elif solver == "rk4":
        k2 = f(1, x + dtr * k1 * _ONE_THIRD)
        k3 = f(2, x + dtr * (k2 - k1 * _ONE_THIRD))
        f(3, x + dtr * (k1 - k2 + k3))
    return res, xin


def contract_plain(res, gres, gy, xin, n_tail: int, xd: int) -> Dict:
    """The contraction kernel's plain version: the weight gradients, in the
    layout of ``weights``, from the buffers ``res/gres [S, n, R, h]``, ``gy
    [S, R, xd]`` and ``xin [S, R, xd]``."""
    first, tail = net_grads_plain(res, gres, gy, xin, range(res.shape[0]), xd, n_tail, xd)
    return dict(wx_de=first, de_tail=tail)


def grad_layout(weights: Dict) -> Tuple[List[Tuple[int, Tuple[int, ...]]], int]:
    """``([(offset, shape), ...], total)``: where each gradient lies in the
    kernel's flat gradient row, in :func:`flatten_weights` order."""
    out, off = [], 0
    for a in flatten_weights(weights):
        out.append((off, tuple(a.shape)))
        off += math.prod(a.shape)
    return out, off


def bind_rollout_bwd(lib: ctypes.CDLL):
    """``(backward, sizes, error string)``: the C functions of a build of
    ``csrc/fused_ode_rollout_bwd.cu`` (for the card or, in
    ``utils/host_build.py``, the host) with their signatures."""
    fn = lib.psn_fused_ode_rollout_bwd_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [
        P, P, P, P,  # s_de, dt, sol, cot
        P, P, I,  # padded weights, padded biases, tail layers
        P, P, P,  # g_s_de, g_w, g_x0
        P, P, P, P, P,  # res, gres, gy, xin, parts (scratch)
        I, I, I, I,  # Tm1, B, h, xd
        I, I, I,  # solver, stages, resident weight slots (-1: as many as fit)
        P,  # stream
    ]
    fn.restype = ctypes.c_int
    sizes = lib.psn_fused_ode_bwd_sizes
    sizes.argtypes = [I] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    sizes.restype = None
    err = lib.psn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, sizes, err


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launcher of ``csrc/fused_ode_rollout_bwd.cu`` (:func:`bind_rollout_bwd`)."""
    return bind_rollout_bwd(cuda_build.load("fused_ode_rollout_bwd"))


def bwd_sizes(sizes, Tm1, B, h, xd, n_tail, solver) -> Tuple[int, ...]:
    """``(g_w, res, gy, xin, parts)`` floats at these shapes and the padded
    width H of the weights (:func:`noencode_bwd.pad_net`), from the C
    function ``sizes`` of :func:`bind_rollout_bwd`."""
    got = (ctypes.c_longlong * 6)()
    sizes(Tm1, B, h, xd, n_tail, _SOLVER_CODE[solver], got)
    return tuple(got)


def fused_ode_rollout_bwd_cuda(s_de, weights: Dict, dt, sol, cot, solver: str = "euler"):
    """Launch the CUDA backward: the recompute of every stage of every
    row-step, the reverse walk (one block per batch row), and the
    contraction of the weight gradients (in a fixed order: bit-identical on
    relaunch). Same contract as :func:`fused_ode_rollout_bwd_plain`,
    float32, every width (above 128 the wide kernels). Scratch: the
    residual and cotangent buffers, ``2 S n (T-1) B h`` floats and a little
    more (0.8 GB at B=64, T=1001, RK4, h=128), live until the call
    returns."""
    out, _ = _launch_bwd(s_de, weights, dt, sol, cot, solver)
    fused_ode_rollout_bwd.launches += 1
    return out


def _launch_bwd(s_de, weights: Dict, dt, sol, cot, solver: str, launcher=None, stages: int = 7,
                bufs: Optional[Dict] = None, host: bool = False, slots: int = -1):
    """Launch the backward's kernels ``stages`` (1 the recompute, 2 the
    walk, 4 the contraction) through ``launcher`` (of
    :func:`bind_rollout_bwd`; the default build when None), on the buffers
    ``bufs`` (flat ``res``, ``gres``, ``gy``, ``xin``, ``parts``; new ones
    when None); ``host``: a host build on CPU tensors
    (``utils/host_build.py``); ``slots``: at most this many of the walk's
    hidden weights resident in shared memory (-1: as many as fit). Returns
    ``((g_s_de, g_weights, g_x0), bufs)``; the outputs of kernels not
    launched are left unset. Counts nothing:
    :func:`fused_ode_rollout_bwd_cuda` is the entry; the smoke times one
    kernel at a time, the tests run the contraction on given buffers, the
    phase clock its own build."""
    solver = normalize_solver(solver)
    check_inputs(s_de, weights, sol[0], dt, "cpu" if host else "cuda")
    Tm1, B, h = s_de.shape
    xd = sol.shape[-1]
    for name, a in (("sol", sol), ("cot", cot)):
        if a.device != s_de.device or a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {s_de.device}, got {a.dtype} on {a.device}")
        if tuple(a.shape) != (Tm1 + 1, B, xd):
            raise ValueError(f"{name} must have shape {(Tm1 + 1, B, xd)}, got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fn, sizes, err = launcher or _launcher()
    layout, total = grad_layout(weights)
    tail = weights["de_tail"]
    n_w, n_res, n_gy, n_xin, n_parts, H = bwd_sizes(sizes, Tm1, B, h, xd, len(tail), solver)
    if n_w != total:
        raise RuntimeError("gradient layout of the CUDA backward and of its wrapper disagree")
    f32 = dict(dtype=torch.float32, device=s_de.device)
    if bufs is None:
        bufs = dict(res=torch.empty(n_res, **f32), gres=torch.empty(n_res, **f32),
                    gy=torch.empty(n_gy, **f32), xin=torch.empty(n_xin, **f32))
    bufs.setdefault("parts", torch.empty(n_parts, **f32))
    g_s = torch.empty(Tm1, B, h, **f32)
    g_flat = torch.empty(total, **f32)
    g_x0 = torch.empty(B, xd, **f32)
    w, b = pad_net(weights["wx_de"], tail, H)  # must outlive the launch
    rc = launch(
        fn, s_de.device, s_de.data_ptr(), dt.data_ptr(), sol.data_ptr(), cot.data_ptr(),
        w.data_ptr(), b.data_ptr(), len(tail), g_s.data_ptr(), g_flat.data_ptr(), g_x0.data_ptr(),
        *(bufs[k].data_ptr() for k in ("res", "gres", "gy", "xin", "parts")),
        Tm1, B, h, xd, _SOLVER_CODE[solver], stages, slots,
    )
    if rc != 0:
        raise RuntimeError(
            f"fused_ode_rollout_bwd kernel launch failed: CUDA error {rc} ({err(rc).decode()})"
        )
    g_list = [g_flat[off : off + math.prod(shape)].view(shape) for off, shape in layout]
    return (g_s, unflatten_weights(g_list), g_x0), bufs


def fused_ode_rollout_bwd(s_de, weights: Dict, dt, sol, cot, solver: str = "euler"):
    """Reverse walk on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors, an error otherwise."""
    dev = s_de.device
    if dev.type == "cuda":
        return fused_ode_rollout_bwd_cuda(s_de, weights, dt, sol, cot, solver)
    if dev.type == "cpu":
        return fused_ode_rollout_bwd_plain(s_de, weights, dt, sol, cot, solver)
    raise ValueError(f"fused_ode_rollout_bwd runs on cuda or cpu tensors, got {dev}")


fused_ode_rollout_bwd.launches = 0


class FusedOdeRollout(torch.autograd.Function):
    """The fused ODE rollout with its reverse-time backward.

    Forward: the forward rollout (the CUDA kernel on the card); it saves
    the solution, nothing per step. Backward: :func:`fused_ode_rollout_bwd`,
    plus ``g_sol[0]`` into ``g_x0`` (the solution's first row is ``x0``).
    Weights enter as flat tensor arguments (:func:`flatten_weights`); ``dt``
    gets no gradient.
    """

    @staticmethod
    def forward(ctx, solver, s_de, x0, dt, *wflat):
        rows = fused_ode_rollout(s_de, unflatten_weights(wflat), x0, dt, solver)
        sol = torch.cat([x0[None], rows], dim=0)
        ctx.solver = solver
        ctx.save_for_backward(s_de, dt, sol, *wflat)
        return sol

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_sol):
        s_de, dt, sol, *wflat = ctx.saved_tensors
        g_s, g_w, g_x0 = fused_ode_rollout_bwd(
            s_de, unflatten_weights(wflat), dt, sol, g_sol.contiguous(), ctx.solver
        )
        return (None, g_s, g_x0 + g_sol[0], None, *flatten_weights(g_w))


def fused_ode_rollout_diff(s_de, weights: Dict, x0, dt, solver: str = "euler"):
    """Differentiable fused rollout (the training entry): ``[T, B, xd]``
    including the initial row, with gradients to ``s_de``, ``weights`` and
    ``x0`` through :class:`FusedOdeRollout`; ``dt`` gets none."""
    return FusedOdeRollout.apply(
        normalize_solver(solver), s_de.contiguous(), x0.contiguous(),
        dt.float().contiguous(), *flatten_weights(weights),
    )
