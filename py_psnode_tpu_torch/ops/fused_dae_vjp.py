"""Reverse-time VJP of the fused DAE rollout (counterpart of
``py_psnode_tpu/ops/fused_dae_vjp.py``).

The backward walks the time grid in reverse, recomputing each step's
activations from the saved packed solution (the only residual the forward
keeps), and accumulates:

  * every weight and bias gradient over all batch rows and steps;
  * the per-step cotangents of the precomputed layer-1 streams
    (``g_s_de``/``g_s_ae``/``g_s_ae_ev``), which autograd then carries back
    through the stream precompute's large matrix products;
  * the reverse-time carries ``dL/dx_t`` and ``dL/di_t`` (the lagged
    algebraic coupling makes ``i_t`` a second adjoint state).

Event steps are handled as in the forward: the algebraic recompute is
re-evaluated and its VJP routes the ``i_in`` cotangent of event rows into
the ``x_t``/stream/weight gradients instead of the ``i_t`` carry. ``dt``
and ``ev`` get no gradient.

:func:`fused_dae_rollout_bwd` runs the hand-written CUDA backward
``csrc/fused_dae_rollout_bwd.cu`` on CUDA tensors and
:func:`fused_dae_rollout_bwd_plain`, the same walk as an eager PyTorch
loop, on CPU tensors. The CUDA backward is three kernels
(``ops/noencode_bwd.py``): the recompute of every evaluation at every
row-step at once (:func:`recompute_plain` is its plain version), the
reverse walk of the cotangents, and the contraction of the weight
gradients (:func:`contract_plain`). :class:`FusedDaeRollout` is the
``torch.autograd.Function`` around the forward kernel and this backward.

Teacher forcing of ``x`` (``x_true``, the JAX package's ``tf_x``): the
stages start from ``x_true[t]`` and the AE at t+1 reads ``x_true[t+1]``,
so the stages' x cotangent goes to ``g_xt[t]`` and the AE's to
``g_xt1[t]`` (the cotangents of the two read points) instead of the x
carry, which then carries only the event recompute's part; the
contraction's first-layer operand is the true state except at the event.
:class:`FusedDaeTfxRollout` wraps that mode; it computes ``g_xt``/``g_xt1``
only where autograd asks for ``x_true``'s gradient.

The bf16 compute mode (``precision="bfloat16"``): :class:`FusedDaeRollout`
rounds the streams and the 2-D weights to bfloat16 inside its forward and
keeps those rounded tensors for the backward, which recomputes exactly what
the forward computed (JAX ``_vjp_forward`` :596-625); every product rounds
its activation or cotangent (``dot``), every weight-gradient product both
operands (``dot_t``), and the stream cotangents and every gradient stay
float32, flowing back to the float32 originals. Under teacher forcing of
``x`` (:class:`FusedDaeTfxRollout`) the true states stay float32, rounded
where a product reads them, and their cotangents are float32.

Not ported: the TPU's time padding, time blocking, ``any_ev`` scalar
prefetch and lanes (scheduling that does not change the result).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from py_psnode_tpu_torch.models.funcs import elu
from py_psnode_tpu_torch.ops.fused_dae import (
    _ONE_THIRD,
    _SOLVER_CODE,
    _check_kernel_inputs,
    cast_compute,
    fused_dae_rollout_packed,
    is_bf16,
    normalize_solver,
    pack_aux,
    unpack_solution,
)
from py_psnode_tpu_torch.ops.noencode_bwd import (
    STAGES,
    dot,
    dot_t,
    launch,
    net_grads_plain,
    pad_net,
    work_dtype,
)
from py_psnode_tpu_torch.utils import cuda_build



def delu(p: torch.Tensor) -> torch.Tensor:
    """ELU'(p): 1 for p > 0, exp(p) for p <= 0."""
    return torch.where(p > 0, 1.0, torch.exp(torch.clamp(p, max=0.0)))


def flatten_weights(weights: Dict):
    """``[wx_de, wi_de, gx_ae, W, b, ... (DE tail), W, b, ... (AE tail)]``
    and ``(n_de, n_ae)``: the order of the kernel's gradient row."""
    flat = [weights["wx_de"], weights["wi_de"], weights["gx_ae"]]
    for net in ("de_tail", "ae_tail"):
        for W, b in weights[net]:
            flat += [W, b]
    return flat, (len(weights["de_tail"]), len(weights["ae_tail"]))


def unflatten_weights(flat, n_tails) -> Dict:
    n_de, _ = n_tails
    pairs = lambda seq: [(seq[2 * k], seq[2 * k + 1]) for k in range(len(seq) // 2)]
    return dict(
        wx_de=flat[0], wi_de=flat[1], gx_ae=flat[2],
        de_tail=pairs(flat[3 : 3 + 2 * n_de]), ae_tail=pairs(flat[3 + 2 * n_de :]),
    )


def _tail_fwd_res(h1pre, tail):
    """Forward through the tail layers keeping the pre-activations and
    activations for the VJP."""
    pres, h = [h1pre], elu(h1pre)
    hs = [h]
    for W, b in tail[:-1]:
        pre = dot(h, W) + b
        pres.append(pre)
        h = elu(pre)
        hs.append(h)
    W, b = tail[-1]
    return dot(h, W) + b, (pres, hs)


def _tail_bwd(res, gy, tail, d_tail):
    """Backprop the tail, adding the weight/bias grads into ``d_tail`` in
    place; returns the cotangent of the first-layer pre-activation. The
    bf16 compute mode rides the weights' dtype (JAX ``_tail_bwd``
    ``cdtype``)."""
    pres, hs = res
    cd = tail[-1][0].dtype
    d_tail[-1][0].add_(dot_t(hs[-1], gy, cd))
    d_tail[-1][1].add_(gy.sum(0))
    g = dot(gy, tail[-1][0].T)
    for k in range(len(tail) - 2, -1, -1):
        gpre = g * delu(pres[k + 1])
        d_tail[k][0].add_(dot_t(hs[k], gpre, cd))
        d_tail[k][1].add_(gpre.sum(0))
        g = dot(gpre, tail[k][0].T)
    return g * delu(pres[0])


@torch.no_grad()
def fused_dae_rollout_bwd_plain(
    streams: Dict, weights: Dict, x0, i0, aux, packed, cot, solver: str = "rk4", x_true=None,
    g_true: bool = False,
):
    """The reverse walk as an eager PyTorch loop on any device, in the
    inputs' dtype (float32 for the bf16 compute mode's bfloat16 streams
    and weights): the plain version of the CUDA kernel.

    Args:
      streams/weights/x0/i0/aux: the forward's inputs (``aux`` from
        :func:`~py_psnode_tpu_torch.ops.fused_dae.pack_aux`).
      packed: the forward's packed solution ``[T-1, B, xd+id]``.
      cot: cotangents of the full solutions, ``cat(g_xsol, g_isol)`` as
        ``[T, B, xd+id]``; row 0 is not read.
      x_true: ``[T, B, xd]``, the forward's teacher-forced true states.
      g_true: also return the cotangents of the true states' two read
        points (needs ``x_true``).

    Returns ``(g_streams, g_weights, g_x0, g_i0)``: the stream cotangents
    ``[T-1, B, h]``, the weight grads in the layout of ``weights``, and
    the carries at t=0 (without ``cot[0]``); with ``g_true`` a fifth
    element ``(g_xt, g_xt1)``, each ``[T-1, B, xd]``: of ``x_true[t]``
    (the stages' start) and of ``x_true[t+1]`` (the AE at t+1) at step t.
    """
    tf = x_true is not None
    if g_true and not tf:
        raise ValueError("g_true needs x_true")
    solver = normalize_solver(solver)
    s_de, s_ae, s_ae_ev = streams["s_de"], streams["s_ae"], streams["s_ae_ev"]
    wx, wi, gx = weights["wx_de"], weights["wi_de"], weights["gx_ae"]
    de_tail, ae_tail = weights["de_tail"], weights["ae_tail"]
    Tm1 = s_de.shape[0]
    xd = x0.shape[-1]
    wd, cd = work_dtype(s_de), wx.dtype
    dt_all = aux[..., 0:1].to(wd)
    ev_all = aux[..., 1:2] > 0.0
    any_ev = ev_all.any(dim=1)[:, 0].tolist()  # one host read for all steps
    z = lambda a: torch.zeros_like(a, dtype=wd)
    g_w = dict(
        wx_de=z(wx), wi_de=z(wi), gx_ae=z(gx),
        de_tail=[(z(W), z(b)) for W, b in de_tail],
        ae_tail=[(z(W), z(b)) for W, b in ae_tail],
    )
    g_s = {k: z(v) for k, v in streams.items()}
    gx_c, gi_c = z(x0), z(i0)
    g_xt = g_xt1 = None
    if g_true:
        g_xt, g_xt1 = x0.new_zeros(Tm1, *x0.shape), x0.new_zeros(Tm1, *x0.shape)
    for t in reversed(range(Tm1)):
        x_t, i_t = (x0, i0) if t == 0 else (packed[t - 1, :, :xd], packed[t - 1, :, xd:])
        # the AE at t+1 and the stages read the true states under teacher
        # forcing; the event recompute reads the rolled x_t
        x1 = x_true[t + 1] if tf else packed[t, :, :xd]
        x_s = x_true[t] if tf else x_t
        dt, ev = dt_all[t], ev_all[t]
        gX1 = cot[t + 1, :, :xd] + gx_c
        gI1 = cot[t + 1, :, xd:] + gi_c

        # i_in exactly as the forward computed it
        i_in = i_t
        if any_ev[t]:
            i_ev, res_ev = _tail_fwd_res(s_ae_ev[t] + dot(x_t, gx), ae_tail)
            i_in = torch.where(ev, i_ev, i_t)
        i_proj = dot(i_in, wi)

        # AE at t+1: i_{t+1} = AE(x_{t+1}; s_ae[t])
        _, res_ae = _tail_fwd_res(s_ae[t] + dot(x1, gx), ae_tail)
        gp_ae = _tail_bwd(res_ae, gI1, ae_tail, g_w["ae_tail"])
        g_w["gx_ae"] += dot_t(x1, gp_ae, cd)
        g_s["s_ae"][t] = gp_ae
        if not tf:
            gX1 = gX1 + dot(gp_ae, gx.T)
        elif g_true:
            g_xt1[t] = dot(gp_ae, gx.T)

        def F_fwd(x, t=t, i_proj=i_proj):
            out, res = _tail_fwd_res(s_de[t] + dot(x, wx) + i_proj, de_tail)
            return out, (x, res)

        def F_bwd(xres, gf, i_in=i_in):
            """Adds the DE weight grads; returns (g_x, g_i_in, g_s_de)."""
            x, res = xres
            gp = _tail_bwd(res, gf, de_tail, g_w["de_tail"])
            g_w["wx_de"] += dot_t(x, gp, cd)
            g_w["wi_de"] += dot_t(i_in, gp, cd)
            return dot(gp, wx.T), dot(gp, wi.T), gp

        if solver == "euler":
            _, res = F_fwd(x_s)
            g_x, g_i_in, gs_de = F_bwd(res, dt * gX1)
            g_x0 = gX1 + g_x
        elif solver == "midpoint":
            # x1 = x + dt * F(x_mid), x_mid = x + (dt/2) F(x)
            f0, res0 = F_fwd(x_s)
            _, res_m = F_fwd(x_s + f0 * (0.5 * dt))
            g_xmid, gi_m, gp_m = F_bwd(res_m, dt * gX1)
            g_x00, gi_0, gp_0 = F_bwd(res0, (0.5 * dt) * g_xmid)
            g_x0 = gX1 + g_xmid + g_x00
            g_i_in = gi_m + gi_0
            gs_de = gp_m + gp_0
        else:  # rk4, Kutta's 3/8 rule
            k1, res1 = F_fwd(x_s)
            k2, res2 = F_fwd(x_s + dt * k1 * _ONE_THIRD)
            k3, res3 = F_fwd(x_s + dt * (k2 - k1 * _ONE_THIRD))
            _, res4 = F_fwd(x_s + dt * (k1 - k2 + k3))
            c = dt * 0.125
            g_k1, g_k2, g_k3, g_k4 = gX1 * c, 3.0 * gX1 * c, 3.0 * gX1 * c, gX1 * c
            g_x0, g_i_in, gs_de = gX1, z(i_in), z(s_de[t])

            g_a4, gi4, gp4 = F_bwd(res4, g_k4)
            g_x0 = g_x0 + g_a4
            g_k1 = g_k1 + dt * g_a4
            g_k2 = g_k2 - dt * g_a4
            g_k3 = g_k3 + dt * g_a4
            g_i_in, gs_de = g_i_in + gi4, gs_de + gp4

            g_a3, gi3, gp3 = F_bwd(res3, g_k3)
            g_x0 = g_x0 + g_a3
            g_k2 = g_k2 + dt * g_a3
            g_k1 = g_k1 - dt * g_a3 * _ONE_THIRD
            g_i_in, gs_de = g_i_in + gi3, gs_de + gp3

            g_a2, gi2, gp2 = F_bwd(res2, g_k2)
            g_x0 = g_x0 + g_a2
            g_k1 = g_k1 + dt * g_a2 * _ONE_THIRD
            g_i_in, gs_de = g_i_in + gi2, gs_de + gp2

            g_a1, gi1, gp1 = F_bwd(res1, g_k1)
            g_x0 = g_x0 + g_a1
            g_i_in, gs_de = g_i_in + gi1, gs_de + gp1
        g_s["s_de"][t] = gs_de
        if tf:  # the step started from x_true[t], not from the x carry
            if g_true:
                g_xt[t] = g_x0
            g_x0 = z(g_x0)

        # route the i_in cotangent: event rows through the AE_ev VJP, the
        # other rows to the i_t carry
        if any_ev[t]:
            gp_ev = _tail_bwd(res_ev, torch.where(ev, g_i_in, 0.0), ae_tail, g_w["ae_tail"])
            g_w["gx_ae"] += dot_t(x_t, gp_ev, cd)
            g_s["s_ae_ev"][t] = gp_ev
            gx_c = g_x0 + dot(gp_ev, gx.T)
            gi_c = torch.where(ev, 0.0, g_i_in)
        else:
            gx_c, gi_c = g_x0, g_i_in
    if g_true:
        return g_s, g_w, gx_c, gi_c, (g_xt, g_xt1)
    return g_s, g_w, gx_c, gi_c


@torch.no_grad()
def recompute_plain(streams: Dict, weights: Dict, x0, i0, aux, packed, solver: str = "rk4", x_true=None):
    """The recompute kernel's buffers as plain PyTorch, in the inputs' dtype
    (float32 in the bf16 compute mode, its products by ``dot``):
    ``(res [E, L, R, h], xin [E, R, xd+id])`` for every row-step ``r = t B +
    b``, the ``E = S + 2`` slots the DE stages in evaluation order, the AE at
    t+1, the AE at the event (its pre-activations zero on rows without an
    event); ``L`` the longer tail. A stage's input is ``(x, i_in)``, an AE's
    ``x`` (the rest zero): under teacher forcing (``x_true``) the stages
    start from ``x_true[t]`` and the AE at t+1 reads ``x_true[t+1]``, the
    AE at the event the rolled ``x_t``. The arguments of
    :func:`fused_dae_rollout_bwd_plain`."""
    solver = normalize_solver(solver)
    s_de, s_ae, s_ae_ev = streams["s_de"], streams["s_ae"], streams["s_ae_ev"]
    wx, wi, gx = weights["wx_de"], weights["wi_de"], weights["gx_ae"]
    de_tail, ae_tail = weights["de_tail"], weights["ae_tail"]
    Tm1, B, h = s_de.shape
    xd, idim = x0.shape[-1], i0.shape[-1]
    R, S = Tm1 * B, STAGES[solver]
    rows = lambda a: a.reshape(R, -1)
    x_t = rows(torch.cat([x0[None], packed[:-1, :, :xd]]))
    i_t = rows(torch.cat([i0[None], packed[:-1, :, xd:]]))
    wd = work_dtype(s_de)
    dt = rows(aux[..., 0:1]).to(wd)
    ev = aux[..., 1].reshape(R) > 0
    res = s_de.new_zeros(S + 2, max(len(de_tail), len(ae_tail)), R, h, dtype=wd)
    xin = s_de.new_zeros(S + 2, R, xd + idim, dtype=wd)

    def net(q, first_in, stream, first_w, tail, keep=None):
        xin[q, :, : first_in.shape[1]] = first_in
        y, (pres, _) = _tail_fwd_res(rows(stream) + dot(first_in, first_w), tail)
        for l, p in enumerate(pres):
            res[q, l] = p if keep is None else torch.where(keep[:, None], p, 0.0)
        return y

    i_in = torch.where(ev[:, None], net(S + 1, x_t, s_ae_ev, gx, ae_tail, keep=ev), i_t)
    net(S, rows(packed[:, :, :xd] if x_true is None else x_true[1:]), s_ae, gx, ae_tail)
    w_first = torch.cat([wx, wi])
    f = lambda q, xq: net(q, torch.cat([xq, i_in], dim=1), s_de, w_first, de_tail)
    x_s = x_t if x_true is None else rows(x_true[:-1])
    k1 = f(0, x_s)
    if solver == "midpoint":
        f(1, x_s + k1 * (0.5 * dt))
    elif solver == "rk4":
        k2 = f(1, x_s + dt * k1 * _ONE_THIRD)
        k3 = f(2, x_s + dt * (k2 - k1 * _ONE_THIRD))
        f(3, x_s + dt * (k1 - k2 + k3))
    return res, xin


def contract_plain(res, gres, gy, xin, ev, n_tails: Tuple[int, int], xd: int, idim: int,
                   cdtype=torch.float32) -> Dict:
    """The contraction kernel's plain version: the weight gradients, in the
    layout of ``weights``, from the buffers ``res/gres [E, L, R, h]``, ``gy
    [E, R, max(xd, id)]``, ``xin [E, R, xd+id]`` and the event flags ``ev
    [R]`` (bool; the AE at the event counts only there); ``cdtype``
    bfloat16 in the bf16 compute mode. Under teacher forcing ``xin`` holds
    the true states (:func:`recompute_plain`), so the first layers'
    gradients need nothing more."""
    n_de, n_ae = n_tails
    S = res.shape[0] - 2
    first, de_tail = net_grads_plain(res, gres, gy, xin, range(S), xd + idim, n_de, xd, cdtype=cdtype)
    gx, ae_tail = net_grads_plain(res, gres, gy, xin, (S, S + 1), xd, n_ae, idim, keep=ev, cdtype=cdtype)
    return dict(wx_de=first[:xd], wi_de=first[xd:], gx_ae=gx, de_tail=de_tail, ae_tail=ae_tail)


def grad_layout(weights: Dict) -> Tuple[List[Tuple[int, Tuple[int, ...]]], int]:
    """``([(offset, shape), ...], total)``: where each gradient lies in the
    kernel's flat gradient row, in :func:`flatten_weights` order."""
    out, off = [], 0
    for a in flatten_weights(weights)[0]:
        out.append((off, tuple(a.shape)))
        off += math.prod(a.shape)
    return out, off


def bind_rollout_bwd(lib: ctypes.CDLL, bf16: bool = False):
    """``(backward, sizes, error string, TF-x backward, bf16)``: the C
    functions of a build of ``csrc/fused_dae_rollout_bwd.cu`` (for the card
    or, in ``utils/host_build.py``, the host) with their signatures, the
    backward that of the bf16 compute mode where ``bf16`` (the TF-x one
    too); the TF-x one None for a build that has none (an older checkout's,
    which ``phase_clock bwd-ab`` binds)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    args = [
        P, P, P, P,  # s_de, s_ae, s_ae_ev, aux
        P, P, P, P,  # x0, i0, sol, cot
        P, P, I,  # DE padded weights, biases, tail layers
        P, P, I,  # AE padded weights, biases, tail layers
        P, P, P,  # g_s_de, g_s_ae, g_s_ae_ev
        P, P, P,  # g_w, g_x0, g_i0
        P, P, P, P, P,  # res, gres, gy, xin, parts (scratch)
        I, I, I, I, I,  # Tm1, B, h, xd, id
        I, I, I,  # solver, stages, resident weight slots (-1: the DE's hidden weights)
    ]
    fn = lib.psn_fused_dae_rollout_bwd_bf16 if bf16 else lib.psn_fused_dae_rollout_bwd_f32
    fn.argtypes = args + [P]  # stream
    fn.restype = ctypes.c_int
    tf = None
    tf_name = "psn_fused_dae_rollout_bwd_tfx_bf16" if bf16 else "psn_fused_dae_rollout_bwd_tfx_f32"
    if hasattr(lib, tf_name):
        tf = getattr(lib, tf_name)
        tf.argtypes = args + [P, P, P, P, P]  # x_true[:-1], x_true[1:], g_xt, g_xt1 (null: none), stream
        tf.restype = ctypes.c_int
    sizes = lib.psn_fused_dae_bwd_sizes
    sizes.argtypes = [I] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
    sizes.restype = None
    err = lib.psn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, sizes, err, tf, bf16


@functools.lru_cache(maxsize=None)
def _launcher(bf16: bool = False):
    """The C launcher of ``csrc/fused_dae_rollout_bwd.cu`` (:func:`bind_rollout_bwd`)."""
    return bind_rollout_bwd(cuda_build.load("fused_dae_rollout_bwd"), bf16)


def bwd_sizes(sizes, Tm1, B, h, xd, idim, n_tails, solver) -> Tuple[int, ...]:
    """``(g_w, res, gy, xin, parts)`` floats at these shapes and the padded
    width H of the weights (:func:`noencode_bwd.pad_net`), from the C
    function ``sizes`` of :func:`bind_rollout_bwd`."""
    got = (ctypes.c_longlong * 6)()
    sizes(Tm1, B, h, xd, idim, *n_tails, _SOLVER_CODE[solver], got)
    return tuple(got)


def fused_dae_rollout_bwd_cuda(
    streams: Dict, weights: Dict, x0, i0, aux, packed, cot, solver: str = "rk4", x_true=None,
    g_true: bool = False,
):
    """Launch the CUDA backward: the recompute of every evaluation of every
    row-step, the reverse walk (one block per batch row), and the
    contraction of the weight gradients (in a fixed order: bit-identical on
    relaunch). Same contract as :func:`fused_dae_rollout_bwd_plain`,
    float32, every width (above 128 the wide kernels). Scratch: the
    residual and cotangent buffers, ``2 (S + 2) L (T-1) B h`` floats and a
    little more (1.2 GB at B=64, T=1001, RK4, h=128; 4.7 GB at h=512), live
    until the call returns. ``x_true``/``g_true``: the kernels' TF-x mode,
    with the true states' cotangents written only where ``g_true``."""
    out, _ = _launch_bwd(streams, weights, x0, i0, aux, packed, cot, solver, x_true=x_true, g_true=g_true)
    fused_dae_rollout_bwd.launches += 1
    return out


def _launch_bwd(streams: Dict, weights: Dict, x0, i0, aux, packed, cot, solver: str, launcher=None,
                stages: int = 7, bufs: Optional[Dict] = None, host: bool = False, slots: int = -1,
                x_true=None, g_true: bool = False):
    """Launch the backward's kernels ``stages`` (1 the recompute, 2 the
    walk, 4 the contraction) through ``launcher`` (of
    :func:`bind_rollout_bwd`; the default build when None), on the buffers
    ``bufs`` (flat ``res``, ``gres``, ``gy``, ``xin``, ``parts``; new ones
    when None); ``host``: a host build on CPU tensors
    (``utils/host_build.py``); ``slots``: how many of the walk's hidden
    weights (the DE's, then the AE's) are resident in shared memory (-1:
    the DE's); ``x_true`` the TF-x mode, ``g_true`` its true-state
    cotangents. Returns ``((g_streams, g_weights, g_x0, g_i0), bufs)``, with
    ``g_true`` a fifth output ``(g_xt, g_xt1)``; the outputs of kernels not
    launched are left unset. bfloat16 streams and weights: the kernels'
    bf16 compute mode. Counts nothing:
    :func:`fused_dae_rollout_bwd_cuda` is the entry; the smoke times one
    kernel at a time, the tests run the contraction on given buffers, the
    phase clock its own build."""
    solver = normalize_solver(solver)
    if g_true and x_true is None:
        raise ValueError("g_true needs x_true")
    bf16 = _check_kernel_inputs(streams, weights, x0, i0, aux, "cpu" if host else "cuda", x_true)
    s_de = streams["s_de"]
    Tm1, B, h = s_de.shape
    xd, idim = x0.shape[-1], i0.shape[-1]
    for name, a, shape in (("packed", packed, (Tm1, B, xd + idim)),
                           ("cot", cot, (Tm1 + 1, B, xd + idim))):
        if a.device != s_de.device or a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {s_de.device}, got {a.dtype} on {a.device}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fn, sizes, err, fn_tf, mode = launcher or _launcher(bf16)
    if mode != bf16:
        raise ValueError(f"a launcher bound for bf16={mode} got the {'bf16' if bf16 else 'float32'} mode's inputs")
    layout, total = grad_layout(weights)
    n_tails = (len(weights["de_tail"]), len(weights["ae_tail"]))
    n_w, n_res, n_gy, n_xin, n_parts, H = bwd_sizes(sizes, Tm1, B, h, xd, idim, n_tails, solver)
    if n_w != total:
        raise RuntimeError("gradient layout of the CUDA backward and of its wrapper disagree")
    f32 = dict(dtype=torch.float32, device=s_de.device)
    if bufs is None:
        bufs = dict(res=torch.empty(n_res, **f32), gres=torch.empty(n_res, **f32),
                    gy=torch.empty(n_gy, **f32), xin=torch.empty(n_xin, **f32))
    bufs.setdefault("parts", torch.empty(n_parts, **f32))
    g_s = {k: torch.empty(Tm1, B, h, **f32) for k in ("s_de", "s_ae", "s_ae_ev")}
    g_flat = torch.empty(total, **f32)
    g_x0, g_i0 = torch.empty(B, xd, **f32), torch.empty(B, idim, **f32)
    g_tf, tf_args = None, ()
    if x_true is not None:
        if fn_tf is None:
            raise RuntimeError("this build of fused_dae_rollout_bwd has no TF-x mode")
        fn = fn_tf
        if g_true:
            g_tf = (torch.empty(Tm1, B, xd, **f32), torch.empty(Tm1, B, xd, **f32))
        tf_args = (x_true.data_ptr(), x_true[1:].data_ptr(),
                   *((g.data_ptr() for g in g_tf) if g_true else (None, None)))
    # the padded weights must outlive the launch; in the bf16 mode they hold
    # the bf16 weights' values in float32 (exact)
    f = lambda W: W.float()
    w_de, b_de = pad_net(f(torch.cat([weights["wx_de"], weights["wi_de"]])),
                         [(f(W), b) for W, b in weights["de_tail"]], H)
    w_ae, b_ae = pad_net(f(weights["gx_ae"]), [(f(W), b) for W, b in weights["ae_tail"]], H)
    rc = launch(
        fn, s_de.device, s_de.data_ptr(), streams["s_ae"].data_ptr(), streams["s_ae_ev"].data_ptr(),
        aux.data_ptr(), x0.data_ptr(), i0.data_ptr(), packed.data_ptr(), cot.data_ptr(),
        w_de.data_ptr(), b_de.data_ptr(), n_tails[0], w_ae.data_ptr(), b_ae.data_ptr(), n_tails[1],
        g_s["s_de"].data_ptr(), g_s["s_ae"].data_ptr(), g_s["s_ae_ev"].data_ptr(),
        g_flat.data_ptr(), g_x0.data_ptr(), g_i0.data_ptr(),
        *(bufs[k].data_ptr() for k in ("res", "gres", "gy", "xin", "parts")),
        Tm1, B, h, xd, idim, _SOLVER_CODE[solver], stages, slots, *tf_args,
    )
    if rc != 0:
        raise RuntimeError(
            f"fused_dae_rollout_bwd kernel launch failed: CUDA error {rc} ({err(rc).decode()})"
        )
    g_list = [g_flat[off : off + math.prod(shape)].view(shape) for off, shape in layout]
    out = (g_s, unflatten_weights(g_list, n_tails), g_x0, g_i0)
    return (out + (g_tf,) if g_true else out), bufs


def fused_dae_rollout_bwd(streams, weights, x0, i0, aux, packed, cot, solver="rk4", x_true=None,
                          g_true=False):
    """Reverse walk on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors, an error otherwise."""
    dev = streams["s_de"].device
    if dev.type == "cuda":
        return fused_dae_rollout_bwd_cuda(streams, weights, x0, i0, aux, packed, cot, solver, x_true, g_true)
    if dev.type == "cpu":
        return fused_dae_rollout_bwd_plain(streams, weights, x0, i0, aux, packed, cot, solver, x_true, g_true)
    raise ValueError(f"fused_dae_rollout_bwd runs on cuda or cpu tensors, got {dev}")


fused_dae_rollout_bwd.launches = 0


class FusedDaeRollout(torch.autograd.Function):
    """The fused rollout with its reverse-time backward (counterpart of the
    ``jax.custom_vjp`` ``fused_dae_rollout_diff``, :693-720).

    Forward: the forward rollout (the CUDA kernel on the card) in the
    compute mode of ``precision`` (:func:`~py_psnode_tpu_torch.ops.
    fused_dae.cast_compute`); it saves the inputs as the kernels read them
    (bfloat16 streams and weights in the bf16 mode) and the packed solution
    rows, nothing per step. Backward: :func:`fused_dae_rollout_bwd`, its
    float32 gradients to the float32 inputs. Weights enter as flat tensor
    arguments (:func:`flatten_weights`); ``aux`` (dt, ev) gets no gradient.
    """

    @staticmethod
    def forward(ctx, solver, n_tails, precision, s_de, s_ae, s_ae_ev, x0, i0, aux, *wflat):
        streams, weights = cast_compute(dict(s_de=s_de, s_ae=s_ae, s_ae_ev=s_ae_ev),
                                        unflatten_weights(wflat, n_tails), precision)
        packed = fused_dae_rollout_packed(streams, weights, x0, i0, aux, solver)
        ctx.solver, ctx.n_tails = solver, n_tails
        ctx.save_for_backward(*streams.values(), x0, i0, aux, packed, *flatten_weights(weights)[0])
        return unpack_solution(packed, x0, i0, s_de.shape[0])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_xsol, g_isol):
        s_de, s_ae, s_ae_ev, x0, i0, aux, packed, *wflat = ctx.saved_tensors
        streams = dict(s_de=s_de, s_ae=s_ae, s_ae_ev=s_ae_ev)
        cot = torch.cat([g_xsol, g_isol], dim=-1).contiguous()
        g_s, g_w, g_x0, g_i0 = fused_dae_rollout_bwd(
            streams, unflatten_weights(wflat, ctx.n_tails), x0, i0, aux, packed, cot, ctx.solver
        )
        # the initial rows of the solutions are x0/i0 themselves
        g_x0 = g_x0 + g_xsol[0]
        g_i0 = g_i0 + g_isol[0]
        return (None, None, None, g_s["s_de"], g_s["s_ae"], g_s["s_ae_ev"], g_x0, g_i0, None,
                *flatten_weights(g_w)[0])


def fused_dae_rollout_diff(
    streams: Dict, weights: Dict, x0, i0, dt, ev, solver: str = "rk4",
    precision: str = "default",
):
    """Differentiable fused rollout (the training entry): the contract of
    :func:`~py_psnode_tpu_torch.ops.fused_dae.fused_dae_rollout`, with
    gradients (float32, also in the bf16 compute mode) to ``streams``,
    ``weights``, ``x0`` and ``i0`` through :class:`FusedDaeRollout`;
    ``dt``/``ev`` get none."""
    is_bf16(precision)  # an unknown precision raises here
    wflat, n_tails = flatten_weights(weights)
    return FusedDaeRollout.apply(
        normalize_solver(solver), n_tails, precision,
        streams["s_de"], streams["s_ae"], streams["s_ae_ev"],
        x0.contiguous(), i0.contiguous(), pack_aux(dt, ev), *wflat,
    )


class FusedDaeTfxRollout(torch.autograd.Function):
    """The fused rollout under teacher forcing of ``x`` with its backward
    (counterpart of the ``jax.custom_vjp`` ``fused_dae_tf_x_rollout_diff``,
    :724-755): :class:`FusedDaeRollout` plus the true states ``x_true [T,
    B, xd]``, in the compute mode of ``precision`` as there (the true states
    stay float32). The kernels compute the true states' cotangents only
    where autograd asks for ``x_true``'s gradient (the encoded states of the
    direct-encode DAE; the no-encode DAE's raw data asks for none); its
    gradient is then ``zeros[T]`` with ``[:-1] += g_xt`` and ``[1:] +=
    g_xt1``."""

    @staticmethod
    def forward(ctx, solver, n_tails, precision, s_de, s_ae, s_ae_ev, x0, i0, aux, x_true, *wflat):
        streams, weights = cast_compute(dict(s_de=s_de, s_ae=s_ae, s_ae_ev=s_ae_ev),
                                        unflatten_weights(wflat, n_tails), precision)
        packed = fused_dae_rollout_packed(streams, weights, x0, i0, aux, solver, x_true)
        ctx.solver, ctx.n_tails = solver, n_tails
        ctx.save_for_backward(*streams.values(), x0, i0, aux, x_true, packed, *flatten_weights(weights)[0])
        return unpack_solution(packed, x0, i0, s_de.shape[0])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_xsol, g_isol):
        s_de, s_ae, s_ae_ev, x0, i0, aux, x_true, packed, *wflat = ctx.saved_tensors
        streams = dict(s_de=s_de, s_ae=s_ae, s_ae_ev=s_ae_ev)
        cot = torch.cat([g_xsol, g_isol], dim=-1).contiguous()
        want = ctx.needs_input_grad[9]
        out = fused_dae_rollout_bwd(
            streams, unflatten_weights(wflat, ctx.n_tails), x0, i0, aux, packed, cot, ctx.solver, x_true, want
        )
        g_s, g_w, g_x0, g_i0 = out[:4]
        g_x_true = None
        if want:
            g_xt, g_xt1 = out[4]
            g_x_true = torch.zeros_like(x_true)
            g_x_true[:-1] += g_xt
            g_x_true[1:] += g_xt1
        return (None, None, None, g_s["s_de"], g_s["s_ae"], g_s["s_ae_ev"], g_x0 + g_xsol[0], g_i0 + g_isol[0],
                None, g_x_true, *flatten_weights(g_w)[0])


def fused_dae_tf_x_rollout_diff(
    streams: Dict, weights: Dict, x0, i0, x_true, dt, ev, solver: str = "rk4",
    precision: str = "default",
):
    """Differentiable fused rollout under teacher forcing of ``x``: the
    contract of :func:`fused_dae_rollout_diff` plus the true states
    ``x_true [T, B, xd]`` (the step reads ``x_true[t]``, the AE at t+1
    ``x_true[t+1]``, the event recompute the rolled state), which get their
    gradient where they require one (:class:`FusedDaeTfxRollout`), in the
    compute mode of ``precision``."""
    is_bf16(precision)  # an unknown precision raises here
    wflat, n_tails = flatten_weights(weights)
    return FusedDaeTfxRollout.apply(
        normalize_solver(solver), n_tails, precision,
        streams["s_de"], streams["s_ae"], streams["s_ae_ev"],
        x0.contiguous(), i0.contiguous(), pack_aux(dt, ev), x_true.contiguous(), *wflat,
    )
