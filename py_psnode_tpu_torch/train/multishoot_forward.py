"""Multiple-shooting forwards of the six variants (counterpart of
``py_psnode_tpu/train/multishoot_forward.py``).

Each entry takes the model, a batch-major batch and the window count ``K``,
and returns ``(out, gaps)``: ``out`` the model's ``forward`` contract over
the stitched windows, ``gaps [K-1, B, d]`` the continuity defects at the
window boundaries (in latent space for the encode and channel-wise
families). The trainer adds ``gap_weight * mean(gaps**2)`` to the loss.

* The no-encode and direct-encode families have a plain entry, on
  :func:`~py_psnode_tpu_torch.solvers.multishoot.multishoot_ode` /
  :func:`~py_psnode_tpu_torch.solvers.multishoot.multishoot_dae`, and a
  fused one, which folds the fused path's own inputs (the layer-1 streams,
  ``dt``, the event mask) into ``[L, K*B, ...]`` and runs all windows in one
  launch of kernels 1-2 (DAE) or 3-4 (ODE) over ``K*B`` rows and ``L``
  steps. A stream row depends only on its step's inputs and the sample's
  t=0 conditioning, so folding the streams equals precomputing them on the
  folded inputs.
* Window 0 starts from the model's own t=0 state (the DAE's ``Init_Func``,
  the ODE's ``x[0]``), windows 1.. from the true data states (encoded for
  the encode and channel-wise families); ``all_initial`` is the global t=0
  conditioning tiled, so every window continues the same problem. A DAE
  window's initial algebraic output is the AE at its start state, and an
  event may fall on a window's first step.
* The channel-wise family runs in plain PyTorch under either ``fused``
  setting, as the JAX package runs it on XLA: its latent state ``[B, xd,
  h]`` folds flattened to ``[B, xd*h]``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from py_psnode_tpu_torch.models.channelwise import ChannelWiseDAEModel, ChannelWiseODEModel
from py_psnode_tpu_torch.models.dae import DAEEncodeModel, DAEModel
from py_psnode_tpu_torch.models.ode import ODEEncodeModel, ODEModel
from py_psnode_tpu_torch.ops.fused_dae import normalize_solver
from py_psnode_tpu_torch.ops.fused_dae_vjp import fused_dae_rollout_diff
from py_psnode_tpu_torch.ops.fused_model import (
    _grad_mode,
    dae_encode_outputs,
    dae_encode_setup,
    ode_encode_rollout_inputs,
    ode_rollout_inputs,
    rollout_inputs,
)
from py_psnode_tpu_torch.ops.fused_ode_vjp import fused_ode_rollout_diff
from py_psnode_tpu_torch.solvers import event_match, jumped_stream
from py_psnode_tpu_torch.solvers.multishoot import (
    _window_fold,
    _window_unfold,
    check_windows,
    multishoot_dae,
    multishoot_ode,
    tile_batch,
    window_gaps,
    window_starts,
)


def _tm(a):
    return a.transpose(0, 1)


def _solver(model, solver):
    return model.solver if solver is None else solver


def _fold_steps(K, L, *streams):
    """Each ``[T-1, B, ...]`` per-step stream folded into ``[L, K*B, ...]``."""
    return [_window_fold(a, K, L, 0) for a in streams]


# ------------------------------------------------------------- no-encode


def multishoot_ode_apply(model: ODEModel, batch: Dict[str, torch.Tensor], n_windows: int, solver=None):
    """Plain multiple shooting of the ODE no-encode model. Returns
    ``(x_pred [B, T, xd], gaps [K-1, B, xd])``."""
    is_event, e_idx = event_match(batch["t"], batch.get("event_t"))
    z_used = _tm(jumped_stream(batch["z"], batch.get("z_jump"), is_event, e_idx))[:-1]
    tT, xT, zT = _tm(batch["t"]), _tm(batch["x"]), _tm(batch["z"])
    tiled = tile_batch(torch.cat([xT[0], zT[0]], dim=-1), n_windows)
    de_fn = lambda tt, xx, zz: model.de_func(tt, tiled, xx, zz)
    sol, gaps = multishoot_ode(_solver(model, solver), de_fn, tT, xT, z_used, n_windows)
    return _tm(sol), gaps


def fused_multishoot_ode_apply(model: ODEModel, batch: Dict[str, torch.Tensor], n_windows: int, solver=None,
                               precision: str = "default"):
    """:func:`multishoot_ode_apply` through kernels 3-4 (in the compute mode
    of ``precision``): the fused path's ``s_de`` and ``dt`` folded, the
    true window starts, one rollout of ``K*B`` rows over ``L`` steps. Same
    contract."""
    solver = normalize_solver(_solver(model, solver))
    with _grad_mode(model):
        s_de, weights, _, dt = ode_rollout_inputs(model, batch)
        xT = _tm(batch["x"])
        T, B, K = xT.shape[0], xT.shape[1], n_windows
        L = check_windows(T, K)
        x0w = window_starts(xT, K, L)
        s_de_w, dt_w = _fold_steps(K, L, s_de, dt)
        sol_w = fused_ode_rollout_diff(s_de_w, weights, x0w, dt_w, solver, precision)
        return _tm(_window_unfold(sol_w, K, L, B)), window_gaps(sol_w[-1], x0w, K, B)


def _dae_window_starts(x0, batch, K: int):
    """The no-encode DAE's window starts from its ``Init_Func`` output
    ``x0``: ``(x0w [K*B, xd], all_init_f [K*B, d_u], L)``, window 0 at
    ``x0``, windows 1.. at the true ``x[w*L]``, ``all_initial`` the global
    t=0 value tiled."""
    xT, zT, vT, iT = (_tm(batch[k]) for k in ("x", "z", "v", "i"))
    L = check_windows(xT.shape[0], K)
    x0w = torch.cat([x0[None], xT[L : K * L : L]]).reshape(K * xT.shape[1], -1)
    all_init_f = tile_batch(torch.cat([x0, zT[0], vT[0], iT[0]], dim=-1), K)
    return x0w, all_init_f, L


def multishoot_dae_apply(model: DAEModel, batch: Dict[str, torch.Tensor], n_windows: int, solver=None):
    """Plain multiple shooting of the DAE no-encode model. Returns
    ``((x_pred, i_pred) batch-major, gaps [K-1, B, xd])``."""
    is_event, e_idx = event_match(batch["t"], batch.get("event_t"))
    z_used = _tm(jumped_stream(batch["z"], batch.get("z_jump"), is_event, e_idx))[:-1]
    v_used = _tm(jumped_stream(batch["v"], batch.get("v_jump"), is_event, e_idx))[:-1]
    x0 = model.init_func(*(_tm(batch[k])[0] for k in ("z", "v", "i")))
    x0w, all_init_f, _ = _dae_window_starts(x0, batch, n_windows)
    de_fn = lambda tt, xx, zz, vv, ii: model.de_func(tt, all_init_f, xx, zz, vv, ii)
    ae_fn = lambda xx, zz, vv: model.ae_func(all_init_f, xx, zz, vv)
    x_sol, i_sol, gaps = multishoot_dae(
        _solver(model, solver), de_fn, ae_fn, x0w, _tm(batch["t"]), _tm(batch["z"]), _tm(batch["v"]), z_used,
        v_used, n_windows, is_event=_tm(is_event)[:-1],
    )
    return (_tm(x_sol), _tm(i_sol)), gaps


def fused_multishoot_dae_apply(model: DAEModel, batch: Dict[str, torch.Tensor], n_windows: int, solver=None,
                               precision: str = "default"):
    """:func:`multishoot_dae_apply` through kernels 1-2 (in the compute mode
    of ``precision``): the fused path's
    streams, ``dt`` and event mask folded, the window starts of
    :func:`multishoot_dae_apply` and each window's AE at its start, one
    rollout of ``K*B`` rows over ``L`` steps. Same contract."""
    solver = normalize_solver(_solver(model, solver))
    K = n_windows
    with _grad_mode(model):
        streams, weights, x0, _, dt, ev = rollout_inputs(model, batch)
        x0w, all_init_f, L = _dae_window_starts(x0, batch, K)
        i0w = model.ae_func(all_init_f, x0w, window_starts(_tm(batch["z"]), K, L),
                            window_starts(_tm(batch["v"]), K, L))
        folded = dict(zip(streams, _fold_steps(K, L, *streams.values())))
        dt_w, ev_w = _fold_steps(K, L, dt, ev)
        x_sol_w, i_sol_w = fused_dae_rollout_diff(folded, weights, x0w, i0w, dt_w, ev_w, solver, precision)
        B = batch["t"].shape[0]
        return ((_tm(_window_unfold(x_sol_w, K, L, B)), _tm(_window_unfold(i_sol_w, K, L, B))),
                window_gaps(x_sol_w[-1], x0w, K, B))


# ---------------------------------------------------------- direct-encode


def multishoot_ode_encode_apply(model: ODEEncodeModel, batch: Dict[str, torch.Tensor], n_windows: int,
                                solver=None):
    """Plain multiple shooting of the direct-encode ODE: the windows start
    from the encoded true states (teacher forcing in latent space), the
    stitched latent solution is decoded. Returns ``((x_pred, x_re),
    gaps [K-1, B, h])``."""
    xh, zh = model.x_encoder(batch["x"]), model.z_encoder(batch["z"])
    z_jump = batch.get("z_jump")
    zh_jump = model.z_encoder(z_jump) if z_jump is not None else None
    is_event, e_idx = event_match(batch["t"], batch.get("event_t"))
    zh_used = _tm(jumped_stream(zh, zh_jump, is_event, e_idx))[:-1]
    xhT = _tm(xh)
    tiled = tile_batch(torch.cat([xhT[0], _tm(zh)[0]], dim=-1), n_windows)
    de_fn = lambda tt, xx, zz: model.de_func(tt, tiled, xx, zz)
    xh_sol, gaps = multishoot_ode(_solver(model, solver), de_fn, _tm(batch["t"]), xhT, zh_used, n_windows)
    return (model.x_decoder(_tm(xh_sol)), model.x_decoder(xh)), gaps


def fused_multishoot_ode_encode_apply(model: ODEEncodeModel, batch: Dict[str, torch.Tensor], n_windows: int,
                                      solver=None, precision: str = "default"):
    """:func:`multishoot_ode_encode_apply` through kernels 3-4 at ``xd =
    h`` (in the compute mode of ``precision``). Same contract."""
    solver = normalize_solver(_solver(model, solver))
    with _grad_mode(model):
        s_de, weights, _, dt, xh = ode_encode_rollout_inputs(model, batch)
        B, T = xh.shape[0], xh.shape[1]
        K = n_windows
        L = check_windows(T, K)
        xh0w = window_starts(_tm(xh), K, L)
        s_de_w, dt_w = _fold_steps(K, L, s_de, dt)
        sol_w = fused_ode_rollout_diff(s_de_w, weights, xh0w, dt_w, solver, precision)
        x_pred = model.x_decoder(_tm(_window_unfold(sol_w, K, L, B)))
        return (x_pred, model.x_decoder(xh)), window_gaps(sol_w[-1], xh0w, K, B)


def _dae_encode_window_starts(s: Dict, K: int):
    """The direct-encode DAE's latent window starts ``[K*B, h]``: window 0
    the encoded ``Init_Func`` output, windows 1.. the encoded true states
    (so ``x_encoder`` gets a gradient through every window's start)."""
    xhT = s["xhT"]
    L = check_windows(xhT.shape[0], K)
    return torch.cat([s["xh0"][None], xhT[L : K * L : L]]).reshape(K * xhT.shape[1], -1), L


def multishoot_dae_encode_apply(model: DAEEncodeModel, batch: Dict[str, torch.Tensor], n_windows: int,
                                solver=None):
    """Plain multiple shooting of the direct-encode DAE: latent windows,
    latent event jumps, the decoders after, ``x_pred[:, 0]`` the raw Init
    output. Returns ``((x_pred, i_pred, x_re, i_re), gaps [K-1, B, h])``."""
    K = n_windows
    s = dae_encode_setup(model, batch, with_streams=False)
    xh0w, _ = _dae_encode_window_starts(s, K)
    all_init_f = tile_batch(s["all_initial"], K)
    de_fn = lambda tt, xx, zz, vv, ii: model.de_func(tt, all_init_f, xx, zz, vv, ii)
    ae_fn = lambda xx, zz, vv: model.ae_func(all_init_f, xx, zz, vv)
    xh_sol, ih_sol, gaps = multishoot_dae(
        _solver(model, solver), de_fn, ae_fn, xh0w, s["tT"], s["zhT"], s["vhT"], s["zh_used"], s["vh_used"], K,
        is_event=s["ev"],
    )
    return dae_encode_outputs(model, s, xh_sol, ih_sol), gaps


def fused_multishoot_dae_encode_apply(model: DAEEncodeModel, batch: Dict[str, torch.Tensor], n_windows: int,
                                      solver=None, precision: str = "default"):
    """:func:`multishoot_dae_encode_apply` through kernels 1-2 at ``dims =
    (h, zl, h, h)`` (in the compute mode of ``precision``): the streams of :func:`dae_encode_setup` folded, each
    window's AE at its latent start. Same contract."""
    solver = normalize_solver(_solver(model, solver))
    K = n_windows
    with _grad_mode(model):
        s = dae_encode_setup(model, batch)
        xh0w, L = _dae_encode_window_starts(s, K)
        i0w = model.ae_func(tile_batch(s["all_initial"], K), xh0w, window_starts(s["zhT"], K, L),
                            window_starts(s["vhT"], K, L))
        streams = s["streams"]
        folded = dict(zip(streams, _fold_steps(K, L, *streams.values())))
        dt_w, ev_w = _fold_steps(K, L, s["dt"], s["ev"])
        xh_sol_w, ih_sol_w = fused_dae_rollout_diff(folded, s["weights"], xh0w, i0w, dt_w, ev_w, solver,
                                                    precision)
        B = batch["t"].shape[0]
        xh_sol, ih_sol = _window_unfold(xh_sol_w, K, L, B), _window_unfold(ih_sol_w, K, L, B)
        return dae_encode_outputs(model, s, xh_sol, ih_sol), window_gaps(xh_sol_w[-1], xh0w, K, B)


# ------------------------------------------------------------ channel-wise


def _multishoot_cw_latent(model, batch: Dict[str, torch.Tensor], n_windows: int, solver):
    """The windowed latent solve shared by both channel-wise variants: the
    windows start from the per-channel-encoded true states, the global t=0
    features ``f_init`` (of the raw ``z[0]``) tiled, the z-features of the
    jumped stream computed for all steps at once. Where grad is on, each
    dynamics evaluation is recomputed in the backward instead of keeping
    its ``[K*B, h, h]`` activations, as the channel-wise model's own
    rollout does. Returns ``(xh_sol [T, B, xd, h], gaps [K-1, B, xd*h])``."""
    de = model.de_func
    xd, zd, h = de.x_dim, de.z_dim, de.hidden_dim
    is_event, e_idx = event_match(batch["t"], batch.get("event_t"))
    z_used = jumped_stream(batch["z"], batch.get("z_jump"), is_event, e_idx)
    tT = _tm(batch["t"])
    T, B = tT.shape[0], tT.shape[1]
    check_windows(T, n_windows)
    xh_true = de.encode_x(_tm(batch["x"]))  # [T, B, xd, h]
    f_init_f = tile_batch(de.features_of(xh_true[0], _tm(batch["z"])[0]), n_windows)
    fz = de.z_features(_tm(z_used)[:-1])  # [T-1, B, zd, h]

    def dyn(xx, zz):
        return de.dyn(f_init_f, xx.reshape(-1, xd, h), zz.reshape(-1, zd, h)).reshape(xx.shape)

    use_ckpt = torch.is_grad_enabled()
    de_fn = lambda tt, xx, zz: checkpoint(dyn, xx, zz, use_reentrant=False) if use_ckpt else dyn(xx, zz)
    xh_sol, gaps = multishoot_ode(_solver(model, solver), de_fn, tT, xh_true.reshape(T, B, xd * h),
                                  fz.reshape(T - 1, B, zd * h), n_windows)
    return xh_sol.reshape(T, B, xd, h), gaps


def multishoot_cw_ode_apply(model: ChannelWiseODEModel, batch: Dict[str, torch.Tensor], n_windows: int,
                            solver=None):
    """Multiple shooting of the channel-wise ODE. Returns ``((x_pred [B, T,
    xd], x_re), gaps [K-1, B, xd*h])``."""
    de = model.de_func
    xh_sol, gaps = _multishoot_cw_latent(model, batch, n_windows, solver)
    return (_tm(de.decode_x(xh_sol)), de.decode_x(de.encode_x(batch["x"]))), gaps


def multishoot_cw_dae_apply(model: ChannelWiseDAEModel, batch: Dict[str, torch.Tensor], n_windows: int,
                            solver=None):
    """Multiple shooting of the channel-wise DAE: the latent windows of the
    ODE above (no algebraic feedback in this family) and the algebraic
    readout over the stitched latent solution with the raw ``v``. Returns
    ``((x_pred, i_pred, x_re), gaps [K-1, B, xd*h])``."""
    de = model.de_func
    xh_sol, gaps = _multishoot_cw_latent(model, batch, n_windows, solver)
    i_pred = model.ae_func(xh_sol, _tm(batch["v"]))  # [T, B, id]
    return (_tm(de.decode_x(xh_sol)), _tm(i_pred), de.decode_x(de.encode_x(batch["x"]))), gaps
