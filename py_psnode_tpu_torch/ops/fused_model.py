"""Model-level entries of the fused paths (counterparts of
``py_psnode_tpu/ops/fused_model.py:22-196``, of
``py_psnode_tpu/ops/fused_ode.py:393-461`` ``fused_ode_apply`` and
``fused_ode_encode_apply`` and of
``py_psnode_tpu/ops/fused_channelwise.py:633-724`` ``fused_cw_ode_apply``
and ``fused_cw_dae_apply``).

:func:`fused_dae_apply` is a drop-in for ``DAEModel.forward``,
:func:`fused_ode_apply` for ``ODEModel.forward``,
:func:`fused_dae_encode_apply` and :func:`fused_ode_encode_apply` for the
direct-encode models' ``forward`` (the codecs and the Init net before the
rollout, the decoders after it, as plain PyTorch), :func:`fused_cw_ode_apply`
and :func:`fused_cw_dae_apply` for the channel-wise models' ``forward``
(their decoders and the DAE's algebraic readout over all T run as plain
PyTorch after the rollout): the initial evaluations,
the event streams and the stream precompute run as plain PyTorch
(differentiated by autograd), the time loop runs through the rollout's
``torch.autograd.Function``: the forward and backward CUDA kernels on the
card. The direct-encode DAE's latent rollout runs the DAE kernels at
``dims = (h, zl, h, h)`` with one tail layer a net, the ODE's the ODE
kernels at ``xd = h``.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from py_psnode_tpu_torch.bridge import flax_params
from py_psnode_tpu_torch.models.channelwise import ChannelWiseDAEModel, ChannelWiseODEModel
from py_psnode_tpu_torch.models.dae import DAEEncodeModel, DAEModel
from py_psnode_tpu_torch.models.ode import ODEEncodeModel, ODEModel
from py_psnode_tpu_torch.ops.fused_channelwise import precompute_cw_streams
from py_psnode_tpu_torch.ops.fused_channelwise_vjp import fused_cw_rollout_diff
from py_psnode_tpu_torch.ops.fused_dae import normalize_solver, precompute_streams
from py_psnode_tpu_torch.ops.fused_dae_vjp import fused_dae_rollout_diff
from py_psnode_tpu_torch.ops.fused_ode import precompute_ode_streams
from py_psnode_tpu_torch.ops.fused_ode_vjp import fused_ode_rollout_diff
from py_psnode_tpu_torch.solvers import event_match, jumped_stream


def rollout_inputs(model: DAEModel, batch: Dict[str, torch.Tensor]):
    """The fused rollout's inputs for ``model`` on ``batch``:
    ``(streams, weights, x0, i0, dt, ev)`` as :func:`fused_dae_rollout`
    takes them. Runs the Init/AE initial evaluations, the event streams
    and the layer-1 precompute."""
    p = flax_params(model)
    tm = lambda a: a.transpose(0, 1)
    tT = tm(batch["t"]).float()
    zT, vT, iT = tm(batch["z"]), tm(batch["v"]), tm(batch["i"])
    is_event, e_idx = event_match(batch["t"], batch.get("event_t"))
    z_used = tm(jumped_stream(batch["z"], batch.get("z_jump"), is_event, e_idx))[:-1]
    v_used = tm(jumped_stream(batch["v"], batch.get("v_jump"), is_event, e_idx))[:-1]
    ev = tm(is_event)[:-1]

    x0 = model.init_func(zT[0], vT[0], iT[0])
    all_initial = torch.cat([x0, zT[0], vT[0], iT[0]], dim=-1)
    i0 = model.ae_func(all_initial, x0, zT[0], vT[0])
    streams, weights = precompute_streams(
        p, all_initial, zT, vT, z_used, v_used, model.dims
    )
    return streams, weights, x0, i0, tT[1:] - tT[:-1], ev


def fused_dae_apply(
    model: DAEModel,
    batch: Dict[str, torch.Tensor],
    solver=None,
    precision: str = "default",
):
    """Forward the DAE no-encode model through the fused rollout.

    Args:
      model: a :class:`DAEModel`.
      batch: batch-major tensors ``t/x/z/v/i`` and optionally
        ``event_t/z_jump/v_jump``, on the device to run on.
      solver: defaults to ``model.solver``.

    Returns ``(x_pred, i_pred)`` batch-major, the ``DAEModel.forward``
    contract. Where a parameter requires grad (and grad mode is on) the
    result is differentiable; otherwise the call runs under
    ``torch.no_grad()``.
    """
    solver = normalize_solver(model.solver if solver is None else solver)
    with _grad_mode(model):
        streams, weights, x0, i0, dt, ev = rollout_inputs(model, batch)
        x_sol, i_sol = fused_dae_rollout_diff(streams, weights, x0, i0, dt, ev, solver, precision)
    return x_sol.transpose(0, 1), i_sol.transpose(0, 1)


def _grad_mode(model):
    """Grad mode as it is where a parameter of ``model`` requires grad,
    else ``torch.no_grad()``."""
    needs_grad = torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters())
    return contextlib.nullcontext() if needs_grad else torch.no_grad()


def ode_rollout_inputs(model: ODEModel, batch: Dict[str, torch.Tensor]):
    """The fused ODE rollout's inputs for ``model`` on ``batch``:
    ``(s_de, weights, x0, dt)``. ``all_initial`` is ``cat(x[0], z[0])`` of
    the un-jumped ``z``; the jumped ``z`` of each step goes into ``s_de``."""
    tm = lambda a: a.transpose(0, 1)
    is_event, e_idx = event_match(batch["t"], batch.get("event_t"))
    z_used = tm(jumped_stream(batch["z"], batch.get("z_jump"), is_event, e_idx))[:-1]
    tT, xT, zT = tm(batch["t"]).float(), tm(batch["x"]), tm(batch["z"])
    all_initial = torch.cat([xT[0], zT[0]], dim=-1)
    s_de, weights = precompute_ode_streams(flax_params(model), all_initial, z_used, model.x_dim)
    return s_de, weights, xT[0], tT[1:] - tT[:-1]


def fused_ode_apply(model: ODEModel, batch: Dict[str, torch.Tensor], solver=None):
    """Forward the ODE no-encode model through the fused rollout.

    Args:
      model: an :class:`ODEModel`.
      batch: batch-major tensors ``t/x/z`` and optionally
        ``event_t/z_jump``, on the device to run on.
      solver: defaults to ``model.solver``.

    Returns ``x_pred [B, T, xd]``, the ``ODEModel.forward`` contract. Where a
    parameter requires grad (and grad mode is on) the result is
    differentiable; otherwise the call runs under ``torch.no_grad()``.
    """
    solver = normalize_solver(model.solver if solver is None else solver)
    with _grad_mode(model):
        s_de, weights, x0, dt = ode_rollout_inputs(model, batch)
        sol = fused_ode_rollout_diff(s_de, weights, x0, dt, solver)
    return sol.transpose(0, 1)


def ode_encode_rollout_inputs(model: ODEEncodeModel, batch: Dict[str, torch.Tensor]):
    """The fused latent rollout's inputs for the direct-encode ODE on
    ``batch``: ``(s_de, weights, xh0, dt, xh)``, ``xh`` the encoded ``x``
    ``[B, T, h]``. ``all_initial`` is ``cat(xh[0], zh[0])`` of the
    un-jumped encoded ``z``; the jumped encoded ``z`` of each step goes into
    ``s_de``."""
    tm = lambda a: a.transpose(0, 1)
    xh, zh = model.x_encoder(batch["x"]), model.z_encoder(batch["z"])
    z_jump = batch.get("z_jump")
    zh_jump = model.z_encoder(z_jump) if z_jump is not None else None
    is_event, e_idx = event_match(batch["t"], batch.get("event_t"))
    zh_used = tm(jumped_stream(zh, zh_jump, is_event, e_idx))[:-1]
    tT, xhT = tm(batch["t"]).float(), tm(xh)
    all_initial = torch.cat([xhT[0], tm(zh)[0]], dim=-1)
    s_de, weights = precompute_ode_streams({"de_func": flax_params(model.de_func)}, all_initial, zh_used,
                                           model.hidden_dim)
    return s_de, weights, xhT[0], tT[1:] - tT[:-1], xh


def fused_ode_encode_apply(model: ODEEncodeModel, batch: Dict[str, torch.Tensor], solver=None):
    """Forward the direct-encode ODE through the fused rollout: the codecs
    run as plain PyTorch, the latent 2-layer dynamics through the ODE
    kernels at ``xd = h``. Returns batch-major ``(x_pred, x_re)``, the
    ``ODEEncodeModel.forward`` contract. Differentiable where a parameter
    requires grad, else run under ``torch.no_grad()``."""
    solver = normalize_solver(model.solver if solver is None else solver)
    with _grad_mode(model):
        s_de, weights, xh0, dt, xh = ode_encode_rollout_inputs(model, batch)
        xh_sol = fused_ode_rollout_diff(s_de, weights, xh0, dt, solver)
        return model.x_decoder(xh_sol.transpose(0, 1)), model.x_decoder(xh)


def dae_encode_setup(model: DAEEncodeModel, batch: Dict[str, torch.Tensor], tf_x: bool = False,
                     with_streams: bool = True) -> Dict:
    """The preamble shared by the direct-encode DAE's fused and
    teacher-forced forwards: the codecs and Init, the events jumped in
    latent space, the initial algebraic evaluation, and the layer-1 stream
    precompute at ``dims = (h, zl, h, h)`` (skipped where
    ``with_streams`` is False: the time-parallel path evaluates the nets).
    ``i0`` is the AE at the encoded Init state ``xh0``, or under ``tf_x``
    at the encoded true initial state (the ``integrate_dae`` rule of
    teacher forcing).

    Returns a dict: ``x0`` (the raw Init output), ``xh0``, ``xh`` and ``ih``
    (the encoded ``x`` and ``i``, batch-major), ``all_initial``, ``i0``,
    ``streams``/``weights`` (None without streams), ``tT``, ``dt``, ``ev``,
    and the time-major latent streams ``zhT``, ``vhT``, ``ihT``, ``xhT``,
    ``zh_used``, ``vh_used``.
    """
    tm = lambda a: a.transpose(0, 1)
    tT = tm(batch["t"]).float()
    zT, vT, iT = tm(batch["z"]), tm(batch["v"]), tm(batch["i"])
    x0 = model.init_func(zT[0], vT[0], iT[0])
    xh0 = model.x_encoder(x0)
    xh, zh = model.x_encoder(batch["x"]), model.encode_z(batch["z"])
    vh, ih = model.v_encoder(batch["v"]), model.i_encoder(batch["i"])
    z_jump, v_jump = batch.get("z_jump"), batch.get("v_jump")
    zh_jump = model.encode_z(z_jump) if z_jump is not None else None
    vh_jump = model.v_encoder(v_jump) if v_jump is not None else None
    is_event, e_idx = event_match(batch["t"], batch.get("event_t"))
    zh_used = tm(jumped_stream(zh, zh_jump, is_event, e_idx))[:-1]
    vh_used = tm(jumped_stream(vh, vh_jump, is_event, e_idx))[:-1]
    xhT, zhT, vhT, ihT = tm(xh), tm(zh), tm(vh), tm(ih)
    all_initial = torch.cat([xh0, zhT[0], vhT[0], ihT[0]], dim=-1)
    i0 = model.ae_func(all_initial, xhT[0] if tf_x else xh0, zhT[0], vhT[0])
    streams = weights = None
    if with_streams:
        p = {k: flax_params(getattr(model, k)) for k in ("de_func", "ae_func")}
        streams, weights = precompute_streams(p, all_initial, zhT, vhT, zh_used, vh_used, model.latent_dims)
    return dict(x0=x0, xh0=xh0, xh=xh, ih=ih, xhT=xhT, zhT=zhT, vhT=vhT, ihT=ihT, zh_used=zh_used,
                vh_used=vh_used, ev=tm(is_event)[:-1], all_initial=all_initial, i0=i0, streams=streams,
                weights=weights, tT=tT, dt=tT[1:] - tT[:-1])


def dae_encode_outputs(model: DAEEncodeModel, s: Dict, xh_sol, ih_sol):
    """Decode the latent solutions ``[T, B, h]`` into the
    ``DAEEncodeModel.forward`` 4-tuple ``(x_pred, i_pred, x_re, i_re)``
    batch-major, the first row of ``x_pred`` the raw Init output (ref
    neural_01_DAE_02_direct_encode.py:150)."""
    x_pred = torch.cat([s["x0"][None], model.x_decoder(xh_sol[1:])])
    return (x_pred.transpose(0, 1), model.i_decoder(ih_sol).transpose(0, 1), model.x_decoder(s["xh"]),
            model.i_decoder(s["ih"]))


def fused_dae_encode_apply(model: DAEEncodeModel, batch: Dict[str, torch.Tensor], solver=None):
    """Forward the direct-encode DAE through the fused rollout: the codecs
    and Init as plain PyTorch (:func:`dae_encode_setup`), the latent 2-layer
    DE and AE nets through the DAE kernels at ``dims = (h, zl, h, h)``, the
    decoders after (:func:`dae_encode_outputs`). Returns ``(x_pred, i_pred,
    x_re, i_re)`` batch-major, the ``DAEEncodeModel.forward`` contract.
    Differentiable where a parameter requires grad, else run under
    ``torch.no_grad()``."""
    solver = normalize_solver(model.solver if solver is None else solver)
    with _grad_mode(model):
        s = dae_encode_setup(model, batch)
        xh_sol, ih_sol = fused_dae_rollout_diff(s["streams"], s["weights"], s["xh0"], s["i0"], s["dt"], s["ev"],
                                                solver)
        return dae_encode_outputs(model, s, xh_sol, ih_sol)


def cw_rollout_inputs(model, batch: Dict[str, torch.Tensor]):
    """The fused channel-wise rollout's inputs for ``model`` (either
    channel-wise model) on ``batch``: ``(streams, weights, xh0, dt)``.
    ``f_init`` uses the un-jumped ``z[0]``; the z-features of every step use
    the jumped stream."""
    de = model.de_func
    tm = lambda a: a.transpose(0, 1)
    is_event, e_idx = event_match(batch["t"], batch.get("event_t"))
    z_used = tm(jumped_stream(batch["z"], batch.get("z_jump"), is_event, e_idx))[:-1]
    tT, xT, zT = tm(batch["t"]).float(), tm(batch["x"]), tm(batch["z"])
    xh0 = de.encode_x(xT[0])  # [B, xd, h]
    f_init = de.features_of(xh0, zT[0])
    streams, weights = precompute_cw_streams(flax_params(model), f_init, de.z_features(z_used))
    return streams, weights, xh0, tT[1:] - tT[:-1]


def _cw_latent(model, batch, solver):
    solver = normalize_solver(model.solver if solver is None else solver)
    streams, weights, xh0, dt = cw_rollout_inputs(model, batch)
    return fused_cw_rollout_diff(streams, weights, xh0, dt, solver)  # [T, B, xd, h]


def fused_cw_ode_apply(model: ChannelWiseODEModel, batch: Dict[str, torch.Tensor], solver=None):
    """Forward the channel-wise ODE through the fused rollout: returns
    batch-major ``(x_pred, x_re)``, the ``ChannelWiseODEModel.forward``
    contract. Differentiable where a parameter requires grad, else run
    under ``torch.no_grad()``."""
    de = model.de_func
    with _grad_mode(model):
        xh_sol = _cw_latent(model, batch, solver)
        return de.decode_x(xh_sol).transpose(0, 1), de.decode_x(de.encode_x(batch["x"]))


def fused_cw_dae_apply(model: ChannelWiseDAEModel, batch: Dict[str, torch.Tensor], solver=None):
    """Forward the channel-wise DAE through the fused rollout: returns
    batch-major ``(x_pred, i_pred, x_re)``, the ``ChannelWiseDAEModel``
    contract. The algebraic readout runs over all T at once after the
    rollout, as plain PyTorch."""
    de = model.de_func
    with _grad_mode(model):
        xh_sol = _cw_latent(model, batch, solver)
        i_pred = model.ae_func(xh_sol, batch["v"].transpose(0, 1))
        return (de.decode_x(xh_sol).transpose(0, 1), i_pred.transpose(0, 1),
                de.decode_x(de.encode_x(batch["x"])))
