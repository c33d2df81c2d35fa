"""Teacher-forced forwards of the four non-channel-wise variants (counterpart
of ``py_psnode_tpu/ops/teacher_forcing.py``).

Teacher forcing changes the shape of the problem:

  * ``input_true_x`` on an ODE: every step reads the true previous state,
    so no step depends on another; the ``T-1`` dynamics evaluations run as
    one batched ``[T-1, B]`` evaluation of the net in plain PyTorch
    (:func:`tf_parallel_ode_apply`, :func:`tf_parallel_ode_encode_apply`).
    The JAX package runs these outside any Pallas kernel as well.
  * ``input_true_i`` on a DAE: the lagged algebraic input is known, so its
    projection folds into the precomputed layer-1 stream and the
    differential rollout is an ODE in ``x`` through the ODE kernels 3-4
    (:func:`fused_dae_tf_i_apply`, :func:`fused_dae_encode_tf_i_apply`);
    the algebraic readout then runs at all steps at once. The event
    recompute never feeds the step under ``input_true_i`` (ref
    my_solvers.py:113).
  * ``input_true_x`` on a DAE: the TF-x mode of kernels 1-2
    (:func:`fused_dae_tf_x_apply`, :func:`fused_dae_encode_tf_x_apply`):
    each step starts from the true state, the AE at t+1 reads the true
    state, and the event recompute the rolled carry, which the kernel
    keeps.
  * both on a DAE: both carries come from data and the event recompute is
    dead, so every step is independent: one batched evaluation
    (:func:`tf_parallel_dae_apply`, :func:`tf_parallel_dae_encode_apply`).

The kernel entries take ``precision``; under ``"bfloat16"`` the two TF-i
ones run kernels 3-4 in their bf16 compute mode and the TF-x ones kernels
1-2 in theirs (the encode form's true-state cotangents float32). The direct-encode variants teacher-force in latent space
(``x_true = x_encoder(x)``, ``i_true = i_encoder(i)``). Every entry takes the model and
a batch-major batch, returns its model's ``forward`` contract, and is
differentiable where a parameter requires grad (else it runs under
``torch.no_grad()``).
"""

from __future__ import annotations

from typing import Dict

import torch

from py_psnode_tpu_torch.bridge import flax_params
from py_psnode_tpu_torch.models.dae import DAEEncodeModel, DAEModel
from py_psnode_tpu_torch.models.ode import ODEEncodeModel, ODEModel
from py_psnode_tpu_torch.ops.fused_dae import normalize_solver, precompute_streams
from py_psnode_tpu_torch.ops.fused_dae_vjp import fused_dae_tf_x_rollout_diff
from py_psnode_tpu_torch.ops.fused_model import _grad_mode, dae_encode_outputs, dae_encode_setup
from py_psnode_tpu_torch.ops.fused_ode_vjp import fused_ode_rollout_diff
from py_psnode_tpu_torch.solvers import event_match, get_stepper, jumped_stream


def _tm(a):
    return a.transpose(0, 1)


def _over_steps(a, Tm1):
    """``a [B, d]`` broadcast over the ``T-1`` steps."""
    return a.expand(Tm1, *a.shape)


def _parallel_step(stepper, f, tT, x_in):
    """``x_in + step(f)`` from ``t[:-1]`` to ``t[1:]`` at every step at once."""
    t0, t1 = tT[:-1], tT[1:]
    return x_in + stepper(f, t0, t1 - t0, t1, x_in)


def tf_parallel_ode_apply(model: ODEModel, batch: Dict[str, torch.Tensor], solver=None):
    """``ODEModel.forward(..., input_true_x=True)`` parallel over time:
    ``x[j] = x_true[j-1] + step(f; x_true[j-1], z_step[j-1])`` for every j
    at once. Returns batch-major ``x_pred``."""
    stepper = get_stepper(model.solver if solver is None else solver)
    with _grad_mode(model):
        is_event, e_idx = event_match(batch["t"], batch.get("event_t"))
        z_used = _tm(jumped_stream(batch["z"], batch.get("z_jump"), is_event, e_idx))[:-1]
        tT, xT, zT = _tm(batch["t"]).float(), _tm(batch["x"]), _tm(batch["z"])
        init_b = _over_steps(torch.cat([xT[0], zT[0]], dim=-1), tT.shape[0] - 1)
        x1 = _parallel_step(stepper, lambda tt, xx: model.de_func(tt, init_b, xx, z_used), tT, xT[:-1])
        return _tm(torch.cat([xT[0][None], x1]))


def _dae_tf_setup(model: DAEModel, batch: Dict[str, torch.Tensor], tf_x: bool, with_streams: bool = True):
    """The teacher-forced no-encode DAE's preamble: the event streams, Init,
    the AE at t=0 (at the true ``x[0]`` under ``tf_x``, ref
    my_solvers.py:95) and, for the kernel paths, the layer-1 stream
    precompute (``with_streams=False`` skips it: the time-parallel path
    evaluates the nets). Returns a dict of time-major tensors."""
    tT = _tm(batch["t"]).float()
    xT, zT, vT, iT = (_tm(batch[k]) for k in ("x", "z", "v", "i"))
    is_event, e_idx = event_match(batch["t"], batch.get("event_t"))
    z_used = _tm(jumped_stream(batch["z"], batch.get("z_jump"), is_event, e_idx))[:-1]
    v_used = _tm(jumped_stream(batch["v"], batch.get("v_jump"), is_event, e_idx))[:-1]
    x0 = model.init_func(zT[0], vT[0], iT[0])
    all_initial = torch.cat([x0, zT[0], vT[0], iT[0]], dim=-1)
    i0 = model.ae_func(all_initial, xT[0] if tf_x else x0, zT[0], vT[0])
    streams = weights = None
    if with_streams:
        streams, weights = precompute_streams(flax_params(model), all_initial, zT, vT, z_used, v_used,
                                              model.dims)
    return dict(tT=tT, xT=xT, zT=zT, vT=vT, iT=iT, z_used=z_used, v_used=v_used, ev=_tm(is_event)[:-1],
                x0=x0, all_initial=all_initial, i0=i0, streams=streams, weights=weights, dt=tT[1:] - tT[:-1])


def fused_dae_tf_x_apply(model: DAEModel, batch: Dict[str, torch.Tensor], solver=None, precision: str = "default"):
    """``DAEModel.forward(..., input_true_x=True)`` through the TF-x mode
    of kernels 1-2. The true states are raw data: the backward computes no
    cotangent for them. Returns ``(x_pred, i_pred)`` batch-major."""
    solver = normalize_solver(model.solver if solver is None else solver)
    with _grad_mode(model):
        s = _dae_tf_setup(model, batch, True)
        x_sol, i_sol = fused_dae_tf_x_rollout_diff(s["streams"], s["weights"], s["x0"], s["i0"], s["xT"], s["dt"],
                                                   s["ev"], solver, precision)
        return _tm(x_sol), _tm(i_sol)


def tf_parallel_dae_apply(model: DAEModel, batch: Dict[str, torch.Tensor], solver=None):
    """``DAEModel.forward(..., input_true_x=True, input_true_i=True)``
    parallel over time: one batched evaluation of the DE at the true
    ``(x, i)`` of every step and of the AE at the true ``x`` of every step.
    Returns ``(x_pred, i_pred)`` batch-major."""
    stepper = get_stepper(model.solver if solver is None else solver)
    with _grad_mode(model):
        s = _dae_tf_setup(model, batch, True, with_streams=False)
        xT, zT, vT, iT = s["xT"], s["zT"], s["vT"], s["iT"]
        init_b = _over_steps(s["all_initial"], xT.shape[0] - 1)
        f = lambda tt, xx: model.de_func(tt, init_b, xx, s["z_used"], s["v_used"], iT[:-1])
        x1 = _parallel_step(stepper, f, s["tT"], xT[:-1])
        i_rest = model.ae_func(init_b, xT[1:], zT[1:], vT[1:])
        return _tm(torch.cat([s["x0"][None], x1])), _tm(torch.cat([s["i0"][None], i_rest]))


def _tf_i_rollout(streams, weights, i_true, x0, dt, solver, precision="default"):
    """The differential rollout under ``input_true_i``: the true lagged
    ``i`` projection folded into ``s_de`` (float32), then the ODE kernels
    3-4 in the compute mode of ``precision``."""
    s_de = streams["s_de"] + i_true[:-1] @ weights["wi_de"]
    return fused_ode_rollout_diff(s_de, dict(wx_de=weights["wx_de"], de_tail=weights["de_tail"]), x0, dt, solver,
                                  precision)


def fused_dae_tf_i_apply(model: DAEModel, batch: Dict[str, torch.Tensor], solver=None, precision: str = "default"):
    """``DAEModel.forward(..., input_true_i=True)``: the rollout through
    the ODE kernels 3-4 (:func:`_tf_i_rollout`), then the AE at every
    rolled state at once. Returns ``(x_pred, i_pred)`` batch-major."""
    solver = normalize_solver(model.solver if solver is None else solver)
    with _grad_mode(model):
        s = _dae_tf_setup(model, batch, False)
        x_sol = _tf_i_rollout(s["streams"], s["weights"], s["iT"], s["x0"], s["dt"], solver, precision)
        init_b = _over_steps(s["all_initial"], x_sol.shape[0] - 1)
        i_rest = model.ae_func(init_b, x_sol[1:], s["zT"][1:], s["vT"][1:])
        return _tm(x_sol), _tm(torch.cat([s["i0"][None], i_rest]))


# ------------------------------------------- direct-encode, in latent space


def tf_parallel_ode_encode_apply(model: ODEEncodeModel, batch: Dict[str, torch.Tensor], solver=None):
    """``ODEEncodeModel.forward(..., input_true_x=True)`` parallel over
    time, every step from the encoded true state. Returns ``(x_pred,
    x_re)`` batch-major."""
    stepper = get_stepper(model.solver if solver is None else solver)
    with _grad_mode(model):
        xh, zh = model.x_encoder(batch["x"]), model.z_encoder(batch["z"])
        z_jump = batch.get("z_jump")
        zh_jump = model.z_encoder(z_jump) if z_jump is not None else None
        is_event, e_idx = event_match(batch["t"], batch.get("event_t"))
        zh_used = _tm(jumped_stream(zh, zh_jump, is_event, e_idx))[:-1]
        tT, xhT = _tm(batch["t"]).float(), _tm(xh)
        init_b = _over_steps(torch.cat([xhT[0], _tm(zh)[0]], dim=-1), tT.shape[0] - 1)
        x1 = _parallel_step(stepper, lambda tt, xx: model.de_func(tt, init_b, xx, zh_used), tT, xhT[:-1])
        return model.x_decoder(_tm(torch.cat([xhT[0][None], x1]))), model.x_decoder(xh)


def fused_dae_encode_tf_x_apply(model: DAEEncodeModel, batch: Dict[str, torch.Tensor], solver=None,
                                precision: str = "default"):
    """``DAEEncodeModel.forward(..., input_true_x=True)`` through the TF-x
    mode of kernels 1-2 at the latent shape, the true states the encoded
    ``x`` (their cotangents computed: they reach the x encoder). Returns
    the 4-tuple contract."""
    solver = normalize_solver(model.solver if solver is None else solver)
    with _grad_mode(model):
        s = dae_encode_setup(model, batch, tf_x=True)
        xh_sol, ih_sol = fused_dae_tf_x_rollout_diff(s["streams"], s["weights"], s["xh0"], s["i0"], s["xhT"],
                                                     s["dt"], s["ev"], solver, precision)
        return dae_encode_outputs(model, s, xh_sol, ih_sol)


def fused_dae_encode_tf_i_apply(model: DAEEncodeModel, batch: Dict[str, torch.Tensor], solver=None,
                                precision: str = "default"):
    """``DAEEncodeModel.forward(..., input_true_i=True)``: the encoded true
    ``i`` folded into the stream, the latent rollout through the ODE
    kernels 3-4 at ``xd = h``, the AE at every rolled latent state at once.
    Returns the 4-tuple contract."""
    solver = normalize_solver(model.solver if solver is None else solver)
    with _grad_mode(model):
        s = dae_encode_setup(model, batch)
        xh_sol = _tf_i_rollout(s["streams"], s["weights"], s["ihT"], s["xh0"], s["dt"], solver, precision)
        init_b = _over_steps(s["all_initial"], xh_sol.shape[0] - 1)
        i_rest = model.ae_func(init_b, xh_sol[1:], s["zhT"][1:], s["vhT"][1:])
        return dae_encode_outputs(model, s, xh_sol, torch.cat([s["i0"][None], i_rest]))


def tf_parallel_dae_encode_apply(model: DAEEncodeModel, batch: Dict[str, torch.Tensor], solver=None):
    """``DAEEncodeModel.forward(..., input_true_x=True,
    input_true_i=True)`` parallel over time, both latent carries from the
    encoded data. Returns the 4-tuple contract."""
    stepper = get_stepper(model.solver if solver is None else solver)
    with _grad_mode(model):
        s = dae_encode_setup(model, batch, tf_x=True, with_streams=False)
        xhT, zhT, vhT, ihT = s["xhT"], s["zhT"], s["vhT"], s["ihT"]
        init_b = _over_steps(s["all_initial"], xhT.shape[0] - 1)
        f = lambda tt, xx: model.de_func(tt, init_b, xx, s["zh_used"], s["vh_used"], ihT[:-1])
        x1 = _parallel_step(stepper, f, s["tT"], xhT[:-1])
        i_rest = model.ae_func(init_b, xhT[1:], zhT[1:], vhT[1:])
        return dae_encode_outputs(model, s, torch.cat([s["xh0"][None], x1]),
                                  torch.cat([s["i0"][None], i_rest]))
