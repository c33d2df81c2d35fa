"""Model-level entry of the fused DAE path, forward only (counterpart of
``py_psnode_tpu/ops/fused_model.py:22-69``).

Drop-in for ``DAEModel.forward``: the Init/AE initial evaluations and the
stream precompute run as plain PyTorch, the time loop runs through
:func:`~py_psnode_tpu_torch.ops.fused_dae.fused_dae_rollout` (the CUDA
kernel on the card). The backward kernel and its ``autograd.Function`` are
not ported yet, so this entry refuses parameters that require grad.
"""

from __future__ import annotations

from typing import Dict

import torch

from py_psnode_tpu_torch.bridge import flax_params
from py_psnode_tpu_torch.models.dae import DAEModel
from py_psnode_tpu_torch.ops.fused_dae import (
    fused_dae_rollout,
    normalize_solver,
    precompute_streams,
)
from py_psnode_tpu_torch.solvers import event_match, jumped_stream


def rollout_inputs(model: DAEModel, batch: Dict[str, torch.Tensor]):
    """The fused rollout's inputs for ``model`` on ``batch``:
    ``(streams, weights, x0, i0, dt, ev)`` as :func:`fused_dae_rollout`
    takes them. Runs the Init/AE initial evaluations, the event streams
    and the layer-1 precompute; call it under ``torch.no_grad()``."""
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
      model: a :class:`DAEModel` whose parameters do not require grad.
      batch: batch-major tensors ``t/x/z/v/i`` and optionally
        ``event_t/z_jump/v_jump``, on the device to run on.
      solver: defaults to ``model.solver``.

    Returns ``(x_pred, i_pred)`` batch-major, the ``DAEModel.forward``
    contract.
    """
    if any(p.requires_grad for p in model.parameters()):
        raise RuntimeError(
            "fused_dae_apply is forward-only in this port: the backward "
            "kernel is not ported yet. Call model.requires_grad_(False) to "
            "evaluate, or use the plain DAEModel forward"
        )
    solver = normalize_solver(model.solver if solver is None else solver)
    with torch.no_grad():
        streams, weights, x0, i0, dt, ev = rollout_inputs(model, batch)
        x_sol, i_sol = fused_dae_rollout(streams, weights, x0, i0, dt, ev, solver, precision)
    return x_sol.transpose(0, 1), i_sol.transpose(0, 1)
