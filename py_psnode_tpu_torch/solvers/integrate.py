"""Fixed-grid ODE and semi-explicit DAE rollouts, forward only (counterpart
of ``py_psnode_tpu/solvers/integrate.py``: ``integrate_ode`` :101,
``integrate_dae``).

These are the plain, step-by-step paths: a Python loop over the time grid
that evaluates the nets as they are, without the layer-1 lift of the fused
path. They are the second, independent check of the fused rollouts.
Teacher forcing, rematerialization and the discrete adjoint are not ported
yet.

ODE semantics (ref my_solvers.py:52-80): ``x_solution[0] = x0``; step ``j``
advances the rolled state from ``t[j]`` to ``t[j+1]`` with the
event-adjusted input ``z_step[j]``.

DAE semantics (ref my_solvers.py:82-131):
  * ``i_solution[0] = g(x0, z[0], v[0])``;
  * each step consumes the *lagged* algebraic output from the previous step
    (explicit discretization, no Newton solve), then
    ``i[j] = g(x[j], z[j], v[j])`` with raw (un-jumped) inputs;
  * on an event step the algebraic output is first recomputed from the
    jumped inputs at the rolled state, per sample.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from py_psnode_tpu_torch.solvers.steppers import get_stepper


def integrate_ode(stepper, de_fn: Callable, t: torch.Tensor, x0: torch.Tensor,
                  z_step: torch.Tensor) -> torch.Tensor:
    """Integrate ``dx/dt = de_fn(t, x, z)`` on the sample's time grid.

    Args:
      de_fn: ``(t, x, z) -> dx/dt``; any conditioning on the initial state
        is closed over by the caller.
      t: ``[T, B, 1]`` time grid; x0: ``[B, xd]`` initial state.
      z_step: ``[T-1, B, zd]`` event-adjusted inputs per step.

    Returns ``[T, B, xd]`` with ``solution[0] == x0``.
    """
    stepper = get_stepper(stepper)
    xs = [x0]
    for j in range(t.shape[0] - 1):
        t0, t1, z0 = t[j], t[j + 1], z_step[j]
        f = lambda tt, xx: de_fn(tt, xx, z0)
        xs.append(xs[-1] + stepper(f, t0, t1 - t0, t1, xs[-1]))
    return torch.stack(xs)


def integrate_dae(
    stepper,
    de_fn: Callable,
    ae_fn: Callable,
    x_init: torch.Tensor,
    t: torch.Tensor,
    z: torch.Tensor,
    v: torch.Tensor,
    z_step: torch.Tensor,
    v_step: torch.Tensor,
    is_event: Optional[torch.Tensor] = None,
):
    """Integrate ``dx/dt = f(x, z, v, i)``, ``i = g(x, z, v)``.

    Args:
      de_fn: ``(t, x, z, v, i) -> dx/dt``; ae_fn: ``(x, z, v) -> i``.
      x_init: ``[B, xd]`` learned consistent initial state.
      t: ``[T, B, 1]`` time grid; z, v: ``[T, B, *]`` raw input streams.
      z_step, v_step: ``[T-1, B, *]`` event-adjusted inputs per step.
      is_event: ``[T-1, B]`` bool, True where the step's start time is an
        event time; None means no events.

    Returns ``(x_solution [T, B, xd], i_solution [T, B, id])``.
    """
    stepper = get_stepper(stepper)
    T = t.shape[0]
    x_prev = x_init
    i_prev = ae_fn(x_init, z[0], v[0])
    # one host read of the per-step "any event" flags instead of one per step
    any_ev = [False] * (T - 1) if is_event is None else is_event.any(dim=1).tolist()
    xs, is_ = [x_prev], [i_prev]
    for j in range(T - 1):
        t0, t1 = t[j], t[j + 1]
        z0s, v0s = z_step[j], v_step[j]
        i_in = i_prev
        if any_ev[j]:
            i_ev = ae_fn(x_prev, z0s, v0s)
            i_in = torch.where(is_event[j][:, None], i_ev, i_prev)
        f = lambda tt, xx: de_fn(tt, xx, z0s, v0s, i_in)
        x_prev = x_prev + stepper(f, t0, t1 - t0, t1, x_prev)
        i_prev = ae_fn(x_prev, z[j + 1], v[j + 1])
        xs.append(x_prev)
        is_.append(i_prev)
    return torch.stack(xs), torch.stack(is_)
