"""Fixed-grid ODE and semi-explicit DAE rollouts, forward only (counterpart
of ``py_psnode_tpu/solvers/integrate.py``: ``integrate_ode`` :101,
``integrate_dae``).

These are the plain, step-by-step paths: a Python loop over the time grid
that evaluates the nets as they are, without the layer-1 lift of the fused
path. They are the second, independent check of the fused rollouts.
Rematerialization and the discrete adjoint are not ported yet.

ODE semantics (ref my_solvers.py:52-80): ``x_solution[0] = x0``; step ``j``
advances the rolled state (the true ``x[j]`` under ``input_true_x``) from
``t[j]`` to ``t[j+1]`` with the event-adjusted input ``z_step[j]``.

DAE semantics (ref my_solvers.py:82-131):
  * ``i_solution[0] = g(x0, z[0], v[0])``;
  * each step consumes the *lagged* algebraic output from the previous step
    (explicit discretization, no Newton solve), then
    ``i[j] = g(x[j], z[j], v[j])`` with raw (un-jumped) inputs;
  * on an event step the algebraic output is first recomputed from the
    jumped inputs at the rolled state, per sample;
  * teacher forcing: ``input_true_x`` steps from the true ``x[j-1]`` and
    evaluates ``g`` at the true ``x[j]``, ``i_solution[0]`` at the true
    ``x[0]``, while the event recompute still reads the rolled state;
    ``input_true_i`` feeds the true ``i[j-1]`` to the step and skips the
    event recompute (ref :108-121).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from py_psnode_tpu_torch.solvers.steppers import get_stepper


def integrate_ode(stepper, de_fn: Callable, t: torch.Tensor, x0: torch.Tensor,
                  z_step: torch.Tensor, x_true: Optional[torch.Tensor] = None, *,
                  input_true_x: bool = False) -> torch.Tensor:
    """Integrate ``dx/dt = de_fn(t, x, z)`` on the sample's time grid.

    Args:
      de_fn: ``(t, x, z) -> dx/dt``; any conditioning on the initial state
        is closed over by the caller.
      t: ``[T, B, 1]`` time grid; x0: ``[B, xd]`` initial state.
      z_step: ``[T-1, B, zd]`` event-adjusted inputs per step.
      x_true: ``[T, B, xd]`` true states, read under ``input_true_x``.
      input_true_x: teacher forcing, every step from the true ``x[j]``.

    Returns ``[T, B, xd]`` with ``solution[0] == x0``.
    """
    stepper = get_stepper(stepper)
    if input_true_x and x_true is None:
        raise ValueError("input_true_x needs x_true")
    xs = [x0]
    for j in range(t.shape[0] - 1):
        t0, t1, z0 = t[j], t[j + 1], z_step[j]
        x_in = x_true[j] if input_true_x else xs[-1]
        f = lambda tt, xx: de_fn(tt, xx, z0)
        xs.append(x_in + stepper(f, t0, t1 - t0, t1, x_in))
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
    x_true: Optional[torch.Tensor] = None,
    i_true: Optional[torch.Tensor] = None,
    *,
    input_true_x: bool = False,
    input_true_i: bool = False,
):
    """Integrate ``dx/dt = f(x, z, v, i)``, ``i = g(x, z, v)``.

    Args:
      de_fn: ``(t, x, z, v, i) -> dx/dt``; ae_fn: ``(x, z, v) -> i``.
      x_init: ``[B, xd]`` learned consistent initial state.
      t: ``[T, B, 1]`` time grid; z, v: ``[T, B, *]`` raw input streams.
      z_step, v_step: ``[T-1, B, *]`` event-adjusted inputs per step.
      is_event: ``[T-1, B]`` bool, True where the step's start time is an
        event time; None means no events.
      x_true, i_true: ``[T, B, *]`` true trajectories, read under the
        matching teacher-forcing switch.
      input_true_x / input_true_i: the teacher-forcing switches.

    Returns ``(x_solution [T, B, xd], i_solution [T, B, id])``.
    """
    stepper = get_stepper(stepper)
    if (input_true_x and x_true is None) or (input_true_i and i_true is None):
        raise ValueError("input_true_x needs x_true and input_true_i needs i_true")
    T = t.shape[0]
    x_prev = x_init
    i_prev = ae_fn(x_true[0] if input_true_x else x_init, z[0], v[0])
    # one host read of the per-step "any event" flags instead of one per
    # step; under input_true_i the recompute never feeds the step
    no_ev = is_event is None or input_true_i
    any_ev = [False] * (T - 1) if no_ev else is_event.any(dim=1).tolist()
    xs, is_ = [x_prev], [i_prev]
    for j in range(T - 1):
        t0, t1 = t[j], t[j + 1]
        z0s, v0s = z_step[j], v_step[j]
        i_in = i_true[j] if input_true_i else i_prev
        if any_ev[j]:  # at the rolled state, also under input_true_x
            i_ev = ae_fn(x_prev, z0s, v0s)
            i_in = torch.where(is_event[j][:, None], i_ev, i_prev)
        x_in = x_true[j] if input_true_x else x_prev
        f = lambda tt, xx: de_fn(tt, xx, z0s, v0s, i_in)
        x_prev = x_in + stepper(f, t0, t1 - t0, t1, x_in)
        i_prev = ae_fn(x_true[j + 1] if input_true_x else x_prev, z[j + 1], v[j + 1])
        xs.append(x_prev)
        is_.append(i_prev)
    return torch.stack(xs), torch.stack(is_)
