"""ODE no-encode model (counterpart of ``py_psnode_tpu/models/ode.py:27-75``).

``dx/dt = f(x, z)`` with a 4-layer skip-augmented dynamics net on the raw
states, conditioned on ``all_initial = cat(x[0], z[0])`` (the un-jumped
``z``); at an event step the exogenous input is the stored post-jump value.
This module runs the plain rollout
(:func:`~py_psnode_tpu_torch.solvers.integrate_ode`); the fused path is
:func:`py_psnode_tpu_torch.ops.fused_model.fused_ode_apply`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from py_psnode_tpu_torch.models.funcs import DEFunc
from py_psnode_tpu_torch.solvers import event_match, integrate_ode, jumped_stream


def _tm(a):
    return a.transpose(0, 1)


class ODEModel(nn.Module):
    """ODE no-encode (ref neural_00_ODE_01_no_encode.py:71-101).

    ``forward`` returns ``x_solution`` batch-major ``[B, T, xd]``, whose
    first row is ``x[:, 0]``.
    """

    def __init__(self, x_dim: int, z_dim: int, hidden_dim: int, solver: str = "euler",
                 device=None):
        super().__init__()
        self.x_dim, self.z_dim = x_dim, z_dim
        self.hidden_dim = h = hidden_dim
        self.solver = solver
        self.de_func = DEFunc(x_dim + z_dim, (h, h, h, x_dim), device=device)

    def forward(
        self,
        t,
        x,
        z,
        event_t: Optional[torch.Tensor] = None,
        z_jump: Optional[torch.Tensor] = None,
    ):
        is_event, e_idx = event_match(t, event_t)
        z_used = jumped_stream(z, z_jump, is_event, e_idx)
        tT, xT = _tm(t), _tm(x)
        all_initial = torch.cat([xT[0], _tm(z)[0]], dim=-1)
        de_fn = lambda tt, xx, zz: self.de_func(tt, all_initial, xx, zz)
        sol = integrate_ode(self.solver, de_fn, tT, xT[0], _tm(z_used)[:-1])
        return _tm(sol)
