"""DAE no-encode model (counterpart of ``py_psnode_tpu/models/dae.py:27-100``).

``dx/dt = f(x, z, v, i)``, ``i = g(x, z, v)`` with the learned consistent
initialization ``x0 = Init(z0, v0, i0)``; the algebraic output enters the
differential step lagged by one step. This module runs the plain rollout
(:func:`~py_psnode_tpu_torch.solvers.integrate_dae`); the fused path is
:func:`py_psnode_tpu_torch.ops.fused_model.fused_dae_apply`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from py_psnode_tpu_torch.models.funcs import AEFunc, DEFunc, InitFunc
from py_psnode_tpu_torch.solvers import event_match, integrate_dae, jumped_stream


def _tm(a):
    return a.transpose(0, 1)


class DAEModel(nn.Module):
    """DAE no-encode (ref neural_01_DAE_01_no_encode.py:86-133).

    ``forward`` returns ``(x_solution, i_solution)`` batch-major. The
    pure-latent mode ``x_dim == 0`` is not ported yet.
    """

    def __init__(
        self,
        x_dim: int,
        z_dim: int,
        v_dim: int,
        i_dim: int,
        hidden_dim: int,
        solver: str = "euler",
        device=None,
    ):
        super().__init__()
        if x_dim <= 0:
            raise NotImplementedError("the pure-latent mode x_dim == 0 is not ported yet")
        self.x_dim, self.z_dim, self.v_dim, self.i_dim = x_dim, z_dim, v_dim, i_dim
        self.hidden_dim = h = hidden_dim
        self.solver = solver
        d_u = x_dim + z_dim + v_dim + i_dim
        self.init_func = InitFunc(z_dim + v_dim + i_dim, (h, h, x_dim), device=device)
        self.de_func = DEFunc(d_u, (h, h, h, x_dim), device=device)
        self.ae_func = AEFunc(d_u + x_dim + z_dim + v_dim, (h, h, h, i_dim), device=device)

    @property
    def dims(self):
        return (self.x_dim, self.z_dim, self.v_dim, self.i_dim)

    def forward(
        self,
        t,
        x,
        z,
        v,
        i,
        event_t: Optional[torch.Tensor] = None,
        z_jump: Optional[torch.Tensor] = None,
        v_jump: Optional[torch.Tensor] = None,
    ):
        is_event, e_idx = event_match(t, event_t)
        z_used = jumped_stream(z, z_jump, is_event, e_idx)
        v_used = jumped_stream(v, v_jump, is_event, e_idx)

        tT, zT, vT, iT = _tm(t), _tm(z), _tm(v), _tm(i)
        x0 = self.init_func(zT[0], vT[0], iT[0])
        all_initial = torch.cat([x0, zT[0], vT[0], iT[0]], dim=-1)
        de_fn = lambda tt, xx, zz, vv, ii: self.de_func(tt, all_initial, xx, zz, vv, ii)
        ae_fn = lambda xx, zz, vv: self.ae_func(all_initial, xx, zz, vv)
        x_sol, i_sol = integrate_dae(
            self.solver,
            de_fn,
            ae_fn,
            x0,
            tT,
            zT,
            vT,
            _tm(z_used)[:-1],
            _tm(v_used)[:-1],
            is_event=_tm(is_event)[:-1],
        )
        return _tm(x_sol), _tm(i_sol)
