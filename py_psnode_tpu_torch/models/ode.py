"""ODE no-encode and direct-encode models (counterpart of
``py_psnode_tpu/models/ode.py:27-137``).

No-encode: ``dx/dt = f(x, z)`` with a 4-layer skip-augmented dynamics net
on the raw states, conditioned on ``all_initial = cat(x[0], z[0])`` (the
un-jumped ``z``); at an event step the exogenous input is the stored
post-jump value. Direct-encode: the same rollout in a latent space of width
``h``, with codecs for ``x`` and ``z``, a 2-layer dynamics net, and events
jumping the encoded ``z``. ``input_true_x`` teacher-forces the rollout,
the direct-encode one in latent space (``x_true = x_encoder(x)``). These
modules run the plain rollout
(:func:`~py_psnode_tpu_torch.solvers.integrate_ode`); the fused paths are
:func:`py_psnode_tpu_torch.ops.fused_model.fused_ode_apply` and
:func:`~py_psnode_tpu_torch.ops.fused_model.fused_ode_encode_apply`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from py_psnode_tpu_torch.models.funcs import Codec, DEFunc
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
        input_true_x: bool = False,
    ):
        is_event, e_idx = event_match(t, event_t)
        z_used = jumped_stream(z, z_jump, is_event, e_idx)
        tT, xT = _tm(t), _tm(x)
        all_initial = torch.cat([xT[0], _tm(z)[0]], dim=-1)
        de_fn = lambda tt, xx, zz: self.de_func(tt, all_initial, xx, zz)
        sol = integrate_ode(self.solver, de_fn, tT, xT[0], _tm(z_used)[:-1], xT, input_true_x=input_true_x)
        return _tm(sol)


class ODEEncodeModel(nn.Module):
    """ODE direct-encode (ref neural_00_ODE_02_direct_encode.py:60-89):
    whole-vector codecs, the integration in latent space, events jumping
    the encoded ``z``.

    ``forward`` returns batch-major ``(x_pred [B, T, xd], x_re [B, T,
    xd])``: the decoded latent solution and the reconstruction
    ``decode(encode(x))`` of the reconstruction loss.
    """

    def __init__(self, x_dim: int, z_dim: int, hidden_dim: int, solver: str = "euler",
                 device=None):
        super().__init__()
        self.x_dim, self.z_dim = x_dim, z_dim
        self.hidden_dim = h = hidden_dim
        self.solver = solver
        self.x_encoder = Codec(x_dim, (h, h), device=device)
        self.x_decoder = Codec(h, (h, x_dim), device=device)
        self.z_encoder = Codec(z_dim, (h, h), device=device)
        self.de_func = DEFunc(2 * h, (h, h), device=device)

    def forward(
        self,
        t,
        x,
        z,
        event_t: Optional[torch.Tensor] = None,
        z_jump: Optional[torch.Tensor] = None,
        input_true_x: bool = False,
    ):
        xh, zh = self.x_encoder(x), self.z_encoder(z)
        zh_jump = self.z_encoder(z_jump) if z_jump is not None else None
        is_event, e_idx = event_match(t, event_t)
        zh_used = jumped_stream(zh, zh_jump, is_event, e_idx)
        tT, xhT = _tm(t), _tm(xh)
        all_initial = torch.cat([xhT[0], _tm(zh)[0]], dim=-1)
        de_fn = lambda tt, xx, zz: self.de_func(tt, all_initial, xx, zz)
        xh_sol = integrate_ode(self.solver, de_fn, tT, xhT[0], _tm(zh_used)[:-1], xhT,
                               input_true_x=input_true_x)
        return self.x_decoder(_tm(xh_sol)), self.x_decoder(xh)
