"""DAE no-encode and direct-encode models (counterpart of
``py_psnode_tpu/models/dae.py:27-202``).

``dx/dt = f(x, z, v, i)``, ``i = g(x, z, v)`` with the learned consistent
initialization ``x0 = Init(z0, v0, i0)``; the algebraic output enters the
differential step lagged by one step. The direct-encode model runs the same
rollout in a latent space of width ``h`` (five codecs, 2-layer nets, events
jumping the encoded inputs). These modules run the plain rollout
(:func:`~py_psnode_tpu_torch.solvers.integrate_dae`); the fused paths are
:func:`py_psnode_tpu_torch.ops.fused_model.fused_dae_apply` and
:func:`~py_psnode_tpu_torch.ops.fused_model.fused_dae_encode_apply`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from py_psnode_tpu_torch.models.funcs import AEFunc, Codec, DEFunc, InitFunc
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


class DAEEncodeModel(nn.Module):
    """DAE direct-encode (ref neural_01_DAE_02_direct_encode.py:103-153).

    Five codecs (x encoder and decoder, v and i encoders, i decoder) and a
    z encoder unless ``z_dim == 0`` (z then enters raw, zero-wide); the
    latent start ``xh0 = x_encoder(Init(z0, v0, i0))``; the integration in
    latent space with events jumping the encoded ``z`` and ``v``; the
    decoded first row of ``x_pred`` replaced by the raw Init output (ref
    :150). ``forward`` returns ``(x_pred, i_pred, x_re, i_re)``
    batch-major, the last two the reconstructions of the loss.
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
        self.x_dim, self.z_dim, self.v_dim, self.i_dim = x_dim, z_dim, v_dim, i_dim
        self.hidden_dim = h = hidden_dim
        self.solver = solver
        kw = dict(device=device)
        self.x_encoder = Codec(x_dim, (h, h), **kw)
        self.x_decoder = Codec(h, (h, x_dim), **kw)
        self.z_encoder = Codec(z_dim, (h, h), **kw) if z_dim != 0 else None
        self.v_encoder = Codec(v_dim, (h, h), **kw)
        self.i_encoder = Codec(i_dim, (h, h), **kw)
        self.i_decoder = Codec(h, (h, i_dim), **kw)
        self.init_func = InitFunc(z_dim + v_dim + i_dim, (h, h, x_dim), **kw)
        zl = h if z_dim else 0
        self.de_func = DEFunc(3 * h + zl, (h, h), **kw)
        self.ae_func = AEFunc(5 * h + 2 * zl, (h, h), **kw)

    @property
    def latent_dims(self):
        """``(h, zl, h, h)``: the widths of the latent rollout (``zl`` 0
        when ``z_dim == 0``)."""
        h = self.hidden_dim
        return (h, h if self.z_dim else 0, h, h)

    def encode_z(self, z):
        """The encoded ``z``, or ``z`` itself where there is no z encoder."""
        return z if self.z_encoder is None else self.z_encoder(z)

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
        tT, zT, vT, iT = _tm(t), _tm(z), _tm(v), _tm(i)
        x0 = self.init_func(zT[0], vT[0], iT[0])
        xh0 = self.x_encoder(x0)
        xh, zh, vh, ih = self.x_encoder(x), self.encode_z(z), self.v_encoder(v), self.i_encoder(i)
        zh_jump = self.encode_z(z_jump) if z_jump is not None else None
        vh_jump = self.v_encoder(v_jump) if v_jump is not None else None
        is_event, e_idx = event_match(t, event_t)
        zh_used = jumped_stream(zh, zh_jump, is_event, e_idx)
        vh_used = jumped_stream(vh, vh_jump, is_event, e_idx)

        zhT, vhT, ihT = _tm(zh), _tm(vh), _tm(ih)
        all_initial = torch.cat([xh0, zhT[0], vhT[0], ihT[0]], dim=-1)
        de_fn = lambda tt, xx, zz, vv, ii: self.de_func(tt, all_initial, xx, zz, vv, ii)
        ae_fn = lambda xx, zz, vv: self.ae_func(all_initial, xx, zz, vv)
        xh_sol, ih_sol = integrate_dae(
            self.solver,
            de_fn,
            ae_fn,
            xh0,
            tT,
            zhT,
            vhT,
            _tm(zh_used)[:-1],
            _tm(vh_used)[:-1],
            is_event=_tm(is_event)[:-1],
        )
        x_pred = torch.cat([x0[None], self.x_decoder(xh_sol[1:])])  # ref :150
        return (_tm(x_pred), _tm(self.i_decoder(ih_sol)), self.x_decoder(xh),
                self.i_decoder(ih))
