"""The channel-wise family (counterpart of ``py_psnode_tpu/models/channelwise.py``):
``ChannelWiseODEModel`` and ``ChannelWiseDAEModel``.

Each channel of ``x`` is encoded into a latent ``[h]`` vector; the latent
state ``xh [B, xd, h]`` is integrated with the shared vertical dynamics of
:class:`~py_psnode_tpu_torch.models.funcs.ChannelWiseDEFunc` and decoded per
channel. Semantics kept from the JAX package:

  * ``f_init = features_of(xh0, z[0])`` uses the un-jumped ``z[0]``; the
    per-step z-features use the event-adjusted stream;
  * row 0 of ``x_pred`` is ``decode(encode(x0))``, not ``x0``;
  * the DAE readout ``i = AE(xh_sol, v)`` runs over all T after the loop,
    with no feedback into the dynamics;
  * ``x_re = decode(encode(x))``, the autoencoder reconstruction.

This module runs the plain time loop. Where grad is on, each step is
recomputed in the backward (``torch.utils.checkpoint``) instead of keeping
its activations, as the JAX models' default ``remat=True`` does: a step's
activations are ``[B, h, h]`` per evaluation, too many to keep for 1000
steps. The fused path is :mod:`py_psnode_tpu_torch.ops.fused_channelwise`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from py_psnode_tpu_torch.models.funcs import ChannelWiseAEFunc, ChannelWiseDEFunc
from py_psnode_tpu_torch.solvers import event_match, get_stepper, jumped_stream


def _tm(a):
    return a.transpose(0, 1)


def latent_rollout(de: ChannelWiseDEFunc, solver, t, x, z, event_t=None, z_jump=None):
    """The latent solution ``xh_sol [T, B, xd, h]`` of the channel-wise
    dynamics on a batch-major batch (``t [B, T, 1]``, ``x [B, T, xd]``,
    ``z [B, T, zd]``)."""
    stepper = get_stepper(solver)
    is_event, e_idx = event_match(t, event_t)
    z_used = jumped_stream(z, z_jump, is_event, e_idx)
    tT, xT = _tm(t), _tm(x)
    xh0 = de.encode_x(xT[0])
    f_init = de.features_of(xh0, _tm(z)[0])
    fzT = de.z_features(_tm(z_used)[:-1])  # [T-1, B, zd, h], all steps at once

    def step(xh, t0, t1, fz0):
        f = lambda tt, xx: de.dyn(f_init, xx, fz0)
        return xh + stepper(f, t0, (t1 - t0)[..., None], t1, xh)

    use_ckpt = torch.is_grad_enabled()
    xs = [xh0]
    for j in range(tT.shape[0] - 1):
        args = (xs[-1], tT[j], tT[j + 1], fzT[j])
        xs.append(checkpoint(step, *args, use_reentrant=False) if use_ckpt else step(*args))
    return torch.stack(xs)


class ChannelWiseODEModel(nn.Module):
    """Channel-wise neural ODE. ``forward`` returns ``(x_pred [B, T, xd],
    x_re [B, T, xd])``."""

    def __init__(self, x_dim: int, z_dim: int, hidden_dim: int, solver: str = "euler",
                 channel_impl: str = "einsum", device=None):
        super().__init__()
        self.x_dim, self.z_dim, self.hidden_dim = x_dim, z_dim, hidden_dim
        self.solver, self.channel_impl = solver, channel_impl
        self.de_func = ChannelWiseDEFunc(x_dim, z_dim, hidden_dim, impl=channel_impl, device=device)

    def forward(self, t, x, z, event_t: Optional[torch.Tensor] = None,
                z_jump: Optional[torch.Tensor] = None):
        de = self.de_func
        xh_sol = latent_rollout(de, self.solver, t, x, z, event_t, z_jump)
        return _tm(de.decode_x(xh_sol)), de.decode_x(de.encode_x(x))


class ChannelWiseDAEModel(nn.Module):
    """Channel-wise neural DAE: the channel-wise ODE in the latent space plus
    the decoupled algebraic readout ``i = AE(xh, v)``. ``i``, ``v_jump`` are
    accepted for the DAE batch contract and do not enter the rollout.
    ``forward`` returns ``(x_pred [B, T, xd], i_pred [B, T, id], x_re [B, T,
    xd])``."""

    def __init__(self, x_dim: int, z_dim: int, v_dim: int, i_dim: int, hidden_dim: int,
                 solver: str = "euler", channel_impl: str = "einsum", device=None):
        super().__init__()
        self.x_dim, self.z_dim, self.v_dim, self.i_dim = x_dim, z_dim, v_dim, i_dim
        self.hidden_dim, self.solver = hidden_dim, solver
        self.channel_impl = channel_impl
        self.de_func = ChannelWiseDEFunc(x_dim, z_dim, hidden_dim, impl=channel_impl, device=device)
        self.ae_func = ChannelWiseAEFunc(x_dim, v_dim, i_dim, hidden_dim, impl=channel_impl,
                                         device=device)

    def forward(self, t, x, z, v, i, event_t: Optional[torch.Tensor] = None,
                z_jump: Optional[torch.Tensor] = None, v_jump: Optional[torch.Tensor] = None):
        de = self.de_func
        xh_sol = latent_rollout(de, self.solver, t, x, z, event_t, z_jump)
        i_pred = self.ae_func(xh_sol, _tm(v))  # [T, B, id], all T at once
        return _tm(de.decode_x(xh_sol)), _tm(i_pred), de.decode_x(de.encode_x(x))
