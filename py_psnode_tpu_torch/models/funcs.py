"""Neural function blocks (counterpart of ``py_psnode_tpu/models/funcs.py:22-90``
and, for the channel-wise family, :109-257).

Every dynamics net consumes the skip-augmented triple
``cat(all_initial, u - all_initial, u)``; the algebraic net concatenates the
initial condition without differencing it. Submodules keep the flax names
(``x_dot``, ``i_calculator``, ``init_fun``, ``net``, ``dense_k``) so that
the weight bridge maps checkpoints one to one.

The channel-wise blocks (:class:`PerChannelMLP`, :class:`ChannelWiseDEFunc`,
:class:`ChannelWiseAEFunc`) hold per-channel nets as stacked weights
``w_k [C, d_in, f]``, ``b_k [C, f]`` and use ``torch.nn.functional.elu``,
as the JAX modules use ``nn.elu``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as Fn
from torch import nn


def elu(x: torch.Tensor) -> torch.Tensor:
    """ELU as the fused kernels write it: ``exp(min(x, 0)) - 1`` below 0."""
    return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


class MLP(nn.Module):
    """``Linear→ELU`` stack; no activation after the final layer.

    ``in_features`` is the input width; ``features`` the widths of the
    layers, named ``dense_0 .. dense_{n-1}``; ``act`` the activation.
    """

    def __init__(self, in_features: int, features: Sequence[int], device=None,
                 act: Callable = elu):
        super().__init__()
        self.features = tuple(features)
        self.act = act
        d = in_features
        for k, f in enumerate(self.features):
            self.add_module(f"dense_{k}", nn.Linear(d, f, device=device))
            d = f

    def forward(self, x):
        n = len(self.features)
        for k in range(n):
            x = getattr(self, f"dense_{k}")(x)
            if k < n - 1:
                x = self.act(x)
        return x


class DEFunc(nn.Module):
    """Differential dynamics ``u_dot = MLP(cat(init, u - init, u))`` with
    ``u = cat(x, z, v, i)``; ``d_u`` is the width of ``u``."""

    def __init__(self, d_u: int, features: Sequence[int], device=None):
        super().__init__()
        self.x_dot = MLP(3 * d_u, features, device=device)

    def forward(self, t0, all_initial, *inputs):
        u = torch.cat(inputs, dim=-1)
        return self.x_dot(torch.cat([all_initial, u - all_initial, u], dim=-1))


class AEFunc(nn.Module):
    """Algebraic map ``i_t = MLP(cat(all_initial, x_t, z_t, v_t))``: the
    initial condition is concatenated, not differenced."""

    def __init__(self, d_in: int, features: Sequence[int], device=None):
        super().__init__()
        self.i_calculator = MLP(d_in, features, device=device)

    def forward(self, all_initial, xt, zt, vt):
        return self.i_calculator(torch.cat([all_initial, xt, zt, vt], dim=-1))


class InitFunc(nn.Module):
    """Learned consistent initialization ``x0 = MLP(cat(z0, v0, i0))``."""

    def __init__(self, d_in: int, features: Sequence[int], device=None):
        super().__init__()
        self.init_fun = MLP(d_in, features, device=device)

    def forward(self, z0, v0, i0):
        return self.init_fun(torch.cat([z0, v0, i0], dim=-1))


class Codec(nn.Module):
    """Two-layer ELU encoder or decoder of the direct-encode variants
    (``features`` two widths), held as ``net``: its parameters are
    ``net.dense_k``, the flax paths ``<codec>/net/dense_k/{kernel,bias}``."""

    def __init__(self, in_features: int, features: Sequence[int], device=None):
        super().__init__()
        self.net = MLP(in_features, features, device=device)

    def forward(self, x):
        return self.net(x)


class PerChannelMLP(nn.Module):
    """``n_channels`` independent MLPs applied to ``[..., C, d_in]`` slices,
    as stacked weights ``w_k [C, d_prev, f]`` and ``b_k [C, f]``; ELU
    between layers.

    ``impl``: ``"einsum"`` (one grouped product per layer) or
    ``"blockdiag"`` (the channels flattened into one block-diagonal product
    ``[.., C*d] @ [C*d, C*f]`` for layers with ``d_prev >= 8``). Both give
    the same numbers: the off-block weights are exact zeros.
    """

    def __init__(self, n_channels: int, features: Sequence[int], d_in: int,
                 impl: str = "einsum", device=None):
        super().__init__()
        if impl not in ("einsum", "blockdiag"):
            raise ValueError(f'impl must be "einsum" or "blockdiag", got {impl!r}')
        self.n_channels, self.features, self.d_in = n_channels, tuple(features), d_in
        self.impl = impl
        d = d_in
        for k, f in enumerate(self.features):
            self.register_parameter(f"w_{k}", nn.Parameter(torch.empty(n_channels, d, f, device=device)))
            self.register_parameter(f"b_{k}", nn.Parameter(torch.empty(n_channels, f, device=device)))
            d = f

    def forward(self, x):
        C, n = self.n_channels, len(self.features)
        for k in range(n):
            w, b = getattr(self, f"w_{k}"), getattr(self, f"b_{k}")
            d, f = w.shape[1], w.shape[2]
            if self.impl == "blockdiag" and d >= 8 and C > 1:
                eye = torch.eye(C, dtype=w.dtype, device=w.device)
                wbd = (eye[:, None, :, None] * w[:, :, None, :]).reshape(C * d, C * f)
                y = x.reshape(x.shape[:-2] + (C * d,)) @ wbd + b.reshape(C * f)
                x = y.reshape(y.shape[:-1] + (C, f))
            else:
                x = torch.einsum("...ci,cio->...co", x, w) + b
            if k < n - 1:
                x = Fn.elu(x)
        return x


class ChannelWiseDEFunc(nn.Module):
    """Channel-wise dynamics: per-channel 1→h encoders of ``x`` and ``z``,
    per-channel h→h extractors, a shared vertical net over the channel axis
    (``xh_dot_v``, input ``cat(ft, f_init, ft - f_init)`` of ``3 (xd+zd)``
    channels) and per-channel h→h output heads."""

    def __init__(self, x_dim: int, z_dim: int, hidden_dim: int, impl: str = "einsum",
                 device=None):
        super().__init__()
        h, kw = hidden_dim, dict(impl=impl, device=device)
        self.x_dim, self.z_dim, self.hidden_dim = x_dim, z_dim, h
        self.x_encoder = PerChannelMLP(x_dim, (h, h), 1, device=device)
        self.x_decoder = PerChannelMLP(x_dim, (h, 1), h, device=device)
        self.xh_ext = PerChannelMLP(x_dim, (h, h), h, **kw)
        self.xh_dot_head = PerChannelMLP(x_dim, (h, h), h, **kw)
        self.z_encoder = PerChannelMLP(z_dim, (h, h), 1, device=device)
        self.zh_ext = PerChannelMLP(z_dim, (h, h), h, **kw)
        self.xh_dot_v = MLP(3 * (x_dim + z_dim), (h, h, h, x_dim), device=device, act=Fn.elu)

    def encode_x(self, x):
        """``[.., xd] -> [.., xd, h]``."""
        return self.x_encoder(x[..., None])

    def decode_x(self, xh):
        """``[.., xd, h] -> [.., xd]``."""
        return self.x_decoder(xh)[..., 0]

    def z_features(self, z):
        """``[.., zd] -> [.., zd, h]``: depends only on the known ``z``, so
        callers compute it for all steps at once, outside the loop."""
        return self.zh_ext(self.z_encoder(z[..., None]))

    def features_of(self, xh, z):
        """The stacked channel features ``[.., xd+zd, h]``."""
        return torch.cat([self.xh_ext(xh), self.z_features(z)], dim=-2)

    def dyn(self, f_init, xh, fz):
        """Dynamics at precomputed z-features ``fz``."""
        ft = torch.cat([self.xh_ext(xh), fz], dim=-2)
        feat = torch.cat([ft, f_init, ft - f_init], dim=-2)
        dot = self.xh_dot_v(feat.transpose(-1, -2)).transpose(-1, -2)
        return self.xh_dot_head(dot)

    def forward(self, t0, f_init, xh, z):
        return self.dyn(f_init, xh, self.z_features(z))


class ChannelWiseAEFunc(nn.Module):
    """Channel-wise algebraic readout ``i = AE(xh, v)``."""

    def __init__(self, x_dim: int, v_dim: int, i_dim: int, hidden_dim: int,
                 impl: str = "einsum", device=None):
        super().__init__()
        h, kw = hidden_dim, dict(impl=impl, device=device)
        self.xh_ext = PerChannelMLP(x_dim, (h, h), h, **kw)
        self.v_encoder = PerChannelMLP(v_dim, (h, h), 1, device=device)
        self.vh_ext = PerChannelMLP(v_dim, (h, h), h, **kw)
        self.yh_func_v = MLP(x_dim + v_dim, (h, h, h, i_dim), device=device, act=Fn.elu)
        self.yh_ext = PerChannelMLP(i_dim, (h, h), h, **kw)
        self.y_decoder = PerChannelMLP(i_dim, (h, 1), h, device=device)

    def forward(self, xh, v):
        feat = torch.cat([self.xh_ext(xh), self.vh_ext(self.v_encoder(v[..., None]))], dim=-2)
        yh = self.yh_func_v(feat.transpose(-1, -2)).transpose(-1, -2)
        return self.y_decoder(self.yh_ext(yh))[..., 0]
