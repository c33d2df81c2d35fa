"""Neural function blocks (counterpart of ``py_psnode_tpu/models/funcs.py:22-80``).

Every dynamics net consumes the skip-augmented triple
``cat(all_initial, u - all_initial, u)``; the algebraic net concatenates the
initial condition without differencing it. Submodules keep the flax names
(``x_dot``, ``i_calculator``, ``init_fun``, ``dense_k``) so that the weight
bridge maps checkpoints one to one.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def elu(x: torch.Tensor) -> torch.Tensor:
    """ELU as the fused kernels write it: ``exp(min(x, 0)) - 1`` below 0."""
    return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


class MLP(nn.Module):
    """``Linear→ELU`` stack; no activation after the final layer.

    ``in_features`` is the input width; ``features`` the widths of the
    layers, named ``dense_0 .. dense_{n-1}``.
    """

    def __init__(self, in_features: int, features: Sequence[int], device=None):
        super().__init__()
        self.features = tuple(features)
        d = in_features
        for k, f in enumerate(self.features):
            self.add_module(f"dense_{k}", nn.Linear(d, f, device=device))
            d = f

    def forward(self, x):
        n = len(self.features)
        for k in range(n):
            x = getattr(self, f"dense_{k}")(x)
            if k < n - 1:
                x = elu(x)
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
