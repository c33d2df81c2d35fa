"""Weight initialization (counterpart of ``py_psnode_tpu/models/initializers.py``
and of flax ``nn.Dense``'s defaults).

``lecun_normal_init``: flax's default, ``lecun_normal`` kernels (a normal
truncated at ±2 standard deviations, scaled to variance ``1 / fan_in``)
and zero biases. ``torch_style_init``: torch ``nn.Linear``'s default,
kernels and biases ``U(±1/sqrt(fan_in))``. Both draw from an explicit
``torch.Generator``, so their numbers differ from JAX's PRNG by design;
parity tests carry JAX's initial parameters across with
:mod:`py_psnode_tpu_torch.bridge` instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _linears(module: nn.Module):
    return [m for m in module.modules() if isinstance(m, nn.Linear)]


@torch.no_grad()
def lecun_normal_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax Dense defaults for every ``nn.Linear`` of ``module``, in module
    order: weights from a ±2σ truncated normal with variance
    ``1 / fan_in``, zero biases."""
    for lin in _linears(module):
        std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
        w = torch.empty(lin.weight.shape, dtype=lin.weight.dtype)
        nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
        lin.weight.copy_(w * std)
        lin.bias.zero_()
    return module


@torch.no_grad()
def torch_style_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """torch ``nn.Linear``'s default distribution for every ``nn.Linear``
    of ``module``: weight and bias ``U(±1/sqrt(fan_in))``."""
    for lin in _linears(module):
        bound = 1.0 / math.sqrt(lin.in_features)
        for p in (lin.weight, lin.bias):
            u = torch.empty(p.shape, dtype=p.dtype)
            u.uniform_(-bound, bound, generator=generator)
            p.copy_(u)
    return module


def init_params(module: nn.Module, style: str = "lecun", seed: int = 0) -> nn.Module:
    """Initialize ``module`` in the named style from ``torch.Generator``
    seeded with ``seed`` (draws on the CPU, copied to the module's device)."""
    gen = torch.Generator().manual_seed(seed)
    if style == "lecun":
        return lecun_normal_init(module, gen)
    if style == "torch":
        return torch_style_init(module, gen)
    raise ValueError(f'init_style must be "lecun" or "torch", got {style!r}')
