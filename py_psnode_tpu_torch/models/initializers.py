"""Weight initialization (counterpart of ``py_psnode_tpu/models/initializers.py``
and of flax ``nn.Dense``'s defaults).

``lecun_normal_init``: flax's default, ``lecun_normal`` kernels (a normal
truncated at ±2 standard deviations, scaled to variance ``1 / fan_in``)
and zero biases. ``torch_style_init``: torch ``nn.Linear``'s default,
kernels and biases ``U(±1/sqrt(fan_in))``. The two rules take another
fan-in for the stacked weights ``w_k [C, d_in, f]`` of a per-channel net
(``PerChannelMLP``): flax's ``lecun_normal`` counts every axis but the last
as input, ``C * d_in``; the JAX package's ``torch_style_init``
(``py_psnode_tpu/models/initializers.py:52-60``) counts ``d_in``. Both
draw from an explicit ``torch.Generator``, so their numbers differ from
JAX's PRNG by design;
parity tests carry JAX's initial parameters across with
:mod:`py_psnode_tpu_torch.bridge` instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from py_psnode_tpu_torch.models.funcs import PerChannelMLP

# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _layers(module: nn.Module):
    """``(weight, bias, flax fan-in, torch fan-in)`` of every dense
    layer of ``module`` in module order: an ``nn.Linear`` (``weight [out,
    in]``) or a layer ``k`` of a ``PerChannelMLP`` (``w_k [C, d_in, f]``)."""
    out = []
    for m in module.modules():
        if isinstance(m, nn.Linear):
            out.append((m.weight, m.bias, m.in_features, m.in_features))
        elif isinstance(m, PerChannelMLP):
            for k in range(len(m.features)):
                w, b = getattr(m, f"w_{k}"), getattr(m, f"b_{k}")
                out.append((w, b, w.shape[0] * w.shape[1], w.shape[1]))
    return out


@torch.no_grad()
def lecun_normal_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax defaults for every dense layer of ``module``, in module order:
    weights from a ±2σ truncated normal with variance ``1 / fan_in``
    (``C * d_in`` for a per-channel stack), zero biases."""
    for weight, bias, fan_in, _ in _layers(module):
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        w = torch.empty(weight.shape, dtype=weight.dtype)
        nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
        weight.copy_(w * std)
        bias.zero_()
    return module


@torch.no_grad()
def torch_style_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """torch ``nn.Linear``'s default distribution for every dense layer of
    ``module``: weight and bias ``U(±1/sqrt(fan_in))`` (``d_in`` for a
    per-channel stack)."""
    for weight, bias, _, fan_in in _layers(module):
        bound = 1.0 / math.sqrt(fan_in)
        for p in (weight, bias):
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
