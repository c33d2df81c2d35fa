"""Seeded inputs of the channel-wise rollout, for the kernel checks.

The card tests, the host build of the kernels (``utils/host_build.py``) and
the phase clock (``utils/phase_clock.py``) draw the same inputs from a seed
with numpy, so one case means the same numbers everywhere.
"""

from __future__ import annotations

import numpy as np
import torch


def seeded_inputs(B: int, Tm1: int, h: int, xd: int, zd: int, seed: int = 0):
    """``(streams, weights, x0, dt)`` of a channel-wise rollout on the CPU,
    in the port's layout: lecun-scaled weights, unit-scale-ish streams, dt
    0.05 (0.02 in batch row 1)."""
    rng = np.random.default_rng(seed)
    t = lambda *s, sc=1.0: torch.tensor((rng.standard_normal(s) * sc).astype(np.float32))
    stack = lambda: (t(xd, h, h, sc=h ** -0.5), t(xd, h, sc=0.1), t(xd, h, h, sc=h ** -0.5), t(xd, h, sc=0.1))
    weights = dict(a=t(xd + zd, h, sc=(xd + zd) ** -0.5),
                   vert=[(t(h, h, sc=h ** -0.5), t(h, sc=0.1)), (t(h, h, sc=h ** -0.5), t(h, sc=0.1)),
                         (t(h, xd, sc=h ** -0.5), t(xd, sc=0.1))],
                   ext=stack(), head=stack())
    streams = dict(fz=t(Tm1, B, zd, h, sc=0.5), s_constV=t(B, h, h, sc=0.5))
    dt = torch.full((Tm1, B, 1), 0.05)
    dt[:, 1:2] = 0.02
    return streams, weights, t(B, xd, h), dt
