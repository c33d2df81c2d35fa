"""Seeded inputs of the no-encode rollouts (DAE and ODE), for the kernel checks.

The card tests (``tests/test_torch_kernel.py``), the host build of the
backward kernels (``utils/host_build.py``) and its tests, and the phase
clock (``utils/phase_clock.py``) draw the same inputs from a seed with
numpy, so one case means the same numbers everywhere.
"""

from __future__ import annotations

import numpy as np
import torch

from py_psnode_tpu_torch.ops.fused_dae import pack_aux


def _draw(seed):
    rng = np.random.default_rng(seed)
    return lambda *s, sc=1.0: torch.tensor((rng.standard_normal(s) * sc).astype(np.float32))


def _step_sizes(Tm1: int, B: int):
    dt = torch.full((Tm1, B, 1), 0.05)
    dt[:, 1:2] = 0.02
    return dt


def dae_inputs(B: int, Tm1: int, h: int, xd: int = 3, idim: int = 2, seed: int = 0, n_tail: int = 3):
    """``(streams, weights, x0, i0, aux)`` of a DAE rollout on the CPU, in
    the flax layout: ``n_tail`` lecun-scaled tail layers a net (3, the
    no-encode nets; 1, the direct-encode latent nets at ``xd = idim = h``),
    the first-layer projections at scale ``min(0.5, 1/sqrt(width))``, dt
    0.05 (0.02 in batch row 1), events in rows 1 and 3 (modulo B) at step
    2, in every row at step 9, and in row 0 at the walk's first step
    ``Tm1 - 1``."""
    t = _draw(seed)
    streams = {k: t(Tm1, B, h, sc=0.5) for k in ("s_de", "s_ae", "s_ae_ev")}
    tail = lambda out: [(t(h, o, sc=h ** -0.5), t(o, sc=0.1)) for o in [h] * (n_tail - 1) + [out]]
    sc = lambda width: min(0.5, width ** -0.5)
    weights = dict(wx_de=t(xd, h, sc=sc(xd)), wi_de=t(idim, h, sc=sc(idim)), gx_ae=t(xd, h, sc=sc(xd)),
                   de_tail=tail(xd), ae_tail=tail(idim))
    x0, i0 = t(B, xd), t(B, idim)
    ev = torch.zeros(Tm1, B, dtype=torch.bool)
    for step, rows in ((2, [1 % B, 3 % B]), (9, slice(None)), (Tm1 - 1, [0])):
        if step < Tm1:
            ev[step, rows] = True
    return streams, weights, x0, i0, pack_aux(_step_sizes(Tm1, B), ev)


def ode_inputs(B: int, Tm1: int, h: int, xd: int = 2, n_tail: int = 3, seed: int = 0,
               readout: float = 0.1):
    """``(s_de, weights, x0, dt)`` of an ODE rollout on the CPU, in the flax
    layout: lecun-scaled weights with the readout (the last tail layer)
    scaled by ``readout`` more (the default keeps the state bounded over a
    thousand steps), dt 0.05 (0.02 in batch row 1)."""
    t = _draw(seed)
    s_de = t(Tm1, B, h, sc=0.5)
    outs = [h] * (n_tail - 1) + [xd]
    scale = [1.0] * (n_tail - 1) + [readout]
    weights = dict(wx_de=t(xd, h, sc=xd ** -0.5),
                   de_tail=[(t(h, o, sc=c * h ** -0.5), t(o, sc=0.1 * c)) for o, c in zip(outs, scale)])
    return s_de, weights, t(B, xd), _step_sizes(Tm1, B)
