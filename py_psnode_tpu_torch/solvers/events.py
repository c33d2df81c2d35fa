"""Branchless disturbance-event handling (counterpart of
``py_psnode_tpu/solvers/events.py``).

At a step starting at ``t0``, if ``t0`` is in the sample's own event
schedule, the exogenous input used for that one step is replaced by the
stored post-jump value. Membership is an exact float match, as in the
reference (``neural_base.py:54``), but every sample uses its own schedule.

Shapes: ``t [B, T, 1]`` (or ``[B, T]``), ``event_t [B, E]`` (times that
match no grid time are inert), ``*_jump [B, E, D]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def event_match(
    t: torch.Tensor, event_t: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(is_event [B, T] bool, e_idx [B, T] int64)``: where the grid time
    equals some event time, and the index of the first matching event (0
    where none matches)."""
    tt = t[..., 0] if t.dim() == 3 else t
    if event_t is None or event_t.shape[-1] == 0:
        return (
            torch.zeros(tt.shape, dtype=torch.bool, device=tt.device),
            torch.zeros(tt.shape, dtype=torch.int64, device=tt.device),
        )
    match = tt[:, :, None] == event_t[:, None, :]  # [B, T, E]
    is_event = match.any(dim=-1)
    # argmax returns the first maximal index, as jnp.argmax does
    e_idx = match.to(torch.int32).argmax(dim=-1)
    return is_event, e_idx


def jumped_stream(
    stream: torch.Tensor,
    jump: Optional[torch.Tensor],
    is_event: torch.Tensor,
    e_idx: torch.Tensor,
) -> torch.Tensor:
    """Replace ``stream[b, j]`` by ``jump[b, e_idx[b, j]]`` where an event
    fires; ``stream [B, T, D]``, ``jump [B, E, D]`` (None: unchanged)."""
    if jump is None or jump.numel() == 0:
        return stream
    idx = e_idx[:, :, None].expand(-1, -1, jump.shape[-1])
    sel = torch.take_along_dim(jump, idx, dim=1)  # [B, T, D]
    return torch.where(is_event[:, :, None], sel, stream)
