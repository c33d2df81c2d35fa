"""Optimizer with the JAX package's hyperparameters (counterpart of
``py_psnode_tpu/train/optim.py``).

Adam(5e-3) with a StepLR-equivalent per-update schedule (γ=0.7 every
``max(epochs // 10, 1)`` epochs), an opt-in per-tensor gradient clip
applied BEFORE the update (the reference clips after ``opt.step()``, a
no-op), and an opt-in skip of updates whose gradients are not finite
(``optax.apply_if_finite`` semantics). ``torch.optim.Adam`` computes
optax's update: β 0.9/0.999, eps 1e-8 added outside the square root, both
moments bias-corrected.

:func:`reference_grad_norm` reproduces the reference's logged "gradient
norm"; :func:`robust_scalar_guard` and :func:`zero_nonfinite_grads` are the
robust-loss guard of the trainer.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch


def steplr_schedule(base_lr: float, epochs: int, steps_per_epoch: int, gamma: float = 0.7):
    """lr of the update numbered ``count`` (0 first): ``base_lr *
    gamma**((count // steps_per_epoch) // size)``, ``size = max(epochs //
    10, 1)``: torch's StepLR stepped once per epoch."""
    size = max(epochs // 10, 1)

    def schedule(count):
        return base_lr * gamma ** ((count // steps_per_epoch) // size)

    return schedule


@torch.no_grad()
def per_param_clip(grads: Iterable[torch.Tensor], max_norm: float = 1.0):
    """Scale each gradient tensor in place to L2 norm at most ``max_norm``."""
    for g in grads:
        g.mul_(torch.clamp(max_norm / torch.clamp(torch.linalg.vector_norm(g), min=1e-12), max=1.0))


# updates skipped in a row before a non-finite one is applied anyway
# (optax.apply_if_finite's max_consecutive_errors in the JAX package)
MAX_CONSECUTIVE_ERRORS = 100


class Optimizer:
    """Adam + StepLR schedule (+ optional clip and non-finite skip) over
    ``params``, stepped once per training update.

    ``step()`` reads the parameters' ``.grad``. A skipped update leaves the
    parameters, the Adam moments and the schedule's count unchanged, until
    more than ``MAX_CONSECUTIVE_ERRORS`` updates in a row were skipped.
    """

    def __init__(self, params, learning_rate, epochs, steps_per_epoch, sch_gamma,
                 gradient_clip, skip_nonfinite):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = steplr_schedule(learning_rate, epochs, steps_per_epoch, sch_gamma)
        self.gradient_clip = gradient_clip
        self.skip_nonfinite = skip_nonfinite
        self.count = 0  # applied updates: the schedule's step
        self.notfinite_count = 0
        self.adam = torch.optim.Adam(
            self.params, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8
        )

    def step(self) -> bool:
        """Apply one update; returns False when it was skipped."""
        grads = [p.grad for p in self.params]
        if self.skip_nonfinite:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
                return False
        if self.gradient_clip is not None:
            per_param_clip(grads, self.gradient_clip)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1
        return True


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    learning_rate: float = 5e-3,
    epochs: int = 400,
    steps_per_epoch: int = 1,
    sch_gamma: float = 0.7,
    gradient_clip: Optional[float] = None,
    skip_nonfinite: bool = False,
) -> Optimizer:
    """Adam + StepLR-equivalent schedule over ``params``, with the JAX
    package's ``make_optimizer`` arguments and defaults."""
    return Optimizer(params, learning_rate, epochs, steps_per_epoch, sch_gamma,
                     gradient_clip, skip_nonfinite)


@torch.no_grad()
def reference_grad_norm(grads: Iterable[torch.Tensor], clip: float = 1.0) -> torch.Tensor:
    """The reference's logged quantity (ref :363-373): each tensor clipped
    to L2 norm ``clip``, then the L2 norm of the per-tensor L1 norms."""
    l1s = []
    for g in grads:
        scale = torch.clamp(clip / torch.clamp(torch.linalg.vector_norm(g), min=1e-12), max=1.0)
        l1s.append((g * scale).abs().sum())
    if not l1s:
        return torch.tensor(0.0)
    return torch.linalg.vector_norm(torch.stack(l1s))


def robust_scalar_guard(loss: torch.Tensor, limit: float = 1.0):
    """The scalar robust-loss guard: a non-finite loss becomes 0.0 (a
    zero-gradient step); ``loss > limit`` becomes the direction-preserving
    ``loss / loss.detach()``; otherwise the loss passes through. Returns
    ``(guarded_loss, tripped)``."""
    nonfinite = ~torch.isfinite(loss)
    safe = torch.where(nonfinite, torch.zeros_like(loss), loss)
    over = safe > limit
    denom = torch.where(over, safe, torch.ones_like(safe)).detach()
    guarded = torch.where(nonfinite, torch.zeros_like(loss), torch.where(over, safe / denom, safe))
    return guarded, nonfinite | over


@torch.no_grad()
def zero_nonfinite_grads(grads: Iterable[torch.Tensor]):
    """Zero the non-finite entries of each gradient in place, so that a
    tripped step advances the Adam moments with zero gradients."""
    for g in grads:
        g.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
