"""Multiple shooting (counterpart of ``py_psnode_tpu/solvers/multishoot.py``).

The horizon of ``T-1`` steps splits into ``K`` windows of ``L = (T-1) / K``
steps. Each window starts from a state the caller gives (the data's true
state for windows 1.., per-window teacher forcing), and all windows
integrate at once, the window axis folded into the batch axis: row
``w * B + b`` of a folded tensor is window ``w`` of sample ``b``
(window-major). The continuity defects between a window's rollout end and
the next window's start are returned for the trainer's penalty term.

The rollouts are the plain ``integrate_ode`` / ``integrate_dae``; autograd
keeps their activations (``--remat`` is not ported).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from py_psnode_tpu_torch.solvers.integrate import integrate_dae, integrate_ode


def check_windows(T: int, K: int) -> int:
    """The window length ``L = (T-1) / K``; raises the JAX package's
    ``ValueError`` where ``K`` does not divide ``T-1``."""
    if (T - 1) % K:
        raise ValueError(f"(T-1)={T - 1} not divisible by n_windows={K}")
    return (T - 1) // K


def _window_fold(a: torch.Tensor, K: int, L: int, overlap: int) -> torch.Tensor:
    """``[T(+), B, ...] -> [L+overlap, K*B, ...]``: the K windows of length
    ``L+overlap`` starting at ``w*L``, the window axis merged into the batch
    axis window-major (row ``w*B + b``)."""
    B = a.shape[1]
    windows = torch.stack([a[w * L : w * L + L + overlap] for w in range(K)])  # [K, L+o, B, ...]
    return windows.transpose(0, 1).reshape(L + overlap, K * B, *a.shape[2:])


def _window_unfold(sol: torch.Tensor, K: int, L: int, B: int) -> torch.Tensor:
    """Inverse of the fold for a ``[L+1, K*B, D]`` windowed solution: the
    stitched ``[K*L+1, B, D]``, index 0 from window 0, then each window's
    rollout points 1..L."""
    w = sol.reshape(L + 1, K, B, sol.shape[-1])
    body = w[1:].transpose(0, 1).reshape(K * L, B, sol.shape[-1])
    return torch.cat([w[0, 0][None], body])


def window_starts(a: torch.Tensor, K: int, L: int) -> torch.Tensor:
    """The folded window starts ``a[w*L]`` of a ``[T, B, D]`` stream:
    ``[K*B, D]`` in the fold's row order (``_window_fold(a, K, L, 1)[0]``)."""
    return a[: K * L : L].reshape(K * a.shape[1], *a.shape[2:])


def window_gaps(ends: torch.Tensor, starts: torch.Tensor, K: int, B: int) -> torch.Tensor:
    """``[K-1, B, D]``: the rollout end of windows 0..K-2 minus the start of
    windows 1..K-1, both ``[K*B, D]`` in the fold's row order."""
    return ends.reshape(K, B, -1)[:-1] - starts.reshape(K, B, -1)[1:]


def tile_batch(a: torch.Tensor, K: int) -> torch.Tensor:
    """Tile a per-sample constant ``[B, ...]`` (e.g. ``all_initial``) to the
    folded ``[K*B, ...]`` batch, in the fold's row order."""
    return a.repeat(K, *(1,) * (a.dim() - 1))


def multishoot_ode(stepper, de_fn: Callable, t: torch.Tensor, x: torch.Tensor, z_step: torch.Tensor,
                   n_windows: int):
    """Windowed ODE solve.

    Args:
      de_fn: dynamics over the FOLDED batch ``[K*B, ...]`` (tile per-sample
        closures with :func:`tile_batch`).
      t, x: ``[T, B, *]`` time-major; window ``w`` starts from ``x[w*L]``.
      z_step: ``[T-1, B, zd]`` event-adjusted inputs.

    Returns ``(solution [T, B, xd], gaps [K-1, B, xd])``, ``gaps[w] =
    rollout_end(window w) - x[(w+1)*L]``.
    """
    T, B, K = t.shape[0], t.shape[1], n_windows
    L = check_windows(T, K)
    x0w = window_starts(x, K, L)
    sol_w = integrate_ode(stepper, de_fn, _window_fold(t, K, L, 1), x0w, _window_fold(z_step, K, L, 0))
    return _window_unfold(sol_w, K, L, B), window_gaps(sol_w[-1], x0w, K, B)


def multishoot_dae(stepper, de_fn: Callable, ae_fn: Callable, x0w: torch.Tensor, t: torch.Tensor,
                   z: torch.Tensor, v: torch.Tensor, z_step: torch.Tensor, v_step: torch.Tensor,
                   n_windows: int, is_event: Optional[torch.Tensor] = None):
    """Windowed semi-explicit DAE solve.

    Args:
      x0w: folded window-start differential states ``[K*B, xd]`` in the
        fold's row order. Callers give the model's ``Init_Func`` output for
        window 0 and the TRUE data states for windows 1.. (an ``Init_Func``
        start mid-transient is not identifiable; the JAX package's
        ``multishoot_dae`` says why).
      t, z, v: ``[T, B, *]``; z_step, v_step: ``[T-1, B, *]``; is_event:
        ``[T-1, B]`` bool or None. An event may fall on a window's first
        step.

    Returns ``(x_solution [T, B, xd], i_solution [T, B, id], gaps [K-1,
    B, xd])``, the gaps between each window's rollout end and the next
    window's start.
    """
    T, B, K = t.shape[0], t.shape[1], n_windows
    L = check_windows(T, K)
    fold = lambda a, overlap: _window_fold(a, K, L, overlap)
    x_sol_w, i_sol_w = integrate_dae(
        stepper, de_fn, ae_fn, x0w, fold(t, 1), fold(z, 1), fold(v, 1), fold(z_step, 0), fold(v_step, 0),
        is_event=None if is_event is None else fold(is_event, 0),
    )
    return (_window_unfold(x_sol_w, K, L, B), _window_unfold(i_sol_w, K, L, B),
            window_gaps(x_sol_w[-1], x0w, K, B))
