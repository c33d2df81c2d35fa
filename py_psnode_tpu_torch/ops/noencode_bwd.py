"""What the no-encode kernels' wrappers share (the backward pair, kernels 2
and 4: ``ops/fused_dae_vjp.py``, ``ops/fused_ode_vjp.py``; the forward pair,
kernels 1 and 3, takes :func:`launch` and :func:`pointer_array`).

Each CUDA backward is three kernels (``csrc/noencode_bwd.cuh``): a
time-parallel recompute that writes every evaluation's layer
pre-activations ``res [E, L, R, h]`` and first-layer inputs ``xin [E, R,
kx]``, the reverse walk that writes their cotangents ``gres [E, L, R, h]``
and each evaluation's output cotangent ``gy [E, R, ow]``, and a contraction
of those buffers into the weight gradients. ``R = (T-1) B`` row-steps ``r =
t B + b``; the ``E`` evaluation slots are the solver's stages in evaluation
order, then, for the DAE, the AE at t+1 and the AE at the event.
:func:`net_grads_plain` is the contraction's plain version; each family's
module has the recompute's.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from py_psnode_tpu_torch.models.funcs import elu

MAX_HIDDEN = 128  # the kernels pad every vector and weight to 128
STAGES = {"euler": 1, "midpoint": 2, "rk4": 4}  # evaluations of the dynamics a step


def check_widths(**widths: int) -> None:
    """Raise unless every width is at most :data:`MAX_HIDDEN`."""
    for name, w in widths.items():
        if w > MAX_HIDDEN:
            raise ValueError(f"the no-encode backward kernels take {name} <= {MAX_HIDDEN}, got {w}")


def launch(fn, dev: torch.device, *args) -> int:
    """``fn(*args, stream)`` on ``dev``'s current stream; on CPU tensors (a
    host build of the kernels, ``utils/host_build.py``) with no stream."""
    if dev.type != "cuda":
        return fn(*args, None)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def pointer_array(tensors):
    """A ctypes array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def pad_net(first: torch.Tensor, tail: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """``(w [n + 1, 128, 128], b [n, 128])``: a net's first-layer weight
    ``[kin, h]`` and tail layers ``(W [in, out], b [out])`` zero-padded, as
    the kernels read them."""
    n = len(tail)
    w = first.new_zeros(n + 1, MAX_HIDDEN, MAX_HIDDEN)
    b = first.new_zeros(n, MAX_HIDDEN)
    w[0, : first.shape[0], : first.shape[1]] = first
    for l, (W, bias) in enumerate(tail):
        w[l + 1, : W.shape[0], : W.shape[1]] = W
        b[l, : bias.shape[0]] = bias
    return w, b


def net_operands(res, gres, gy, xin, slots: Sequence[int], kin: int, n: int, out: int, keep=None):
    """The products of the contraction for one net, over the rows of its
    evaluation ``slots``: ``[(U, V, bias), ...]``, the gradient of each of
    its weights being ``U^T V`` and, where ``bias``, of its bias the column
    sums of V: the first layer's ``(xin, gres[0])``, then tail layer l's
    ``(elu(res[l]), gres[l + 1])`` (the last one's against ``gy``).
    ``keep [R]`` (bool), where given, drops the rows of the last slot where
    it is False (the AE at the event on rows without one). The buffers are
    as the kernels lay them out (``res [E, L, R, h]`` ...)."""
    def rows(get) -> torch.Tensor:
        parts = [get(e) for e in slots]
        if keep is not None:
            parts[-1] = parts[-1][keep]
        return torch.cat(parts)

    ops = [(rows(lambda e: xin[e, :, :kin]), rows(lambda e: gres[e, 0]), False)]
    for l in range(n):
        v = rows(lambda e: gres[e, l + 1]) if l < n - 1 else rows(lambda e: gy[e, :, :out])
        ops.append((elu(rows(lambda e: res[e, l])), v, True))
    return ops


def net_grads_plain(res, gres, gy, xin, slots: Sequence[int], kin: int, n: int, out: int, keep=None):
    """The contraction's plain version for one net (the arguments of
    :func:`net_operands`): ``(dW_first [kin, h], [(dW_l, db_l), ...])``."""
    (u0, v0, _), *tail = net_operands(res, gres, gy, xin, slots, kin, n, out, keep)
    return u0.T @ v0, [(u.T @ v, v.sum(0)) for u, v, _ in tail]
