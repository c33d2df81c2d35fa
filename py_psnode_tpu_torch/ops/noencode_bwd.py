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

The bf16 compute mode of kernels 1-4 (``precision="bfloat16"``; JAX
``fused_dae.py:143`` ``_dot``, ``fused_dae_vjp.py:52`` ``_dot_t``) rides
the dtype of the weights: :func:`dot` and :func:`dot_t` are the products of
every plain version, the float32 product where the weight is not bfloat16.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from py_psnode_tpu_torch.models.funcs import elu

BLOCK = 128  # the kernels cut the padded weights in 128 x 128 blocks
STAGES = {"euler": 1, "midpoint": 2, "rk4": 4}  # evaluations of the dynamics a step


def _acc(*ts: torch.Tensor) -> torch.dtype:
    """The dtype a bf16-mode product sums in: float32, or float64 where an
    operand is float64 (a plain version run in float64 arithmetic between
    the same rounding points, as ``chip_smoke.py`` phase 21 measures how
    far the arithmetic alone moves a result)."""
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) else torch.float32


def dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` as the kernels compute it. In the bf16 compute mode (``w``
    bfloat16) ``a`` is rounded to bf16 (round to nearest even, as XLA's
    ``astype``) and the product taken in float32 (:func:`_acc`): a bf16 x
    bf16 product is exact in float32, so this is the kernels' arithmetic up
    to summation order. Any other ``w``: the plain product."""
    if w.dtype != torch.bfloat16:
        return a @ w
    acc = _acc(a)
    return a.to(torch.bfloat16).to(acc) @ w.to(acc)


def dot_t(a: torch.Tensor, b: torch.Tensor, cdtype=torch.float32) -> torch.Tensor:
    """``a.T @ b``, a weight gradient; with ``cdtype`` bfloat16 (the bf16
    compute mode) both operands are rounded to bf16 first and the product
    taken in float32 (:func:`_acc`)."""
    if cdtype != torch.bfloat16:
        return a.T @ b
    acc = _acc(a, b)
    return a.to(torch.bfloat16).to(acc).T @ b.to(torch.bfloat16).to(acc)


def work_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a plain version computes in: float32 for the bf16 compute
    mode's bfloat16 inputs, else the inputs' own (float64 for the
    reference walks)."""
    return torch.float32 if t.dtype == torch.bfloat16 else t.dtype


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


def pad_net(first: torch.Tensor, tail: Sequence[Tuple[torch.Tensor, torch.Tensor]], H: int):
    """``(w [n + 1, H, H], b [n, H])``: a net's first-layer weight ``[kin,
    h]`` and tail layers ``(W [in, out], b [out])`` zero-padded to width H
    (a multiple of :data:`BLOCK`, the kernels' own: the last of the C
    ``psn_fused_*_bwd_sizes``), each weight in ``H / 128`` x ``H / 128`` blocks
    of 128 x 128, block ``(kc, oc)`` (rows ``128 kc..``, columns ``128
    oc..``) the ``kc * H / 128 + oc``-th, row-major, as the kernels read
    them; at ``H = 128`` the plain padded layout."""
    n, nc = len(tail), H // BLOCK
    w = first.new_zeros(n + 1, H, H)
    b = first.new_zeros(n, H)
    w[0, : first.shape[0], : first.shape[1]] = first
    for l, (W, bias) in enumerate(tail):
        w[l + 1, : W.shape[0], : W.shape[1]] = W
        b[l, : bias.shape[0]] = bias
    blocks = w.view(n + 1, nc, BLOCK, nc, BLOCK).transpose(2, 3).contiguous()
    return blocks.view(n + 1, H, H), b


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


def net_grads_plain(res, gres, gy, xin, slots: Sequence[int], kin: int, n: int, out: int, keep=None,
                    cdtype=torch.float32):
    """The contraction's plain version for one net (the arguments of
    :func:`net_operands`; ``cdtype`` bfloat16 in the bf16 compute mode):
    ``(dW_first [kin, h], [(dW_l, db_l), ...])``."""
    (u0, v0, _), *tail = net_operands(res, gres, gy, xin, slots, kin, n, out, keep)
    return dot_t(u0, v0, cdtype), [(dot_t(u, v, cdtype), v.sum(0)) for u, v, _ in tail]
