"""Training loss of the DAE no-encode variant (counterpart of
``py_psnode_tpu/train/losses.py``: ``mse`` :29, ``masked_sum_se`` :45,
``dae_no_encode_loss`` :78-93).

Masked MSE compositions with the reference's quirks kept:

  * mask-sum normalization ``sum(se * mask) / sum(mask)``;
  * the ω channel (dim 1) weighted by an extra ×9 through a mask
    broadcast (ref neural_01_DAE_01_no_encode.py:414-417);
  * the unmasked initial-step terms x0_loss and i0_loss are ADDED to the
    DAE loss (the ODE loss computes its x0 term without adding it), each
    weighted by ``sample_w`` so that padded batch rows count for nothing.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def mse(a: torch.Tensor, b: torch.Tensor, sample_w: Optional[torch.Tensor] = None):
    """Plain MSE mean, optionally weighted over the batch axis.

    With ``sample_w`` (``[B]`` of 0/1) padded rows contribute nothing and
    the result equals the plain mean over the real rows.
    """
    se = (a - b) ** 2
    if sample_w is None:
        return se.mean()
    w = sample_w.reshape((-1,) + (1,) * (se.dim() - 1))
    per_row = se[0].numel() if se.dim() > 1 else 1
    return (se * w).sum() / (sample_w.sum() * per_row)


def masked_sum_se(pred, true, mask):
    """``sum(se * mask) / sum(mask)``: the reference's masked normalization."""
    return ((pred - true) ** 2 * mask).sum() / mask.sum()


def dae_no_encode_loss(outputs, batch, omega_extra_weight: float = 9.0) -> Tuple[torch.Tensor, Dict]:
    """ref neural_01_DAE_01_no_encode.py:414-419: ω (dim 1) upweighted by
    a broadcast extra term, plus i_loss and the unmasked x0/i0 terms.
    Returns ``(loss, {"x_loss", "i_loss", "loss"})``."""
    x_pred, i_pred = outputs
    x, i, mask = batch["x"], batch["i"], batch["mask"]
    w = batch.get("sample_w")
    se_x = (x_pred - x) ** 2
    x_loss = ((se_x * mask).sum() + (se_x[:, :, 1:2] * mask).sum() * omega_extra_weight) / mask.sum()
    i_loss = masked_sum_se(i_pred, i, mask)
    x0_loss = mse(x[:, 0, :], x_pred[:, 0, :], w)
    i0_loss = mse(i[:, 0, :], i_pred[:, 0, :], w)
    loss = x_loss + i_loss + x0_loss + i0_loss
    return loss, {"x_loss": x_loss, "i_loss": i_loss, "loss": loss}
