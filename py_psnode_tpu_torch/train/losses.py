"""Training losses of the no-encode, direct-encode and channel-wise variants
(counterpart of ``py_psnode_tpu/train/losses.py``: ``mse`` :29,
``masked_sum_se`` :45, ``ode_no_encode_loss`` :50, ``ode_encode_loss`` :61,
``dae_no_encode_loss`` :78-93, ``dae_encode_loss`` :96,
``ode_channelwise_loss`` and ``dae_channelwise_loss`` :123-143).

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


def ode_no_encode_loss(x_pred, batch) -> Tuple[torch.Tensor, Dict]:
    """ref neural_00_ODE_01_no_encode.py:353-355: the per-dim masked losses
    summed; ``x0_loss`` is computed and NOT added. Returns ``(loss,
    {"x_loss", "x0_loss", "loss"})``."""
    x, mask = batch["x"], batch["mask"]
    se = (x_pred - x) ** 2 * mask
    x_loss = (se.sum(dim=(0, 1)) / mask.sum()).sum()
    x0_loss = mse(x[:, 0, :], x_pred[:, 0, :], batch.get("sample_w"))
    return x_loss, {"x_loss": x_loss, "x0_loss": x0_loss, "loss": x_loss}


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


def ode_encode_loss(outputs, batch) -> Tuple[torch.Tensor, Dict]:
    """ref neural_00_ODE_02_direct_encode.py:267-270: the masked x loss plus
    the unmasked x0 term and the reconstruction ``mse(x_re, x)``. Returns
    ``(loss, {"x_loss", "x0_loss", "recon_loss", "loss"})``."""
    x_pred, x_re = outputs
    x, mask = batch["x"], batch["mask"]
    w = batch.get("sample_w")
    x_loss = (((x_pred - x) ** 2 * mask).sum(dim=(0, 1)) / mask.sum()).sum()
    x0_loss = mse(x[:, 0, :], x_pred[:, 0, :], w)
    recon = mse(x_re, x, w)
    loss = x0_loss + x_loss + recon
    return loss, {"x_loss": x_loss, "x0_loss": x0_loss, "recon_loss": recon, "loss": loss}


def dae_encode_loss(outputs, batch) -> Tuple[torch.Tensor, Dict]:
    """ref neural_01_DAE_02_direct_encode.py:359-365: masked x and i losses
    (no ω weighting), the unmasked x0 and i0 terms and both
    reconstructions. Returns ``(loss, {"x_loss", "i_loss", "recon_loss",
    "loss"})``."""
    x_pred, i_pred, x_re, i_re = outputs
    x, i, mask = batch["x"], batch["i"], batch["mask"]
    w = batch.get("sample_w")
    x_loss = masked_sum_se(x_pred, x, mask)
    i_loss = masked_sum_se(i_pred, i, mask)
    recon = mse(x_re, x, w) + mse(i_re, i, w)
    x0_loss = mse(x[:, 0, :], x_pred[:, 0, :], w)
    i0_loss = mse(i[:, 0, :], i_pred[:, 0, :], w)
    loss = x_loss + i_loss + x0_loss + i0_loss + recon
    return loss, {"x_loss": x_loss, "i_loss": i_loss, "recon_loss": recon, "loss": loss}


def ode_channelwise_loss(outputs, batch) -> Tuple[torch.Tensor, Dict]:
    """The channel-wise ODE is an autoencoding design: the direct-encode
    recipe, :func:`ode_encode_loss`."""
    return ode_encode_loss(outputs, batch)


def dae_channelwise_loss(outputs, batch) -> Tuple[torch.Tensor, Dict]:
    """Channel-wise DAE: masked x and i losses (no ω weighting), the
    unmasked x0 and i0 terms and the x reconstruction. Returns ``(loss,
    {"x_loss", "i_loss", "recon_loss", "loss"})``."""
    x_pred, i_pred, x_re = outputs
    x, i, mask = batch["x"], batch["i"], batch["mask"]
    w = batch.get("sample_w")
    x_loss = masked_sum_se(x_pred, x, mask)
    i_loss = masked_sum_se(i_pred, i, mask)
    recon = mse(x_re, x, w)
    x0_loss = mse(x[:, 0, :], x_pred[:, 0, :], w)
    i0_loss = mse(i[:, 0, :], i_pred[:, 0, :], w)
    loss = x_loss + i_loss + x0_loss + i0_loss + recon
    return loss, {"x_loss": x_loss, "i_loss": i_loss, "recon_loss": recon, "loss": loss}
