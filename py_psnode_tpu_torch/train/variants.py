"""Registry of the model variants the port serves (counterpart of
``py_psnode_tpu/train/variants.py``). Ported: ``ode_no_encode``,
``dae_no_encode``, ``ode_channelwise`` and ``dae_channelwise``."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

from py_psnode_tpu_torch.models import ChannelWiseDAEModel, ChannelWiseODEModel, DAEModel, ODEModel
from py_psnode_tpu_torch.ops.fused_model import (
    fused_cw_dae_apply,
    fused_cw_ode_apply,
    fused_dae_apply,
    fused_ode_apply,
)
from py_psnode_tpu_torch.train import losses as L

ODE_BATCH_ARGS = ("t", "x", "z", "event_t", "z_jump")
DAE_BATCH_ARGS = ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")

# variants of the JAX package that the port does not serve yet
NOT_PORTED = ("ode_encode", "dae_encode")


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    kind: str  # 'ode' | 'dae'
    larger_than: Optional[float]
    batch_args: Tuple[str, ...]
    make_model: Callable
    loss_fn: Callable
    # the --fused route: fused_apply(model, batch, solver=...)
    fused_apply: Callable
    # the channel-wise family: a per-channel matmul form (channel_impl) and
    # no teacher forcing
    channel_wise: bool = False
    # cap the eval batch at the training batch: the DAE channel-wise
    # readout holds [T, b, h, h] activations (py_psnode_tpu/train/trainer.py:689-695)
    eval_batch_capped: bool = False

    @property
    def loss_keys(self):
        return ("x_loss", "i_loss", "loss") if self.kind == "dae" else ("x_loss", "loss")


VARIANTS = {
    "ode_no_encode": Variant(
        name="ode_no_encode",
        kind="ode",
        larger_than=3.29,
        batch_args=ODE_BATCH_ARGS,
        make_model=lambda dims, hidden, **kw: ODEModel(**dims, hidden_dim=hidden, **kw),
        loss_fn=L.ode_no_encode_loss,
        fused_apply=fused_ode_apply,
    ),
    "dae_no_encode": Variant(
        name="dae_no_encode",
        kind="dae",
        larger_than=math.pi,
        batch_args=DAE_BATCH_ARGS,
        make_model=lambda dims, hidden, **kw: DAEModel(**dims, hidden_dim=hidden, **kw),
        loss_fn=L.dae_no_encode_loss,
        fused_apply=fused_dae_apply,
    ),
    "ode_channelwise": Variant(
        name="ode_channelwise",
        kind="ode",
        larger_than=None,
        batch_args=ODE_BATCH_ARGS,
        make_model=lambda dims, hidden, **kw: ChannelWiseODEModel(**dims, hidden_dim=hidden, **kw),
        loss_fn=L.ode_channelwise_loss,
        fused_apply=fused_cw_ode_apply,
        channel_wise=True,
    ),
    "dae_channelwise": Variant(
        name="dae_channelwise",
        kind="dae",
        larger_than=None,
        batch_args=DAE_BATCH_ARGS,
        make_model=lambda dims, hidden, **kw: ChannelWiseDAEModel(**dims, hidden_dim=hidden, **kw),
        loss_fn=L.dae_channelwise_loss,
        fused_apply=fused_cw_dae_apply,
        channel_wise=True,
        eval_batch_capped=True,
    ),
}


def get_variant(name: str) -> Variant:
    if name in NOT_PORTED:
        raise NotImplementedError(f"variant {name!r} is not ported yet")
    try:
        return VARIANTS[name]
    except KeyError:
        raise ValueError(f"unknown variant {name!r}; choose from {sorted(VARIANTS)}") from None


def dataset_dims(variant: Variant, ds):
    dims = dict(x_dim=ds.x.shape[-1], z_dim=ds.z.shape[-1])
    if variant.kind == "dae":
        dims.update(v_dim=ds.v.shape[-1], i_dim=ds.i.shape[-1])
    return dims
