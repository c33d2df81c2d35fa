"""Registry of the model variants the port serves (counterpart of
``py_psnode_tpu/train/variants.py``). Ported: ``ode_no_encode`` and
``dae_no_encode``."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

from py_psnode_tpu_torch.models import DAEModel, ODEModel
from py_psnode_tpu_torch.train import losses as L

ODE_BATCH_ARGS = ("t", "x", "z", "event_t", "z_jump")
DAE_BATCH_ARGS = ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")

# variants of the JAX package that the port does not serve yet
NOT_PORTED = ("ode_encode", "dae_encode", "ode_channelwise", "dae_channelwise")


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    kind: str  # 'ode' | 'dae'
    larger_than: Optional[float]
    batch_args: Tuple[str, ...]
    make_model: Callable
    loss_fn: Callable

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
    ),
    "dae_no_encode": Variant(
        name="dae_no_encode",
        kind="dae",
        larger_than=math.pi,
        batch_args=DAE_BATCH_ARGS,
        make_model=lambda dims, hidden, **kw: DAEModel(**dims, hidden_dim=hidden, **kw),
        loss_fn=L.dae_no_encode_loss,
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
