"""Registry of the model variants the port serves (counterpart of
``py_psnode_tpu/train/variants.py``). Only ``dae_no_encode`` is ported."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

from py_psnode_tpu_torch.models import DAEModel

DAE_BATCH_ARGS = ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")

# variants of the JAX package that the port does not serve yet
NOT_PORTED = ("ode_no_encode", "ode_encode", "dae_encode", "ode_channelwise", "dae_channelwise")


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    kind: str  # 'dae' (the ODE family is not ported yet)
    larger_than: Optional[float]
    batch_args: Tuple[str, ...]
    make_model: Callable


def _dae_dims(ds):
    return dict(
        x_dim=ds.x.shape[-1],
        z_dim=ds.z.shape[-1],
        v_dim=ds.v.shape[-1],
        i_dim=ds.i.shape[-1],
    )


VARIANTS = {
    "dae_no_encode": Variant(
        name="dae_no_encode",
        kind="dae",
        larger_than=math.pi,
        batch_args=DAE_BATCH_ARGS,
        make_model=lambda dims, hidden, **kw: DAEModel(**dims, hidden_dim=hidden, **kw),
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
    return _dae_dims(ds)
