"""Registry of the model variants the port serves (counterpart of
``py_psnode_tpu/train/variants.py``). Ported: ``ode_no_encode``,
``dae_no_encode``, ``ode_channelwise`` and ``dae_channelwise``, each with
its export recipe (the artifact names and ``dim.txt`` of the JAX
package's)."""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from py_psnode_tpu_torch.bridge import flax_params
from py_psnode_tpu_torch.export import export_submodule, flatten_channelwise, write_dim_txt
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
    # export_fn(model, dims, path, write_program): the submodules' artifacts
    # into path, the .pt2 programs rewritten where write_program (the first
    # export of a run) and otherwise written only where missing
    export_fn: Callable
    # the channel-wise family: a per-channel matmul form (channel_impl) and
    # no teacher forcing
    channel_wise: bool = False
    # cap the eval batch at the training batch: the DAE channel-wise
    # readout holds [T, b, h, h] activations (py_psnode_tpu/train/trainer.py:689-695)
    eval_batch_capped: bool = False

    @property
    def loss_keys(self):
        return ("x_loss", "i_loss", "loss") if self.kind == "dae" else ("x_loss", "loss")


# --- export recipes (py_psnode_tpu/train/variants.py:77-195)

def export_examples(name: str, model, dims) -> Dict[str, Tuple[np.ndarray, ...]]:
    """Each exported submodule's example arguments in the JAX recipes (batch
    1, zeros, t0 a 0-d array), by submodule name in export order."""
    z = lambda *shape: np.zeros(shape, np.float32)
    xd, zd = dims["x_dim"], dims["z_dim"]
    if name == "ode_no_encode":
        return {"de_func": (z(), z(1, xd + zd), z(1, xd), z(1, zd))}
    if name == "dae_no_encode":
        vd, idim = dims["v_dim"], dims["i_dim"]
        all_init = z(1, xd + zd + vd + idim)
        return {"init_func": (z(1, zd), z(1, vd), z(1, idim)),
                "de_func": (z(), all_init, z(1, xd), z(1, zd), z(1, vd), z(1, idim)),
                "ae_func": (all_init, z(1, xd), z(1, zd), z(1, vd))}
    h = model.hidden_dim
    out = {"de_func": (z(), z(1, xd + zd, h), z(1, xd, h), z(1, zd))}
    if name == "dae_channelwise":
        out["ae_func"] = (z(1, xd, h), z(1, dims["v_dim"]))
    return out


def _export_no_encode(name, model, dims, path, write_program):
    """The no-encode recipes: ``ode_no_encode`` writes de_func (ref
    neural_00_ODE_01_no_encode.py:93-101), ``dae_no_encode`` init/de/ae
    funcs (ref neural_01_DAE_01_no_encode.py:117-133)."""
    for sub, args in export_examples(name, model, dims).items():
        module = getattr(model, sub)
        export_submodule(path, sub, module, flax_params(module), args, write_program)


def _export_channelwise(name, model, dims, path, write_program):
    """The channel-wise recipes: de_func (and, for the DAE, ae_func) as a
    stacked ``.npz``, a per-channel-sliced ``.bin`` and a ``.pt2``, and
    dim.txt."""
    write_dim_txt(path, model.hidden_dim)
    for sub, args in export_examples(name, model, dims).items():
        module = getattr(model, sub)
        params = flax_params(module)
        export_submodule(path, sub, module, params, args, write_program, bin_flat=flatten_channelwise(params))


VARIANTS = {
    "ode_no_encode": Variant(
        name="ode_no_encode",
        kind="ode",
        larger_than=3.29,
        batch_args=ODE_BATCH_ARGS,
        make_model=lambda dims, hidden, **kw: ODEModel(**dims, hidden_dim=hidden, **kw),
        loss_fn=L.ode_no_encode_loss,
        fused_apply=fused_ode_apply,
        export_fn=functools.partial(_export_no_encode, "ode_no_encode"),
    ),
    "dae_no_encode": Variant(
        name="dae_no_encode",
        kind="dae",
        larger_than=math.pi,
        batch_args=DAE_BATCH_ARGS,
        make_model=lambda dims, hidden, **kw: DAEModel(**dims, hidden_dim=hidden, **kw),
        loss_fn=L.dae_no_encode_loss,
        fused_apply=fused_dae_apply,
        export_fn=functools.partial(_export_no_encode, "dae_no_encode"),
    ),
    "ode_channelwise": Variant(
        name="ode_channelwise",
        kind="ode",
        larger_than=None,
        batch_args=ODE_BATCH_ARGS,
        make_model=lambda dims, hidden, **kw: ChannelWiseODEModel(**dims, hidden_dim=hidden, **kw),
        loss_fn=L.ode_channelwise_loss,
        fused_apply=fused_cw_ode_apply,
        export_fn=functools.partial(_export_channelwise, "ode_channelwise"),
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
        export_fn=functools.partial(_export_channelwise, "dae_channelwise"),
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
