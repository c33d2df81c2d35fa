"""Checkpoints, evaluation, losses, the optimizer, the variant registry, the
multiple-shooting forwards and the trainer."""

from py_psnode_tpu_torch.train.multishoot_forward import (  # noqa: F401
    fused_multishoot_dae_apply,
    fused_multishoot_dae_encode_apply,
    fused_multishoot_ode_apply,
    fused_multishoot_ode_encode_apply,
    multishoot_cw_dae_apply,
    multishoot_cw_ode_apply,
    multishoot_dae_apply,
    multishoot_dae_encode_apply,
    multishoot_ode_apply,
    multishoot_ode_encode_apply,
)
from py_psnode_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: F401
