"""Fused DAE path: stream precompute, the CUDA forward and backward kernels
with their plain PyTorch versions, the autograd Function and the
model-level entry."""

from py_psnode_tpu_torch.ops.fused_dae import (  # noqa: F401
    fused_dae_rollout,
    precompute_streams,
    split_de_layer1,
)
from py_psnode_tpu_torch.ops.fused_dae_vjp import (  # noqa: F401
    FusedDaeRollout,
    fused_dae_rollout_diff,
)
from py_psnode_tpu_torch.ops.fused_model import fused_dae_apply  # noqa: F401
