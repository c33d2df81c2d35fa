"""Fused DAE forward: stream precompute, the CUDA rollout kernel and its
plain PyTorch version, and the model-level entry."""

from py_psnode_tpu_torch.ops.fused_dae import (  # noqa: F401
    fused_dae_rollout,
    precompute_streams,
    split_de_layer1,
)
from py_psnode_tpu_torch.ops.fused_model import fused_dae_apply  # noqa: F401
