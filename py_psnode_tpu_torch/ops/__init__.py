"""Fused DAE, ODE and channel-wise paths: stream precompute, the CUDA forward
and backward kernels with their plain PyTorch versions, the autograd
Functions and the model-level entries (no-encode, direct-encode and
channel-wise)."""

from py_psnode_tpu_torch.ops.fused_channelwise import (  # noqa: F401
    fused_cw_rollout,
    precompute_cw_streams,
)
from py_psnode_tpu_torch.ops.fused_channelwise_vjp import (  # noqa: F401
    FusedCwRollout,
    fused_cw_rollout_diff,
)
from py_psnode_tpu_torch.ops.fused_dae import (  # noqa: F401
    fused_dae_rollout,
    precompute_streams,
    split_de_layer1,
)
from py_psnode_tpu_torch.ops.fused_dae_vjp import (  # noqa: F401
    FusedDaeRollout,
    fused_dae_rollout_diff,
)
from py_psnode_tpu_torch.ops.fused_model import (  # noqa: F401
    fused_cw_dae_apply,
    fused_cw_ode_apply,
    fused_dae_apply,
    fused_dae_encode_apply,
    fused_ode_apply,
    fused_ode_encode_apply,
)
from py_psnode_tpu_torch.ops.fused_ode import fused_ode_rollout, precompute_ode_streams  # noqa: F401
from py_psnode_tpu_torch.ops.fused_ode_vjp import (  # noqa: F401
    FusedOdeRollout,
    fused_ode_rollout_diff,
)
