"""Neural function blocks and the DAE and ODE no-encode, direct-encode and
channel-wise models."""

from py_psnode_tpu_torch.models.channelwise import (  # noqa: F401
    ChannelWiseDAEModel,
    ChannelWiseODEModel,
)
from py_psnode_tpu_torch.models.dae import DAEEncodeModel, DAEModel  # noqa: F401
from py_psnode_tpu_torch.models.funcs import (  # noqa: F401
    AEFunc,
    ChannelWiseAEFunc,
    ChannelWiseDEFunc,
    Codec,
    DEFunc,
    InitFunc,
    MLP,
    PerChannelMLP,
)
from py_psnode_tpu_torch.models.ode import ODEEncodeModel, ODEModel  # noqa: F401
