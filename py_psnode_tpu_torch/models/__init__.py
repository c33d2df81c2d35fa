"""Neural function blocks and the DAE and ODE no-encode models."""

from py_psnode_tpu_torch.models.dae import DAEModel  # noqa: F401
from py_psnode_tpu_torch.models.funcs import AEFunc, DEFunc, InitFunc, MLP  # noqa: F401
from py_psnode_tpu_torch.models.ode import ODEModel  # noqa: F401
