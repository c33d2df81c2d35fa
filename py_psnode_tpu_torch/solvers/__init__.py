"""Fixed-grid steppers, event streams, the ODE and DAE rollouts and their
multiple-shooting forms."""

from py_psnode_tpu_torch.solvers.events import event_match, jumped_stream  # noqa: F401
from py_psnode_tpu_torch.solvers.integrate import integrate_dae, integrate_ode  # noqa: F401
from py_psnode_tpu_torch.solvers.multishoot import (  # noqa: F401
    multishoot_dae,
    multishoot_ode,
    tile_batch,
)
from py_psnode_tpu_torch.solvers.steppers import (  # noqa: F401
    RK4,
    Euler,
    Midpoint,
    get_stepper,
)
