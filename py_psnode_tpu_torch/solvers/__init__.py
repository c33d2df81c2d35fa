"""Fixed-grid steppers, event streams and the ODE and DAE rollouts."""

from py_psnode_tpu_torch.solvers.events import event_match, jumped_stream  # noqa: F401
from py_psnode_tpu_torch.solvers.integrate import integrate_dae, integrate_ode  # noqa: F401
from py_psnode_tpu_torch.solvers.steppers import (  # noqa: F401
    RK4,
    Euler,
    Midpoint,
    get_stepper,
)
