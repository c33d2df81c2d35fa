"""Fixed-grid explicit steppers (counterpart of
``py_psnode_tpu/solvers/steppers.py``).

A stepper is a function ``step(f, t0, dt, t1, x0) -> dx`` where ``f(t, x)``
is the dynamics closure; exogenous inputs are held constant across
substeps. ``rk4`` is Kutta's 3/8 rule. The reference's DAE branch bug of
passing ``t0=z0`` (``my_fixed_grid.py:58``) is not reproduced.
"""

from __future__ import annotations

_ONE_THIRD = 1.0 / 3.0
_TWO_THIRDS = 2.0 / 3.0


class Euler:
    """Explicit Euler: ``dx = dt * f(t0, x0)``."""

    order = 1
    n_evals = 1

    def __call__(self, f, t0, dt, t1, x0):
        return dt * f(t0, x0)


class Midpoint:
    """Explicit midpoint, order 2."""

    order = 2
    n_evals = 2

    def __call__(self, f, t0, dt, t1, x0):
        half_dt = 0.5 * dt
        f0 = f(t0, x0)
        x_mid = x0 + f0 * half_dt
        return dt * f(t0 + half_dt, x_mid)


class RK4:
    """Kutta 3/8-rule RK4, order 4."""

    order = 4
    n_evals = 4

    def __call__(self, f, t0, dt, t1, x0):
        k1 = f(t0, x0)
        k2 = f(t0 + dt * _ONE_THIRD, x0 + dt * k1 * _ONE_THIRD)
        k3 = f(t0 + dt * _TWO_THIRDS, x0 + dt * (k2 - k1 * _ONE_THIRD))
        k4 = f(t1, x0 + dt * (k1 - k2 + k3))
        return (k1 + 3.0 * (k2 + k3) + k4) * dt * 0.125


_STEPPERS = {
    "euler": Euler,
    "midpoint": Midpoint,
    "rk4": RK4,
    "rk4_38": RK4,
}


def get_stepper(name):
    """Resolve a stepper by name or pass an instance through."""
    if isinstance(name, str):
        try:
            return _STEPPERS[name.lower()]()
        except KeyError:
            raise ValueError(
                f"Unknown stepper {name!r}; choose from {sorted(_STEPPERS)}"
            ) from None
    return name
