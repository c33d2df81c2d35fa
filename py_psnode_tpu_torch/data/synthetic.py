"""Synthetic AVR trajectories for the ODE family (numpy copy of the AVR part
of ``py_psnode_tpu/data/synthetic.py``: ``_event_indices`` :40,
``generate_avr_samples`` :58, ``write_avr_dataset`` :587).

:func:`generate_avr_samples` simulates a PSASP-Type-1-style excitation
system (AVR), states ``x = [xr, Efd]``, inputs ``z = [Vt, Vref]``, under a
terminal-voltage dip and recovery (two events), and returns the ODE
``.npz`` schema. It draws only ``rng.uniform``/``rng.integers`` and computes
in float64, so the same seed gives the same arrays on every machine and the
same arrays as the JAX package. The SMIB, motor and composite generators
are not ported.

Event-stream convention (``my_solvers.py:70-72``): the recorded stream
holds the pre-jump (left-limit) value at an event index; ``z_jump`` holds
the post-jump value that the solver substitutes for the step starting at
that time. The true dynamics use post-jump inputs from the event onward.
"""

from __future__ import annotations

import pathlib

import numpy as np

from py_psnode_tpu_torch.data.schema import save_ode_samples


def _event_indices(rng, N, T, shared_events):
    """Grid-aligned fault-on index and duration, varied per sample and scaled
    to the horizon so short trajectories still contain the disturbance.
    ``shared_events=True`` draws one schedule for the whole file."""
    n = 1 if shared_events else N
    f_idx = rng.integers(max(T // 8, 1), max(T // 3, 2), n)
    dur = rng.integers(max(T // 20, 1), max(T // 10, 2), n)
    if shared_events:
        f_idx = np.broadcast_to(f_idx, (N,)).copy()
        dur = np.broadcast_to(dur, (N,)).copy()
    return f_idx, dur


def generate_avr_samples(
    n_samples: int,
    n_steps: int = 1001,
    dt: float = 0.01,
    seed: int = 0,
    substeps: int = 10,
    shared_events: bool = False,
):
    """Vectorized RK4 simulation of a two-state AVR under a voltage dip.

    Dynamics: ``dxr/dt = (Ka*(Vref - Vt) - xr)/Ta``,
    ``dEfd/dt = (xr - Efd)/Te``.

    Returns a dict of arrays in the ODE ``.npz`` schema.
    """
    rng = np.random.default_rng(seed)
    N, T = n_samples, n_steps
    t = np.arange(T) * dt
    ka = rng.uniform(20.0, 60.0, (N, 1))
    ta = rng.uniform(0.05, 0.2, (N, 1))
    te = rng.uniform(0.3, 1.0, (N, 1))
    vref = rng.uniform(0.98, 1.05, (N, 1))
    v_pre = rng.uniform(0.98, 1.04, (N, 1))
    v_fault = rng.uniform(0.3, 0.7, (N, 1))
    v_post = rng.uniform(0.92, 1.02, (N, 1))

    f_idx, dur = _event_indices(rng, N, T, shared_events)
    f_idx, dur = f_idx[:, None], dur[:, None]
    c_idx = np.minimum(f_idx + np.maximum(dur, 1), T - 2)
    t_f = f_idx * dt
    t_c = c_idx * dt

    steps = np.arange(T)[None, :]
    # right-continuous Vt(t) used by the true dynamics
    vt_rc = np.where(steps < f_idx, v_pre, np.where(steps < c_idx, v_fault, v_post))
    # left-limit stream recorded in the data
    vt_stream = np.where(steps <= f_idx, v_pre, np.where(steps <= c_idx, v_fault, v_post))

    # steady-state init: xr = Ka*(Vref - Vt0), Efd = xr
    xr = ka * (vref - v_pre)
    efd = xr.copy()
    x = np.zeros((N, T, 2))
    x[:, 0, 0], x[:, 0, 1] = xr[:, 0], efd[:, 0]

    h = dt / substeps
    for j in range(1, T):
        vt = vt_rc[:, j - 1 : j]
        for _ in range(substeps):
            def f(xr_, efd_):
                return (ka * (vref - vt) - xr_) / ta, (xr_ - efd_) / te
            k1 = f(xr, efd)
            k2 = f(xr + 0.5 * h * k1[0], efd + 0.5 * h * k1[1])
            k3 = f(xr + 0.5 * h * k2[0], efd + 0.5 * h * k2[1])
            k4 = f(xr + h * k3[0], efd + h * k3[1])
            xr = xr + (h / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
            efd = efd + (h / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        x[:, j, 0], x[:, j, 1] = xr[:, 0], efd[:, 0]

    z = np.stack([vt_stream, np.broadcast_to(vref, (N, T))], axis=-1)
    event_t = np.concatenate([t_f, t_c], axis=1)
    # post-jump z at each event: [Vt_post, Vref]
    z_jump = np.stack(
        [np.concatenate([v_fault, v_post], axis=1), np.broadcast_to(vref, (N, 2))],
        axis=-1,
    )
    return dict(
        t=t[None, :, None].repeat(N, 0),
        x=x,
        z=z,
        event_t=event_t,
        z_jump=z_jump,
        mask=np.ones_like(x),
        name=[("xr", "p.u."), ("Efd", "p.u.")],
    )


def write_avr_dataset(dir_path, n_train=320, n_test=64, n_steps=1001, seed=0):
    """Write ``training.npz`` (seed ``seed``) and ``testing.npz`` (seed
    ``seed + 1``) AVR sample files; returns their paths."""
    d = pathlib.Path(dir_path)
    d.mkdir(parents=True, exist_ok=True)
    for name, n, s in (("training", n_train, seed), ("testing", n_test, seed + 1)):
        data = generate_avr_samples(n, n_steps=n_steps, seed=s)
        save_ode_samples(d / f"{name}.npz", **data)
    return d / "training.npz", d / "testing.npz"
