"""The port's fused ODE path against autograd and the JAX package, on the
CPU.

* ``precompute_ode_streams`` against the JAX one: rtol 1e-6 (the same
  products in float32).
* The port's fused forward (the plain loop, the CPU path of the kernel's
  wrapper) against the JAX ``fused_ode_apply`` with its Pallas kernel in
  interpret mode, at the JAX package's fused-against-XLA bar of rtol 2e-4 /
  atol 1e-5 (``tests/test_fused_ode.py``).
* Loss and grads of the port's ``fused_ode_apply`` (``FusedOdeRollout``:
  the plain forward and the plain reverse walk) against
  ``jax.value_and_grad`` through the JAX ``fused_ode_apply`` in interpret
  mode, with weights carried across by ``bridge.py``: loss rtol 1e-4, grads
  rtol 2e-3 / atol 2e-4, the same file's bars.
* The plain reverse walk against ``torch.autograd.grad`` through the plain
  forward loop, for the no-encode shape and the direct-encode latent shape
  (``xd = h``, one tail layer): rtol 1e-4 / atol 1e-5 (float32, another
  summation order).

The CUDA kernels themselves run only on a card: ``tests/test_torch_kernel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py_psnode_tpu.ops.fused_ode import fused_ode_apply as jax_fused_ode_apply
from py_psnode_tpu.ops.fused_ode import precompute_ode_streams as jax_precompute

from py_psnode_tpu_torch import bridge
from py_psnode_tpu_torch.ops import fused_ode as F
from py_psnode_tpu_torch.ops import fused_ode_vjp as V
from py_psnode_tpu_torch.ops.fused_model import fused_ode_apply

from test_torch_ode_modules import KEYS, jax_ode_params, ode_batch, port_model

SOLVERS = ["euler", "midpoint", "rk4"]
JAX_FWD_TOL = dict(rtol=2e-4, atol=1e-5)
JAX_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
AUTOGRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def test_precompute_ode_streams_matches_jax():
    batch = ode_batch(B=3, T=7)
    _, params, _ = jax_ode_params(batch, 16, "euler")
    rng = np.random.default_rng(4)
    all_initial = rng.standard_normal((3, 4)).astype(np.float32)
    z_step = rng.standard_normal((6, 3, 2)).astype(np.float32)
    s_j, w_j = jax_precompute(params["params"], jnp.asarray(all_initial), jnp.asarray(z_step), 2)
    p = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), params["params"])
    s_t, w_t = F.precompute_ode_streams(p, torch.tensor(all_initial), torch.tensor(z_step), 2)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(w_t["wx_de"].numpy(), np.asarray(w_j["wx_de"]), rtol=1e-6)
    assert len(w_t["de_tail"]) == len(w_j["de_tail"]) == 3
    for (W, b), (Wj, bj) in zip(w_t["de_tail"], w_j["de_tail"]):
        np.testing.assert_array_equal(W.numpy(), np.asarray(Wj))
        np.testing.assert_array_equal(b.numpy(), np.asarray(bj))
        assert W.is_contiguous() and b.is_contiguous()


@pytest.mark.parametrize("events", [True, False])
@pytest.mark.parametrize("solver", SOLVERS)
def test_fused_forward_matches_jax_interpret(solver, events):
    batch = ode_batch(events=events)
    _, params, _ = jax_ode_params(batch, 16, solver)
    ref = jax_fused_ode_apply(params, {k: jnp.asarray(batch[k]) for k in KEYS}, x_dim=2,
                              solver=solver, interpret=True)
    model = port_model(params, batch, 16, solver)
    before = F.fused_ode_rollout.launches
    got = fused_ode_apply(model, {k: torch.tensor(batch[k]) for k in KEYS})
    assert F.fused_ode_rollout.launches == before  # CPU tensors: the plain loop
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **JAX_FWD_TOL)


@pytest.mark.parametrize("solver", SOLVERS)
def test_fused_grads_match_jax_interpret(solver):
    batch = ode_batch()
    _, params, _ = jax_ode_params(batch, 16, solver)
    target = np.random.default_rng(9).standard_normal(batch["x"].shape).astype(np.float32)
    jbatch = {k: jnp.asarray(batch[k]) for k in KEYS}

    def jax_loss(p):
        out = jax_fused_ode_apply(p, jbatch, x_dim=2, solver=solver, interpret=True)
        return jnp.sum((out - target) ** 2)

    loss_j, g_j = jax.value_and_grad(jax_loss)(params)
    model = port_model(params, batch, 16, solver)
    out = fused_ode_apply(model, {k: torch.tensor(batch[k]) for k in KEYS})
    loss_t = ((out - torch.tensor(target)) ** 2).sum()
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    ref = bridge.state_dict_from_params(jax.tree_util.tree_map(np.asarray, g_j))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), err_msg=name, **JAX_GRAD_TOL)


def rollout_inputs(B, Tm1, h, xd, n_tail, seed=0):
    """Seeded float32 rollout inputs with per-row step sizes."""
    rng = np.random.default_rng(seed)
    t = lambda *s, sc=1.0: torch.tensor((rng.standard_normal(s) * sc).astype(np.float32))
    outs = [h] * (n_tail - 1) + [xd]
    weights = dict(wx_de=t(xd, h, sc=xd ** -0.5),
                   de_tail=[(t(h, o, sc=h ** -0.5), t(o, sc=0.1)) for o in outs])
    dt = torch.full((Tm1, B, 1), 0.05)
    dt[:, 1] = 0.02
    return t(Tm1, B, h, sc=0.5), weights, t(B, xd), dt


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("xd,n_tail", [(2, 3), (16, 1)])  # no-encode; direct-encode latent
def test_plain_walk_matches_autograd(solver, xd, n_tail):
    s_de, weights, x0, dt = rollout_inputs(3, 10, 16, xd, n_tail)
    leaves = [s_de, x0] + V.flatten_weights(weights)
    for a in leaves:
        a.requires_grad_(True)
    sol = torch.cat([x0[None], F.fused_ode_rollout_plain(s_de, weights, x0, dt, solver)])
    cot = torch.tensor(np.random.default_rng(1).standard_normal(tuple(sol.shape)).astype(np.float32))
    ref = torch.autograd.grad(sol, leaves, cot)
    g_s, g_w, g_x0 = V.fused_ode_rollout_bwd_plain(
        s_de.detach(), V.unflatten_weights([w.detach() for w in leaves[2:]]), dt, sol.detach(),
        cot, solver)
    got = [g_s, g_x0 + cot[0]] + V.flatten_weights(g_w)
    for k, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=str(k), **AUTOGRAD_TOL)


@pytest.mark.parametrize("solver", SOLVERS)
def test_autograd_function_matches_autograd_of_plain_loop(solver):
    s_de, weights, x0, dt = rollout_inputs(3, 10, 16, 16, 1, seed=2)
    leaves = [s_de, x0] + V.flatten_weights(weights)
    for a in leaves:
        a.requires_grad_(True)
    cot = torch.tensor(np.random.default_rng(3).standard_normal((11, 3, 16)).astype(np.float32))
    plain = torch.cat([x0[None], F.fused_ode_rollout_plain(s_de, weights, x0, dt, solver)])
    ref = torch.autograd.grad(plain, leaves, cot)
    fused = V.fused_ode_rollout_diff(s_de, weights, x0, dt, solver)
    np.testing.assert_allclose(fused.detach().numpy(), plain.detach().numpy(), rtol=1e-6, atol=1e-7)
    got = torch.autograd.grad(fused, leaves, cot)
    for k, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=str(k), **AUTOGRAD_TOL)


def test_fused_apply_runs_without_grad_when_nothing_needs_it():
    batch = ode_batch()
    _, params, _ = jax_ode_params(batch, 16, "rk4")
    model = port_model(params, batch, 16, "rk4").requires_grad_(False)
    out = fused_ode_apply(model, {k: torch.tensor(batch[k]) for k in KEYS})
    assert out.grad_fn is None and out.shape == (4, 9, 2)


def test_wrappers_refuse_other_devices():
    s_de, weights, x0, dt = rollout_inputs(2, 4, 8, 2, 3)
    meta = lambda a: a.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        F.fused_ode_rollout(meta(s_de), weights, x0, dt)
    sol = torch.zeros(5, 2, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        V.fused_ode_rollout_bwd(meta(s_de), weights, dt, sol, sol)
    with pytest.raises(ValueError, match="fused kernels support solvers"):
        F.fused_ode_rollout(s_de, weights, x0, dt, "dopri5")
