"""The port's fused channel-wise path against autograd and the JAX package,
on the CPU.

* ``precompute_cw_streams`` against the JAX one, in the port's layout:
  rtol 1e-6 (the same products in float32).
* The plain rollout (the CPU path of the kernel's wrapper) against the JAX
  ``fused_cw_rollout_diff`` with its Pallas kernel in interpret mode, on
  the same seeded inputs, and the model-level ``fused_cw_ode_apply`` /
  ``fused_cw_dae_apply`` (events included) against the JAX ones: rtol
  1e-5 / atol 1e-6, the JAX package's fused-against-XLA bar
  (``tests/test_fused_channelwise.py``).
* Loss and grads of the port's fused applies (``FusedCwRollout``: the plain
  forward and the plain reverse walk) against ``jax.value_and_grad``
  through the JAX fused applies in interpret mode: loss rtol 1e-5, grads
  rtol 2e-3 / atol 2e-4, the same file's bars.
* The plain reverse walk, in float32 and in float64, against
  ``torch.autograd.grad`` through the plain forward loop: rtol 1e-4 / atol
  1e-5 in float32 (another summation order), 1e-10 in float64.
* The per-channel nets' (u, v) pairs of the reverse walk, contracted by the
  plain version of the CUDA backward's contraction, against the weight and
  bias grads of the plain reverse walk: rtol 1e-5 / atol 1e-6 in float32
  (the same terms, summed in another order).

The CUDA kernels themselves run only on a card: ``tests/test_torch_kernel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py_psnode_tpu.ops import fused_channelwise as JF

from py_psnode_tpu_torch import bridge
from py_psnode_tpu_torch.ops import fused_channelwise as FC
from py_psnode_tpu_torch.ops import fused_channelwise_vjp as VC
from py_psnode_tpu_torch.ops.fused_model import fused_cw_dae_apply, fused_cw_ode_apply

from test_torch_cw_modules import (
    DAE_KEYS,
    ODE_KEYS,
    cw_batch,
    jax_cw_params,
    port_cw_model,
    torch_batch,
)
from test_torch_kernel import cw_inputs

SOLVERS = ["euler", "midpoint", "rk4"]
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
# The (u, v) pairs' layers in the backward kernel's order: (net, index of
# the layer's kernel in its stack); the bias follows its kernel.
PAIR_LAYERS = (("head", 2), ("head", 0), ("ext", 2), ("ext", 0))


def rollout_inputs(B=3, Tm1=8, h=16, xd=2, zd=2, seed=0, dtype=torch.float32):
    """``test_torch_kernel.cw_inputs`` on the CPU, in ``dtype``."""
    streams, weights, x0, dt = cw_inputs(B, Tm1, h, xd, zd, seed=seed)
    cast = lambda a: a.to(dtype)
    return ({k: cast(v) for k, v in streams.items()},
            FC.unflatten_weights([cast(a) for a in FC.flatten_weights(weights)]), cast(x0), dt)


def to_jax(streams, weights, x0, dt):
    """The port's rollout inputs in the JAX kernel's layout."""
    j = lambda a: jnp.asarray(a.numpy())
    B, h = x0.shape[0], x0.shape[2]
    per_channel = lambda st: [(j(st[0][c]), j(st[1][c])[None], j(st[2][c]), j(st[3][c])[None])
                              for c in range(st[0].shape[0])]
    jw = dict(a=j(weights["a"]), vert=[(j(W), j(b)[None]) for W, b in weights["vert"]],
              ext=per_channel(weights["ext"]), head=per_channel(weights["head"]))
    js = dict(fz=j(streams["fz"].permute(0, 2, 1, 3)), s_constV=j(streams["s_constV"].reshape(B * h, h)))
    return js, jw, j(x0.transpose(0, 1)), j(dt)


def test_precompute_cw_streams_matches_jax():
    batch = cw_batch()
    _, params, _ = jax_cw_params("ode", batch, 16, "euler")
    rng = np.random.default_rng(4)
    f_init = rng.standard_normal((3, 4, 16)).astype(np.float32)
    fz = rng.standard_normal((8, 3, 2, 16)).astype(np.float32)
    js, jw = JF.precompute_cw_streams(params["params"], jnp.asarray(f_init), jnp.asarray(fz), (2, 2))
    p = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)), params["params"])
    ps, pw = FC.precompute_cw_streams(p, torch.tensor(f_init), torch.tensor(fz))
    np.testing.assert_allclose(ps["s_constV"].reshape(48, 16).numpy(), np.asarray(js["s_constV"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ps["fz"].permute(0, 2, 1, 3).numpy(), np.asarray(js["fz"]))
    np.testing.assert_allclose(pw["a"].numpy(), np.asarray(jw["a"]), rtol=1e-6)
    for (W, b), (Wj, bj) in zip(pw["vert"], jw["vert"]):
        np.testing.assert_array_equal(W.numpy(), np.asarray(Wj))
        np.testing.assert_array_equal(b.numpy(), np.asarray(bj)[0])
    for net in ("ext", "head"):
        for c in range(2):
            for a, aj in zip(pw[net], jw[net][c]):
                np.testing.assert_array_equal(a[c].numpy(), np.asarray(aj).reshape(a[c].shape))
    assert all(a.is_contiguous() for a in FC.flatten_weights(pw))


@pytest.mark.parametrize("xd,zd", [(2, 2), (3, 1)])
@pytest.mark.parametrize("solver", SOLVERS)
def test_plain_rollout_matches_jax_interpret(solver, xd, zd):
    args = rollout_inputs(h=8 if xd == 3 else 16, xd=xd, zd=zd, seed=xd)
    rows = FC.fused_cw_rollout(*args, solver)  # CPU tensors: the plain version
    ref = JF.fused_cw_rollout_diff(*to_jax(*args), solver, True)
    ref = np.transpose(np.asarray(ref), (0, 2, 1, 3))  # [T, xd, B, h] -> [T, B, xd, h]
    np.testing.assert_allclose(rows.numpy(), ref[1:], **FWD_TOL)
    np.testing.assert_array_equal(ref[0], args[2].numpy())


@pytest.mark.parametrize("events", [True, False])
@pytest.mark.parametrize("solver", SOLVERS)
def test_fused_ode_apply_matches_jax_interpret(solver, events):
    batch = cw_batch(T=6, events=events)
    _, params, _ = jax_cw_params("ode", batch, 16, solver)
    ref = JF.fused_cw_ode_apply(params, {k: jnp.asarray(batch[k]) for k in ODE_KEYS}, (2, 2), 16,
                                solver=solver, interpret=True)
    model = port_cw_model("ode", batch, 16, solver, params).requires_grad_(False)
    got = fused_cw_ode_apply(model, torch_batch(batch))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **FWD_TOL)


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_fused_dae_apply_matches_jax_interpret(solver):
    batch = cw_batch(T=6, xd=3, zd=1, vd=2, idim=2, seed=2)
    _, params, _ = jax_cw_params("dae", batch, 8, solver)
    ref = JF.fused_cw_dae_apply(params, {k: jnp.asarray(batch[k]) for k in DAE_KEYS}, (3, 1, 2, 2), 8,
                                solver=solver, interpret=True)
    model = port_cw_model("dae", batch, 8, solver, params).requires_grad_(False)
    got = fused_cw_dae_apply(model, torch_batch(batch))
    assert len(got) == 3
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **FWD_TOL)


def flax_grads(model, grads):
    """Parameter grads of the port's model as flat flax keys (dense kernels
    back to ``[in, out]``)."""
    out = {}
    for (name, _), g in zip(model.named_parameters(), grads):
        *path, leaf = name.split(".")
        if leaf == "weight":
            out["/".join(path + ["kernel"])] = g.t()
        else:
            out["/".join(path + [leaf])] = g
    return out


@pytest.mark.parametrize("kind,solver", [("ode", "euler"), ("ode", "rk4"), ("dae", "euler")])
def test_fused_grads_match_jax_vjp(kind, solver):
    if kind == "ode":
        batch, dims, h, keys, jax_apply, apply = cw_batch(T=5), (2, 2), 8, ODE_KEYS, \
            JF.fused_cw_ode_apply, fused_cw_ode_apply
    else:
        batch, dims, h, keys, jax_apply, apply = cw_batch(T=5, xd=3, zd=1, vd=2, idim=2, seed=3), \
            (3, 1, 2, 2), 8, DAE_KEYS, JF.fused_cw_dae_apply, fused_cw_dae_apply
    _, params, _ = jax_cw_params(kind, batch, h, solver)
    jb = {k: jnp.asarray(batch[k]) for k in keys}
    loss_of = lambda outs: sum(0.5 ** k * (o ** 2).sum() for k, o in enumerate(outs))

    l_j, g_j = jax.value_and_grad(
        lambda p: loss_of(jax_apply(p, jb, dims, h, solver=solver, interpret=True)))(params)
    model = port_cw_model(kind, batch, h, solver, params)
    loss = loss_of(apply(model, torch_batch(batch)))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=1e-5)
    got = flax_grads(model, grads)
    ref = bridge.flatten_params(g_j["params"])
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(r), err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, dict(rtol=1e-4, atol=1e-5)),
                                       (torch.float64, dict(rtol=1e-10, atol=1e-12))])
@pytest.mark.parametrize("solver", SOLVERS)
def test_plain_walk_matches_autograd(solver, dtype, tol):
    streams, weights, x0, dt = rollout_inputs(B=3, Tm1=6, h=8, xd=3, zd=1, seed=7, dtype=dtype)
    leaves = [streams["fz"], streams["s_constV"], x0, *FC.flatten_weights(weights)]
    for a in leaves:
        a.requires_grad_(True)
    rows = FC.fused_cw_rollout_plain(streams, weights, x0, dt, solver)
    sol = torch.cat([x0[None], rows])
    cot = torch.tensor(np.random.default_rng(8).standard_normal(sol.shape), dtype=dtype)
    ref = torch.autograd.grad(sol, leaves, cot)
    with torch.no_grad():
        g_s, g_w, g_x0 = VC.fused_cw_rollout_bwd_plain(streams, weights, dt, sol.detach(), cot, solver)
    got = [g_s["fz"], g_s["s_constV"], g_x0 + cot[0], *FC.flatten_weights(g_w)]
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        torch.testing.assert_close(g, r, **tol)


@pytest.mark.parametrize("xd,zd", [(2, 2), (3, 1)])
@pytest.mark.parametrize("solver", SOLVERS)
def test_pair_contraction_gives_the_per_channel_grads(solver, xd, zd):
    streams, weights, x0, dt = rollout_inputs(B=3, Tm1=6, h=16, xd=xd, zd=zd, seed=11)
    sol = torch.cat([x0[None], FC.fused_cw_rollout_plain(streams, weights, x0, dt, solver)])
    cot = torch.tensor(np.random.default_rng(12).standard_normal(sol.shape).astype(np.float32))
    _, g_w, _ = VC.fused_cw_rollout_bwd_plain(streams, weights, dt, sol, cot, solver)
    pairs = VC.channel_pairs_plain(streams, weights, dt, sol, cot, solver)
    S = {"euler": 1, "midpoint": 2, "rk4": 4}[solver]
    assert tuple(pairs.shape) == (6, S, 3, 4, 2, xd, 16)
    dW, db = VC.contract_channel_pairs_plain(pairs)
    for q, (net, k) in enumerate(PAIR_LAYERS):
        torch.testing.assert_close(dW[q], g_w[net][k], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(db[q], g_w[net][k + 1], rtol=1e-5, atol=1e-6)


def test_autograd_function_matches_plain_walk_and_counts_no_launch():
    streams, weights, x0, dt = rollout_inputs(seed=9)
    leaves = [streams["fz"], streams["s_constV"], x0, *FC.flatten_weights(weights)]
    for a in leaves:
        a.requires_grad_(True)
    launches = (FC.fused_cw_rollout.launches, VC.fused_cw_rollout_bwd.launches)
    sol = VC.fused_cw_rollout_diff(streams, weights, x0, dt, "rk4")
    cot = torch.tensor(np.random.default_rng(10).standard_normal(sol.shape).astype(np.float32))
    got = torch.autograd.grad(sol, leaves, cot)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (FC.fused_cw_rollout.launches, VC.fused_cw_rollout_bwd.launches) == launches
    with torch.no_grad():
        g_s, g_w, g_x0 = VC.fused_cw_rollout_bwd_plain(streams, weights, dt, sol.detach(), cot, "rk4")
    ref = [g_s["fz"], g_s["s_constV"], g_x0 + cot[0], *FC.flatten_weights(g_w)]
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_wrappers_refuse_other_devices_and_bad_shapes():
    streams, weights, x0, dt = rollout_inputs()
    meta = {k: v.to("meta") for k, v in streams.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        FC.fused_cw_rollout(meta, weights, x0, dt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        FC.check_inputs(streams, weights, x0, dt)
