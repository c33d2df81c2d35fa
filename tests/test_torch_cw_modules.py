"""The port's channel-wise modules against the JAX package's, on the CPU.

* The weight bridge carries per-channel stacks (``w_k [C, d_in, f]``,
  ``b_k [C, f]``) across unchanged and dense kernels transposed, both ways.
* Both initialization rules use their own fan-in for a stack: flax's
  ``lecun_normal`` ``C * d_in``, the JAX package's ``torch_style_init``
  ``d_in``.
* ``PerChannelMLP`` gives the same numbers in its ``einsum`` and
  ``blockdiag`` forms.
* ``ChannelWiseDEFunc``, ``ChannelWiseAEFunc`` and both channel-wise models
  (three solvers, with and without events) against the JAX modules with
  the same weights at h=16: rtol 1e-5 / atol 1e-6 (float32; the port's ELU
  is ``torch.nn.functional.elu``, the JAX one ``nn.elu``, both ``expm1``).
* Both channel-wise losses against the JAX losses: rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py_psnode_tpu.models import funcs as jfuncs
from py_psnode_tpu.models.channelwise import ChannelWiseDAEModel as JaxCwDAE
from py_psnode_tpu.models.channelwise import ChannelWiseODEModel as JaxCwODE
from py_psnode_tpu.models.initializers import torch_style_init as jax_torch_style_init
from py_psnode_tpu.train import losses as jlosses

from py_psnode_tpu_torch import bridge
from py_psnode_tpu_torch.models import (
    ChannelWiseAEFunc,
    ChannelWiseDAEModel,
    ChannelWiseDEFunc,
    ChannelWiseODEModel,
    PerChannelMLP,
)
from py_psnode_tpu_torch.models.initializers import init_params
from py_psnode_tpu_torch.train import losses as plosses

SOLVERS = ["euler", "midpoint", "rk4"]
TOL = dict(rtol=1e-5, atol=1e-6)
ODE_KEYS = ("t", "x", "z", "event_t", "z_jump")
DAE_KEYS = ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")


def cw_batch(B=3, T=9, xd=2, zd=2, vd=0, idim=0, events=True, seed=0):
    """A seeded batch-major batch on a uniform grid (dt 0.02); with events,
    row b has one event on a grid time and one inert (-1) entry."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = (np.cumsum(np.full((B, T, 1), 0.02, np.float32), axis=1) - 0.02).astype(np.float32)
    batch = dict(t=t, x=f(B, T, xd), z=f(B, T, zd))
    if vd:
        batch.update(v=f(B, T, vd), i=f(B, T, idim))
    if events:
        event_t = np.full((B, 2), -1.0, np.float32)
        for b in range(B):
            event_t[b, 0] = t[b, 2 + b % 3, 0]
        batch.update(event_t=event_t, z_jump=f(B, 2, zd))
        if vd:
            batch["v_jump"] = f(B, 2, vd)
    else:
        batch.update(event_t=np.zeros((B, 0), np.float32), z_jump=np.zeros((B, 0, zd), np.float32))
        if vd:
            batch["v_jump"] = np.zeros((B, 0, vd), np.float32)
    return batch


def jax_cw_params(kind, batch, h, solver, seed=0):
    """The JAX channel-wise model (``"ode"`` or ``"dae"``) and its initial
    parameters on ``batch``."""
    if kind == "ode":
        model = JaxCwODE(x_dim=batch["x"].shape[-1], z_dim=batch["z"].shape[-1], hidden_dim=h,
                         solver=solver)
        keys = ODE_KEYS
    else:
        model = JaxCwDAE(x_dim=batch["x"].shape[-1], z_dim=batch["z"].shape[-1],
                         v_dim=batch["v"].shape[-1], i_dim=batch["i"].shape[-1], hidden_dim=h,
                         solver=solver)
        keys = DAE_KEYS
    args = tuple(jnp.asarray(batch[k]) for k in keys)
    return model, model.init(jax.random.PRNGKey(seed), *args), args


def port_cw_model(kind, batch, h, solver, params, **kw):
    """The port's channel-wise model with the JAX parameters."""
    xd, zd = batch["x"].shape[-1], batch["z"].shape[-1]
    if kind == "ode":
        model = ChannelWiseODEModel(xd, zd, h, solver=solver, device="meta", **kw)
    else:
        model = ChannelWiseDAEModel(xd, zd, batch["v"].shape[-1], batch["i"].shape[-1], h,
                                    solver=solver, device="meta", **kw)
    return bridge.load_params(model, params)


def torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# ----------------------------------------------------------------- bridge


def test_bridge_round_trip_carries_stacks_and_kernels():
    batch = cw_batch(vd=2, idim=2, xd=3, zd=1)
    _, params, _ = jax_cw_params("dae", batch, 8, "euler")
    model = port_cw_model("dae", batch, 8, "euler", params)
    sd = model.state_dict()
    # a stack keeps its name and layout; a dense kernel becomes weight [out, in]
    # the JAX test configuration runs in float64; the port keeps float32
    w = np.asarray(params["params"]["de_func"]["xh_ext"]["w_0"], np.float32)
    assert w.shape == (3, 8, 8)
    np.testing.assert_array_equal(sd["de_func.xh_ext.w_0"].numpy(), w)
    k = np.asarray(params["params"]["de_func"]["xh_dot_v"]["dense_0"]["kernel"], np.float32)
    np.testing.assert_array_equal(sd["de_func.xh_dot_v.dense_0.weight"].numpy(), k.T)
    back = bridge.flatten_params(bridge.flax_params(model))
    ref = bridge.flatten_params(params["params"])
    assert sorted(back) == sorted(ref)
    for key, arr in ref.items():
        got = back[key].detach().numpy()
        assert got.shape == np.asarray(arr).shape, key
        np.testing.assert_array_equal(got, np.asarray(arr, np.float32), err_msg=key)
    with pytest.raises(ValueError, match="unexpected parameter"):
        bridge.state_dict_from_params({"de_func": {"xh_ext": {"scale": np.ones(3)}}})


# ------------------------------------------------------------- init rules


@pytest.mark.parametrize("style", ["lecun", "torch"])
def test_init_rules_use_their_own_fan_in_for_stacks(style):
    """(4, 128, 128) stack: lecun std 1/sqrt(512) = 0.0442 (flax counts C *
    d_in); torch-style bound 1/sqrt(128) (the JAX rule counts d_in); a
    dense 128-in layer keeps fan-in 128 either way."""
    mlp = init_params(PerChannelMLP(4, (128,), 128), style, seed=0)
    w, b = mlp.w_0.detach().numpy(), mlp.b_0.detach().numpy()
    if style == "lecun":
        np.testing.assert_allclose(w.std(), 1 / np.sqrt(512), rtol=0.02)
        assert np.abs(w).max() <= 2.0 / 0.87962566 / np.sqrt(512) + 1e-6
        assert not b.any()
    else:
        bound = 1 / np.sqrt(128)
        assert np.abs(w).max() <= bound and np.abs(b).max() <= bound
        np.testing.assert_allclose(w.std(), bound / np.sqrt(3), rtol=0.02)
        # the JAX rule draws the same distribution (other bits)
        jp = jax_torch_style_init({"m": {"w_0": jnp.zeros((4, 128, 128)), "b_0": jnp.zeros((4, 128))}},
                                  jax.random.PRNGKey(0))
        jw = np.asarray(jp["m"]["w_0"])
        assert np.abs(jw).max() <= bound
        np.testing.assert_allclose(jw.std(), w.std(), rtol=0.03)


def test_init_covers_every_channelwise_parameter():
    model = init_params(ChannelWiseDAEModel(3, 1, 2, 2, 16), "lecun", seed=1)
    for name, p in model.named_parameters():
        if name.endswith("bias") or ".b_" in name:
            assert not p.detach().any(), name
        else:
            assert p.detach().std() > 0, name
    again = init_params(ChannelWiseDAEModel(3, 1, 2, 2, 16), "lecun", seed=1)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


# ----------------------------------------------------------- PerChannelMLP


def test_per_channel_mlp_einsum_equals_blockdiag():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((5, 7, 3, 16)).astype(np.float32))
    a = init_params(PerChannelMLP(3, (16, 16), 16), "torch", seed=2)
    b = PerChannelMLP(3, (16, 16), 16, impl="blockdiag")
    b.load_state_dict(a.state_dict())
    np.testing.assert_allclose(b(x).detach().numpy(), a(x).detach().numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="impl"):
        PerChannelMLP(3, (16,), 16, impl="dense")


@pytest.mark.parametrize("impl", ["einsum", "blockdiag"])
def test_per_channel_mlp_matches_jax(impl):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 3, 16)).astype(np.float32)
    jm = jfuncs.PerChannelMLP(n_channels=3, features=(16, 16), d_in=16, impl=impl)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    pm = bridge.load_params(PerChannelMLP(3, (16, 16), 16, impl=impl, device="meta"), p)
    np.testing.assert_allclose(pm(torch.tensor(x)).detach().numpy(), np.asarray(jm.apply(p, jnp.asarray(x))),
                               **TOL)


# ------------------------------------------------------ DEFunc and AEFunc


def test_channelwise_funcs_match_jax():
    rng = np.random.default_rng(6)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    B, xd, zd, vd, idim, h = 3, 2, 2, 2, 3, 16
    xh, f_init, z, v = f(B, xd, h), f(B, xd + zd, h), f(B, zd), f(B, vd)
    de = jfuncs.ChannelWiseDEFunc(x_dim=xd, z_dim=zd, hidden_dim=h)
    x0 = f(B, xd)

    def every_net(m, *args):  # __call__ alone leaves the x codecs out
        return m(*args), m.decode_x(m.encode_x(jnp.asarray(x0)))

    dp = de.init(jax.random.PRNGKey(2), 0.0, jnp.asarray(f_init), jnp.asarray(xh), jnp.asarray(z),
                 method=every_net)
    pde = bridge.load_params(ChannelWiseDEFunc(xd, zd, h, device="meta"), dp)
    t = torch.tensor
    np.testing.assert_allclose(
        pde(0.0, t(f_init), t(xh), t(z)).detach().numpy(),
        np.asarray(de.apply(dp, 0.0, jnp.asarray(f_init), jnp.asarray(xh), jnp.asarray(z))), **TOL)
    for method, args in (("encode_x", (x0,)), ("decode_x", (xh,)), ("z_features", (z,)),
                         ("features_of", (xh, z))):
        ref = de.apply(dp, *[jnp.asarray(a) for a in args], method=getattr(jfuncs.ChannelWiseDEFunc, method))
        got = getattr(pde, method)(*[t(a) for a in args])
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), err_msg=method, **TOL)
    ae = jfuncs.ChannelWiseAEFunc(x_dim=xd, v_dim=vd, i_dim=idim, hidden_dim=h)
    ap = ae.init(jax.random.PRNGKey(3), jnp.asarray(xh), jnp.asarray(v))
    pae = bridge.load_params(ChannelWiseAEFunc(xd, vd, idim, h, device="meta"), ap)
    np.testing.assert_allclose(pae(t(xh), t(v)).detach().numpy(),
                               np.asarray(ae.apply(ap, jnp.asarray(xh), jnp.asarray(v))), **TOL)


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("events", [True, False])
@pytest.mark.parametrize("solver", SOLVERS)
def test_ode_model_matches_jax(solver, events):
    batch = cw_batch(events=events)
    model, params, args = jax_cw_params("ode", batch, 16, solver)
    ref = model.apply(params, *args)
    got = port_cw_model("ode", batch, 16, solver, params)(*[torch.tensor(batch[k]) for k in ODE_KEYS])
    assert len(got) == 2
    for g, r, name in zip(got, ref, ("x_pred", "x_re")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), err_msg=name, **TOL)


@pytest.mark.parametrize("events", [True, False])
@pytest.mark.parametrize("solver", SOLVERS)
def test_dae_model_matches_jax(solver, events):
    batch = cw_batch(xd=3, zd=1, vd=2, idim=2, events=events, seed=1)
    model, params, args = jax_cw_params("dae", batch, 16, solver)
    ref = model.apply(params, *args)
    got = port_cw_model("dae", batch, 16, solver, params)(*[torch.tensor(batch[k]) for k in DAE_KEYS])
    assert len(got) == 3
    for g, r, name in zip(got, ref, ("x_pred", "i_pred", "x_re")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), err_msg=name, **TOL)


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("padded", [False, True])
def test_losses_match_jax(padded):
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    B, T = 4, 6
    mask = (rng.random((B, T, 1)) > 0.2).astype(np.float32)
    batch = dict(x=f(B, T, 3), i=f(B, T, 2), mask=mask)
    if padded:
        batch["sample_w"] = np.array([1, 1, 1, 0], np.float32)
    outs_ode = (f(B, T, 3), f(B, T, 3))
    outs_dae = (f(B, T, 3), f(B, T, 2), f(B, T, 3))
    tb = torch_batch(batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for pfn, jfn, outs in ((plosses.ode_channelwise_loss, jlosses.ode_channelwise_loss, outs_ode),
                           (plosses.dae_channelwise_loss, jlosses.dae_channelwise_loss, outs_dae)):
        pl, paux = pfn(tuple(torch.tensor(o) for o in outs), tb)
        jl, jaux = jfn(tuple(jnp.asarray(o) for o in outs), jb)
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
        assert set(paux) == set(jaux)
        for k in jaux:
            np.testing.assert_allclose(float(paux[k]), float(jaux[k]), rtol=1e-6, err_msg=k)
