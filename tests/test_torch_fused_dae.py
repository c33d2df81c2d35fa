"""The port's fused DAE forward against the JAX package, on the CPU.

The plain rollout (the CPU path of ``fused_dae_rollout``) is held against
the Pallas kernel in interpret mode, and ``fused_dae_apply`` against the
JAX ``fused_dae_apply`` and against the port's own non-fused ``DAEModel``.
Tolerance rtol 1e-5 / atol 1e-6 (float32, different summation order).
The CUDA kernel itself runs only on a card: ``tests/test_torch_kernel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py_psnode_tpu.ops import fused_dae as jfd
from py_psnode_tpu.ops.fused_model import fused_dae_apply as jax_fused_dae_apply

from py_psnode_tpu_torch import bridge
from py_psnode_tpu_torch.cli.common import main as port_main
from py_psnode_tpu_torch.models.dae import DAEModel
from py_psnode_tpu_torch.ops import fused_dae as F
from py_psnode_tpu_torch.ops.fused_model import fused_dae_apply
from py_psnode_tpu_torch.utils.device import resolve_device

RTOL, ATOL = 1e-5, 1e-6
BATCH_KEYS = ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")


def rollout_inputs(B=5, Tm1=16, h=16, xd=3, idim=2, seed=0, events=True):
    """Seeded numpy rollout inputs in the flax layout (``kernel [in, out]``)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    streams = {k: f(Tm1, B, h, sc=0.5) for k in ("s_de", "s_ae", "s_ae_ev")}
    tail = lambda out: [(f(h, o, sc=h ** -0.5), f(o, sc=0.1)) for o in (h, h, out)]
    weights = dict(wx_de=f(xd, h, sc=0.5), wi_de=f(idim, h, sc=0.5), gx_ae=f(xd, h, sc=0.5),
                   de_tail=tail(xd), ae_tail=tail(idim))
    x0, i0 = f(B, xd), f(B, idim)
    dt = np.full((Tm1, B, 1), 0.05, np.float32)
    dt[:, 1] = 0.02  # per-row step sizes
    ev = np.zeros((Tm1, B), bool)
    if events:
        ev[2, 1] = ev[2, 3] = ev[9, :] = ev[Tm1 - 1, 0] = True
    return streams, weights, x0, i0, dt, ev


def _tree(fn, streams, weights):
    w = {k: (fn(v) if not isinstance(v, list) else [(fn(W), fn(b)) for W, b in v])
         for k, v in weights.items()}
    return {k: fn(v) for k, v in streams.items()}, w


@pytest.mark.parametrize("events", [False, True])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_plain_rollout_matches_pallas_interpret(solver, events):
    streams, weights, x0, i0, dt, ev = rollout_inputs(events=events)
    js, jw = _tree(jnp.asarray, streams, weights)
    x_ref, i_ref = jfd.fused_dae_rollout(
        js, jw, jnp.asarray(x0), jnp.asarray(i0), jnp.asarray(dt), jnp.asarray(ev),
        solver=solver, interpret=True,
    )
    ts, tw = _tree(torch.tensor, streams, weights)
    before = F.fused_dae_rollout.launches
    x, i = F.fused_dae_rollout(ts, tw, torch.tensor(x0), torch.tensor(i0), torch.tensor(dt),
                               torch.tensor(ev), solver)
    assert F.fused_dae_rollout.launches == before  # the CPU path launches nothing
    assert x.shape == (17, 5, 3) and i.shape == (17, 5, 2)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(i.numpy(), np.asarray(i_ref), rtol=RTOL, atol=ATOL)


def _model_and_batch(solver, h=16, T=33, B=4, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = np.tile((np.arange(T, dtype=np.float32) * np.float32(0.02))[None, :, None], (B, 1, 1))
    b = dict(t=t, x=f(B, T, 3), z=f(B, T, 1), v=f(B, T, 2), i=f(B, T, 2),
             event_t=np.stack([t[:, 5, 0], t[:, T - 4, 0]], 1), z_jump=f(B, 2, 1), v_jump=f(B, 2, 2))
    b["event_t"][0] = -1.0  # row 0: no events
    from py_psnode_tpu.models.dae import DAEModel as JaxDAEModel

    jm = JaxDAEModel(3, 1, 2, 2, hidden_dim=h, solver=solver)
    params = jm.init(jax.random.PRNGKey(seed), *[jnp.asarray(b[k]) for k in BATCH_KEYS])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    model = bridge.load_params(DAEModel(3, 1, 2, 2, h, solver=solver), params)
    return model.requires_grad_(False), params, b


@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_fused_dae_apply_matches_jax_and_plain_model(solver):
    model, params, b = _model_and_batch(solver)
    x_ref, i_ref = jax_fused_dae_apply(
        params, {k: jnp.asarray(v) for k, v in b.items()}, (3, 1, 2, 2), 16,
        solver=solver, interpret=True,
    )
    tb = {k: torch.tensor(v) for k, v in b.items()}
    x, i = fused_dae_apply(model, tb)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(i.numpy(), np.asarray(i_ref), rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        x_plain, i_plain = model(*[tb[k] for k in BATCH_KEYS])
    np.testing.assert_allclose(x.numpy(), x_plain.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(i.numpy(), i_plain.numpy(), rtol=RTOL, atol=ATOL)


def test_fused_dae_apply_is_forward_only():
    """With no parameter requiring grad (or grad mode off) the fused entry
    runs forward only and builds no graph; a parameter that requires grad
    makes the result differentiable."""
    model, _, b = _model_and_batch("euler")
    tb = {k: torch.tensor(v) for k, v in b.items()}
    x, i = fused_dae_apply(model, tb)
    assert x.grad_fn is None and i.grad_fn is None
    model.de_func.x_dot.dense_1.weight.requires_grad_(True)
    with torch.no_grad():
        assert fused_dae_apply(model, tb)[0].grad_fn is None
    x_g, _ = fused_dae_apply(model, tb)
    assert x_g.requires_grad
    np.testing.assert_array_equal(x_g.detach().numpy(), x.numpy())
    model.requires_grad_(False)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        fused_dae_apply(model, tb, precision="bfloat16")
    with pytest.raises(ValueError, match="rk4"):
        fused_dae_apply(model, tb, solver="heun")


def test_precompute_streams_matches_jax():
    model, params, b = _model_and_batch("rk4", T=9)
    rng = np.random.default_rng(7)
    B, T = 4, 9
    all_init = rng.standard_normal((B, 8)).astype(np.float32)
    z, v = b["z"].swapaxes(0, 1), b["v"].swapaxes(0, 1)
    z_step, v_step = z[:-1] + 1.0, v[:-1] - 1.0
    js, jw = jfd.precompute_streams(params["params"], *map(jnp.asarray, (all_init, z, v, z_step, v_step)),
                                    (3, 1, 2, 2))
    ts, tw = F.precompute_streams(bridge.flax_params(model), *map(torch.tensor, (all_init, z, v, z_step, v_step)),
                                  (3, 1, 2, 2))
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=RTOL, atol=ATOL)
    for k in ("wx_de", "wi_de", "gx_ae"):
        np.testing.assert_allclose(tw[k].numpy(), np.asarray(jw[k]), rtol=RTOL, atol=ATOL)
    for net in ("de_tail", "ae_tail"):
        assert len(tw[net]) == len(jw[net]) == 3
        for (W, bb), (jW, jb) in zip(tw[net], jw[net]):
            assert W.is_contiguous()
            np.testing.assert_array_equal(W.numpy(), np.asarray(jW))
            np.testing.assert_array_equal(bb.numpy(), np.asarray(jb))


def test_pack_and_unpack_match_jax():
    rng = np.random.default_rng(8)
    dt = rng.random((6, 3, 1)).astype(np.float32)
    ev = rng.random((6, 3)) > 0.5
    np.testing.assert_array_equal(F.pack_aux(torch.tensor(dt), torch.tensor(ev)).numpy(),
                                  np.asarray(jfd.pack_aux(jnp.asarray(dt), jnp.asarray(ev), 0)))
    packed = rng.random((6, 3, 5)).astype(np.float32)
    x0, i0 = rng.random((3, 3)).astype(np.float32), rng.random((3, 2)).astype(np.float32)
    ref = jfd.unpack_solution(*map(jnp.asarray, (packed, x0, i0)), 6)
    got = F.unpack_solution(*map(torch.tensor, (packed, x0, i0)), 6)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("name", ["euler", "midpoint", "rk4", "RK4_38"])
def test_normalize_solver_matches_jax(name):
    assert F.normalize_solver(name) == jfd.normalize_solver(name)


def test_kernel_input_checks():
    streams, weights, x0, i0, dt, ev = rollout_inputs()
    ts, tw = _tree(torch.tensor, streams, weights)
    aux = F.pack_aux(torch.tensor(dt), torch.tensor(ev))
    args = (ts, tw, torch.tensor(x0), torch.tensor(i0), aux)
    with pytest.raises(ValueError, match="CUDA tensors"):
        F._check_kernel_inputs(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        F.fused_dae_rollout_packed_cuda(*args)
    meta = lambda a: a.to("meta")
    ms, mw = _tree(meta, ts, tw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        F.fused_dae_rollout_packed(ms, mw, meta(args[2]), meta(args[3]), meta(aux))


def test_cuda_path_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main("dae_no_encode", ["--testing", "--fused", "--model", str(tmp_path / "m"),
                                    "--test_data", str(tmp_path / "d.npz")])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
