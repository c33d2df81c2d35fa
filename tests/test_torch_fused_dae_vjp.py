"""The port's fused DAE backward against autograd and the JAX package, on
the CPU.

* The plain reverse walk (the CPU path of ``fused_dae_rollout_bwd``)
  against ``torch.autograd.grad`` through the plain forward rollout:
  rtol 1e-4 / atol 1e-5 (float32, another summation order).
* The same walk against ``jax.vjp`` of the JAX ``fused_dae_rollout_diff``
  with its Pallas kernels in interpret mode, for every output, at the JAX
  package's fused-against-XLA bar of rtol 2e-3 / atol 2e-4
  (``tests/test_fused_dae_vjp.py``).
* Grads of the port's ``fused_dae_apply`` + ``dae_no_encode_loss``
  against the JAX ``fused_dae_apply`` grads carried across by
  ``bridge.py``, and against the port's non-fused ``DAEModel`` autograd,
  at the same bar.

Inputs are seeded numpy float32 arrays handed to both packages. The CUDA
kernel itself runs only on a card: ``tests/test_torch_kernel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py_psnode_tpu.ops.fused_dae_vjp import fused_dae_rollout_diff as jax_rollout_diff
from py_psnode_tpu.ops.fused_model import fused_dae_apply as jax_fused_dae_apply
from py_psnode_tpu.train.losses import dae_no_encode_loss as jax_dae_loss

from py_psnode_tpu_torch import bridge
from py_psnode_tpu_torch.models.dae import DAEModel
from py_psnode_tpu_torch.ops import fused_dae as F
from py_psnode_tpu_torch.ops import fused_dae_vjp as V
from py_psnode_tpu_torch.ops.fused_model import fused_dae_apply
from py_psnode_tpu_torch.train.losses import dae_no_encode_loss

SOLVERS = ["euler", "midpoint", "rk4"]
AUTOGRAD_TOL = dict(rtol=1e-4, atol=1e-5)
JAX_TOL = dict(rtol=2e-3, atol=2e-4)
BATCH_KEYS = ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")
OUT_NAMES = ["g_s_de", "g_s_ae", "g_s_ae_ev", "g_x0", "g_i0", "wx_de", "wi_de", "gx_ae"]


def vjp_inputs(B=3, Tm1=12, h=16, xd=3, idim=2, seed=0, events=True):
    """Seeded numpy rollout inputs (flax layout), per-row step sizes, events
    at the first and last steps and in between, and random cotangents of
    the full solutions."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    streams = {k: f(Tm1, B, h, sc=0.5) for k in ("s_de", "s_ae", "s_ae_ev")}
    tail = lambda out: [(f(h, o, sc=h ** -0.5), f(o, sc=0.1)) for o in (h, h, out)]
    weights = dict(wx_de=f(xd, h, sc=0.5), wi_de=f(idim, h, sc=0.5), gx_ae=f(xd, h, sc=0.5),
                   de_tail=tail(xd), ae_tail=tail(idim))
    x0, i0 = f(B, xd), f(B, idim)
    dt = np.full((Tm1, B, 1), 0.05, np.float32)
    dt[:, 1] = 0.02
    ev = np.zeros((Tm1, B), bool)
    if events:
        ev[0, 0] = ev[3, 1] = ev[3, 2] = ev[Tm1 // 2 + 1, :] = ev[Tm1 - 1, 2] = True
    g_x, g_i = f(Tm1 + 1, B, xd), f(Tm1 + 1, B, idim)
    return streams, weights, x0, i0, dt, ev, g_x, g_i


def _tree(fn, streams, weights):
    w = {k: (fn(v) if not isinstance(v, list) else [(fn(W), fn(b)) for W, b in v])
         for k, v in weights.items()}
    return {k: fn(v) for k, v in streams.items()}, w


def _flat_grads(g_streams, g_weights, g_x0, g_i0):
    """Gradients as one list in OUT_NAMES order, then the tail (W, b) pairs."""
    out = [g_streams["s_de"], g_streams["s_ae"], g_streams["s_ae_ev"], g_x0, g_i0]
    return [np.asarray(a) for a in out + V.flatten_weights(g_weights)[0]]


def _names(n):
    return OUT_NAMES + [f"tail[{k}]" for k in range(n - len(OUT_NAMES))]


def _port_plain_bwd(streams, weights, x0, i0, dt, ev, g_x, g_i, solver):
    ts, tw = _tree(torch.tensor, streams, weights)
    x0t, i0t = torch.tensor(x0), torch.tensor(i0)
    aux = F.pack_aux(torch.tensor(dt), torch.tensor(ev))
    packed = F.fused_dae_rollout_packed_plain(ts, tw, x0t, i0t, aux, solver)
    cot = torch.cat([torch.tensor(g_x), torch.tensor(g_i)], dim=-1)
    before = V.fused_dae_rollout_bwd.launches
    g_s, g_w, g_x0, g_i0 = V.fused_dae_rollout_bwd(ts, tw, x0t, i0t, aux, packed, cot, solver)
    assert V.fused_dae_rollout_bwd.launches == before  # the CPU path launches nothing
    # the initial rows of the solutions are x0/i0 themselves
    return _flat_grads(g_s, g_w, g_x0 + cot[0, :, :3], g_i0 + cot[0, :, 3:])


@pytest.mark.parametrize("events", [False, True])
@pytest.mark.parametrize("solver", SOLVERS)
def test_plain_bwd_matches_autograd(solver, events):
    streams, weights, x0, i0, dt, ev, g_x, g_i = vjp_inputs(events=events)
    got = _port_plain_bwd(streams, weights, x0, i0, dt, ev, g_x, g_i, solver)
    ts, tw = _tree(lambda a: torch.tensor(a, requires_grad=True), streams, weights)
    x0t, i0t = torch.tensor(x0, requires_grad=True), torch.tensor(i0, requires_grad=True)
    aux = F.pack_aux(torch.tensor(dt), torch.tensor(ev))
    packed = F.fused_dae_rollout_packed_plain(ts, tw, x0t, i0t, aux, solver)
    xs, is_ = F.unpack_solution(packed, x0t, i0t, dt.shape[0])
    leaves = [ts["s_de"], ts["s_ae"], ts["s_ae_ev"], x0t, i0t] + V.flatten_weights(tw)[0]
    out = (xs * torch.tensor(g_x)).sum() + (is_ * torch.tensor(g_i)).sum()
    ref = torch.autograd.grad(out, leaves, allow_unused=True)
    ref = [np.zeros_like(a.detach().numpy()) if r is None else r.numpy() for r, a in zip(ref, leaves)]
    for name, a, b in zip(_names(len(ref)), got, ref):
        np.testing.assert_allclose(a, b, err_msg=name, **AUTOGRAD_TOL)
    if not events:
        np.testing.assert_array_equal(got[2], 0.0)  # no event: no g_s_ae_ev


@pytest.mark.parametrize(
    "solver,events,shape",
    [(s, e, (3, 8, 8)) for s in SOLVERS for e in (False, True)]
    + [("rk4", True, (3, 41, 16)), ("midpoint", False, (3, 41, 16))],
)
def test_plain_bwd_matches_jax_vjp(solver, events, shape):
    B, T, h = shape
    streams, weights, x0, i0, dt, ev, g_x, g_i = vjp_inputs(B=B, Tm1=T - 1, h=h, events=events)
    got = _port_plain_bwd(streams, weights, x0, i0, dt, ev, g_x, g_i, solver)
    js, jw = _tree(jnp.asarray, streams, weights)
    (x_ref, i_ref), vjp = jax.vjp(
        lambda s, w, a, b: jax_rollout_diff(s, w, a, b, jnp.asarray(dt), jnp.asarray(ev),
                                            solver, True),
        js, jw, jnp.asarray(x0), jnp.asarray(i0),
    )
    g_s, g_w, g_x0, g_i0 = vjp((jnp.asarray(g_x), jnp.asarray(g_i)))
    ref = _flat_grads(g_s, g_w, g_x0, g_i0)
    assert len(got) == len(ref) == 5 + 3 + 12
    for name, a, b in zip(_names(len(ref)), got, ref):
        np.testing.assert_allclose(a, b, err_msg=name, **JAX_TOL)


def _model_and_batch(solver, h=16, T=33, B=4, seed=0):
    """A JAX DAEModel's initial parameters carried into the port by the
    bridge, and a seeded batch with per-row events (row 0 without)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = np.tile((np.arange(T, dtype=np.float32) * np.float32(0.02))[None, :, None], (B, 1, 1))
    b = dict(t=t, x=f(B, T, 3), z=f(B, T, 1), v=f(B, T, 2), i=f(B, T, 2),
             event_t=np.stack([t[:, 5, 0], t[:, T - 4, 0]], 1), z_jump=f(B, 2, 1),
             v_jump=f(B, 2, 2))
    b["event_t"][0] = -1.0
    mask = np.ones((B, T, 1), np.float32)
    mask[2, T - 6 :] = 0.0  # a truncated row
    b["mask"] = mask
    b["sample_w"] = np.array([1, 1, 1, 0], np.float32)  # a padded row
    from py_psnode_tpu.models.dae import DAEModel as JaxDAEModel

    jm = JaxDAEModel(3, 1, 2, 2, hidden_dim=h, solver=solver)
    params = jm.init(jax.random.PRNGKey(seed), *[jnp.asarray(b[k]) for k in BATCH_KEYS])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    model = bridge.load_params(DAEModel(3, 1, 2, 2, h, solver=solver), params)
    return model, params, b


@pytest.mark.parametrize("solver", SOLVERS)
def test_fused_dae_apply_grads_match_jax_and_plain_model(solver):
    model, params, b = _model_and_batch(solver)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    loss_fn = lambda p: jax_dae_loss(
        jax_fused_dae_apply(p, jb, (3, 1, 2, 2), 16, solver=solver, interpret=True), jb
    )[0]
    ref_loss, ref_g = jax.value_and_grad(loss_fn)(params)
    ref = bridge.state_dict_from_params(jax.tree_util.tree_map(np.asarray, ref_g))

    tb = {k: torch.tensor(v) for k, v in b.items()}
    loss, _ = dae_no_encode_loss(fused_dae_apply(model, tb), tb)
    loss.backward()
    fused = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    loss_plain, _ = dae_no_encode_loss(model(*[tb[k] for k in BATCH_KEYS]), tb)
    loss_plain.backward()
    plain = {n: p.grad for n, p in model.named_parameters()}

    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    np.testing.assert_allclose(loss_plain.item(), float(ref_loss), rtol=1e-4)
    assert set(fused) == set(ref) == set(plain) and len(ref) == 22
    for name in ref:
        np.testing.assert_allclose(fused[name].numpy(), ref[name].numpy(), err_msg=name, **JAX_TOL)
        np.testing.assert_allclose(plain[name].numpy(), ref[name].numpy(), err_msg=name, **JAX_TOL)


def test_fused_rollout_function_is_differentiable_on_cpu():
    """``fused_dae_rollout_diff`` routes the backward through the plain walk
    on the CPU (no kernel launch), and gives no gradient to dt/ev."""
    streams, weights, x0, i0, dt, ev, g_x, g_i = vjp_inputs(Tm1=6, h=8)
    ts, tw = _tree(lambda a: torch.tensor(a, requires_grad=True), streams, weights)
    dtt = torch.tensor(dt, requires_grad=True)
    before = (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches)
    xs, is_ = V.fused_dae_rollout_diff(ts, tw, torch.tensor(x0), torch.tensor(i0), dtt,
                                       torch.tensor(ev), "rk4")
    ((xs * torch.tensor(g_x)).sum() + (is_ * torch.tensor(g_i)).sum()).backward()
    assert (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches) == before
    assert dtt.grad is None
    assert all(torch.isfinite(W.grad).all() for W, _ in tw["de_tail"] + tw["ae_tail"])


def test_bwd_kernel_input_checks():
    streams, weights, x0, i0, dt, ev, g_x, g_i = vjp_inputs(Tm1=4, h=8)
    ts, tw = _tree(torch.tensor, streams, weights)
    aux = F.pack_aux(torch.tensor(dt), torch.tensor(ev))
    x0t, i0t = torch.tensor(x0), torch.tensor(i0)
    packed = F.fused_dae_rollout_packed_plain(ts, tw, x0t, i0t, aux, "euler")
    cot = torch.cat([torch.tensor(g_x), torch.tensor(g_i)], dim=-1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        V.fused_dae_rollout_bwd_cuda(ts, tw, x0t, i0t, aux, packed, cot)
    meta = lambda a: a.to("meta")
    ms, mw = _tree(meta, ts, tw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        V.fused_dae_rollout_bwd(ms, mw, meta(x0t), meta(i0t), meta(aux), meta(packed), meta(cot))


def test_grad_layout_matches_flatten_order():
    _, weights, *_ = vjp_inputs(h=8)
    layout, total = V.grad_layout(weights)
    flat, n_tails = V.flatten_weights(weights)
    assert n_tails == (3, 3) and len(layout) == len(flat) == 15
    off = 0
    for (o, shape), a in zip(layout, flat):
        assert o == off and shape == a.shape
        off += a.size
    assert total == off == 3 * 8 + 2 * 8 + 3 * 8 + 2 * (2 * (8 * 8 + 8)) + (8 * 3 + 3) + (8 * 2 + 2)
    # wx_de, wi_de, gx_ae, then (W, b) per tail layer, DE before AE
    assert [s for _, s in layout[:5]] == [(3, 8), (2, 8), (3, 8), (8, 8), (8,)]
    back = V.unflatten_weights(flat, n_tails)
    assert back["ae_tail"][2][0].shape == (8, 2)
