"""The port's teacher forcing (``--input_true_x`` / ``--input_true_i``)
against the JAX package, on the CPU, at a small size.

Small size (h=16, T=8, B=3, one event a row; the motor widths xd=3, zd=1,
vd=2, id=2 for the DAEs, xd=zd=2 for the ODEs): the same seeded numpy
inputs and weights (JAX's initial parameters with random biases, carried
over by ``bridge.load_params``) go through each of the eight teacher-forced
paths of ``py_psnode_tpu.ops.teacher_forcing`` (the fused ones in Pallas
interpret mode) and its counterpart in ``py_psnode_tpu_torch.ops.
teacher_forcing`` (on the CPU the plain versions of kernels 1-4 behind
their ``autograd.Function``): the forward at rtol 1e-5 / atol 1e-6, the
variant loss's gradients at rtol 2e-3 / atol 2e-4 (3e-3 / 3e-4 for the
direct-encode DAE). Also: the port's plain ``integrate_ode`` /
``integrate_dae`` under teacher forcing against the float64 numpy oracle
``tests/np_reference.py`` (each stepper, each switch, with and without
events); the plain TF-x backward of kernel 2 against ``torch.autograd`` of
the plain forward, the true states' cotangent included; the JAX package's
refusals; and the CLI flags into ``TrainConfig``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import np_reference as ref
from test_torch_dae_encode import dae_batch
from test_torch_dae_encode import jax_model as jax_dae_encode_model
from test_torch_dae_encode import port_model as port_dae_encode_model
from test_torch_ode_encode import flax_grads, ode_batch
from test_torch_ode_encode import jax_model as jax_ode_encode_model
from test_torch_ode_encode import port_model as port_ode_encode_model
from py_psnode_tpu.models import DAEModel as JaxDAEModel
from py_psnode_tpu.models import ODEModel as JaxODEModel
from py_psnode_tpu.ops import teacher_forcing as JTF
from py_psnode_tpu.train import losses as jlosses
from py_psnode_tpu_torch import bridge
from py_psnode_tpu_torch.cli import common as cli_common
from py_psnode_tpu_torch.models import DAEModel, ODEModel
from py_psnode_tpu_torch.ops import fused_dae as F
from py_psnode_tpu_torch.ops import fused_dae_vjp as V
from py_psnode_tpu_torch.ops import teacher_forcing as TTF
from py_psnode_tpu_torch.solvers import event_match, integrate_dae, integrate_ode, jumped_stream
from py_psnode_tpu_torch.train import TrainConfig, Trainer
from py_psnode_tpu_torch.train import losses as tlosses
from py_psnode_tpu_torch.utils.noencode_inputs import dae_inputs, true_states

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
ENC_GRAD_TOL = dict(rtol=3e-3, atol=3e-4)  # as the JAX package holds its encode DAE (test_teacher_forcing.py:275)
H = 16
DAE_KEYS = ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")
ODE_KEYS = ("t", "x", "z", "event_t", "z_jump")


def _bias_noise(params, seed):
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    leaves = [l + 0.1 * jax.random.normal(k, l.shape, l.dtype) if l.ndim == 1 else l for l, k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _port(model, params):
    return bridge.load_params(model, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params),
                              device="cpu")


def dae_models(batch, solver):
    dims = tuple(batch[k].shape[-1] for k in ("x", "z", "v", "i"))
    jm = JaxDAEModel(*dims, hidden_dim=H, solver=solver)
    params = _bias_noise(jm.init(jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in DAE_KEYS)), 0)
    return params, _port(DAEModel(*dims, H, solver=solver, device="meta"), params)


def ode_models(batch, solver):
    jm = JaxODEModel(x_dim=2, z_dim=2, hidden_dim=H, solver=solver)
    params = _bias_noise(jm.init(jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in ODE_KEYS)), 0)
    return params, _port(ODEModel(2, 2, H, solver=solver, device="meta"), params)


DIMS = (3, 1, 2, 2)
# name: (family, the JAX call (params, batch, solver), the port's entry,
# the port's plain model switches, the loss, the gradients' tolerance)
PATHS = {
    "tf_parallel_ode_apply": (
        "ode", lambda p, b, s: JTF.tf_parallel_ode_apply(p, b, 2, H, solver=s), TTF.tf_parallel_ode_apply,
        dict(input_true_x=True), "ode_no_encode_loss", GRAD_TOL),
    "tf_parallel_ode_encode_apply": (
        "ode_encode", lambda p, b, s: JTF.tf_parallel_ode_encode_apply(p, b, H, solver=s),
        TTF.tf_parallel_ode_encode_apply, dict(input_true_x=True), "ode_encode_loss", GRAD_TOL),
    "fused_dae_tf_x_apply": (
        "dae", lambda p, b, s: JTF.fused_dae_tf_x_apply(p, b, DIMS, H, solver=s, interpret=True),
        TTF.fused_dae_tf_x_apply, dict(input_true_x=True), "dae_no_encode_loss", GRAD_TOL),
    "fused_dae_tf_i_apply": (
        "dae", lambda p, b, s: JTF.fused_dae_tf_i_apply(p, b, DIMS, H, solver=s, interpret=True),
        TTF.fused_dae_tf_i_apply, dict(input_true_i=True), "dae_no_encode_loss", GRAD_TOL),
    "tf_parallel_dae_apply": (
        "dae", lambda p, b, s: JTF.tf_parallel_dae_apply(p, b, DIMS, H, solver=s), TTF.tf_parallel_dae_apply,
        dict(input_true_x=True, input_true_i=True), "dae_no_encode_loss", GRAD_TOL),
    "fused_dae_encode_tf_x_apply": (
        "dae_encode", lambda p, b, s: JTF.fused_dae_encode_tf_x_apply(p, b, DIMS, H, solver=s, interpret=True),
        TTF.fused_dae_encode_tf_x_apply, dict(input_true_x=True), "dae_encode_loss", ENC_GRAD_TOL),
    "fused_dae_encode_tf_i_apply": (
        "dae_encode", lambda p, b, s: JTF.fused_dae_encode_tf_i_apply(p, b, DIMS, H, solver=s, interpret=True),
        TTF.fused_dae_encode_tf_i_apply, dict(input_true_i=True), "dae_encode_loss", ENC_GRAD_TOL),
    "tf_parallel_dae_encode_apply": (
        "dae_encode", lambda p, b, s: JTF.tf_parallel_dae_encode_apply(p, b, DIMS, H, solver=s),
        TTF.tf_parallel_dae_encode_apply, dict(input_true_x=True, input_true_i=True), "dae_encode_loss",
        ENC_GRAD_TOL),
}


def _setup(family, solver):
    """(batch, JAX params, port model, the model's batch keys)."""
    if family in ("dae", "dae_encode"):
        batch = dae_batch(dims=DIMS, seed=3)
        batch["sample_w"] = np.array([1, 1, 0], np.float32)
        if family == "dae":
            return (batch, *dae_models(batch, solver), DAE_KEYS)
        _, params = jax_dae_encode_model(batch, solver)
        return batch, params, port_dae_encode_model(params, batch, solver), DAE_KEYS
    batch = ode_batch(seed=3)
    batch["sample_w"] = np.array([1, 1, 0], np.float32)
    if family == "ode":
        return (batch, *ode_models(batch, solver), ODE_KEYS)
    _, params = jax_ode_encode_model(batch, solver)
    return batch, params, port_ode_encode_model(params, batch, solver), ODE_KEYS


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


# every path with Euler and RK4, but the two TF-x kernel paths (the JAX
# VJP's interpret mode takes 10-15 s a call) with one solver each
CASES = [(name, solver) for name in PATHS for solver in ("euler", "rk4")
         if (name, solver) not in (("fused_dae_tf_x_apply", "rk4"), ("fused_dae_encode_tf_x_apply", "euler"))]


@pytest.mark.parametrize("name,solver", CASES)
def test_tf_path_matches_jax(name, solver):
    """The forward against the JAX function and against the port's own
    plain model with the same switches; the loss and its gradients
    against JAX's."""
    family, jax_fn, port_fn, switches, loss_name, grad_tol = PATHS[name]
    batch, params, model, keys = _setup(family, solver)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    jax_loss = getattr(jlosses, loss_name)

    def j_loss(p):  # one trace for the forward and the gradients
        out = jax_fn(p, jb, solver)
        return jax_loss(out, jb)[0], out

    (j_value, want), j_grads = jax.value_and_grad(j_loss, has_aux=True)(params)
    want = _outs(want)
    with torch.no_grad():
        got = _outs(port_fn(model, tb))
        plain = _outs(model(*(tb[k] for k in keys), **switches))
    assert len(got) == len(want)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=RTOL, atol=ATOL)

    out = port_fn(model, tb)
    loss, _ = getattr(tlosses, loss_name)(out, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_value), rtol=RTOL)
    want_g = {k: np.asarray(v) for k, v in bridge.flatten_params(j_grads["params"]).items()}
    got_g = flax_grads(model)
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k, **grad_tol)


# ---------------------------------------------------------------- oracle


def _events(t, B, rng, d):
    event_t = np.stack([[t[3 + b, b, 0], t[8, b, 0]] for b in range(B)])
    return event_t, rng.normal(size=(B, 2, d))


def _jumped(t, stream, event_t, jump):
    bm = lambda a: torch.tensor(a).transpose(0, 1)
    if event_t is None:
        return bm(stream).transpose(0, 1)[:-1], torch.zeros(t.shape[0] - 1, t.shape[1], dtype=torch.bool)
    is_event, e_idx = event_match(bm(t), torch.tensor(event_t))
    used = jumped_stream(bm(stream), torch.tensor(jump), is_event, e_idx)
    return used.transpose(0, 1)[:-1], is_event.transpose(0, 1)[:-1]


@pytest.mark.parametrize("events", [True, False])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_port_integrate_ode_tf_x_matches_numpy_oracle(solver, events):
    rng = np.random.default_rng(11)
    T, B, xd, zd = 12, 3, 2, 3
    Wx, Wz = rng.normal(size=(xd, xd)) * 0.4, rng.normal(size=(zd, xd)) * 0.4
    f_np = lambda t, x, z: np.tanh(x @ Wx + z @ Wz)
    f_t = lambda t, x, z: torch.tanh(x @ torch.tensor(Wx) + z @ torch.tensor(Wz))
    t = np.cumsum(np.full((T, B, 1), 0.02), axis=0) - 0.02
    x, z = rng.normal(size=(T, B, xd)), rng.normal(size=(T, B, zd))
    event_t, z_jump = _events(t, B, rng, zd) if events else (None, None)
    want = ref.integrate_ode(solver, f_np, t, x, z, event_t=event_t, z_jump=z_jump, input_true_x=True)
    z_used, _ = _jumped(t, z, event_t, z_jump)
    got = integrate_ode(solver, f_t, torch.tensor(t), torch.tensor(x[0]), z_used, torch.tensor(x),
                        input_true_x=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("switches", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("events", [True, False])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_port_integrate_dae_tf_matches_numpy_oracle(solver, events, switches):
    tf_x, tf_i = switches
    rng = np.random.default_rng(12)
    T, B, xd, zd, vd, idim = 12, 3, 3, 1, 2, 2
    Wf = [rng.normal(size=(d, xd)) * 0.4 for d in (xd, zd, vd, idim)]
    Wg = [rng.normal(size=(d, idim)) * 0.4 for d in (xd, zd, vd)]
    f_np = lambda t, x, z, v, i: np.tanh(x @ Wf[0] + z @ Wf[1] + v @ Wf[2] + i @ Wf[3])
    g_np = lambda x, z, v: np.tanh(x @ Wg[0] + z @ Wg[1] + v @ Wg[2])
    Tf, Tg = [torch.tensor(w) for w in Wf], [torch.tensor(w) for w in Wg]
    f_t = lambda t, x, z, v, i: torch.tanh(x @ Tf[0] + z @ Tf[1] + v @ Tf[2] + i @ Tf[3])
    g_t = lambda x, z, v: torch.tanh(x @ Tg[0] + z @ Tg[1] + v @ Tg[2])
    t = np.cumsum(np.full((T, B, 1), 0.02), axis=0) - 0.02
    x, z, v, i = (rng.normal(size=(T, B, d)) for d in (xd, zd, vd, idim))
    x_init = rng.normal(size=(B, xd))
    event_t = z_jump = v_jump = None
    if events:
        event_t, z_jump = _events(t, B, rng, zd)
        v_jump = rng.normal(size=(B, 2, vd))
    want = ref.integrate_dae(solver, f_np, g_np, x_init, t, x, z, v, i, event_t=event_t, z_jump=z_jump,
                             v_jump=v_jump, input_true_x=tf_x, input_true_i=tf_i)
    z_used, is_event = _jumped(t, z, event_t, z_jump)
    v_used, _ = _jumped(t, v, event_t, v_jump)
    T_ = torch.tensor
    got = integrate_dae(solver, f_t, g_t, T_(x_init), T_(t), T_(z), T_(v), z_used, v_used, is_event, T_(x), T_(i),
                        input_true_x=tf_x, input_true_i=tf_i)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-12)


# ------------------------------------------------------- plain backward


@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_plain_tf_x_backward_matches_autograd(solver):
    """Kernel 2's plain TF-x walk (every gradient, and the true states'
    cotangents g_xt / g_xt1 combined as the autograd Function combines
    them) against torch.autograd of kernel 1's plain TF-x loop (float32,
    each tensor within 1e-5 of its own scale), events included; without
    g_true the walk's other outputs are the same."""
    streams, weights, x0, i0, aux = dae_inputs(3, 6, 12, seed=4)
    streams = {k: v.requires_grad_() for k, v in streams.items()}
    wflat = [w.requires_grad_() for w in V.flatten_weights(weights)[0]]
    weights = V.unflatten_weights(wflat, (3, 3))
    x0, i0 = x0.requires_grad_(), i0.requires_grad_()
    x_true = true_states(6, 3, 3, seed=4).requires_grad_()
    packed = F.fused_dae_rollout_packed_plain(streams, weights, x0, i0, aux, solver, x_true)
    cot = torch.tensor(np.random.default_rng(5).standard_normal((7, 3, 5)).astype(np.float32))
    x_sol, i_sol = F.unpack_solution(packed, x0, i0, 6)
    (torch.cat([x_sol, i_sol], dim=-1) * cot).sum().backward()
    detached = lambda tree: {k: v.detach() for k, v in tree.items()}
    w_det = V.unflatten_weights([w.detach() for w in wflat], (3, 3))
    args = (detached(streams), w_det, x0.detach(), i0.detach(), aux, packed.detach(), cot, solver, x_true.detach())
    g_s, g_w, g_x0, g_i0, (g_xt, g_xt1) = V.fused_dae_rollout_bwd_plain(*args, g_true=True)

    def close(a, b):
        assert a.shape == b.shape and b.abs().max() > 0
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()

    for k in streams:
        close(g_s[k], streams[k].grad)
    for a, w in zip(V.flatten_weights(g_w)[0], wflat):
        close(a, w.grad)
    close(g_x0 + cot[0, :, :3], x0.grad)
    close(g_i0 + cot[0, :, 3:], i0.grad)
    g_x_true = torch.zeros_like(x_true)
    g_x_true[:-1] += g_xt
    g_x_true[1:] += g_xt1
    close(g_x_true, x_true.grad)
    without = V.fused_dae_rollout_bwd_plain(*args)
    assert len(without) == 4
    for a, b in zip([*without[0].values(), without[2], without[3]], [*g_s.values(), g_x0, g_i0]):
        assert torch.equal(a, b)


def test_tf_x_rollout_function_gives_x_true_its_gradient_only_when_asked():
    """``FusedDaeTfxRollout`` on the CPU: ``x_true`` that requires grad
    gets the walk's combined cotangent (the encode DAE's case), raw data
    gets none and the weights the same gradients either way."""
    streams, weights, x0, i0, aux = dae_inputs(2, 5, 8, seed=6)
    dt, ev = aux[..., 0:1], aux[..., 1] > 0
    grads = {}
    for wants in (True, False):
        wflat = [w.clone().requires_grad_() for w in V.flatten_weights(weights)[0]]
        x_true = true_states(5, 2, 3, seed=6).requires_grad_(wants)
        xs, is_ = V.fused_dae_tf_x_rollout_diff(streams, V.unflatten_weights(wflat, (3, 3)), x0, i0, x_true, dt,
                                                ev, "rk4")
        (xs.square().sum() + is_.square().sum()).backward()
        grads[wants] = [w.grad for w in wflat]
        assert (x_true.grad is not None) == wants
        if wants:
            ref_x = x_true.detach().clone().requires_grad_()
            packed = F.fused_dae_rollout_packed_plain(streams, weights, x0, i0, aux, "rk4", ref_x)
            xs2, is2 = F.unpack_solution(packed, x0, i0, 5)
            (xs2.square().sum() + is2.square().sum()).backward()
            np.testing.assert_allclose(x_true.grad.numpy(), ref_x.grad.numpy(), rtol=1e-4, atol=1e-5)
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


# ------------------------------------------------------------ refusals


def test_tf_validation_errors():
    """The JAX package's ValueErrors and messages; what is still not ported
    keeps raising."""
    with pytest.raises(ValueError, match="DAE variants only"):
        Trainer(TrainConfig(variant="ode_no_encode", input_true_i=True, device="cpu"))
    with pytest.raises(ValueError, match="DAE variants only"):
        Trainer(TrainConfig(variant="ode_encode", input_true_i=True, input_true_x=True, device="cpu"))
    for variant in ("dae_channelwise", "ode_channelwise"):
        with pytest.raises(ValueError, match="channel-wise family defines no teacher forcing"):
            Trainer(TrainConfig(variant=variant, input_true_x=True, device="cpu"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(TrainConfig(variant="dae_no_encode", input_true_x=True, n_windows=4, device="cpu"))
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(TrainConfig(variant="dae_encode", n_windows=4, auto_resume=True, device="cpu"))
    Trainer(TrainConfig(variant="dae_encode", n_windows=4, device="cpu"))  # multishoot is served
    for variant, kw in (("dae_no_encode", dict(input_true_x=True)), ("dae_encode", dict(input_true_i=True)),
                        ("ode_encode", dict(input_true_x=True))):
        Trainer(TrainConfig(variant=variant, device="cpu", **kw))  # accepted


def test_cli_tf_flags_reach_the_train_config(monkeypatch):
    seen = []

    class Capture:
        def __init__(self, cfg):
            seen.append(cfg)

        def test(self):
            return None

    monkeypatch.setattr(cli_common, "Trainer", Capture)
    for flags, want in (([], (False, False)), (["--input_true_x"], (True, False)),
                        (["--input_true_i"], (False, True)), (["--input_true_x", "--input_true_i"], (True, True))):
        cli_common.main("dae_no_encode", ["--testing", "--device", "cpu", "--model", "m", "--test_data", "d"] + flags)
        assert (seen[-1].input_true_x, seen[-1].input_true_i) == want
    args = cli_common.build_parser().parse_args(["--input_true_x", "--input_true_i"])
    assert args.input_true_x and args.input_true_i
    with pytest.raises(NotImplementedError, match="not ported"):
        cli_common.main("dae_no_encode", ["--testing", "--device", "cpu", "--input_true_x", "--remat", "sqrt"])
