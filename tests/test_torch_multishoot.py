"""The port's multiple shooting (``--n_windows`` / ``--gap_weight``) against
the JAX package, on the CPU, at a small size.

Small size (B=3, T=13 and K=4 windows of L=3 steps; h=16, the channel-wise
family h=8; the motor widths xd=3, zd=1, vd=2, id=2 for the DAEs, xd=zd=2
for the ODEs): one event a row at step 2, 3 or 4, so that row 1's event
falls on window 1's first step. The same seeded numpy inputs and weights
(JAX's initial parameters with random biases, carried over by
``bridge.load_params``) go through:

* the window fold, unfold and tile against the JAX package's, bit for bit;
* the port's plain ``multishoot_ode`` / ``multishoot_dae`` against the JAX
  ones (solution and gaps, rtol 1e-5 / atol 1e-6);
* each of the ten multishoot forwards of ``py_psnode_tpu_torch.train.
  multishoot_forward`` against its JAX function (the fused ones in Pallas
  interpret mode; on the CPU the port's fused ones run the plain versions of
  kernels 1-4 behind their ``autograd.Function``): the outputs and gaps at
  rtol 1e-5 / atol 1e-6, the trainer's loss (the variant loss plus 0.3 *
  mean(gaps**2)) and its gradients at rtol 2e-3 / atol 2e-4;
* K=1 against the model's own forward, with no gaps, for every family;
* the trainer's loss term (``gap_loss`` in ``aux``, zero at K=1), its
  dispatch, the JAX package's refusals and the CLI flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cw_modules import cw_batch, jax_cw_params, port_cw_model
from test_torch_dae_encode import dae_batch
from test_torch_dae_encode import jax_model as jax_dae_encode_model
from test_torch_dae_encode import port_model as port_dae_encode_model
from test_torch_ode_encode import flax_grads, ode_batch
from test_torch_ode_encode import jax_model as jax_ode_encode_model
from test_torch_ode_encode import port_model as port_ode_encode_model
from test_torch_teacher_forcing import _bias_noise, _outs, _port
from py_psnode_tpu.models import DAEModel as JaxDAEModel
from py_psnode_tpu.models import ODEModel as JaxODEModel
from py_psnode_tpu.solvers import multishoot as JMSS
from py_psnode_tpu.train import losses as jlosses
from py_psnode_tpu.train import multishoot_forward as JMS
from py_psnode_tpu_torch import bridge
from py_psnode_tpu_torch.cli import common as cli_common
from py_psnode_tpu_torch.models import DAEModel, ODEModel
from py_psnode_tpu_torch.ops.fused_model import (
    fused_dae_apply,
    fused_dae_encode_apply,
    fused_ode_apply,
    fused_ode_encode_apply,
)
from py_psnode_tpu_torch.solvers import multishoot as TMSS
from py_psnode_tpu_torch.train import TrainConfig, Trainer
from py_psnode_tpu_torch.train import losses as tlosses
from py_psnode_tpu_torch.train import multishoot_forward as TMS
from py_psnode_tpu_torch.train import trainer as trainer_mod
from py_psnode_tpu_torch.train.optim import make_optimizer

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
H, CW_H = 16, 8
T, K = 13, 4
GAP_WEIGHT = 0.3
DIMS = (3, 1, 2, 2)
DAE_KEYS = ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")
ODE_KEYS = ("t", "x", "z", "event_t", "z_jump")


def setup(family, solver):
    """``(batch, JAX params, port model, the model's batch keys, variant)``
    on the seeded small batch of ``family``; the JAX model initializes on
    the batch's first two steps (the parameters do not depend on T, and
    JAX compiles a shorter rollout faster)."""
    if family in ("dae", "dae_encode"):
        batch = dae_batch(T=T, dims=DIMS, seed=3)
    elif family in ("ode", "ode_encode"):
        batch = ode_batch(T=T, seed=3)
    else:
        dae = family == "cw_dae"
        batch = cw_batch(T=T, **(dict(xd=3, zd=1, vd=2, idim=2) if dae else dict(xd=2, zd=2)), seed=3)
        batch["mask"] = (np.random.default_rng(4).random((3, T, 1 if dae else 2)) > 0.2).astype(np.float32)
    batch["sample_w"] = np.array([1, 1, 0], np.float32)
    short = {k: v[:, :2] if v.ndim == 3 and v.shape[1] == T else v for k, v in batch.items()}
    if family == "dae":
        jm = JaxDAEModel(*DIMS, hidden_dim=H, solver=solver)
        params = _bias_noise(jm.init(jax.random.PRNGKey(0), *(jnp.asarray(short[k]) for k in DAE_KEYS)), 0)
        return batch, params, _port(DAEModel(*DIMS, H, solver=solver, device="meta"), params), DAE_KEYS, "dae_no_encode"
    if family == "ode":
        jm = JaxODEModel(x_dim=2, z_dim=2, hidden_dim=H, solver=solver)
        params = _bias_noise(jm.init(jax.random.PRNGKey(0), *(jnp.asarray(short[k]) for k in ODE_KEYS)), 0)
        return batch, params, _port(ODEModel(2, 2, H, solver=solver, device="meta"), params), ODE_KEYS, "ode_no_encode"
    if family == "dae_encode":
        _, params = jax_dae_encode_model(short, solver)
        return batch, params, port_dae_encode_model(params, batch, solver), DAE_KEYS, "dae_encode"
    if family == "ode_encode":
        _, params = jax_ode_encode_model(short, solver)
        return batch, params, port_ode_encode_model(params, batch, solver), ODE_KEYS, "ode_encode"
    kind = family[3:]
    _, params, _ = jax_cw_params(kind, short, CW_H, solver)
    params = _bias_noise(params, 0)
    model = port_cw_model(kind, batch, CW_H, solver, jax.tree_util.tree_map(np.asarray, params))
    return batch, params, model, (DAE_KEYS if kind == "dae" else ODE_KEYS), f"{kind}_channelwise"


# name: (family, the JAX call (params, batch, K, solver))
APPLIES = {
    "multishoot_ode_apply": ("ode", lambda p, b, k, s: JMS.multishoot_ode_apply(p, b, 2, H, k, s, remat=False)),
    "fused_multishoot_ode_apply": (
        "ode", lambda p, b, k, s: JMS.fused_multishoot_ode_apply(p, b, 2, H, k, s, interpret=True)),
    "multishoot_dae_apply": ("dae", lambda p, b, k, s: JMS.multishoot_dae_apply(p, b, DIMS, H, k, s, remat=False)),
    "fused_multishoot_dae_apply": (
        "dae", lambda p, b, k, s: JMS.fused_multishoot_dae_apply(p, b, DIMS, H, k, s, interpret=True)),
    "multishoot_ode_encode_apply": (
        "ode_encode", lambda p, b, k, s: JMS.multishoot_ode_encode_apply(p, b, H, k, s, remat=False)),
    "fused_multishoot_ode_encode_apply": (
        "ode_encode", lambda p, b, k, s: JMS.fused_multishoot_ode_encode_apply(p, b, H, k, s, interpret=True)),
    "multishoot_dae_encode_apply": (
        "dae_encode", lambda p, b, k, s: JMS.multishoot_dae_encode_apply(p, b, DIMS, H, k, s, remat=False)),
    "fused_multishoot_dae_encode_apply": (
        "dae_encode", lambda p, b, k, s: JMS.fused_multishoot_dae_encode_apply(p, b, DIMS, H, k, s, interpret=True)),
    "multishoot_cw_ode_apply": (
        "cw_ode", lambda p, b, k, s: JMS.multishoot_cw_ode_apply(p, b, 2, 2, CW_H, k, s, remat=False)),
    "multishoot_cw_dae_apply": (
        "cw_dae", lambda p, b, k, s: JMS.multishoot_cw_dae_apply(p, b, DIMS, CW_H, k, s, remat=False)),
}


# one solver an entry (the fold is the solver's business nowhere), Euler
# and RK4 within each family's pair; the JAX compile of each case's
# gradient takes seconds
CASES = [("multishoot_ode_apply", "euler"), ("fused_multishoot_ode_apply", "rk4"),
         ("multishoot_dae_apply", "euler"), ("fused_multishoot_dae_apply", "rk4"),
         ("multishoot_ode_encode_apply", "rk4"), ("fused_multishoot_ode_encode_apply", "euler"),
         ("multishoot_dae_encode_apply", "rk4"), ("fused_multishoot_dae_encode_apply", "euler"),
         ("multishoot_cw_ode_apply", "rk4"), ("multishoot_cw_dae_apply", "euler")]


@pytest.mark.parametrize("name,solver", CASES)
def test_multishoot_apply_matches_jax(name, solver):
    """The outputs and gaps against the JAX function (and a fused entry's
    against the port's plain one), the trainer's loss and its gradients
    against JAX's."""
    family, jax_fn = APPLIES[name]
    batch, params, model, _, variant = setup(family, solver)
    port_fn = getattr(TMS, name)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    jax_loss = getattr(jlosses, f"{variant}_loss")

    def j_loss(p):
        out, gaps = jax_fn(p, jb, K, solver)
        return jax_loss(out, jb)[0] + GAP_WEIGHT * jnp.mean(gaps**2), (out, gaps)

    # one compiled program: JAX's op-by-op dispatch compiles each primitive
    (j_value, (want, want_gaps)), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    with torch.no_grad():
        got, gaps = port_fn(model, tb, K)
        plain = getattr(TMS, name.replace("fused_", ""))(model, tb, K)
    assert tuple(gaps.shape) == (K - 1, 3, np.asarray(want_gaps).shape[-1])
    for g, w, p in zip(_outs(got) + [gaps], _outs(want) + [want_gaps], _outs(plain[0]) + [plain[1]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=RTOL, atol=ATOL)

    out, gaps = port_fn(model, tb, K)
    loss = getattr(tlosses, f"{variant}_loss")(out, tb)[0] + GAP_WEIGHT * torch.mean(gaps**2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_value), rtol=RTOL)
    want_g = {k: np.asarray(v) for k, v in bridge.flatten_params(j_grads["params"]).items()}
    got_g = flax_grads(model)
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k, **GRAD_TOL)


# family: (the port's forward of the model, the fused forward or None)
K1_FORWARDS = {"ode": fused_ode_apply, "dae": fused_dae_apply, "ode_encode": fused_ode_encode_apply,
               "dae_encode": fused_dae_encode_apply, "cw_ode": None, "cw_dae": None}
K1_APPLIES = {"ode": "multishoot_ode_apply", "dae": "multishoot_dae_apply",
              "ode_encode": "multishoot_ode_encode_apply", "dae_encode": "multishoot_dae_encode_apply",
              "cw_ode": "multishoot_cw_ode_apply", "cw_dae": "multishoot_cw_dae_apply"}


@pytest.mark.parametrize("family", list(K1_APPLIES))
def test_one_window_is_the_model_forward(family):
    """K=1: the plain multishoot forward equals the model's forward, the
    fused one the fused forward, and there are no gaps."""
    batch, _, model, keys, _ = setup(family, "rk4")
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    name = K1_APPLIES[family]
    with torch.no_grad():
        pairs = [(getattr(TMS, name), lambda b: model(*(b[k] for k in keys)))]
        if K1_FORWARDS[family] is not None:
            pairs.append((getattr(TMS, "fused_" + name), lambda b: K1_FORWARDS[family](model, b)))
        for ms, forward in pairs:
            out, gaps = ms(model, tb, 1)
            assert gaps.shape[0] == 0
            for g, w in zip(_outs(out), _outs(forward(tb))):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------- the solvers


def test_fold_unfold_and_tile_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((T, 3, 2)).astype(np.float32)
    for overlap, length in ((1, T), (0, T - 1)):
        got = TMSS._window_fold(torch.tensor(a[:length]), K, 3, overlap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(JMSS._window_fold(jnp.asarray(a[:length]), K, 3,
                                                                                 overlap)))
    sol = rng.standard_normal((4, K * 3, 2)).astype(np.float32)
    np.testing.assert_array_equal(TMSS._window_unfold(torch.tensor(sol), K, 3, 3).numpy(),
                                  np.asarray(JMSS._window_unfold(jnp.asarray(sol), K, 3, 3)))
    init = rng.standard_normal((3, 5)).astype(np.float32)
    np.testing.assert_array_equal(TMSS.tile_batch(torch.tensor(init), K).numpy(),
                                  np.asarray(JMSS.tile_batch(jnp.asarray(init), K)))
    np.testing.assert_array_equal(TMSS.window_starts(torch.tensor(a), K, 3).numpy(),
                                  np.asarray(JMSS._window_fold(jnp.asarray(a), K, 3, 1)[0]))
    ev = rng.random((T - 1, 3)) > 0.5
    np.testing.assert_array_equal(TMSS._window_fold(torch.tensor(ev), K, 3, 0).numpy(),
                                  np.asarray(JMSS._window_fold(jnp.asarray(ev)[:, :, None], K, 3, 0))[:, :, 0])


def _tanh_problem(rng):
    """Seeded small nets as closures in both packages, float32 streams."""
    Wf = [rng.normal(size=(d, 3)).astype(np.float32) * 0.4 for d in (3, 1, 2, 2)]
    Wg = [rng.normal(size=(d, 2)).astype(np.float32) * 0.4 for d in (3, 1, 2)]
    f = lambda m: lambda t, x, z, v, i: m.tanh(x @ Wf[0] + z @ Wf[1] + v @ Wf[2] + i @ Wf[3])
    g = lambda m: lambda x, z, v: m.tanh(x @ Wg[0] + z @ Wg[1] + v @ Wg[2])
    t = (np.cumsum(np.full((T, 3, 1), 0.02), axis=0) - 0.02).astype(np.float32)
    x, z, v, i = (rng.normal(size=(T, 3, d)).astype(np.float32) for d in (3, 1, 2, 2))
    return f, g, t, x, z, v, i


@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_multishoot_solvers_match_jax(solver):
    """``multishoot_ode`` and ``multishoot_dae`` (events at a window's first
    step among them) against the JAX ones, solution and gaps."""
    rng = np.random.default_rng(7)
    f, g, t, x, z, v, i = _tanh_problem(rng)
    T_ = torch.tensor
    ode = lambda m: lambda tt, xx, zz: f(m)(tt, xx, zz[..., :1], zz[..., 1:], xx[..., :2])
    zs = np.concatenate([z, v], -1)[:-1]
    want = JMSS.multishoot_ode(solver, ode(jnp), jnp.asarray(t), jnp.asarray(x), jnp.asarray(zs), K, remat=False)
    got = TMSS.multishoot_ode(solver, ode(torch), T_(t), T_(x), T_(zs), K)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)

    ev = np.zeros((T - 1, 3), bool)
    ev[3, 1] = ev[4, 2] = ev[6, 0] = True  # steps 3 and 6 start windows 1 and 2
    z_step, v_step = z[:-1] + ev[..., None], v[:-1] - ev[..., None]
    x0w = rng.normal(size=(K * 3, 3)).astype(np.float32)
    want = JMSS.multishoot_dae(solver, f(jnp), g(jnp), jnp.asarray(x0w), jnp.asarray(t), jnp.asarray(z),
                               jnp.asarray(v), jnp.asarray(i), jnp.asarray(z_step), jnp.asarray(v_step), K,
                               is_event=jnp.asarray(ev), remat=False)
    got = TMSS.multishoot_dae(solver, f(torch), g(torch), T_(x0w), T_(t), T_(z), T_(v), T_(z_step), T_(v_step), K,
                              is_event=T_(ev))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_indivisible_windows_raise_the_jax_error():
    rng = np.random.default_rng(8)
    f, g, t, x, z, v, i = _tanh_problem(rng)
    ode = lambda m: lambda tt, xx, zz: m.tanh(xx + zz[..., :1])
    with pytest.raises(ValueError) as jax_err:
        JMSS.multishoot_ode("euler", ode(jnp), jnp.asarray(t), jnp.asarray(x), jnp.asarray(z[:-1]), 5)
    with pytest.raises(ValueError) as port_err:
        TMSS.multishoot_ode("euler", ode(torch), torch.tensor(t), torch.tensor(x), torch.tensor(z[:-1]), 5)
    assert str(port_err.value) == str(jax_err.value) == "(T-1)=12 not divisible by n_windows=5"
    batch, _, model, _, _ = setup("dae", "euler")
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    for name in ("multishoot_dae_apply", "fused_multishoot_dae_apply"):
        with pytest.raises(ValueError, match=r"\(T-1\)=12 not divisible by n_windows=5"):
            getattr(TMS, name)(model, tb, 5)


# ------------------------------------------------------------ the trainer


def test_train_step_adds_the_gap_term():
    """The step's ``aux``: ``gap_loss = gap_weight * mean(gaps**2)`` and
    ``loss`` the variant loss plus it (zero at K=1); the robust guard
    wraps the sum."""
    batch, _, model, _, _ = setup("dae", "euler")
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        out, gaps = TMS.fused_multishoot_dae_apply(model, tb, K)
        want = {K: (tlosses.dae_no_encode_loss(out, tb)[1]["loss"], GAP_WEIGHT * torch.mean(gaps**2)),
                1: (tlosses.dae_no_encode_loss(fused_dae_apply(model, tb), tb)[1]["loss"], torch.tensor(0.0))}
    for n_windows, (base, gap) in want.items():
        for robust in (False, True):
            cfg = TrainConfig(variant="dae_no_encode", device="cpu", fused=True, n_windows=n_windows,
                              gap_weight=GAP_WEIGHT, robust_loss=robust, robust_limit=1e-3)
            m = setup("dae", "euler")[2]
            opt = make_optimizer(m.parameters(), 5e-3, 1, 1, 0.7, None)
            aux, _ = Trainer(cfg)._make_train_step(m, opt)(tb)
            np.testing.assert_allclose(aux["gap_loss"].item(), gap.item(), rtol=1e-6)
            np.testing.assert_allclose(aux["loss"].item(), (base + gap).item(), rtol=1e-6)
            assert ("robust_tripped" in aux) == robust
            if robust:
                assert aux["robust_tripped"].item() == 1.0  # the sum is above 1e-3


def test_trainer_dispatches_as_the_jax_package(monkeypatch):
    """Fused: the four fused forwards (with the matmul precision, as the JAX
    package passes it), the channel-wise ones plain; not fused: the plain
    ones."""
    fused_fns, plain_fns = dict(trainer_mod._MS_FUSED), dict(trainer_mod._MS_PLAIN)
    called = []
    for table in (trainer_mod._MS_FUSED, trainer_mod._MS_PLAIN):
        for name, fn in list(table.items()):
            monkeypatch.setitem(table, name, lambda m, b, k, solver, fn=fn, **kw: called.append((fn, k, solver, kw)))
    for variant in plain_fns:
        for fused in (True, False):
            cfg = TrainConfig(variant=variant, device="cpu", fused=fused, n_windows=5, solver="rk4")
            Trainer(cfg)._multishoot_forward(None)({})
            want = fused_fns.get(variant, plain_fns[variant]) if fused else plain_fns[variant]
            kw = dict(precision="default") if fused and variant in fused_fns else {}
            assert called[-1] == (want, 5, "rk4", kw)
    assert sorted(fused_fns) == ["dae_encode", "dae_no_encode", "ode_encode", "ode_no_encode"]


def test_multishoot_refusals_and_what_stays_not_ported():
    with pytest.raises(ValueError, match="teacher forcing and multi-shooting are mutually exclusive "
                                         r"\(multi-shooting IS windowed teacher forcing\)"):
        Trainer(TrainConfig(variant="dae_encode", input_true_i=True, n_windows=4, device="cpu"))
    for kw in (dict(auto_resume=True), dict(checkpointer="orbax"), dict(n_devices=2)):
        with pytest.raises(NotImplementedError, match="not ported"):
            Trainer(TrainConfig(variant="dae_no_encode", n_windows=4, device="cpu", **kw))
    for variant in trainer_mod._MS_PLAIN:
        Trainer(TrainConfig(variant=variant, n_windows=20, gap_weight=0.3, fused=True, device="cpu"))


def test_cli_multishoot_flags_reach_the_train_config(monkeypatch):
    seen = []

    class Capture:
        def __init__(self, cfg):
            seen.append(cfg)

        def test(self):
            return None

    monkeypatch.setattr(cli_common, "Trainer", Capture)
    base = ["--testing", "--device", "cpu", "--model", "m", "--test_data", "d"]
    for flags, want in (([], (None, 1.0)), (["--n_windows", "20", "--gap_weight", "0.3"], (20, 0.3)),
                        (["--n_windows", "0"], (None, 1.0))):
        cli_common.main("dae_encode", base + flags)
        assert (seen[-1].n_windows, seen[-1].gap_weight) == want
    for flags in (["--remat", "sqrt"], ["--auto_resume"], ["--devices", "2"], ["--checkpointer", "orbax"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            cli_common.main("dae_no_encode", base + ["--n_windows", "20"] + flags)
