"""The bf16 compute mode of kernels 1-4 (``precision="bfloat16"``,
``TrainConfig.matmul_precision``) against the JAX package's, on the CPU.

The JAX package runs its Pallas kernels in interpret mode; on the CPU the
port runs the plain versions of kernels 1-4 (``ops/noencode_bwd.py``
``dot`` / ``dot_t``: each product rounds its operands where the JAX
kernel's ``_dot`` / ``_dot_t`` rounds them, then multiplies in float32).
Small size: B=3, T=9, h=16 for the rollouts (the motor widths, events at
three steps), the model-level entries on the batches of
``test_torch_multishoot.py`` (B=3, T=13, h=16). Every output and every
gradient tensor is held by the discrimination bar

    rel-L2(port_bf16 - jax_bf16) <= 0.1 x rel-L2(jax_bf16 - jax_f32),

which shows that the port rounds where the JAX kernels round, not merely
that it lands near float32; every gradient is float32. Also: a ``Trainer``
run of ``dae_no_encode`` (``fused=True``, bf16) against the JAX Trainer's
step 1 by the same bar, the channel-wise and TF-x configurations that build
under bf16 (``cast_cw`` casting exactly the 2-D weights), an unknown
precision, ``"highest"`` and the plain route under bf16. The kernels themselves against the plain bf16
versions: ``tests/test_torch_kernel.py`` on the card,
``tests/test_torch_bf16_host.py`` (their host build) here.

``python tests/test_torch_bf16.py anchors`` prints the JAX package's bf16
Trainer numbers at full width (Euler, one epoch of two steps: the motor
DAE from checkpoint 200, the direct-encode DAE and both ODEs from their
starting checkpoints, and the motor DAE with ``n_windows=20``), the
``BF16_ANCHORS`` of ``chip_smoke.py``, and beside them the port's own bf16
Trainer on the CPU in the same settings (about three minutes).
"""

import pathlib
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from test_torch_multishoot import DIMS, GAP_WEIGHT, H, K, setup  # noqa: E402
from test_torch_ode_encode import flax_grads  # noqa: E402
from test_torch_teacher_forcing import _outs  # noqa: E402
from py_psnode_tpu.ops import fused_dae as jfd  # noqa: E402
from py_psnode_tpu.ops import fused_dae_vjp as jfdv  # noqa: E402
from py_psnode_tpu.ops import fused_model as jfm  # noqa: E402
from py_psnode_tpu.ops import fused_ode as jfo  # noqa: E402
from py_psnode_tpu.ops import teacher_forcing as JTF  # noqa: E402
from py_psnode_tpu.train import losses as jlosses  # noqa: E402
from py_psnode_tpu.train import multishoot_forward as JMS  # noqa: E402
from py_psnode_tpu_torch import bridge  # noqa: E402
from py_psnode_tpu_torch.ops import fused_dae as F  # noqa: E402
from py_psnode_tpu_torch.ops import fused_dae_vjp as V  # noqa: E402
from py_psnode_tpu_torch.ops import fused_ode as FO  # noqa: E402
from py_psnode_tpu_torch.ops import fused_ode_vjp as VO  # noqa: E402
from py_psnode_tpu_torch.ops import teacher_forcing as TF  # noqa: E402
from py_psnode_tpu_torch.ops.fused_model import fused_dae_encode_apply, fused_ode_encode_apply  # noqa: E402
from py_psnode_tpu_torch.train import TrainConfig, Trainer  # noqa: E402
from py_psnode_tpu_torch.train import losses as tlosses  # noqa: E402
from py_psnode_tpu_torch.train import multishoot_forward as TMS  # noqa: E402

BAR = 0.1
BF16 = "bfloat16"
STREAMS = ("s_de", "s_ae", "s_ae_ev")


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads for torch, as test_torch_train_slice.py's
    ``few_threads``: the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def hold(port, jax_bf16, jax_f32, what=""):
    """The discrimination bar on one tensor; a tensor that no kernel
    computes (a decoder's reconstruction of the data: the JAX bf16 and
    float32 runs agree exactly) is held to the JAX one at the float32
    tolerance of the other port tests instead."""
    gap = rel_l2(jax_bf16, jax_f32)
    if gap == 0:
        np.testing.assert_allclose(port, np.asarray(jax_bf16), rtol=1e-5, atol=1e-6, err_msg=what)
        return
    err = rel_l2(port, jax_bf16)
    assert err <= BAR * gap, f"{what}: rel-L2 to the JAX bf16 {err:.3e} > {BAR} x the bf16-float32 gap {gap:.3e}"


def dae_args(events=True, B=3, Tm1=8, h=16, xd=3, idim=2, seed=0):
    """Seeded numpy rollout inputs (flax layout) of the DAE kernels: events
    in row 1 at step 2, in every row at step 5 and in row 0 at the last step
    (the walk's first)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    streams = {k: f(Tm1, B, h, sc=0.5) for k in ("s_de", "s_ae", "s_ae_ev")}
    tail = lambda out: [(f(h, o, sc=h ** -0.5), f(o, sc=0.1)) for o in (h, h, out)]
    weights = dict(wx_de=f(xd, h, sc=0.5), wi_de=f(idim, h, sc=0.5), gx_ae=f(xd, h, sc=0.5), de_tail=tail(xd),
                   ae_tail=tail(idim))
    dt = np.full((Tm1, B, 1), 0.05, np.float32)
    dt[:, 1] = 0.02
    ev = np.zeros((Tm1, B), bool)
    if events:
        ev[2, 1] = ev[5, :] = ev[Tm1 - 1, 0] = True
    return streams, weights, f(B, xd), f(B, idim), dt, ev


def ode_args(B=3, Tm1=8, h=16, xd=2, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    weights = dict(wx_de=f(xd, h, sc=0.5), de_tail=[(f(h, o, sc=h ** -0.5), f(o, sc=0.1)) for o in (h, h, xd)])
    dt = np.full((Tm1, B, 1), 0.05, np.float32)
    dt[:, 1] = 0.02
    return f(Tm1, B, h, sc=0.5), weights, f(B, xd), dt


def tree(fn, streams, weights):
    w = {k: (fn(v) if not isinstance(v, list) else [(fn(W), fn(b)) for W, b in v]) for k, v in weights.items()}
    return {k: fn(v) for k, v in streams.items()}, w


# ------------------------------------------------------------- the rollouts


@pytest.mark.parametrize("events", [False, True])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_dae_forward_bf16_matches_jax(solver, events):
    streams, weights, x0, i0, dt, ev = dae_args(events)
    js, jw = tree(jnp.asarray, streams, weights)
    run = lambda p: jfd.fused_dae_rollout(js, jw, *map(jnp.asarray, (x0, i0, dt, ev)), solver=solver,
                                          interpret=True, precision=p)
    jb, jf = run(BF16), run("default")
    ts, tw = tree(torch.tensor, streams, weights)
    got = F.fused_dae_rollout(ts, tw, *map(torch.tensor, (x0, i0, dt, ev)), solver, BF16)
    for name, g, b, f in zip(("x", "i"), got, jb, jf):
        assert g.dtype == torch.float32
        hold(g.numpy(), b, f, name)


@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_ode_forward_bf16_matches_jax(solver):
    s_de, weights, x0, dt = ode_args()
    jw = tree(jnp.asarray, {}, weights)[1]
    run = lambda p: jfo.fused_ode_rollout_diff(jnp.asarray(s_de), jw, jnp.asarray(x0), jnp.asarray(dt), solver,
                                               True, p)[1:]
    got = FO.fused_ode_rollout(torch.tensor(s_de), tree(torch.tensor, {}, weights)[1], torch.tensor(x0),
                               torch.tensor(dt), solver, BF16)
    hold(got.numpy(), run(BF16), run("default"), "x")


def _dae_vjp_jax(args, solver, cx, ci, precision):
    streams, weights, x0, i0, dt, ev = args

    def loss(st, w, a, b):
        xs, is_ = jfdv.fused_dae_rollout_diff(st, w, a, b, jnp.asarray(dt), jnp.asarray(ev), solver, True,
                                              precision)
        return jnp.sum(cx * xs) + jnp.sum(ci * is_)

    js, jw = tree(jnp.asarray, streams, weights)
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(js, jw, jnp.asarray(x0), jnp.asarray(i0))
    return [g[0][k] for k in STREAMS] + jfdv.flatten_weights(g[1])[0] + [g[2], g[3]]


@pytest.mark.parametrize("solver", ["rk4"])
def test_fused_dae_rollout_vjp_bf16_matches_jax(solver):
    """Every gradient of ``FusedDaeRollout`` (the three streams, every
    weight and bias, x0, i0) by the bar, float32."""
    args = dae_args()
    rng = np.random.default_rng(5)
    cx, ci = rng.standard_normal((9, 3, 3)).astype(np.float32), rng.standard_normal((9, 3, 2)).astype(np.float32)
    jb, jf = (_dae_vjp_jax(args, solver, cx, ci, p) for p in (BF16, "default"))
    streams, weights, x0, i0, dt, ev = args
    leaf = lambda a: torch.tensor(a, requires_grad=True)
    ts, tw = tree(leaf, streams, weights)
    tx0, ti0 = leaf(x0), leaf(i0)
    xs, is_ = V.fused_dae_rollout_diff(ts, tw, tx0, ti0, torch.tensor(dt), torch.tensor(ev), solver, BF16)
    (torch.sum(torch.tensor(cx) * xs) + torch.sum(torch.tensor(ci) * is_)).backward()
    got = [t.grad for t in [ts[k] for k in STREAMS] + V.flatten_weights(tw)[0] + [tx0, ti0]]
    assert len(got) == len(jb)
    for k, (g, b, f) in enumerate(zip(got, jb, jf)):
        assert g.dtype == torch.float32
        hold(g.numpy(), b, f, f"gradient {k}")


@pytest.mark.parametrize("solver", ["rk4"])
def test_fused_ode_rollout_vjp_bf16_matches_jax(solver):
    """Every gradient of ``FusedOdeRollout`` (s_de, every weight and bias,
    x0) by the bar, float32."""
    s_de, weights, x0, dt = ode_args()
    c = np.random.default_rng(6).standard_normal((9, 3, 2)).astype(np.float32)

    def jax_grads(precision):
        loss = lambda s, w, a: jnp.sum(c * jfo.fused_ode_rollout_diff(s, w, a, jnp.asarray(dt), solver, True,
                                                                      precision))
        g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(s_de), tree(jnp.asarray, {}, weights)[1],
                                                       jnp.asarray(x0))
        return [g[0]] + VO.flatten_weights(g[1]) + [g[2]]

    jb, jf = jax_grads(BF16), jax_grads("default")
    leaf = lambda a: torch.tensor(a, requires_grad=True)
    ts, tw, tx0 = leaf(s_de), tree(leaf, {}, weights)[1], leaf(x0)
    sol = VO.fused_ode_rollout_diff(ts, tw, tx0, torch.tensor(dt), solver, BF16)
    torch.sum(torch.tensor(c) * sol).backward()
    got = [t.grad for t in [ts] + VO.flatten_weights(tw) + [tx0]]
    for k, (g, b, f) in enumerate(zip(got, jb, jf)):
        assert g.dtype == torch.float32
        hold(g.numpy(), b, f, f"gradient {k}")


# ------------------------------------------------------ the model entries

# name: (family of test_torch_multishoot.setup, the JAX call (params, batch,
# solver, precision), the port's (model, batch, precision), multishoot)
ENTRIES = {
    "fused_ode_encode_apply": ("ode_encode", lambda p, b, s, q: jfo.fused_ode_encode_apply(p, b, H, s, True, q),
                               lambda m, b, q: fused_ode_encode_apply(m, b, precision=q), False),
    "fused_dae_encode_apply": ("dae_encode",
                               lambda p, b, s, q: jfm.fused_dae_encode_apply(p, b, DIMS, H, s, True, q),
                               lambda m, b, q: fused_dae_encode_apply(m, b, precision=q), False),
    "fused_dae_tf_i_apply": ("dae", lambda p, b, s, q: JTF.fused_dae_tf_i_apply(p, b, DIMS, H, s, True, q),
                             lambda m, b, q: TF.fused_dae_tf_i_apply(m, b, precision=q), False),
    "fused_multishoot_dae_apply": (
        "dae", lambda p, b, s, q: JMS.fused_multishoot_dae_apply(p, b, DIMS, H, K, s, interpret=True, precision=q),
        lambda m, b, q: TMS.fused_multishoot_dae_apply(m, b, K, precision=q), True),
}


@pytest.mark.parametrize("name,solver", [("fused_ode_encode_apply", "rk4"), ("fused_dae_encode_apply", "euler"),
                                         ("fused_dae_tf_i_apply", "rk4"), ("fused_multishoot_dae_apply", "euler")])
def test_model_entry_bf16_matches_jax(name, solver):
    """The two encode applies, the TF-i DAE and a K=4 fused multishoot
    forward: every output (and gap) and every parameter's gradient of the
    trainer's loss by the bar, the gradients float32."""
    check_entry(*ENTRIES[name], solver)


def check_entry(family, jax_fn, port_fn, ms, solver):
    """A model entry (``jax_fn(params, batch, solver, precision)`` against
    ``port_fn(model, batch, precision)`` on ``family``'s batch of
    ``test_torch_multishoot.setup``; ``ms``: it returns ``(out, gaps)``):
    every output and every parameter's gradient of the trainer's loss by
    the bar, the gradients float32."""
    batch, params, model, _, variant = setup(family, solver)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_loss = getattr(jlosses, f"{variant}_loss")

    def j_loss(p, precision):
        out = jax_fn(p, jb, solver, precision)
        if ms:
            out, gaps = out
            return jax_loss(out, jb)[0] + GAP_WEIGHT * jnp.mean(gaps**2), _outs(out) + [gaps]
        return jax_loss(out, jb)[0], _outs(out)

    runs = {}
    for precision in (BF16, "default"):
        (_, outs), grads = jax.jit(jax.value_and_grad(lambda p: j_loss(p, precision), has_aux=True))(params)
        runs[precision] = (outs, {k: np.asarray(v) for k, v in bridge.flatten_params(grads["params"]).items()})

    tb = {k: torch.tensor(v) for k, v in batch.items()}
    model.requires_grad_(True)
    out = port_fn(model, tb, BF16)
    if ms:
        out, gaps = out
        loss = getattr(tlosses, f"{variant}_loss")(out, tb)[0] + GAP_WEIGHT * torch.mean(gaps**2)
        outs = _outs(out) + [gaps]
    else:
        loss, outs = getattr(tlosses, f"{variant}_loss")(out, tb)[0], _outs(out)
    loss.backward()
    (jo_b, jg_b), (jo_f, jg_f) = runs[BF16], runs["default"]
    for k, (g, b, f) in enumerate(zip(outs, jo_b, jo_f)):
        hold(g.detach().numpy(), b, f, f"output {k}")
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    got_g = flax_grads(model)
    assert sorted(got_g) == sorted(jg_b)
    for k in jg_b:
        hold(got_g[k], jg_b[k], jg_f[k], k)


# -------------------------------------------------------------- the trainer


def _smib(tmp_path):
    from py_psnode_tpu.data.synthetic import write_smib_dataset

    return write_smib_dataset(tmp_path, n_train=8, n_test=4, n_steps=9)


def _config(train_f, test_f, model, **kw):
    return dict(variant="dae_no_encode", hidden=16, solver="rk4", fused=True, num=8, batch=4, epoch=1, step=9,
                larger_than=None, train_data=str(train_f), test_data=str(test_f), model=str(model), echo_logs=False,
                loss_record_iter=1, **kw)


def test_trainer_bf16_step_matches_jax(tmp_path):
    """One bf16 epoch of the port's Trainer on the CPU (the plain versions
    of kernels 1-2) from a numpy starting checkpoint: its step-1 loss
    against the JAX Trainer's bf16 one by the bar (the JAX float32 run sets
    the gap), and a checkpoint written."""
    from chip_smoke import start_checkpoint
    from test_torch_train_slice import read_metrics
    from py_psnode_tpu.train.trainer import TrainConfig as JaxConfig
    from py_psnode_tpu.train.trainer import Trainer as JaxTrainer

    train_f, test_f = _smib(tmp_path / "data")
    start = tmp_path / "start.ckpt"
    cfg = lambda model, **kw: _config(train_f, test_f, tmp_path / model, warm_start=str(start), **kw)
    port = Trainer(TrainConfig(**cfg("port", matmul_precision=BF16, device="cpu")))
    start_checkpoint(start, port.build_model(port.load_train_dataset(), init=False), 0)
    jax_step1 = {}
    for precision in (BF16, "default"):
        _, run_dir = JaxTrainer(JaxConfig(**cfg(f"jax_{precision}", matmul_precision=precision))).train()
        jax_step1[precision] = read_metrics(run_dir)[0][0]["loss"]
    port = Trainer(TrainConfig(**cfg("port", matmul_precision=BF16, device="cpu")))
    _, run_dir = port.train()
    port_step1 = read_metrics(run_dir)[0][0]["loss"]
    hold([port_step1], [jax_step1[BF16]], [jax_step1["default"]], "step-1 loss")
    assert (run_dir / "model_checkpoint.1").exists()


def test_bf16_refusals_and_identities(tmp_path):
    """Under bf16 with fused, the channel-wise variants (multishoot too) and
    TF-x build a Trainer, and the TF-x rollout runs in float32 gradients;
    ``cast_cw`` casts exactly the 2-D weights; an unknown precision raises
    ValueError; "highest" is the identity of cast_compute and cast_cw; the
    rollouts' gradients leave in float32."""
    from py_psnode_tpu_torch.ops import fused_channelwise as FC
    from py_psnode_tpu_torch.utils.cw_inputs import seeded_inputs

    for variant in ("ode_channelwise", "dae_channelwise"):
        for kw in (dict(), dict(n_windows=4)):
            Trainer(TrainConfig(variant=variant, fused=True, matmul_precision=BF16, device="cpu", **kw))
        Trainer(TrainConfig(variant=variant, fused=False, matmul_precision=BF16, device="cpu"))  # plain route
    for variant in ("dae_no_encode", "dae_encode"):
        Trainer(TrainConfig(variant=variant, fused=True, matmul_precision=BF16, input_true_x=True, device="cpu"))
        for kw in (dict(input_true_i=True), dict(input_true_x=True, input_true_i=True), dict(n_windows=4)):
            Trainer(TrainConfig(variant=variant, fused=True, matmul_precision=BF16, device="cpu", **kw))
    with pytest.raises(ValueError, match="precision must be one of"):
        Trainer(TrainConfig(variant="dae_no_encode", matmul_precision="tf32", device="cpu"))
    with pytest.raises(ValueError, match="precision must be one of"):
        Trainer(TrainConfig(variant="ode_channelwise", fused=True, matmul_precision="tf32", device="cpu"))
    streams, weights, x0, i0, dt, ev = dae_args()
    ts, tw = tree(torch.tensor, streams, weights)
    for precision in ("default", "float32", "highest"):
        assert F.cast_compute(ts, tw, precision) == (ts, tw)
    tw_leaf = tree(lambda a: torch.tensor(a, requires_grad=True), {}, weights)[1]
    xs, is_ = V.fused_dae_tf_x_rollout_diff(ts, tw_leaf, *map(torch.tensor, (x0, i0)), torch.zeros(9, 3, 3),
                                            *map(torch.tensor, (dt, ev)), "euler", BF16)
    (xs.sum() + is_.sum()).backward()
    assert all(t.grad.dtype == torch.float32 for t in V.flatten_weights(tw_leaf)[0])
    cw_streams, cw_weights, _, _ = seeded_inputs(2, 3, 8, 2, 2)
    for precision in ("default", "float32", "highest"):
        assert FC.cast_cw(cw_streams, cw_weights, precision) == (cw_streams, cw_weights)
    cs, cwb = FC.cast_cw(cw_streams, cw_weights, BF16)
    assert cs is cw_streams
    two_d = {id(w) for w in [cw_weights["a"], *(W for W, _ in cw_weights["vert"]),
                             *(cw_weights[n][k] for n in ("ext", "head") for k in (0, 2))]}
    for w, wb in zip(FC.flatten_weights(cw_weights), FC.flatten_weights(cwb)):
        if id(w) in two_d:
            assert wb.dtype == torch.bfloat16 and torch.equal(wb, w.to(torch.bfloat16))
        else:
            assert wb is w and w.dtype == torch.float32
    with pytest.raises(ValueError, match="precision must be one of"):
        V.fused_dae_rollout_diff(ts, tw, *map(torch.tensor, (x0, i0, dt, ev)), "euler", "tf32")
    cs, cw = F.cast_compute(ts, tw, BF16)
    assert all(v.dtype == torch.bfloat16 for v in cs.values())
    assert all(cw[k].dtype == torch.bfloat16 for k in ("wx_de", "wi_de", "gx_ae"))
    assert all(W.dtype == torch.bfloat16 and b.dtype == torch.float32 for W, b in cw["de_tail"] + cw["ae_tail"])


@pytest.mark.parametrize("variant", ["dae_no_encode", "ode_encode"])
def test_plain_route_ignores_bf16(variant):
    """Without ``fused`` the forward is bit-identical under "bfloat16" and
    "default", as the JAX package's on the CPU."""
    family = {"dae_no_encode": "dae", "ode_encode": "ode_encode"}[variant]
    batch, _, model, _, _ = setup(family, "rk4")
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    outs = []
    for precision in ("default", BF16):
        trainer = Trainer(TrainConfig(variant=variant, matmul_precision=precision, device="cpu"))
        with torch.no_grad():
            outs.append(_outs(trainer._forward_fn(model)(tb)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ------------------------------------------ the card's yardsticks, on the CPU


def torch_dae_args():
    """:func:`dae_args` as the kernels' torch inputs: (streams, weights,
    x0, i0, aux)."""
    streams, weights, x0, i0, dt, ev = dae_args()
    ts, tw = tree(torch.tensor, streams, weights)
    return ts, tw, torch.tensor(x0), torch.tensor(i0), F.pack_aux(torch.tensor(dt), torch.tensor(ev))


def test_plain_bf16_in_float64_arithmetic():
    """``chip_smoke.py`` phase 21's floor: the plain versions on float64
    streams and carries with the bf16 weights keep the bf16 mode's rounding
    points and compute in float64 between them (the products too), so they
    lie far inside the bf16-float32 gap of the float32 plain bf16 version;
    on float32 operands the products stay float32."""
    from py_psnode_tpu_torch.ops.noencode_bwd import dot, dot_t

    streams, weights, x0, i0, aux = torch_dae_args()
    cs, cw = F.cast_compute(streams, weights, BF16)
    d64 = {k: v.double() for k, v in cs.items()}
    a = torch.randn(5, 16)
    assert dot(a, cw["wx_de"].T).dtype == torch.float32 and dot(a.double(), cw["wx_de"].T).dtype == torch.float64
    assert dot_t(a, a.double(), torch.bfloat16).dtype == torch.float64
    ref = F.fused_dae_rollout_packed_plain(cs, cw, x0, i0, aux, "rk4")
    f32 = F.fused_dae_rollout_packed_plain(streams, weights, x0, i0, aux, "rk4")
    fl = F.fused_dae_rollout_packed_plain(d64, cw, x0.double(), i0.double(), aux.double(), "rk4")
    assert rel_l2(fl, ref) <= BAR * rel_l2(ref, f32)
    cot = torch.randn(ref.shape[0] + 1, *ref.shape[1:], generator=torch.Generator().manual_seed(3))
    g = V.fused_dae_rollout_bwd_plain(cs, cw, x0, i0, aux, ref, cot, "rk4")
    g_f = V.fused_dae_rollout_bwd_plain(streams, weights, x0, i0, aux, f32, cot, "rk4")
    g64 = V.fused_dae_rollout_bwd_plain(d64, cw, x0.double(), i0.double(), aux.double(), ref.double(), cot.double(),
                                        "rk4")
    for k in STREAMS:
        assert g64[0][k].dtype == torch.float64
        assert rel_l2(g64[0][k], g[0][k]) <= BAR * rel_l2(g[0][k], g_f[0][k]), k
    s_de, wo, x0o, dto = ode_args()
    s_de, wo, x0o, dto = torch.tensor(s_de), tree(torch.tensor, {}, wo)[1], torch.tensor(x0o), torch.tensor(dto)
    cs_o, cw_o = FO.cast_ode(s_de, wo, BF16)
    ref_o = FO.fused_ode_rollout_plain(cs_o, cw_o, x0o, dto, "rk4")
    fl_o = FO.fused_ode_rollout_plain(cs_o.double(), cw_o, x0o.double(), dto.double(), "rk4")
    assert rel_l2(fl_o, ref_o) <= BAR * rel_l2(ref_o, FO.fused_ode_rollout_plain(s_de, wo, x0o, dto, "rk4"))


def test_smoke_local_dae_step_is_the_rollouts_step():
    """``chip_smoke.bf16_local_dae`` (kernel 1's rows against one step of the
    plain versions from its own states, all row-steps at once) gives the
    plain bf16 rollout's own rows back when that rollout stands in for the
    kernel, with events."""
    import chip_smoke as CS

    streams, weights, x0, i0, aux = torch_dae_args()
    cs, cw = F.cast_compute(streams, weights, BF16)
    for solver in ("euler", "rk4"):
        rows = F.fused_dae_rollout_packed_plain(cs, cw, x0, i0, aux, solver)
        (bx, bi), (fx, fi) = CS.bf16_local_dae(cs, cw, streams, weights, x0, i0, aux, rows, solver)
        torch.testing.assert_close(torch.cat([bx, bi], -1), rows, rtol=1e-6, atol=1e-6)
        assert rel_l2(fx, bx) > 0 and rel_l2(fi, bi) > 0


# ------------------------------------------------------------ the anchors


def bf16_runs(name: str, root: pathlib.Path, package: str = "jax"):
    """The JAX package's Trainer (CPU, fused, bf16, Pallas in interpret
    mode), or with ``package`` "port" the port's (CPU, fused: the plain
    versions of kernels 1-4), in the setting of the float32 anchors of
    ``chip_smoke.py``: its step 1 and step 2 (loss, gradient norm) and
    epoch-1 eval. ``name``: a variant, or "ms" for the motor DAE with K=20
    windows, gap weight 0.3."""
    jax.config.update("jax_platforms", "cpu")
    import test_torch_dae_encode as dae_encode
    import test_torch_ode_encode as ode_encode
    import test_torch_ode_slice as ode_slice
    from test_torch_train_slice import read_metrics
    from test_torch_train_slice import run_config as motor_config
    from py_psnode_tpu.train import trainer as jax_trainer

    kw = dict(fused=True, matmul_precision=BF16)
    config, runner = jax_trainer.TrainConfig, jax_trainer.Trainer
    if package == "port":
        config, runner, kw["device"] = TrainConfig, Trainer, "cpu"
    variant = name
    if name == "ms":
        variant, kw = "dae_no_encode", dict(kw, n_windows=20, gap_weight=0.3)
    if variant == "dae_no_encode":
        cfg = motor_config(root / "train", "euler", **kw)
    else:
        mod = {"dae_encode": dae_encode, "ode_no_encode": ode_slice, "ode_encode": ode_encode}[variant]
        cfg = mod.run_config(mod.make_inputs(root / "data"), root / "train", "euler", **kw)
    _, run_dir = runner(config(**cfg)).train()
    train, ev = read_metrics(run_dir)
    return dict(step1=(train[0]["loss"], train[0]["grad_norm"]), step2=(train[1]["loss"], train[1]["grad_norm"]),
                eval1=tuple(ev[k] for k in ("x_loss", "i_loss") if k in ev))


def jax_bf16_gaps(root: pathlib.Path):
    """The JAX package's own bf16 mode against its float32 mode at phase
    21's step check (``chip_smoke.phase_bf16_vs_f32``: B=64, T=1001,
    h=128, RK4, the same weights and batches, the fused entries in
    interpret mode): per variant, the loss's relative difference and the
    gradients' rel-L2 (all parameters as one vector)."""
    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as CS
    from py_psnode_tpu.ops.fused_ode import fused_ode_apply as jax_fused_ode_apply

    (root / "ode").mkdir(parents=True, exist_ok=True)
    train_f, test_f = CS.write_avr_dataset(root / "ode", n_train=128, n_test=32, n_steps=1001, seed=0)
    start = CS.ode_start_checkpoint(root / "ode" / "start.ckpt", (2, 2), 128, seed=0)
    files = {"ode_no_encode": (train_f, test_f, start),
             "dae_encode": (CS.TRAIN_DATA, CS.TEST_DATA, CS.start_checkpoint(
                 root / "de.start", CS.DAEEncodeModel(3, 1, 2, 2, hidden_dim=128, device="meta"), seed=0)),
             "ode_encode": (train_f, test_f, CS.start_checkpoint(
                 root / "oe.start", CS.ODEEncodeModel(2, 2, hidden_dim=128, device="meta"), seed=0))}
    entries = {
        "dae_no_encode": (lambda p, b, q: jfm.fused_dae_apply(p, b, (3, 1, 2, 2), 128, "rk4", True, q),
                          jlosses.dae_no_encode_loss),
        "ode_no_encode": (lambda p, b, q: jax_fused_ode_apply(p, b, 2, "rk4", True, q), jlosses.ode_no_encode_loss),
        "dae_encode": (lambda p, b, q: jfm.fused_dae_encode_apply(p, b, (3, 1, 2, 2), 128, "rk4", True, q),
                       jlosses.dae_encode_loss),
        "ode_encode": (lambda p, b, q: jfo.fused_ode_encode_apply(p, b, 128, "rk4", True, q),
                       jlosses.ode_encode_loss),
    }
    out = {}
    for variant, (model, batch, _, _) in CS.bf16_models(files, "cpu").items():
        apply, loss_fn = entries[variant]
        params = {"params": jax.tree_util.tree_map(lambda a: jnp.asarray(a.detach().numpy()),
                                                   bridge.flax_params(model))}
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        res = {}
        for precision in ("default", BF16):
            f = lambda p: loss_fn(apply(p, jb, precision), jb)[0]
            loss, g = jax.jit(jax.value_and_grad(f))(params)
            res[precision] = float(loss), np.concatenate([np.asarray(a).ravel() for a in jax.tree_util.tree_leaves(g)])
        (l32, g32), (lbf, gbf) = res["default"], res[BF16]
        out[variant] = (abs(lbf - l32) / abs(l32), float(np.linalg.norm(gbf - g32) / np.linalg.norm(g32)))
        print(f"{variant}: loss rel {out[variant][0]:.3e}, gradients rel-L2 {out[variant][1]:.3e}", flush=True)
    return out


if __name__ == "__main__" and sys.argv[1:2] == ["gaps"]:
    with tempfile.TemporaryDirectory() as tmp:
        jax_bf16_gaps(pathlib.Path(tmp))

if __name__ == "__main__" and sys.argv[1:2] == ["anchors"]:
    for name in sys.argv[2:] or ("dae_no_encode", "ode_no_encode", "dae_encode", "ode_encode", "ms"):
        for package in ("jax", "port"):
            with tempfile.TemporaryDirectory() as tmp:
                a = bf16_runs(name, pathlib.Path(tmp), package)
            print(f"{package} {name}: " + ", ".join(f"{k}={tuple(float(f'{v:.8g}') for v in a[k])}" for k in a),
                  flush=True)
