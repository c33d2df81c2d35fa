"""The port's direct-encode DAE against the JAX package, on the CPU.

Small size (h=16, T=8, B=3, events in every row; the motor widths xd=3,
zd=1, vd=2, id=2, and a zero-wide z): the same seeded numpy inputs and the
same weights (JAX's initial parameters with random biases, carried over by
``bridge.load_params``) go through the JAX function and its counterpart in
``py_psnode_tpu_torch``:

* ``DAEEncodeModel.forward`` against the JAX ``DAEEncodeModel``, each
  solver, with and without events, at rtol 1e-5 / atol 1e-6 (float32 in
  another summation order); ``x_pred[:, 0]`` is the raw Init output,
  exactly;
* ``fused_dae_encode_apply`` (on the CPU the plain versions of kernels 1
  and 2 behind the ``autograd.Function``, at ``dims = (h, zl, h, h)``)
  against the JAX ``fused_dae_encode_apply`` in Pallas interpret mode: the
  forward at rtol 1e-5 / atol 1e-6, the gradients of ``dae_encode_loss``
  at rtol 2e-3 / atol 2e-4;
* ``dae_encode_loss`` with and without padded rows;
* ``zd == 0``: no z encoder, ``all_initial`` 3h wide, and an export of
  eight submodules whose file set and ``.bin`` bytes are the JAX recipe's;
* the port's plain ``integrate_dae`` against the float64 numpy oracle
  ``tests/np_reference.py`` for each stepper, with and without events, at
  the raw widths and at latent widths (rtol 1e-10 in float64).

Full size: the motor set (128 training and 32 test samples, T=1001) and
``chip_smoke.start_checkpoint`` of the h=128 model (seed 0). One JAX run
for the file (its ``Trainer``, non-fused, one epoch of two steps at batch
64, Euler, and its CLI ``--testing``) checks the anchors written into
``chip_smoke.py`` (``ENC_ANCHORS``) and holds the port's fused
``Trainer`` (step 1 at rtol 1e-5 / 1e-4, loss / gradient norm; step 2 and
the epoch-1 eval at 1e-3) and its CLI ``--testing --fused`` (rtol 1e-5).
``python tests/test_torch_dae_encode.py [euler rk4]`` prints the anchors
again, ``... conditioning`` the two training steps of both encode variants
in float32 beside float64.
"""

import pathlib
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import np_reference as ref
from test_torch_ode_encode import conditioning, flax_grads
from test_torch_ode_slice import few_threads, read_metrics  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import ENC_ANCHORS, TEST_DATA, TRAIN_DATA, start_checkpoint  # noqa: E402
from py_psnode_tpu.models import DAEEncodeModel as JaxDAEEncodeModel  # noqa: E402
from py_psnode_tpu.ops import fused_dae_encode_apply as jax_fused_dae_encode_apply  # noqa: E402
from py_psnode_tpu.train import losses as jlosses  # noqa: E402
from py_psnode_tpu.train.variants import VARIANTS as JAX_VARIANTS  # noqa: E402
from py_psnode_tpu_torch import bridge  # noqa: E402
from py_psnode_tpu_torch.models import DAEEncodeModel  # noqa: E402
from py_psnode_tpu_torch.ops.fused_model import fused_dae_encode_apply  # noqa: E402
from py_psnode_tpu_torch.solvers import event_match, integrate_dae, jumped_stream  # noqa: E402
from py_psnode_tpu_torch.train import losses as tlosses  # noqa: E402
from py_psnode_tpu_torch.train.variants import get_variant  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
KEYS = ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")
H = 16
HIDDEN = 128  # the full-size width


def dae_batch(B=3, T=8, dims=(3, 1, 2, 2), seed=0, events=True):
    """Seeded batch-major float32 DAE batch (mask ``[B, T, 1]`` as the motor
    set's); with ``events`` one event a row on a grid point (step 2, 3 or
    4) beside an inert sentinel."""
    xd, zd, vd, idim = dims
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = (np.cumsum(np.full((B, T, 1), 0.02, np.float32), axis=1) - 0.02).astype(np.float32)
    event_t = np.full((B, 2), -1.0, np.float32)
    if events:
        for b in range(B):
            event_t[b, 0] = t[b, 2 + b % 3, 0]
    mask = (rng.random((B, T, 1)) > 0.2).astype(np.float32)
    return dict(t=t, x=f(B, T, xd), z=f(B, T, zd), v=f(B, T, vd), i=f(B, T, idim), event_t=event_t,
                z_jump=f(B, 2, zd), v_jump=f(B, 2, vd), mask=mask)


def dims_of(batch):
    return tuple(batch[k].shape[-1] for k in ("x", "z", "v", "i"))


def jax_model(batch, solver, seed=0):
    """The JAX model and its initial parameters with random biases."""
    model = JaxDAEEncodeModel(*dims_of(batch), hidden_dim=H, solver=solver)
    params = model.init(jax.random.PRNGKey(seed), *(jnp.asarray(batch[k]) for k in KEYS))
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    leaves = [l + 0.1 * jax.random.normal(k, l.shape, l.dtype) if l.ndim == 1 else l for l, k in zip(leaves, keys)]
    return model, jax.tree_util.tree_unflatten(tree, leaves)


def port_model(params, batch, solver):
    model = DAEEncodeModel(*dims_of(batch), H, solver=solver, device="meta")
    return bridge.load_params(model, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params),
                              device="cpu")


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("events", [True, False])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_dae_encode_model_matches_jax(solver, events):
    batch = dae_batch(events=events)
    jm, params = jax_model(batch, solver)
    want = jm.apply(params, *(jnp.asarray(batch[k]) for k in KEYS))
    model = port_model(params, batch, solver)
    got = model(*(torch.tensor(batch[k]) for k in KEYS))
    assert [tuple(g.shape) for g in got] == [(3, 8, 3), (3, 8, 2), (3, 8, 3), (3, 8, 2)]
    for g, w, name in zip(got, want, ("x_pred", "i_pred", "x_re", "i_re")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)
    # ref :150: the first row of x_pred is the raw Init output
    tm = lambda k: torch.tensor(batch[k])[:, 0]
    assert torch.equal(got[0][:, 0], model.init_func(tm("z"), tm("v"), tm("i")))


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_dae_encode_model_with_a_zero_wide_z_matches_jax(solver):
    batch = dae_batch(dims=(3, 0, 2, 2), seed=5)
    jm, params = jax_model(batch, solver)
    assert "z_encoder" not in params["params"]
    model = port_model(params, batch, solver)
    assert model.z_encoder is None and model.latent_dims == (H, 0, H, H)
    assert model.de_func.x_dot.dense_0.in_features == 3 * (3 * H)  # all_initial 3h wide
    want = jm.apply(params, *(jnp.asarray(batch[k]) for k in KEYS))
    got = model(*(torch.tensor(batch[k]) for k in KEYS))
    for g, w, name in zip(got, want, ("x_pred", "i_pred", "x_re", "i_re")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)


# ------------------------------------------------------------------ fused


@pytest.mark.parametrize("zd", [1, 0])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_fused_dae_encode_apply_matches_jax_fused(solver, zd):
    batch = dae_batch(dims=(3, zd, 2, 2), seed=1)
    _, params = jax_model(batch, solver)
    want = jax_fused_dae_encode_apply(params, {k: jnp.asarray(v) for k, v in batch.items()}, dims_of(batch), H,
                                      solver=solver, interpret=True)
    model = port_model(params, batch, solver).requires_grad_(False)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    got = fused_dae_encode_apply(model, tb)
    for g, w, name in zip(got, want, ("x_pred", "i_pred", "x_re", "i_re")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)
    plain = model(*(tb[k] for k in KEYS))
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(got[0][:, 0], model.init_func(tb["z"][:, 0], tb["v"][:, 0], tb["i"][:, 0]))


@pytest.mark.parametrize("tf_x", [False, True])
def test_dae_encode_setup_matches_jax(tf_x):
    """The shared preamble: the initial algebraic output (at the encoded
    Init state, or under ``tf_x`` at the encoded true initial state) and
    the layer-1 streams at ``dims = (h, zl, h, h)``."""
    from py_psnode_tpu.ops.fused_model import dae_encode_setup as jax_dae_encode_setup
    from py_psnode_tpu_torch.ops.fused_model import dae_encode_setup

    batch = dae_batch(seed=9)
    _, params = jax_model(batch, "euler")
    want = jax_dae_encode_setup(params, {k: jnp.asarray(v) for k, v in batch.items()}, dims_of(batch), H,
                                tf_x=tf_x)
    with torch.no_grad():
        got = dae_encode_setup(port_model(params, batch, "euler"), {k: torch.tensor(v) for k, v in batch.items()},
                               tf_x=tf_x)
    np.testing.assert_allclose(got["i0"].numpy(), np.asarray(want["i0"]), rtol=RTOL, atol=ATOL)
    for k in ("s_de", "s_ae", "s_ae_ev"):
        np.testing.assert_allclose(got["streams"][k].numpy(), np.asarray(want["streams"][k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("solver,zd", [("euler", 1), ("midpoint", 0)])
def test_fused_dae_encode_grads_match_jax_fused(solver, zd):
    batch = dae_batch(dims=(3, zd, 2, 2), seed=2)
    batch["sample_w"] = np.array([1, 1, 0], np.float32)
    _, params = jax_model(batch, solver)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_loss(p):
        out = jax_fused_dae_encode_apply(p, jb, dims_of(batch), H, solver=solver, interpret=True)
        return jlosses.dae_encode_loss(out, jb)[0]

    j_loss, j_grads = jax.value_and_grad(jax_loss)(params)
    model = port_model(params, batch, solver)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    loss, _ = tlosses.dae_encode_loss(fused_dae_encode_apply(model, tb), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    want = {k: np.asarray(v) for k, v in bridge.flatten_params(j_grads["params"]).items()}
    got = flax_grads(model)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("with_w", [False, True])
def test_dae_encode_loss_matches_jax(with_w):
    rng = np.random.default_rng(3)
    batch = dae_batch(B=5, T=7)
    if with_w:
        batch["sample_w"] = np.array([1, 1, 1, 0, 0], np.float32)
    outs = [rng.standard_normal(batch[k].shape).astype(np.float32) for k in ("x", "i", "x", "i")]
    loss_j, aux_j = jlosses.dae_encode_loss([jnp.asarray(o) for o in outs],
                                            {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, aux_t = tlosses.dae_encode_loss([torch.tensor(o) for o in outs],
                                            {k: torch.tensor(v) for k, v in batch.items()})
    assert sorted(aux_t) == sorted(aux_j) == ["i_loss", "loss", "recon_loss", "x_loss"]
    for k in aux_t:
        np.testing.assert_allclose(aux_t[k].item(), float(aux_j[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=RTOL)


@pytest.mark.parametrize("style", ["lecun", "torch"])
def test_init_styles_cover_every_codec(style):
    """``init_params`` draws every dense layer of the model, each codec's
    included, by the style's rule (fan-in = the layer's input
    width): lecun's truncated normal with zero biases, torch's uniform."""
    from py_psnode_tpu_torch.models.initializers import init_params

    model = init_params(DAEEncodeModel(3, 1, 2, 2, 32), style, seed=3)
    layers = [m for m in model.modules() if isinstance(m, torch.nn.Linear)]
    assert len(layers) == 2 * 6 + 3 + 2 + 2  # six codecs, Init, the DE and AE nets
    for m in layers:
        bound = m.in_features ** -0.5
        if style == "lecun":
            assert torch.all(m.bias == 0)
            assert m.weight.abs().max() <= 2 * bound / 0.87962566103423978 + 1e-6
        else:
            assert m.weight.abs().max() <= bound and m.bias.abs().max() <= bound
        assert m.weight.std() > 0.3 * bound


def test_dae_encode_variant():
    v = get_variant("dae_encode")
    assert (v.kind, v.larger_than, v.encode, v.channel_wise) == ("dae", np.pi, True, False)
    assert v.loss_keys == ("x_loss", "i_loss", "loss") and v.batch_args == KEYS
    assert v.fused_apply is fused_dae_encode_apply


def test_zero_wide_z_export_matches_the_jax_recipe(tmp_path):
    """``zd == 0``: the JAX recipe and the port's write the same eight
    submodules (no z encoder) and dim.txt, with the same ``.bin`` bytes;
    the port's ``.pt2`` of de_func takes the zero-wide z."""
    batch = dae_batch(dims=(3, 0, 2, 2), seed=6)
    jm, params = jax_model(batch, "euler")
    dims = dict(x_dim=3, z_dim=0, v_dim=2, i_dim=2)
    JAX_VARIANTS["dae_encode"].export_fn(jm, params, dims, tmp_path / "jax")
    model = port_model(params, batch, "euler")
    get_variant("dae_encode").export_fn(model, dims, tmp_path / "port", True)
    subs = ("x_encoder", "x_decoder", "v_encoder", "i_encoder", "i_decoder", "init_func", "de_func", "ae_func")
    port_files = {p.name for p in (tmp_path / "port").iterdir()}
    assert port_files == {"dim.txt"} | {f"{s}.{e}" for s in subs for e in ("pt2", "weights.npz", "weights.bin")}
    jax_files = {p.name for p in (tmp_path / "jax").iterdir()}
    assert {f for f in jax_files if not f.endswith(".stablehlo")} == {f for f in port_files if not f.endswith(".pt2")}
    for f in sorted(port_files):
        if f.endswith(".bin") or f == "dim.txt":
            assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    rng = np.random.default_rng(7)
    args = [torch.zeros(()), *(torch.tensor(rng.standard_normal((1, w)).astype(np.float32))
                               for w in (3 * H, H, 0, H, H))]
    with np.load(tmp_path / "port" / "de_func.weights.npz") as f:
        weights = {k: torch.tensor(f[k]) for k in f.files}
    got = torch.export.load(tmp_path / "port" / "de_func.pt2").module()(weights, *args)
    with torch.no_grad():
        torch.testing.assert_close(got, model.de_func(*args), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- golden


@pytest.mark.parametrize("widths", [(2, 1, 2, 2), (H, H, H, H)])  # raw widths, latent widths
@pytest.mark.parametrize("events", [True, False])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_port_integrate_dae_matches_numpy_oracle(solver, events, widths):
    rng = np.random.default_rng(8)
    T, B = 12, 3
    xd, zd, vd, idim = widths
    W = {k: rng.normal(size=s) * 0.4 for k, s in (("x", (xd, xd)), ("z", (zd, xd)), ("v", (vd, xd)),
                                                  ("i", (idim, xd)), ("gx", (xd, idim)), ("gz", (zd, idim)),
                                                  ("gv", (vd, idim)))}
    f_np = lambda t, x, z, v, i: np.tanh(x @ W["x"] + z @ W["z"] + v @ W["v"] + i @ W["i"])
    g_np = lambda x, z, v: np.tanh(x @ W["gx"] + z @ W["gz"] + v @ W["gv"])
    Wt = {k: torch.tensor(v) for k, v in W.items()}
    f_t = lambda t, x, z, v, i: torch.tanh(x @ Wt["x"] + z @ Wt["z"] + v @ Wt["v"] + i @ Wt["i"])
    g_t = lambda x, z, v: torch.tanh(x @ Wt["gx"] + z @ Wt["gz"] + v @ Wt["gv"])
    t = np.cumsum(np.full((T, B, 1), 0.02), axis=0) - 0.02
    x, z, v, i = (rng.normal(size=(T, B, d)) for d in (xd, zd, vd, idim))
    x_init = rng.normal(size=(B, xd))
    event_t = z_jump = v_jump = None
    if events:
        event_t = np.stack([[t[3 + b, b, 0], t[8, b, 0]] for b in range(B)])
        z_jump, v_jump = rng.normal(size=(B, 2, zd)), rng.normal(size=(B, 2, vd))
    want_x, want_i = ref.integrate_dae(solver, f_np, g_np, x_init, t, x, z, v, i, event_t=event_t,
                                       z_jump=z_jump, v_jump=v_jump)
    bm = lambda a: torch.tensor(a).transpose(0, 1)
    z_used, v_used, is_event = bm(z), bm(v), None
    if events:
        is_event, e_idx = event_match(bm(t), torch.tensor(event_t))
        z_used = jumped_stream(bm(z), torch.tensor(z_jump), is_event, e_idx)
        v_used = jumped_stream(bm(v), torch.tensor(v_jump), is_event, e_idx)
        is_event = is_event.transpose(0, 1)[:-1]
    got_x, got_i = integrate_dae(solver, f_t, g_t, torch.tensor(x_init), torch.tensor(t), torch.tensor(z),
                                 torch.tensor(v), z_used.transpose(0, 1)[:-1], v_used.transpose(0, 1)[:-1],
                                 is_event=is_event)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got_i.numpy(), want_i, rtol=1e-10, atol=1e-12)


# ------------------------------------------------------------- full size


def make_inputs(root: pathlib.Path):
    """The h=128 starting checkpoint under ``root`` (the motor set is
    committed)."""
    root.mkdir(parents=True, exist_ok=True)
    start_checkpoint(root / "start.ckpt", DAEEncodeModel(3, 1, 2, 2, HIDDEN, device="meta"), seed=0)
    return root


def run_config(data: pathlib.Path, root: pathlib.Path, solver="euler", **kw):
    """TrainConfig keywords (shared by both packages) for one epoch from a
    copy of the starting checkpoint, logging every step."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(data / "start.ckpt", root / "ws.ckpt")
    return dict(variant="dae_encode", train_data=str(TRAIN_DATA), test_data=str(TEST_DATA),
                model=str(root / "run"), num=128, batch=64, epoch=200, hidden=HIDDEN, larger_than=None, seed=0,
                warm_start=str(root / "ws.ckpt"), stop_after=1, loss_record_iter=1, solver=solver,
                echo_logs=False, **kw)


def eval_argv(data: pathlib.Path, root: pathlib.Path):
    """``--testing`` flags on a copy of the starting checkpoint."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(data / "start.ckpt", root / "model_checkpoint.0")
    return ["--testing", "--model", str(root / "model_checkpoint.0"), "--test_data", str(TEST_DATA)]


def jax_anchors(data: pathlib.Path, root: pathlib.Path, solver="euler"):
    """The JAX package on the CPU (the non-fused XLA path): its Trainer's
    step records and epoch-1 eval, and its CLI's ``--testing``
    (x_loss_total, i_loss_total) on the starting checkpoint."""
    jax.config.update("jax_platforms", "cpu")
    from py_psnode_tpu.cli.common import main as jax_main
    from py_psnode_tpu.train.trainer import TrainConfig, Trainer

    _, run_dir = Trainer(TrainConfig(**run_config(data, root / "train", solver, fused=False))).train()
    jax_main("dae_encode", eval_argv(data, root / "test") + ["--solver", solver])
    with np.load(root / "test" / "evaluation.npz", allow_pickle=True) as f:
        test = (float(f["eval"][0]), float(f["eval"][1]))
    return read_metrics(run_dir), test


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("dae_encode"))


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """The JAX package's runs (Euler), once for this file."""
    return jax_anchors(data, tmp_path_factory.mktemp("jax"), "euler")


def test_jax_runs_give_the_written_anchors(jax_run):
    """Step 1 and the evaluation to 1e-6; step 2 and the epoch-1 eval to
    1e-4 (a test session's XLA setup moves them by a few 1e-6 from a
    standalone process's after Adam's first, sign-like update)."""
    ((s1, s2), ev), test = jax_run
    a = ENC_ANCHORS["dae_encode"]["euler"]
    np.testing.assert_allclose([s1["loss"], s1["grad_norm"], *test], [*a["step1"], *a["test"]], rtol=1e-6)
    np.testing.assert_allclose([s2["loss"], s2["grad_norm"], ev["x_loss"], ev["i_loss"]],
                               [*a["step2"], *a["eval1"]], rtol=1e-4)


def test_port_fused_trainer_matches_jax(data, tmp_path, few_threads, jax_run):  # noqa: F811
    from py_psnode_tpu_torch.ops import fused_dae as F
    from py_psnode_tpu_torch.ops import fused_dae_vjp as V
    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    ((j1, j2), j_ev), _ = jax_run
    launches = (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches)
    _, run_dir = Trainer(TrainConfig(**run_config(data, tmp_path, fused=True, device="cpu"))).train()
    # on the CPU the plain versions run: no kernel launch is counted
    assert (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches) == launches
    train, ev = read_metrics(run_dir)
    assert [r["batch"] for r in train] == [1, 2]
    for k in ("loss", "x_loss", "i_loss"):
        np.testing.assert_allclose(train[0][k], j1[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(train[0]["grad_norm"], j1["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose([train[1]["loss"], train[1]["grad_norm"], ev["x_loss"], ev["i_loss"]],
                               [j2["loss"], j2["grad_norm"], j_ev["x_loss"], j_ev["i_loss"]], rtol=1e-3)
    subs = ("x_encoder", "x_decoder", "z_encoder", "v_encoder", "i_encoder", "i_decoder", "init_func", "de_func",
            "ae_func")
    assert {p.name for p in (run_dir / "saved model").iterdir()} == {"dim.txt"} | {
        f"{s}.{e}" for s in subs for e in ("pt2", "weights.npz", "weights.bin")}


def test_port_cli_testing_matches_jax_cli(data, tmp_path, few_threads, jax_run):  # noqa: F811
    from py_psnode_tpu_torch.cli.common import main as port_main

    _, jax_test = jax_run
    res = port_main("dae_encode", eval_argv(data, tmp_path) + ["--fused", "--device", "cpu"])
    np.testing.assert_allclose([res[0], res[1]], jax_test, rtol=1e-5)
    log = (tmp_path / "Model_model_checkpoint.0_Evaluation.log").read_text()
    assert f"x_loss_total: {res[0]:14.10f}, i_loss_total: {res[1]:14.10f}." in log


def test_full_size_losses_are_well_conditioned_in_float32(data, few_threads):  # noqa: F811
    """The plain model's loss terms on the test set from the starting
    checkpoint in float32 and float64 agree far inside 1e-3: the card's
    losses are held to the JAX float32 anchors, not to a float64 run."""
    from py_psnode_tpu_torch.data import DaeSamples
    from py_psnode_tpu_torch.train.checkpoints import load_checkpoint_params

    ds = DaeSamples.load(str(TEST_DATA), cut_length=1001)
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = DAEEncodeModel(3, 1, 2, 2, HIDDEN, device="meta")
        model = bridge.load_params(model, load_checkpoint_params(data / "start.ckpt"), device="cpu").to(dtype)
        b = {k: torch.as_tensor(getattr(ds, k)) for k in KEYS + ("mask",)}
        b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
        with torch.no_grad():
            out[dtype] = tlosses.dae_encode_loss(model(*(b[k] for k in KEYS)), b)[1]
    for k, v in out[torch.float64].items():
        assert abs(out[torch.float32][k].item() - v.item()) <= 1e-5 * abs(v.item()), k


if __name__ == "__main__":
    import tempfile

    if sys.argv[1:] == ["conditioning"]:
        with tempfile.TemporaryDirectory() as tmp:
            conditioning(pathlib.Path(tmp))
        sys.exit(0)
    for solver in sys.argv[1:] or ["euler", "rk4"]:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            (train, ev), test = jax_anchors(make_inputs(tmp / "data"), tmp, solver)
        for r in train:
            print(solver, f"step {r['batch']}: loss {r['loss']:.8g} gradient_norm {r['grad_norm']:.8g}")
        print(solver, f"epoch-1 eval: x_loss {ev['x_loss']:.8g} i_loss {ev['i_loss']:.8g}; --testing "
              f"x_loss_total {test[0]:.8g} i_loss_total {test[1]:.8g}")
