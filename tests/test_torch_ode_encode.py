"""The port's direct-encode ODE against the JAX package, on the CPU.

Small size (h=16, T=8, B=3, events in every row): the same seeded numpy
inputs and the same weights (JAX's initial parameters with random biases,
carried over by ``bridge.load_params``) go through the JAX function and its
counterpart in ``py_psnode_tpu_torch``:

* ``ODEEncodeModel.forward`` against the JAX ``ODEEncodeModel``, each
  solver, with and without events, at rtol 1e-5 / atol 1e-6 (float32 in
  another summation order);
* ``fused_ode_encode_apply`` (on the CPU the plain versions of kernels 3
  and 4 behind the ``autograd.Function``) against the JAX
  ``fused_ode_encode_apply`` in Pallas interpret mode: the forward at rtol
  1e-5 / atol 1e-6, the gradients of ``ode_encode_loss`` at rtol 2e-3 /
  atol 2e-4;
* ``ode_encode_loss`` with and without padded rows;
* the port's plain ``integrate_ode`` against the float64 numpy oracle
  ``tests/np_reference.py`` for each stepper, with and without events, at
  the raw width and at a latent width (rtol 1e-10 in float64).

Full size: the port's AVR data (128 training and 32 test samples, T=1001,
seed 0) and ``chip_smoke.start_checkpoint`` of the h=128 model (seed 0).
One JAX run for the file (its ``Trainer``, non-fused, one epoch of two
steps at batch 64, Euler, and its CLI ``--testing``) checks the anchors
written into ``chip_smoke.py`` (``ENC_ANCHORS``) and holds the port's
fused ``Trainer`` (step 1 at rtol 1e-5 / 1e-4, loss / gradient norm; step
2 and the epoch-1 eval at 1e-3) and its CLI ``--testing --fused`` (rtol
1e-5). ``python tests/test_torch_ode_encode.py [euler rk4]`` prints the
anchors again, ``... conditioning`` both encode variants' first two
training steps in float32 beside float64 (:func:`conditioning`).
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
from test_torch_ode_slice import few_threads, read_metrics  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import ENC_ANCHORS, start_checkpoint  # noqa: E402
from py_psnode_tpu.models import ODEEncodeModel as JaxODEEncodeModel  # noqa: E402
from py_psnode_tpu.ops import fused_ode_encode_apply as jax_fused_ode_encode_apply  # noqa: E402
from py_psnode_tpu.train import losses as jlosses  # noqa: E402
from py_psnode_tpu_torch import bridge  # noqa: E402
from py_psnode_tpu_torch.data.synthetic import write_avr_dataset  # noqa: E402
from py_psnode_tpu_torch.models import ODEEncodeModel  # noqa: E402
from py_psnode_tpu_torch.ops.fused_model import fused_ode_encode_apply  # noqa: E402
from py_psnode_tpu_torch.solvers import event_match, integrate_ode, jumped_stream  # noqa: E402
from py_psnode_tpu_torch.train import losses as tlosses  # noqa: E402
from py_psnode_tpu_torch.train.variants import get_variant  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
KEYS = ("t", "x", "z", "event_t", "z_jump")
H = 16
HIDDEN = 128  # the full-size width


def ode_batch(B=3, T=8, xd=2, zd=2, seed=0, events=True):
    """Seeded batch-major float32 ODE batch; with ``events`` one event a row
    on a grid point (step 2, 3 or 4) beside an inert sentinel."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = (np.cumsum(np.full((B, T, 1), 0.02, np.float32), axis=1) - 0.02).astype(np.float32)
    event_t = np.full((B, 2), -1.0, np.float32)
    if events:
        for b in range(B):
            event_t[b, 0] = t[b, 2 + b % 3, 0]
    mask = (rng.random((B, T, xd)) > 0.2).astype(np.float32)
    return dict(t=t, x=f(B, T, xd), z=f(B, T, zd), event_t=event_t, z_jump=f(B, 2, zd), mask=mask)


def jax_model(batch, solver, seed=0):
    """The JAX model and its initial parameters with random biases (so that
    the bias mapping is exercised)."""
    model = JaxODEEncodeModel(x_dim=batch["x"].shape[-1], z_dim=batch["z"].shape[-1], hidden_dim=H,
                              solver=solver)
    params = model.init(jax.random.PRNGKey(seed), *(jnp.asarray(batch[k]) for k in KEYS))
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    leaves = [l + 0.1 * jax.random.normal(k, l.shape, l.dtype) if l.ndim == 1 else l for l, k in zip(leaves, keys)]
    return model, jax.tree_util.tree_unflatten(tree, leaves)


def port_model(params, batch, solver):
    model = ODEEncodeModel(batch["x"].shape[-1], batch["z"].shape[-1], H, solver=solver, device="meta")
    return bridge.load_params(model, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params),
                              device="cpu")


def flax_grads(model):
    """The port's gradients in the flax layout, flat: ``{"a/b/kernel": [in,
    out]}``."""
    out = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        g = p.grad.t() if leaf == "weight" else p.grad
        out["/".join(path + ["kernel" if leaf == "weight" else leaf])] = g.detach().numpy()
    return out


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("events", [True, False])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_ode_encode_model_matches_jax(solver, events):
    batch = ode_batch(events=events)
    jm, params = jax_model(batch, solver)
    want = jm.apply(params, *(jnp.asarray(batch[k]) for k in KEYS))
    got = port_model(params, batch, solver)(*(torch.tensor(batch[k]) for k in KEYS))
    assert len(got) == 2 and got[0].shape == got[1].shape == (3, 8, 2)
    for g, w, name in zip(got, want, ("x_pred", "x_re")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)


def test_ode_encode_model_parameters_carry_the_flax_paths():
    batch = ode_batch()
    _, params = jax_model(batch, "euler")
    model = port_model(params, batch, "euler")
    names = {n for n, _ in model.named_parameters()}
    assert "x_encoder.net.dense_1.weight" in names and "de_func.x_dot.dense_1.bias" in names
    flat = bridge.flatten_params(bridge.flax_params(model))
    assert sorted(flat) == sorted(bridge.flatten_params(params["params"]))


# ------------------------------------------------------------------ fused


@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_fused_ode_encode_apply_matches_jax_fused(solver):
    batch = ode_batch(seed=1)
    _, params = jax_model(batch, solver)
    want = jax_fused_ode_encode_apply(params, {k: jnp.asarray(v) for k, v in batch.items()}, H, solver=solver,
                                      interpret=True)
    model = port_model(params, batch, solver).requires_grad_(False)
    got = fused_ode_encode_apply(model, {k: torch.tensor(v) for k, v in batch.items()})
    for g, w, name in zip(got, want, ("x_pred", "x_re")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)
    # the plain model gives the same forward
    plain = model(*(torch.tensor(batch[k]) for k in KEYS))
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_fused_ode_encode_grads_match_jax_fused(solver):
    batch = ode_batch(seed=2)
    batch["sample_w"] = np.array([1, 1, 0], np.float32)
    _, params = jax_model(batch, solver)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_loss(p):
        return jlosses.ode_encode_loss(jax_fused_ode_encode_apply(p, jb, H, solver=solver, interpret=True), jb)[0]

    j_loss, j_grads = jax.value_and_grad(jax_loss)(params)
    model = port_model(params, batch, solver)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    loss, _ = tlosses.ode_encode_loss(fused_ode_encode_apply(model, tb), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    want = {k: np.asarray(v) for k, v in bridge.flatten_params(j_grads["params"]).items()}
    got = flax_grads(model)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("with_w", [False, True])
def test_ode_encode_loss_matches_jax(with_w):
    rng = np.random.default_rng(3)
    batch = ode_batch(B=5, T=7)
    if with_w:
        batch["sample_w"] = np.array([1, 1, 1, 0, 0], np.float32)
    outs = [rng.standard_normal(batch["x"].shape).astype(np.float32) for _ in range(2)]
    loss_j, aux_j = jlosses.ode_encode_loss([jnp.asarray(o) for o in outs],
                                            {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, aux_t = tlosses.ode_encode_loss([torch.tensor(o) for o in outs],
                                            {k: torch.tensor(v) for k, v in batch.items()})
    assert sorted(aux_t) == sorted(aux_j) == ["loss", "recon_loss", "x0_loss", "x_loss"]
    for k in aux_t:
        np.testing.assert_allclose(aux_t[k].item(), float(aux_j[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=RTOL)


def test_ode_encode_variant():
    v = get_variant("ode_encode")
    assert (v.kind, v.larger_than, v.encode, v.channel_wise) == ("ode", None, True, False)
    assert v.loss_keys == ("x_loss", "loss") and v.batch_args == KEYS
    assert v.fused_apply is fused_ode_encode_apply
    import py_psnode_tpu_torch.train.variants as variants

    assert not hasattr(variants, "NOT_PORTED")


# ----------------------------------------------------------------- golden


@pytest.mark.parametrize("width", [2, H])  # the raw state and the latent width
@pytest.mark.parametrize("events", [True, False])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_port_integrate_ode_matches_numpy_oracle(solver, events, width):
    rng = np.random.default_rng(4)
    T, B, zd = 12, 3, 3
    Wx, Wz = rng.normal(size=(width, width)) * 0.4, rng.normal(size=(zd, width)) * 0.4
    f_np = lambda t, x, z: np.tanh(x @ Wx + z @ Wz)
    Tx, Tz = torch.tensor(Wx), torch.tensor(Wz)
    f_t = lambda t, x, z: torch.tanh(x @ Tx + z @ Tz)
    t = np.cumsum(np.full((T, B, 1), 0.02), axis=0) - 0.02
    x, z = rng.normal(size=(T, B, width)), rng.normal(size=(T, B, zd))
    event_t = z_jump = None
    if events:
        event_t = np.stack([[t[3 + b, b, 0], t[8, b, 0]] for b in range(B)])
        z_jump = rng.normal(size=(B, 2, zd))
    want = ref.integrate_ode(solver, f_np, t, x, z, event_t=event_t, z_jump=z_jump)
    bm = lambda a: torch.tensor(a).transpose(0, 1)
    z_used = bm(z)
    if events:
        is_event, e_idx = event_match(bm(t), torch.tensor(event_t))
        z_used = jumped_stream(bm(z), torch.tensor(z_jump), is_event, e_idx)
    got = integrate_ode(solver, f_t, torch.tensor(t), torch.tensor(x[0]), z_used.transpose(0, 1)[:-1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


# ------------------------------------------------------------- full size


def make_inputs(root: pathlib.Path):
    """The AVR data set and the h=128 starting checkpoint under ``root``."""
    write_avr_dataset(root, n_train=128, n_test=32, n_steps=1001, seed=0)
    start_checkpoint(root / "start.ckpt", ODEEncodeModel(2, 2, HIDDEN, device="meta"), seed=0)
    return root


def run_config(data: pathlib.Path, root: pathlib.Path, solver="euler", **kw):
    """TrainConfig keywords (shared by both packages) for one epoch from a
    copy of the starting checkpoint, logging every step."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(data / "start.ckpt", root / "ws.ckpt")
    return dict(variant="ode_encode", train_data=str(data / "training.npz"), test_data=str(data / "testing.npz"),
                model=str(root / "run"), num=128, batch=64, epoch=200, hidden=HIDDEN, larger_than=None, seed=0,
                warm_start=str(root / "ws.ckpt"), stop_after=1, loss_record_iter=1, solver=solver,
                echo_logs=False, **kw)


def eval_argv(data: pathlib.Path, root: pathlib.Path):
    """``--testing`` flags on a copy of the starting checkpoint."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(data / "start.ckpt", root / "model_checkpoint.0")
    return ["--testing", "--model", str(root / "model_checkpoint.0"), "--test_data", str(data / "testing.npz")]


def jax_anchors(data: pathlib.Path, root: pathlib.Path, solver="euler"):
    """The JAX package on the CPU (the non-fused XLA path): its Trainer's
    step records and epoch-1 eval, and its CLI's ``--testing``
    x_loss_total on the starting checkpoint."""
    jax.config.update("jax_platforms", "cpu")
    from py_psnode_tpu.cli.common import main as jax_main
    from py_psnode_tpu.train.trainer import TrainConfig, Trainer

    _, run_dir = Trainer(TrainConfig(**run_config(data, root / "train", solver, fused=False))).train()
    jax_main("ode_encode", eval_argv(data, root / "test") + ["--solver", solver])
    with np.load(root / "test" / "evaluation.npz", allow_pickle=True) as f:
        test_x = float(f["eval"][0])
    return read_metrics(run_dir), test_x


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("avr"))


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """The JAX package's runs (Euler), once for this file."""
    return jax_anchors(data, tmp_path_factory.mktemp("jax"), "euler")


def test_jax_runs_give_the_written_anchors(jax_run):
    """Step 1 and the evaluation to 1e-6; step 2 and the epoch-1 eval to
    1e-4 (after Adam's first, sign-like update a test session's XLA setup
    moves them by a few 1e-6 from a standalone process's)."""
    ((s1, s2), ev), test_x = jax_run
    a = ENC_ANCHORS["ode_encode"]["euler"]
    np.testing.assert_allclose([s1["loss"], s1["grad_norm"], test_x], [*a["step1"], *a["test"]], rtol=1e-6)
    np.testing.assert_allclose([s2["loss"], s2["grad_norm"], ev["x_loss"]], [*a["step2"], *a["eval1"]],
                               rtol=1e-4)


def test_port_fused_trainer_matches_jax(data, tmp_path, few_threads, jax_run):  # noqa: F811
    from py_psnode_tpu_torch.ops import fused_ode as F
    from py_psnode_tpu_torch.ops import fused_ode_vjp as V
    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    ((j1, j2), j_ev), _ = jax_run
    launches = (F.fused_ode_rollout.launches, V.fused_ode_rollout_bwd.launches)
    _, run_dir = Trainer(TrainConfig(**run_config(data, tmp_path, fused=True, device="cpu"))).train()
    # on the CPU the plain versions run: no kernel launch is counted
    assert (F.fused_ode_rollout.launches, V.fused_ode_rollout_bwd.launches) == launches
    train, ev = read_metrics(run_dir)
    assert [r["batch"] for r in train] == [1, 2]
    for k in ("loss", "x_loss"):
        np.testing.assert_allclose(train[0][k], j1[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(train[0]["grad_norm"], j1["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose([train[1]["loss"], train[1]["grad_norm"], ev["x_loss"]],
                               [j2["loss"], j2["grad_norm"], j_ev["x_loss"]], rtol=1e-3)
    saved = run_dir / "saved model"
    assert {p.name for p in saved.iterdir()} == {"dim.txt"} | {
        f"{s}.{e}" for s in ("x_encoder", "x_decoder", "z_encoder", "de_func")
        for e in ("pt2", "weights.npz", "weights.bin")}


def test_port_cli_testing_matches_jax_cli(data, tmp_path, few_threads, jax_run):  # noqa: F811
    from py_psnode_tpu_torch.cli.common import main as port_main

    _, jax_x = jax_run
    res = port_main("ode_encode", eval_argv(data, tmp_path) + ["--fused", "--device", "cpu"])
    np.testing.assert_allclose(res[0], jax_x, rtol=1e-5)
    log = (tmp_path / "Model_model_checkpoint.0_Evaluation.log").read_text()
    assert f"x_loss_total: {res[0]:14.10f}." in log


def test_full_size_losses_are_well_conditioned_in_float32(data, few_threads):  # noqa: F811
    """The plain model's ``--testing`` x loss and training loss from the
    starting checkpoint in float32 and float64 agree far inside 1e-3: the
    card's losses are held to the JAX float32 anchors, not to a float64
    run (``chip_smoke.ODE_F64_RATIO`` is for ill-conditioned inputs)."""
    from py_psnode_tpu_torch.data import OdeSamples
    from py_psnode_tpu_torch.train.checkpoints import load_checkpoint_params

    ds = OdeSamples.load(str(data / "testing.npz"))
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = ODEEncodeModel(2, 2, HIDDEN, device="meta")
        model = bridge.load_params(model, load_checkpoint_params(data / "start.ckpt"), device="cpu").to(dtype)
        b = {k: torch.as_tensor(getattr(ds, k)) for k in KEYS + ("mask",)}
        b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
        with torch.no_grad():
            out[dtype] = tlosses.ode_encode_loss(model(*(b[k] for k in KEYS)), b)[1]
    for k, v in out[torch.float64].items():
        assert abs(out[torch.float32][k].item() - v.item()) <= 1e-5 * abs(v.item()), k


def conditioning(root: pathlib.Path):
    """Both encode variants' first two training steps (the Trainer's
    epoch-1 batches, Adam at lr 5e-3) from their starting checkpoints, the
    plain model in float32 and in float64: prints each step's loss and
    gradient norm and their relative distance. A loss whose float32 and
    float64 runs lie more than 1e-3 apart is ill-conditioned."""
    from chip_smoke import TRAIN_DATA
    from py_psnode_tpu_torch.data import DaeSamples, OdeSamples
    from py_psnode_tpu_torch.models import DAEEncodeModel
    from py_psnode_tpu_torch.train.checkpoints import load_checkpoint_params
    from py_psnode_tpu_torch.train.optim import make_optimizer, reference_grad_norm

    make_inputs(root / "ode")
    dae_start = start_checkpoint(root / "dae.ckpt", DAEEncodeModel(3, 1, 2, 2, HIDDEN, device="meta"), seed=0)
    cases = (("ode_encode", lambda: ODEEncodeModel(2, 2, HIDDEN, device="meta"), root / "ode" / "start.ckpt",
              OdeSamples.load(str(root / "ode" / "training.npz"), num_sample=128, cut_length=1001), KEYS,
              tlosses.ode_encode_loss),
             ("dae_encode", lambda: DAEEncodeModel(3, 1, 2, 2, HIDDEN, device="meta"), dae_start,
              DaeSamples.load(str(TRAIN_DATA), num_sample=128, cut_length=1001),
              ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump"), tlosses.dae_encode_loss))
    for name, make, ckpt, ds, keys, loss_fn in cases:
        runs = {}
        for dtype in (torch.float32, torch.float64):
            model = bridge.load_params(make(), load_checkpoint_params(ckpt), device="cpu").to(dtype)
            opt = make_optimizer(model.parameters(), 5e-3, 200, 2)
            order = np.random.default_rng(1).permutation(len(ds))  # the Trainer's epoch-1 order (seed 0)
            runs[dtype] = []
            for start in (0, 64):
                b = {k: torch.as_tensor(getattr(ds, k)[order[start:start + 64]]) for k in keys + ("mask",)}
                b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
                opt.adam.zero_grad()
                loss, _ = loss_fn(model(*(b[k] for k in keys)), b)
                loss.backward()
                gnorm = reference_grad_norm([p.grad for p in model.parameters()])
                runs[dtype] += [loss.item(), gnorm.item()]
                opt.step()
        for k, what in enumerate(("step-1 loss", "step-1 gradient_norm", "step-2 loss", "step-2 gradient_norm")):
            a, b = runs[torch.float32][k], runs[torch.float64][k]
            print(f"{name} {what}: float32 {a:.8g}, float64 {b:.10g}, relative distance {abs(a - b) / abs(b):.2e}")


if __name__ == "__main__":
    import tempfile

    if sys.argv[1:] == ["conditioning"]:
        with tempfile.TemporaryDirectory() as tmp:
            conditioning(pathlib.Path(tmp))
        sys.exit(0)
    for solver in sys.argv[1:] or ["euler", "rk4"]:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            (train, ev), test_x = jax_anchors(make_inputs(tmp / "data"), tmp, solver)
        for r in train:
            print(solver, f"step {r['batch']}: loss {r['loss']:.8g} gradient_norm {r['grad_norm']:.8g}")
        print(solver, f"epoch-1 eval: x_loss {ev['x_loss']:.8g}; --testing x_loss_total {test_x:.8g}")
