"""Parity of the PyTorch port's modules with the JAX package, on the CPU.

Same seeded numpy inputs (float32) through the JAX function and its
counterpart in ``py_psnode_tpu_torch``; tolerance rtol 1e-5 / atol 1e-6
(float32 arithmetic in a different summation order).
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py_psnode_tpu.data.schema import DaeSamples as JaxDaeSamples
from py_psnode_tpu.export.artifacts import save_params_npz
from py_psnode_tpu.models import funcs as jfuncs
from py_psnode_tpu.models.dae import DAEModel as JaxDAEModel
from py_psnode_tpu.parallel.mesh import pad_batch as jax_pad_batch
from py_psnode_tpu.solvers import events as jevents
from py_psnode_tpu.solvers import steppers as jsteppers
from py_psnode_tpu.train import checkpoints as jckpt
from py_psnode_tpu.train import evaluate as jeval
from py_psnode_tpu.utils.logging import Logger as JaxLogger

from py_psnode_tpu_torch import bridge
from py_psnode_tpu_torch.data import DaeSamples
from py_psnode_tpu_torch.models import funcs as tfuncs
from py_psnode_tpu_torch.models.dae import DAEModel
from py_psnode_tpu_torch.solvers import event_match, get_stepper, jumped_stream
from py_psnode_tpu_torch.train import checkpoints as tckpt
from py_psnode_tpu_torch.train import evaluate as teval
from py_psnode_tpu_torch.utils.batching import pad_batch
from py_psnode_tpu_torch.utils.logging import Logger

RTOL, ATOL = 1e-5, 1e-6
REPO = pathlib.Path(__file__).resolve().parents[1]
MOTOR_TEST = REPO / "benchmarks/h2h_work_prod_s0/data_dae_motor/testing.npz"


def _close(a, b, rtol=RTOL, atol=ATOL):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _np_tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def dae_batch(B=4, T=41, dims=(3, 1, 2, 2), seed=0):
    """Seeded DAE batch with per-sample event schedules on grid points (and
    one inert sentinel), float32, batch-major."""
    xd, zd, vd, idim = dims
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = np.tile((np.arange(T, dtype=np.float32) * np.float32(0.01))[None, :, None], (B, 1, 1))
    event_t = np.stack([t[:, 7, 0], t[:, 12, 0]], axis=1).copy()
    event_t[1, 0] = -1.0  # sentinel: matches no grid time
    event_t[2] = t[2, [3, 20], 0]
    return dict(
        t=t, x=f(B, T, xd), z=f(B, T, zd), v=f(B, T, vd), i=f(B, T, idim),
        event_t=event_t, z_jump=f(B, 2, zd), v_jump=f(B, 2, vd),
        mask=np.ones((B, T, 1), np.float32),
    )


def jax_dae_params(batch, hidden, solver, seed=0):
    dims = tuple(batch[k].shape[-1] for k in ("x", "z", "v", "i"))
    model = JaxDAEModel(*dims, hidden_dim=hidden, solver=solver, remat=False)
    args = [jnp.asarray(batch[k]) for k in ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")]
    params = model.init(jax.random.PRNGKey(seed), *args)
    # random biases too, so that the bias mapping is exercised
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    leaves = [l + 0.1 * jax.random.normal(k, l.shape, l.dtype) if l.ndim == 1 else l
              for l, k in zip(leaves, keys)]
    return model, jax.tree_util.tree_unflatten(tree, leaves), args


# ------------------------------------------------------------------ events


def test_event_match_and_jumped_stream():
    b = dae_batch()
    is_ev, e_idx = jevents.event_match(jnp.asarray(b["t"]), jnp.asarray(b["event_t"]))
    t_is_ev, t_e_idx = event_match(torch.tensor(b["t"]), torch.tensor(b["event_t"]))
    np.testing.assert_array_equal(t_is_ev.numpy(), np.asarray(is_ev))
    np.testing.assert_array_equal(t_e_idx.numpy(), np.asarray(e_idx))
    assert t_is_ev.sum() == 7  # 2 + 1 + 2 + 2 matches, the sentinel is inert
    for k in ("z", "v"):
        ref = jevents.jumped_stream(jnp.asarray(b[k]), jnp.asarray(b[k + "_jump"]), is_ev, e_idx)
        got = jumped_stream(torch.tensor(b[k]), torch.tensor(b[k + "_jump"]), t_is_ev, t_e_idx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_event_match_without_events():
    t = torch.zeros(2, 5, 1)
    is_ev, e_idx = event_match(t, None)
    assert not is_ev.any() and e_idx.shape == (2, 5)
    s = torch.ones(2, 5, 3)
    assert jumped_stream(s, None, is_ev, e_idx) is s


# ------------------------------------------------------------------- funcs


@pytest.mark.parametrize("features", [(16, 16, 3), (16, 5)])
def test_mlp(features):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 7)).astype(np.float32)
    jm = jfuncs.MLP(features)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = bridge.load_params(tfuncs.MLP(7, features), _np_tree(params))
    _close(tm(torch.tensor(x)), jm.apply(params, jnp.asarray(x)))


def test_defunc_aefunc_initfunc():
    rng = np.random.default_rng(2)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    xd, zd, vd, idim, h, B = 3, 1, 2, 2, 16, 5
    d_u = xd + zd + vd + idim
    init, x, z, v, i = f(B, d_u), f(B, xd), f(B, zd), f(B, vd), f(B, idim)
    J = lambda *a: [jnp.asarray(u) for u in a]
    T = lambda *a: [torch.tensor(u) for u in a]

    jde = jfuncs.DEFunc((h, h, h, xd))
    p = jde.init(jax.random.PRNGKey(0), 0.0, *J(init, x, z, v, i))
    tde = bridge.load_params(tfuncs.DEFunc(d_u, (h, h, h, xd)), _np_tree(p))
    _close(tde(0.0, *T(init, x, z, v, i)), jde.apply(p, 0.0, *J(init, x, z, v, i)))

    jae = jfuncs.AEFunc((h, h, h, idim))
    p = jae.init(jax.random.PRNGKey(1), *J(init, x, z, v))
    tae = bridge.load_params(tfuncs.AEFunc(d_u + xd + zd + vd, (h, h, h, idim)), _np_tree(p))
    _close(tae(*T(init, x, z, v)), jae.apply(p, *J(init, x, z, v)))

    jin = jfuncs.InitFunc((h, h, xd))
    p = jin.init(jax.random.PRNGKey(2), *J(z, v, i))
    tin = bridge.load_params(tfuncs.InitFunc(zd + vd + idim, (h, h, xd)), _np_tree(p))
    _close(tin(*T(z, v, i)), jin.apply(p, *J(z, v, i)))


def test_elu_matches_flax():
    x = np.linspace(-30, 5, 101, dtype=np.float32)
    _close(tfuncs.elu(torch.tensor(x)), jax.nn.elu(jnp.asarray(x)))


# ---------------------------------------------------------------- steppers


@pytest.mark.parametrize("name", ["euler", "midpoint", "rk4", "rk4_38"])
def test_steppers(name):
    rng = np.random.default_rng(3)
    A = (rng.standard_normal((4, 4)) * 0.5).astype(np.float32)
    x0 = rng.standard_normal((3, 4)).astype(np.float32)
    jf = lambda t, x: jnp.tanh(x @ jnp.asarray(A)) + t
    tf = lambda t, x: torch.tanh(x @ torch.tensor(A)) + t
    dt = np.float32(0.05)
    ref = jsteppers.get_stepper(name)(jf, np.float32(0.1), dt, np.float32(0.15), jnp.asarray(x0))
    got = get_stepper(name)(tf, torch.tensor(0.1), torch.tensor(dt), torch.tensor(0.15), torch.tensor(x0))
    _close(got, ref)


def test_unknown_stepper_names_choices():
    with pytest.raises(ValueError, match="rk4"):
        get_stepper("heun")


# ------------------------------------------------------------------ bridge


def test_bridge_checkpoint_npz_roundtrip(tmp_path):
    b = dae_batch()
    _, params, _ = jax_dae_params(b, 16, "euler")
    path = tmp_path / "model_checkpoint.3"
    save_params_npz(path, params)
    tree = tckpt.load_checkpoint_params(path)
    flat_j = bridge.flatten_params(_np_tree(params))
    assert bridge.flatten_params(tree).keys() == flat_j.keys()
    model = bridge.load_params(DAEModel(3, 1, 2, 2, 16, device="meta"), tree, device="cpu")
    W = model.de_func.x_dot.dense_0.weight
    K = flat_j["params/de_func/x_dot/dense_0/kernel"]
    assert W.shape == (K.shape[1], K.shape[0])  # flax [in, out] -> torch [out, in]
    np.testing.assert_array_equal(W.detach().numpy(), K.T)
    back = bridge.flatten_params(bridge.flax_params(model))
    for k, v in flat_j.items():
        np.testing.assert_array_equal(back[k[len("params/"):]].detach().numpy(), v)


def test_bridge_rejects_orbax_dir_and_missing_keys(tmp_path):
    d = tmp_path / "model_checkpoint.5"
    d.mkdir()
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load_checkpoint_params(d)
    b = dae_batch()
    _, params, _ = jax_dae_params(b, 16, "euler")
    tree = _np_tree(params)
    del tree["params"]["ae_func"]["i_calculator"]["dense_3"]
    with pytest.raises(RuntimeError, match="Missing key"):
        bridge.load_params(DAEModel(3, 1, 2, 2, 16), tree)


# ------------------------------------------------- DAE model, plain rollout


@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_dae_model_plain_rollout(solver):
    b = dae_batch()
    jm, params, args = jax_dae_params(b, 16, solver)
    x_ref, i_ref = jm.apply(params, *args)
    model = bridge.load_params(DAEModel(3, 1, 2, 2, 16, solver=solver), _np_tree(params))
    with torch.no_grad():
        x, i = model(*[torch.tensor(b[k]) for k in ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")])
    assert x.shape == (4, 41, 3) and i.shape == (4, 41, 2)
    _close(x, x_ref)
    _close(i, i_ref)


# -------------------------------------------------------------------- data


def test_dae_samples_load_and_batches():
    kw = dict(num_sample=8, cut_length=50, contain_larger_than=0.5)
    ref, got = JaxDaeSamples.load(str(MOTOR_TEST), **kw), DaeSamples.load(str(MOTOR_TEST), **kw)
    for k in ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump", "mask", "data_name"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    assert len(got) == 8 and got.n_steps == 50
    for rb, gb in zip(ref.batches(3, shuffle=True, seed=4), got.batches(3, shuffle=True, seed=4)):
        assert rb.keys() == gb.keys()
        for k in rb:
            np.testing.assert_array_equal(gb[k], rb[k])


def test_pad_batch():
    b = dae_batch(B=3)
    ref, got = jax_pad_batch(dict(b), 4), pad_batch(dict(b), 4)
    for k in b:
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["mask"][3].sum() == 0
    assert pad_batch(b, 3) is b


# ------------------------------------------------------------- checkpoints


def test_checkpoint_discovery(tmp_path):
    for e in (1, 2, 3, 10):
        (tmp_path / f"model_checkpoint.{e}").write_bytes(b"")
    evals = np.empty(11, dtype=object)
    for r in range(11):
        evals[r] = np.array([5.0 - (r == 2) * 4.0 - (r == 7) * 4.5, 0.0], dtype=object)
    np.savez(tmp_path / "train_and_eval.npz", eval=evals)
    assert tckpt.list_checkpoints(tmp_path) == jckpt.list_checkpoints(tmp_path)
    assert tckpt.best_checkpoint(tmp_path) == jckpt.best_checkpoint(tmp_path)
    assert tckpt.best_checkpoint(tmp_path)[0] == 2  # epoch 7 has no checkpoint
    assert tckpt.resolve_checkpoint(tmp_path) == jckpt.resolve_checkpoint(tmp_path)
    f = tmp_path / "model_checkpoint.3"
    assert tckpt.resolve_checkpoint(f) == f
    (tmp_path / "empty_run").mkdir()
    with pytest.raises(FileNotFoundError):
        tckpt.resolve_checkpoint(tmp_path / "empty_run")
    assert tckpt.list_checkpoints(tmp_path / "missing") == []


# -------------------------------------------------------- logging and eval


def test_logger_and_evaluate_dae_match(tmp_path):
    rng = np.random.default_rng(5)
    N, T = 7, 12
    ds = DaeSamples.load(str(MOTOR_TEST), num_sample=N, cut_length=T)
    preds = {
        "x_loss_ps": rng.random((N, 3)).astype(np.float32),
        "i_loss_ps": rng.random((N, 2)).astype(np.float32),
    }
    fn = lambda idx: {k: v[idx] for k, v in preds.items()}
    tfn = lambda idx: {k: torch.tensor(v[idx]) for k, v in preds.items()}
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    with JaxLogger(tmp_path / "j", test_log_name="e.log", echo=False) as jl:
        ref = jeval.evaluate_dae(fn, ds, 3, jl, desc="d")
    with Logger(tmp_path / "t", test_log_name="e.log", echo=False) as tl:
        got = teval.evaluate_dae(tfn, ds, 3, tl, desc="d")
    assert (tmp_path / "t" / "e.log").read_text() == (tmp_path / "j" / "e.log").read_text()
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(r))
    x, y = rng.random((N, T, 3)), rng.random((N, T, 3))
    m = rng.random((N, T, 1))
    np.testing.assert_array_equal(teval._per_sample_loss(x, y, m), jeval._per_sample_loss(x, y, m))


def test_run_eval_pads_the_last_batch():
    seen = []

    def fn(idx):
        seen.append(len(idx))
        return {"a": torch.tensor(idx, dtype=torch.float32)[:, None]}

    out = teval._run_eval(fn, 7, 3)
    assert seen == [3, 3, 3]
    np.testing.assert_array_equal(out["a"][:, 0], np.arange(7))


# ----------------------------------------------------------- package rules


def test_port_imports_no_jax():
    """Every module of the port imports without JAX, flax, optax, orbax or
    the JAX package (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import py_psnode_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'py_psnode_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('py_psnode_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
