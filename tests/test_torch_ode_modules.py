"""Parity of the port's ODE modules with the JAX package, on the CPU.

Same seeded numpy inputs through the JAX function and its counterpart in
``py_psnode_tpu_torch``: the AVR generator and the ODE dataset exactly
(``np.array_equal``), the model forward, the loss and the evaluation at
rtol 1e-5 / atol 1e-6 (float32 in another summation order), the log lines
character for character.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py_psnode_tpu.data import synthetic as jsynth
from py_psnode_tpu.data.schema import OdeSamples as JaxOdeSamples
from py_psnode_tpu.export.artifacts import save_params_npz
from py_psnode_tpu.models.ode import ODEModel as JaxODEModel
from py_psnode_tpu.train import evaluate as jeval
from py_psnode_tpu.train import losses as jlosses
from py_psnode_tpu.utils.logging import Logger as JaxLogger

from py_psnode_tpu_torch import bridge
from py_psnode_tpu_torch.data import OdeSamples, synthetic
from py_psnode_tpu_torch.models import ODEModel
from py_psnode_tpu_torch.train import evaluate as teval
from py_psnode_tpu_torch.train import losses as tlosses
from py_psnode_tpu_torch.train.variants import VARIANTS, dataset_dims, get_variant
from py_psnode_tpu_torch.utils.logging import Logger

RTOL, ATOL = 1e-5, 1e-6
KEYS = ("t", "x", "z", "event_t", "z_jump")


def ode_batch(B=4, T=9, xd=2, zd=2, seed=0, events=True):
    """Seeded ODE batch, batch-major float32, with per-sample events on grid
    points (or only inert sentinels)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = (np.cumsum(np.full((B, T, 1), 0.02, np.float32), axis=1) - 0.02).astype(np.float32)
    event_t = np.full((B, 2), -1.0, np.float32)
    if events:
        for b in range(B):
            event_t[b, 0] = t[b, 2 + b % 3, 0]
        event_t[0, 1] = t[0, T - 2, 0]
    return dict(t=t, x=f(B, T, xd), z=f(B, T, zd), event_t=event_t, z_jump=f(B, 2, zd),
                mask=np.ones((B, T, xd), np.float32))


def jax_ode_params(batch, hidden, solver, seed=0):
    """JAX ODEModel params with random biases, so that the bias mapping is
    exercised."""
    model = JaxODEModel(x_dim=batch["x"].shape[-1], z_dim=batch["z"].shape[-1],
                        hidden_dim=hidden, solver=solver)
    args = [jnp.asarray(batch[k]) for k in KEYS]
    params = model.init(jax.random.PRNGKey(seed), *args)
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    leaves = [l + 0.1 * jax.random.normal(k, l.shape, l.dtype) if l.ndim == 1 else l
              for l, k in zip(leaves, keys)]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    return model, params, args


def port_model(params, batch, hidden, solver):
    model = ODEModel(batch["x"].shape[-1], batch["z"].shape[-1], hidden, solver=solver,
                     device="meta")
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    return bridge.load_params(model, np_params, device="cpu")


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("seed", [0, 7])
def test_write_avr_dataset_is_array_identical(tmp_path, seed):
    j_train, j_test = jsynth.write_avr_dataset(tmp_path / "j", n_train=6, n_test=3, n_steps=101,
                                               seed=seed)
    t_train, t_test = synthetic.write_avr_dataset(tmp_path / "t", n_train=6, n_test=3,
                                                  n_steps=101, seed=seed)
    for jf, tf in ((j_train, t_train), (j_test, t_test)):
        with np.load(jf, allow_pickle=True) as a, np.load(tf, allow_pickle=True) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("larger_than", [None, 3.29])
def test_ode_samples_load_is_identical(tmp_path, larger_than):
    train, _ = synthetic.write_avr_dataset(tmp_path, n_train=12, n_test=2, n_steps=31, seed=3)
    ref = JaxOdeSamples.load(str(train), num_sample=5, cut_length=21,
                             contain_larger_than=larger_than)
    got = OdeSamples.load(str(train), num_sample=5, cut_length=21,
                          contain_larger_than=larger_than)
    for k in ("data_name", "t", "x", "z", "event_t", "z_jump", "mask"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)
    assert len(got) == 5 and got.n_steps == 21
    assert [b["t"].shape[0] for b in got.batches(2)] == [2, 2, 1]


def test_ode_samples_mask_defaults_to_ones(tmp_path):
    data = synthetic.generate_avr_samples(3, n_steps=11, seed=1)
    data.pop("mask")
    synthetic.save_ode_samples(tmp_path / "m.npz", **data)
    got = OdeSamples.load(str(tmp_path / "m.npz"))
    ref = JaxOdeSamples.load(str(tmp_path / "m.npz"))
    np.testing.assert_array_equal(got.mask, np.ones_like(got.x))
    np.testing.assert_array_equal(got.mask, ref.mask)


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("events", [True, False])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_ode_model_matches_jax(solver, events):
    batch = ode_batch(events=events)
    jmodel, params, args = jax_ode_params(batch, 16, solver)
    ref = jmodel.apply(params, *args)
    model = port_model(params, batch, 16, solver)
    got = model(*[torch.tensor(batch[k]) for k in KEYS])
    assert got.shape == (4, 9, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[:, 0].detach().numpy(), batch["x"][:, 0])


def test_jax_checkpoint_loads_strictly(tmp_path):
    batch = ode_batch()
    _, params, _ = jax_ode_params(batch, 16, "euler")
    save_params_npz(tmp_path / "model_checkpoint.3", params)
    tree = bridge.load_params_npz(tmp_path / "model_checkpoint.3")
    model = bridge.load_params(ODEModel(2, 2, 16, device="meta"), tree, device="cpu")
    names = sorted(n for n, _ in model.named_parameters())
    assert names == sorted(f"de_func.x_dot.dense_{k}.{p}" for k in range(4) for p in ("weight", "bias"))
    np.testing.assert_array_equal(model.de_func.x_dot.dense_0.weight.detach().numpy(),
                                  np.asarray(params["params"]["de_func"]["x_dot"]["dense_0"]["kernel"]).T)
    del tree["params"]["de_func"]["x_dot"]["dense_3"]
    with pytest.raises(RuntimeError, match="Missing key"):
        bridge.load_params(ODEModel(2, 2, 16, device="meta"), tree, device="cpu")


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("with_w", [False, True])
def test_ode_no_encode_loss_matches_jax(with_w):
    rng = np.random.default_rng(2)
    batch = ode_batch(B=5, T=7)
    batch["mask"] = (rng.random(batch["mask"].shape) > 0.2).astype(np.float32)
    if with_w:
        batch["sample_w"] = np.array([1, 1, 1, 0, 0], np.float32)
    pred = rng.standard_normal(batch["x"].shape).astype(np.float32)
    loss_j, aux_j = jlosses.ode_no_encode_loss(jnp.asarray(pred), {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, aux_t = tlosses.ode_no_encode_loss(torch.tensor(pred), {k: torch.tensor(v) for k, v in batch.items()})
    assert sorted(aux_t) == sorted(aux_j) == ["loss", "x0_loss", "x_loss"]
    for k in aux_t:
        np.testing.assert_allclose(aux_t[k].item(), float(aux_j[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    # x0_loss is computed but not added
    assert aux_t["x0_loss"].item() > 0
    assert loss_t.item() == aux_t["x_loss"].item()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=RTOL)


# ------------------------------------------------------------- evaluation


def test_evaluate_ode_and_summary_match(tmp_path):
    rng = np.random.default_rng(5)
    train, _ = synthetic.write_avr_dataset(tmp_path / "d", n_train=7, n_test=2, n_steps=12, seed=0)
    ds = OdeSamples.load(str(train))
    evals_j, evals_t = [], []
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    with JaxLogger(tmp_path / "j", test_log_name="e.log", echo=False) as jl, \
            Logger(tmp_path / "t", test_log_name="e.log", echo=False) as tl:
        for epoch in range(3):
            preds = rng.random((7, 2)).astype(np.float32)
            evals_j.append(jeval.evaluate_ode(lambda idx: {"x_loss_ps": preds[idx]}, ds, 3, jl,
                                              desc=f"Testing_Epoch_{epoch}"))
            evals_t.append(teval.evaluate_ode(lambda idx: {"x_loss_ps": torch.tensor(preds[idx])},
                                              ds, 3, tl, desc=f"Testing_Epoch_{epoch}"))
        jeval.output_training_process_ode(jl, evals_j)
        teval.output_training_process_ode(tl, evals_t)
    log = (tmp_path / "t" / "e.log").read_text()
    assert log == (tmp_path / "j" / "e.log").read_text()
    assert "Testing_Epoch_2: x_loss_total:" in log and "i_loss" not in log
    for got, ref in zip(evals_t, evals_j):
        assert len(got) == 2
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
        assert got[0] == ref[0]


# --------------------------------------------------------------- registry


def test_ode_no_encode_variant(tmp_path):
    v = get_variant("ode_no_encode")
    assert (v.kind, v.larger_than, v.loss_keys) == ("ode", 3.29, ("x_loss", "loss"))
    assert v.batch_args == ("t", "x", "z", "event_t", "z_jump")
    train, _ = synthetic.write_avr_dataset(tmp_path, n_train=2, n_test=1, n_steps=5, seed=0)
    assert dataset_dims(v, OdeSamples.load(str(train))) == dict(x_dim=2, z_dim=2)
    assert get_variant("dae_no_encode").loss_keys == ("x_loss", "i_loss", "loss")
    # every variant of the JAX package is served; an unknown name is refused
    assert sorted(VARIANTS) == sorted(["ode_no_encode", "ode_encode", "dae_no_encode", "dae_encode",
                                       "ode_channelwise", "dae_channelwise"])
    with pytest.raises(ValueError, match="unknown variant"):
        get_variant("ode_latent")
