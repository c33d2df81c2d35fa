"""The port's training pieces against the JAX package, on the CPU.

Losses, the logged gradient norm and the robust guard against the JAX
functions (rtol 1e-6, float32); the port's Adam + StepLR (with the
optional clip and non-finite skip) against optax over a few updates (rtol
1e-6); the initializers' statistics; an npz checkpoint written by the port
and read back by the JAX package; and the ``--training`` CLI end to end at
a small size. Inputs are seeded numpy float32 arrays handed to both
packages.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from py_psnode_tpu.train import losses as JL
from py_psnode_tpu.train import optim as JO
from py_psnode_tpu.train.checkpoints import load_checkpoint_params as jax_load_checkpoint

from py_psnode_tpu_torch import bridge
from py_psnode_tpu_torch.cli.common import main as port_main
from py_psnode_tpu_torch.models.dae import DAEModel
from py_psnode_tpu_torch.models.initializers import init_params
from py_psnode_tpu_torch.ops import fused_dae as F
from py_psnode_tpu_torch.ops import fused_dae_vjp as V
from py_psnode_tpu_torch.train import TrainConfig, Trainer
from py_psnode_tpu_torch.train import losses as L
from py_psnode_tpu_torch.train import optim as O
from py_psnode_tpu_torch.train.checkpoints import load_checkpoint_params, save_params_npz

REPO = pathlib.Path(__file__).resolve().parents[1]
MOTOR = REPO / "benchmarks/h2h_work_prod_s0/data_dae_motor"
RTOL = 1e-6


def _loss_batch(seed=0, B=5, T=9, with_w=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = (rng.random((B, T, 1)) > 0.2).astype(np.float32)
    b = dict(x=f(B, T, 3), i=f(B, T, 2), mask=mask)
    if with_w:
        b["sample_w"] = np.array([1, 1, 1, 1, 0], np.float32)
    return (f(B, T, 3), f(B, T, 2)), b


@pytest.mark.parametrize("with_w", [False, True])
def test_dae_no_encode_loss_matches_jax(with_w):
    (xp, ip), b = _loss_batch(with_w=with_w)
    ref, ref_aux = JL.dae_no_encode_loss((jnp.asarray(xp), jnp.asarray(ip)),
                                         {k: jnp.asarray(v) for k, v in b.items()})
    got, aux = L.dae_no_encode_loss((torch.tensor(xp), torch.tensor(ip)),
                                    {k: torch.tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
    assert set(aux) == set(ref_aux) == {"x_loss", "i_loss", "loss"}
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(ref_aux[k]), rtol=RTOL)


def test_mse_and_masked_sum_se_match_jax():
    (xp, _), b = _loss_batch()
    w = b["sample_w"]
    for a, c in ((xp, b["x"]), (xp[:, 0], b["x"][:, 0])):
        np.testing.assert_allclose(L.mse(torch.tensor(a), torch.tensor(c)).item(),
                                   float(JL.mse(jnp.asarray(a), jnp.asarray(c))), rtol=RTOL)
        np.testing.assert_allclose(
            L.mse(torch.tensor(a), torch.tensor(c), torch.tensor(w)).item(),
            float(JL.mse(jnp.asarray(a), jnp.asarray(c), jnp.asarray(w))), rtol=RTOL)
    np.testing.assert_allclose(
        L.masked_sum_se(*map(torch.tensor, (xp, b["x"], b["mask"]))).item(),
        float(JL.masked_sum_se(*map(jnp.asarray, (xp, b["x"], b["mask"])))), rtol=RTOL)


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(3, 8), (8,), (8, 8), (8, 2), (2,)]
    return [(rng.standard_normal(s) * 0.7).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("clip", [1.0, 0.25])
def test_reference_grad_norm_matches_jax(clip):
    gs = _grads()
    ref = JO.reference_grad_norm([jnp.asarray(g) for g in gs], clip)
    got = O.reference_grad_norm([torch.tensor(g) for g in gs], clip)
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)


@pytest.mark.parametrize("value", [0.5, 3.0, float("nan"), float("inf")])
def test_robust_scalar_guard_matches_jax(value):
    ref_l, ref_t = JO.robust_scalar_guard(jnp.float32(value), 1.0)
    ref_g = jax.grad(lambda v: JO.robust_scalar_guard(v, 1.0)[0])(jnp.float32(value))
    v = torch.tensor(value, requires_grad=True)
    got_l, got_t = O.robust_scalar_guard(v, 1.0)
    got_l.backward()
    np.testing.assert_allclose(got_l.item(), float(ref_l), rtol=RTOL)
    assert bool(got_t) == bool(ref_t)
    if np.isfinite(value):
        np.testing.assert_allclose(v.grad.item(), float(ref_g), rtol=RTOL)
    g = torch.tensor([1.0, float("nan"), float("inf"), -float("inf")])
    O.zero_nonfinite_grads([g])
    np.testing.assert_array_equal(g.numpy(), np.asarray(JO.zero_nonfinite_grads(
        jnp.asarray([1.0, np.nan, np.inf, -np.inf]))))


@pytest.mark.parametrize("count", [0, 3, 4, 9, 40])
def test_steplr_schedule_matches_jax(count):
    args = (5e-3, 20, 2, 0.7)
    np.testing.assert_allclose(O.steplr_schedule(*args)(count),
                               float(JO.steplr_schedule(*args)(count)), rtol=RTOL)


@pytest.mark.parametrize("clip,skip", [(None, False), (0.5, False), (None, True)])
def test_adam_steplr_matches_optax(clip, skip):
    """Ten updates with a schedule that decays every 4 updates; with
    ``skip``, update 3's gradients hold a NaN and the update is skipped."""
    p0 = _grads(seed=1)
    steps = [_grads(seed=10 + k) for k in range(10)]
    if skip:
        steps[3][2][0, 0] = np.nan
    kw = dict(learning_rate=5e-3, epochs=20, steps_per_epoch=2, sch_gamma=0.7,
              gradient_clip=clip, skip_nonfinite=skip)
    tx = JO.make_optimizer(**kw)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    opt = O.make_optimizer(tp, **kw)
    for gs in steps:
        updates, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, gs):
            p.grad = torch.tensor(g)
        opt.step()
    # atol 1e-8: a tenth of a float32 ulp at the parameters' unit scale, for
    # entries that pass near zero
    for got, ref in zip(tp, jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=1e-8)
    assert opt.count == (9 if skip else 10)


def test_initializer_statistics():
    model = DAEModel(3, 1, 2, 2, hidden_dim=128)
    init_params(model, "lecun", seed=0)
    W = model.de_func.x_dot.dense_1.weight.detach()  # fan_in 128
    assert abs(W.std().item() - 128 ** -0.5) < 0.05 * 128 ** -0.5
    assert W.abs().max().item() <= 2.0 * 128 ** -0.5 / 0.87962566103423978 + 1e-6
    assert abs(W.mean().item()) < 0.1 * 128 ** -0.5
    assert all(torch.all(m.bias == 0) for m in model.modules() if isinstance(m, torch.nn.Linear))
    W0 = model.de_func.x_dot.dense_0.weight.detach()  # fan_in 3 * 8
    assert abs(W0.std().item() - 24 ** -0.5) < 0.05 * 24 ** -0.5
    again = init_params(DAEModel(3, 1, 2, 2, hidden_dim=128), "lecun", seed=0)
    assert torch.equal(again.de_func.x_dot.dense_1.weight, model.de_func.x_dot.dense_1.weight)
    other = init_params(DAEModel(3, 1, 2, 2, hidden_dim=128), "lecun", seed=1)
    assert not torch.equal(other.de_func.x_dot.dense_1.weight, model.de_func.x_dot.dense_1.weight)

    init_params(model, "torch", seed=0)
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            bound = m.in_features ** -0.5
            for p in (m.weight, m.bias):
                assert p.abs().max().item() <= bound
    W = model.de_func.x_dot.dense_1.weight.detach()
    assert abs(W.std().item() - 128 ** -0.5 / np.sqrt(3)) < 0.05 * 128 ** -0.5
    assert model.de_func.x_dot.dense_1.bias.abs().max().item() > 0
    with pytest.raises(ValueError, match="init_style"):
        init_params(model, "xavier")


def test_port_checkpoint_is_read_by_jax(tmp_path):
    model = init_params(DAEModel(3, 1, 2, 2, hidden_dim=8), "torch", seed=3)
    path = tmp_path / "model_checkpoint.7"
    save_params_npz(path, model)
    assert path.exists() and not (tmp_path / "model_checkpoint.7.tmp").exists()
    ref = jax_load_checkpoint(path)
    got = bridge.state_dict_from_params(jax.tree_util.tree_map(np.asarray, ref))
    sd = model.state_dict()
    assert set(got) == set(sd) and len(sd) == 22
    for k in sd:
        np.testing.assert_array_equal(got[k].numpy(), sd[k].numpy())
    back = bridge.load_params(DAEModel(3, 1, 2, 2, hidden_dim=8), load_checkpoint_params(path))
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k])


def test_trainer_refuses_what_is_not_ported():
    for kw in (dict(checkpointer="orbax"), dict(auto_resume=True), dict(n_devices=2),
               dict(n_windows=20, auto_resume=True), dict(input_true_i=True, auto_resume=True)):
        with pytest.raises(NotImplementedError, match="not ported"):
            Trainer(TrainConfig(variant="dae_no_encode", device="cpu", **kw))


@pytest.mark.parametrize("fused", [False, True])
def test_cli_training_writes_its_artifacts(tmp_path, fused):
    """``--training`` at a small size on the motor data (h=8, T=21, 8
    samples, 2 epochs, RK4): the logs, checkpoints, history, metrics and
    summary land where the JAX package puts them, and the fused route runs
    on the CPU without launching a kernel."""
    run = tmp_path / "run"
    launches = (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches)
    model, path = port_main("dae_no_encode", [
        "--training", "--device", "cpu", "--train_data", str(MOTOR / "training.npz"),
        "--test_data", str(MOTOR / "testing.npz"), "--model", str(run), "--num", "8",
        "--batch", "3", "--hidden", "8", "--epoch", "2", "--step", "21", "--solver", "rk4",
        "--larger_than", "none", "--seed", "5",
    ] + (["--fused"] if fused else []))
    assert (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches) == launches
    assert path == run
    for name in ("training.log", "testing.log", "model_checkpoint.1", "model_checkpoint.2",
                 "train_and_eval.npz", "train_metrics.jsonl"):
        assert (run / name).exists(), name
    with np.load(run / "train_and_eval.npz", allow_pickle=True) as f:
        assert len(f["eval"]) == 3 and f["eval"][0].shape == (4,)
    recs = [json.loads(line) for line in (run / "train_metrics.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["eval", "epoch_time"] * 2
    assert all(np.isfinite([recs[0]["x_loss"], recs[0]["i_loss"]]))
    assert "not ported yet" not in (run / "training.log").read_text()
    assert {f.name for f in (run / "saved model").iterdir()} == {
        f"{s}.{ext}" for s in ("init_func", "de_func", "ae_func") for ext in ("pt2", "weights.npz", "weights.bin")}
    assert "Output final testing loss per testing sample" in (run / "testing.log").read_text()
    # the last checkpoint holds the trained weights, readable by the JAX package
    ref = bridge.state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, jax_load_checkpoint(run / "model_checkpoint.2")))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(ref[k].numpy(), v.numpy())


def test_trainer_host_batches_without_device_data(tmp_path):
    """``device_data=False`` takes the host path: shuffled host batches,
    padded to the batch size with ``sample_w`` (8 samples in batches of 3)."""
    cfg = TrainConfig(
        variant="dae_no_encode", train_data=str(MOTOR / "training.npz"),
        test_data=str(MOTOR / "testing.npz"), model=str(tmp_path / "run"), num=8, batch=3,
        hidden=8, epoch=1, step=21, larger_than=None, loss_record_iter=1, device_data=False,
        echo_logs=False, device="cpu",
    )
    _, run = Trainer(cfg).train()
    recs = [json.loads(line) for line in (run / "train_metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if r["kind"] == "train"]
    assert [r["batch"] for r in steps] == [1, 2, 3]
    assert all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in steps)
