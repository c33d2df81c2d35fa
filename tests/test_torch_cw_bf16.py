"""The bf16 compute mode of the channel-wise kernels (5-6) and of the TF-x
rollout (kernels 1-2) against the JAX package's, on the CPU.

The JAX package runs its Pallas kernels in interpret mode; on the CPU the
port runs the plain versions (``ops/fused_channelwise.py``
``RoundedProduct``: each product rounds its operands where the JAX kernels'
``_dot`` / ``_dot_t`` / ``_dot_nt`` round them; ``ops/noencode_bwd.py``
``dot`` / ``dot_t`` for kernels 1-2). Every output and gradient tensor is
held by the discrimination bar of ``test_torch_bf16.py``,

    rel-L2(port_bf16 - jax_bf16) <= 0.1 x rel-L2(jax_bf16 - jax_f32),

every gradient float32:

* kernels 5-6 (``fused_cw_rollout_diff`` at ``precision="bfloat16"``): the
  rollout and every gradient (``g_fz``, ``g_s_constV``, ``g_x0``, every
  weight and bias) at B=3, T=9, h=16, each solver, the AVR ODE's channels
  (xd=2, zd=2) and the motor DAE's (xd=3, zd=1). The plain versions take
  no width of their own, so no JAX run above h=128 is needed. A channel-wise
  evaluation rounds about 700 values a row, so a rollout of this size rounds
  about 7e4, and the JAX package's summation order, another than the
  port's, flips one of them now and then (a value within a float32 rounding
  of a bf16 rounding boundary): the flipped value is carried to every later
  step and to the gradients. Where that puts a tensor above the bar, the
  rollout is taken again one step at a time by the port from each of the
  JAX package's own bf16 states: at most one of its 8 steps may lie above
  the bar of the JAX package's next state (the step of the flip; a port
  that rounded elsewhere would miss at every step), and every tensor is
  then held as ``chip_smoke.py`` holds the kernels over a whole rollout
  (phases 21 and 23; ``host_build.bf16_excess``): at most max(0.25, 2 x
  the JAX tensor's own floor, the same ratio of the port's plain bf16
  version in float64 arithmetic between the same rounding points). At the
  RK4 case with the AVR channels the JAX package's one step from its state
  2 lies 0.14 from the port's, its other seven 0 to 2.4e-5; its whole
  rollout lies 0.056 from the float64 floor (the port's 0.0002), its
  gradients 0.03-0.11 (0.0001-0.0005). That case does not meet the bar
  itself: three gradients lie 0.103-0.114 from the JAX package's;
* the two TF-x entries (``fused_dae_tf_x_apply``,
  ``fused_dae_encode_tf_x_apply``) against ``py_psnode_tpu.ops.
  teacher_forcing``'s under bf16, on the batches of
  ``test_torch_multishoot.py`` (the encode form's true-state cotangents
  reach the x encoder);
* one ``Trainer`` epoch per channel-wise variant (fused, bf16, h=16, T=21,
  one step) against the JAX Trainer's step-1 loss and gradient norm and
  epoch-1 eval, each where the JAX package's bf16 and float32 numbers lie
  far enough apart to tell (``RESOLVED``).

The JAX kernels run at a time block of one step (``one_step_time_blocks``),
and XLA compiles this module's programs without most of its optimisation
passes (``quick_jax_compiles``: the same numbers, measured, in about half
the time).

``python tests/test_torch_cw_bf16.py anchors`` prints the JAX package's
Trainer (CPU, fused, the Pallas kernels in interpret mode) in bf16 and in
float32, and the port's Trainer on the CPU (fused: the plain versions) in
bf16, in the settings of ``chip_smoke.py`` phase 23: the numbers of
``CW_BF16_ANCHORS`` and ``TF_BF16_ANCHORS``. ``python
tests/test_torch_cw_bf16.py witness [variant:h ...]`` prints, for those
channel-wise runs, where the epoch-1 eval lies against the JAX package's
bf16 one in units of its bf16-float32 distance: the port's bf16 run in
float32 and in float64 arithmetic, and the port's eval of the JAX bf16
run's own updated weights (``cw_witness``; ``chip_smoke.py``
``CW_BF16_EVAL_UNRESOLVED``).
"""

import contextlib
import pathlib
import shutil
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from test_torch_bf16 import BAR, BF16, check_entry, hold, rel_l2  # noqa: E402
from test_torch_cw_slice import DIMS, make_inputs, read_metrics, run_config  # noqa: E402
from test_torch_cw_wide import to_port_grads  # noqa: E402
from test_torch_fused_cw import rollout_inputs, to_jax  # noqa: E402
from test_torch_multishoot import DIMS as DAE_DIMS, H  # noqa: E402
from py_psnode_tpu.ops import fused_channelwise as JF  # noqa: E402
from py_psnode_tpu.ops import fused_dae as jfd  # noqa: E402
from py_psnode_tpu.ops import teacher_forcing as JTF  # noqa: E402
from py_psnode_tpu_torch.ops import fused_channelwise as FC  # noqa: E402
from py_psnode_tpu_torch.ops import fused_channelwise_vjp as VC  # noqa: E402
from py_psnode_tpu_torch.ops import teacher_forcing as TF  # noqa: E402
from py_psnode_tpu_torch.utils import host_build  # noqa: E402

# the relative distance of the JAX package's bf16 and float32 numbers below
# which the Trainer test does not tell them apart: the port's float32 step 1
# lies within 1.5e-7 of the JAX package's on the CPU
RESOLVED = 1e-6
# the Trainer test's sets: h=16, 21 steps, 8 training samples in one batch of 8
TRAIN_SMALL = dict(hidden=16, step=21, num=8, batch=8, n_test=8)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads for torch: the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    """XLA's compiles of this module's JAX programs without most of their
    optimisation passes (``jax_disable_most_optimizations``): the
    interpret-mode kernels cost far more to optimise than to run at these
    sizes. The caches are cleared after the module, so that no program
    compiled so reaches another module."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)
    jax.clear_caches()


@pytest.fixture(autouse=True)
def one_step_time_blocks(monkeypatch):
    """The JAX kernels at a time block of one step (their scheduling knob,
    ``fused_dae.set_kernel_tuning``'s ``time_block``, which the channel-wise
    module reads as its own ``TIME_BLOCK``): it regroups the grid's
    iterations and nothing else (the bf16 RK4 rollout of the first test is
    the same to the bit), and cuts each interpret-mode compile about
    eightfold (35 s to 4.6 s there)."""
    monkeypatch.setattr(JF, "TIME_BLOCK", 1)
    monkeypatch.setattr(jfd, "TIME_BLOCK", 1)


def port_rollout_and_grads(streams, weights, x0, dt, cot, solver, dtype=torch.float32):
    """``[rollout rows, g_fz, g_s_constV, g_x0, *weight grads]`` of the
    port's ``fused_cw_rollout_diff`` in the bf16 mode on the CPU (its plain
    versions) with ``(sol * cot).sum()`` as the loss, every input in
    ``dtype`` (float64: the float64 floor)."""
    leaf = lambda a: a.to(dtype).clone().requires_grad_()
    ts = {k: leaf(v) for k, v in streams.items()}
    tw = FC.unflatten_weights([leaf(a) for a in FC.flatten_weights(weights)])
    tx0 = leaf(x0)
    sol = VC.fused_cw_rollout_diff(ts, tw, tx0, dt.to(dtype), solver, BF16)
    (sol * torch.tensor(cot, dtype=dtype)).sum().backward()
    return [sol.detach()[1:], ts["fz"].grad, ts["s_constV"].grad, tx0.grad] + [a.grad for a in FC.flatten_weights(tw)]


@pytest.mark.parametrize("xd,zd", [(2, 2), (3, 1)])
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_cw_rollout_and_vjp_bf16_match_jax(solver, xd, zd):
    """Kernels 5-6's plain bf16 versions through ``FusedCwRollout``: the
    rollout and every gradient by the bar (where a flipped rounding of the
    JAX package's is carried, by the module docstring's rule), the
    gradients float32."""
    B, h = 3, 16
    streams, weights, x0, dt = rollout_inputs(B=B, Tm1=8, h=h, xd=xd, zd=zd, seed=10 + xd)
    js, jw, jx0, jdt = to_jax(streams, weights, x0, dt)
    cot = np.random.default_rng(xd).standard_normal((9, B, xd, h)).astype(np.float32)
    jcot = jnp.asarray(np.transpose(cot, (0, 2, 1, 3)))

    def jax_run(precision):
        def run(s, w, x, c):
            sol, vjp = jax.vjp(lambda s, w, x: JF.fused_cw_rollout_diff(s, w, x, jdt, solver, True, precision),
                               s, w, x)
            return sol, vjp(c)

        sol, g = jax.jit(run)(js, jw, jx0, jcot)
        return [np.transpose(np.asarray(sol), (0, 2, 1, 3))[1:]] + [t.numpy() for t in to_port_grads(*g, B=B, h=h)]

    jb, jf = jax_run(BF16), jax_run("default")
    got = port_rollout_and_grads(streams, weights, x0, dt, cot, solver)
    assert len(got) == len(jb)
    assert all(g.dtype == torch.float32 and tuple(g.shape) == b.shape for g, b in zip(got, jb))
    ratios = [rel_l2(g.numpy(), b) / rel_l2(b, f) for g, b, f in zip(got, jb, jf)]
    if max(ratios) <= BAR:
        return
    # a flip of the JAX package's carried (the module docstring): one step
    # at a time from the JAX package's own states, at most one step above
    # the bar; each tensor within max(0.25, 2 x the JAX tensor's own floor)
    cs, cw = FC.cast_cw(streams, weights, BF16)
    states = torch.cat([x0[None], torch.tensor(jb[0])])  # the JAX package's bf16 rollout
    local = []
    for t in range(8):
        one = lambda s, w: FC.fused_cw_rollout_plain({"fz": s["fz"][t:t + 1], "s_constV": s["s_constV"]}, w,
                                                     states[t], dt[t:t + 1], solver)[0]
        step_b, step_f = one(cs, cw).numpy(), one(streams, weights).numpy()
        local.append(rel_l2(step_b, jb[0][t]) / rel_l2(step_b, step_f))
    assert sum(q > BAR for q in local) <= 1, f"one step from the JAX states: {[f'{q:.4f}' for q in local]}"
    t = lambda arrays: [torch.tensor(a) for a in arrays]
    floor = lambda: port_rollout_and_grads(streams, weights, x0, dt, cot, solver, torch.float64)
    excess = host_build.bf16_excess(got, t(jb), t(jf), floor)
    assert excess <= 1.0, f"worst ratio / bar {excess:.4f} (the ratios {[f'{q:.4f}' for q in ratios]})"


# name: (family of test_torch_multishoot.setup, the JAX call, the port's)
TFX_ENTRIES = {
    "fused_dae_tf_x_apply": ("dae", lambda p, b, s, q: JTF.fused_dae_tf_x_apply(p, b, DAE_DIMS, H, s, True, q),
                             lambda m, b, q: TF.fused_dae_tf_x_apply(m, b, precision=q)),
    "fused_dae_encode_tf_x_apply": (
        "dae_encode", lambda p, b, s, q: JTF.fused_dae_encode_tf_x_apply(p, b, DAE_DIMS, H, s, True, q),
        lambda m, b, q: TF.fused_dae_encode_tf_x_apply(m, b, precision=q)),
}


@pytest.mark.parametrize("name,solver", [("fused_dae_tf_x_apply", "rk4"), ("fused_dae_encode_tf_x_apply", "euler")])
def test_tfx_entry_bf16_matches_jax(name, solver):
    """The TF-x DAE entries under bf16: every output and every parameter's
    gradient of the trainer's loss by the bar (the encode form's through
    its true-state cotangents ``g_xt`` / ``g_xt1`` into the x encoder)."""
    family, jax_fn, port_fn = TFX_ENTRIES[name]
    check_entry(family, jax_fn, port_fn, False, solver)


@pytest.mark.parametrize("variant", sorted(DIMS))
def test_cw_trainer_bf16_step_matches_jax(variant, tmp_path):
    """One bf16 epoch of the port's Trainer (fused: the plain versions of
    kernels 5-6 on the CPU) from a numpy starting checkpoint at h=16: its
    step-1 loss and gradient norm and its epoch-1 eval (after that step)
    against the JAX Trainer's bf16 ones (fused, interpret mode) by the bar,
    the JAX float32 run setting the gap; a number whose two JAX runs lie
    less than RESOLVED apart (relative: the tenth of that falls below the
    float32 agreement of the two packages; the step-1 gradient norms from
    the starting checkpoint at this size) within RESOLVED of the bf16 one
    instead, and at least one number held by the bar."""
    from py_psnode_tpu.train.trainer import TrainConfig as JaxConfig, Trainer as JaxTrainer

    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    inputs = make_inputs(tmp_path / "data", variant, TRAIN_SMALL)
    keys = ("x_loss", "i_loss") if variant == "dae_channelwise" else ("x_loss",)
    numbers = lambda run: [run[0][0]["loss"], run[0][0]["grad_norm"]] + [run[1][k] for k in keys]
    jax_runs = {}
    for precision in (BF16, "default"):
        cfg = run_config(inputs, tmp_path / f"jax_{precision}", variant, TRAIN_SMALL, fused=True,
                         matmul_precision=precision)
        jax_runs[precision] = numbers(read_metrics(JaxTrainer(JaxConfig(**cfg)).train()[1]))
    cfg = run_config(inputs, tmp_path / "port", variant, TRAIN_SMALL, fused=True, matmul_precision=BF16,
                     device="cpu")
    port = numbers(read_metrics(Trainer(TrainConfig(**cfg)).train()[1]))
    told = 0
    for k, (got, b, f) in enumerate(zip(port, jax_runs[BF16], jax_runs["default"])):
        if abs(b - f) > RESOLVED * abs(f):
            hold([got], [b], [f], f"number {k}")
            told += 1
        else:
            np.testing.assert_allclose(got, b, rtol=RESOLVED, err_msg=str(k))
    assert told >= 1, (port, jax_runs)


def test_smoke_local_cw_checks_are_the_rollouts_own():
    """``chip_smoke.cw_local_fwd`` / ``cw_local_bwd`` (kernels 5-6's rows and
    (u, v) pairs against one step or one evaluation's VJP of the plain
    versions from the kernel's own values) give the plain bf16 rollout's and
    walk's own values back when those stand in for the kernels, and tell
    them from float32; their float64 versions (the local floors) lie far
    inside the bf16-float32 gap at this size."""
    import chip_smoke as CS

    streams, weights, x0, dt = rollout_inputs(B=2, Tm1=6, h=16, xd=3, zd=1, seed=5)
    cs, cw = FC.cast_cw(streams, weights, BF16)
    for solver in ("euler", "rk4"):
        rows = FC.fused_cw_rollout_plain(cs, cw, x0, dt, solver)
        ((g,), (b,), (f,)), floor = CS.cw_local_fwd(cs, cw, streams, weights, x0, dt, rows, solver, n=3)
        torch.testing.assert_close(b, g, rtol=1e-6, atol=1e-6)
        assert rel_l2(f.numpy(), b.numpy()) > 0
        assert rel_l2(floor()[0].numpy(), b.numpy()) < 0.1 * rel_l2(f.numpy(), b.numpy())
        sol = torch.cat([x0[None], rows])
        cot = torch.randn(sol.shape, generator=torch.Generator().manual_seed(6))
        pairs = VC.channel_pairs_plain(cs, cw, dt, sol, cot, solver)
        (got, bf, f32), floor = CS.cw_local_bwd(cw, streams, weights, pairs, n=3)
        assert len(got) == len(bf) == len(f32) == len(floor()) == 6
        for g, b, f, fl in zip(got, bf, f32, floor()):
            torch.testing.assert_close(b, g, rtol=1e-5, atol=1e-6)
            assert rel_l2(fl.numpy(), b.numpy()) < 0.1 * rel_l2(f.numpy(), b.numpy()) < 0.1


# ------------------------------------------------------------ the anchors

# chip_smoke.py phase 23's Trainer runs (Euler, one epoch of two steps,
# fused, from the starting checkpoints): the channel-wise variants at h=128
# on CW_TRAIN's sets cut to T=201 and 16 training samples in batches of 8
# (the JAX interpret-mode run of the full ODE set, 128 samples of 1 001
# steps in batches of 64, takes too long on the CPU) and at h=256 on
# CW_WIDE's sets; the two TF-x DAEs in the settings of TF_ANCHORS.
CW_CUT = dict(hidden=128, step=201, num=16, batch=8, n_test=8)
CW_WIDE = dict(hidden=256, step=201, num=16, batch=8, n_test=8)


def trainer_numbers(run_dir):
    """A Trainer run's ``(step-1 (loss, gradient norm), epoch-1 eval)``."""
    train, ev = read_metrics(run_dir)
    return (train[0]["loss"], train[0]["grad_norm"]), tuple(ev[k] for k in ("x_loss", "i_loss") if k in ev)


def cw_anchor_run(variant, size, precision, root: pathlib.Path, port: bool = False):
    """The JAX Trainer (CPU, fused, interpret mode) of a channel-wise
    variant, or with ``port`` the port's (CPU, fused: the plain versions of
    kernels 5-6): :func:`trainer_numbers`."""
    from py_psnode_tpu.train.trainer import TrainConfig as JaxConfig, Trainer as JaxTrainer

    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    cfg = run_config(make_inputs(root / "data", variant, size), root / "train", variant, size, fused=True,
                     matmul_precision=precision, **(dict(device="cpu") if port else {}))
    return trainer_numbers((Trainer(TrainConfig(**cfg)) if port else JaxTrainer(JaxConfig(**cfg))).train()[1])


@contextlib.contextmanager
def port_in_float64():
    """The port's Trainer in float64 arithmetic between the same bf16
    rounding points (the plain versions round their operands to bf16 in any
    dtype): every float32 array it makes a tensor of and every parameter it
    loads become float64, and the export after the epoch (float32 programs)
    is left out."""
    import dataclasses

    from py_psnode_tpu_torch.train import trainer as TR

    as_tensor, load_params, get_variant = torch.as_tensor, TR.load_params, TR.get_variant

    def wide(*args, **kw):
        t = as_tensor(*args, **kw)
        return t.double() if t.dtype == torch.float32 else t

    torch.as_tensor = wide
    TR.load_params = lambda module, *a, **kw: load_params(module, *a, **kw).double()
    TR.get_variant = lambda name: dataclasses.replace(get_variant(name), export_fn=lambda *a, **kw: None)
    try:
        yield
    finally:
        torch.as_tensor, TR.load_params, TR.get_variant = as_tensor, load_params, get_variant


def cw_witness(variant, size, root: pathlib.Path):
    """Where the channel-wise Trainer's epoch-1 eval (after Adam's first two
    updates) lies against the JAX package's bf16 one, in units of the JAX
    bf16-float32 distance: the port's bf16 run (CPU, the plain versions) in
    float32 and in float64 arithmetic, and the port's eval of the JAX bf16
    run's own updated parameters (a run from its checkpoint at learning
    rate 0). Returns the lines to print."""
    from py_psnode_tpu.train.trainer import TrainConfig as JaxConfig, Trainer as JaxTrainer

    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    inputs = make_inputs(root / "data", variant, size)
    cfg = lambda tag, **kw: run_config(inputs, root / tag, variant, size, fused=True, **kw)
    jax_bf16 = JaxTrainer(JaxConfig(**cfg("jax_bf16", matmul_precision=BF16))).train()[1]
    jb = trainer_numbers(jax_bf16)
    jf = trainer_numbers(JaxTrainer(JaxConfig(**cfg("jax_f32", matmul_precision="default"))).train()[1])

    def port(tag, start=None, **kw):
        c = cfg(tag, matmul_precision=BF16, device="cpu", **kw)
        if start is not None:
            shutil.copy(start, c["warm_start"])
        return trainer_numbers(Trainer(TrainConfig(**c)).train()[1])

    runs = {"port, float32 arithmetic": port("port32")}
    with port_in_float64():
        runs["port, float64 arithmetic"] = port("port64")
    runs["port's eval of the JAX bf16 run's parameters"] = port(
        "port_on_jax", pathlib.Path(jax_bf16) / "model_checkpoint.1", learning_rate=0.0)
    gap = lambda k: abs(jb[1][k] - jf[1][k])
    lines = [f"{variant} h={size['hidden']}: JAX eval bf16 {jb[1]}, float32 {jf[1]}; step 1 bf16 {jb[0]}, "
             f"float32 {jf[0]}"]
    for name, (step1, ev) in runs.items():
        lines.append(f"  {name}: eval {ev}, |eval - JAX bf16| / |JAX bf16 - float32| "
                     f"{[round(abs(e - jb[1][k]) / gap(k), 4) for k, e in enumerate(ev)]}; step 1 {step1}")
    return lines


def tfx_anchor_run(variant, precision, root: pathlib.Path, port: bool = False):
    """The JAX Trainer (CPU, fused, interpret mode) of a TF-x DAE in the
    settings of ``TF_ANCHORS``, or with ``port`` the port's (CPU, fused):
    :func:`trainer_numbers`."""
    from test_torch_tf_slice import make_data, tf_config
    from py_psnode_tpu.train.trainer import TrainConfig as JaxConfig, Trainer as JaxTrainer

    from py_psnode_tpu_torch.train import TrainConfig, Trainer

    cfg = tf_config(variant, "x", make_data(variant, root / "data"), root / "train", fused=True,
                    matmul_precision=precision, **(dict(device="cpu") if port else {}))
    return trainer_numbers((Trainer(TrainConfig(**cfg)) if port else JaxTrainer(JaxConfig(**cfg))).train()[1])


if __name__ == "__main__" and sys.argv[1:2] == ["witness"]:
    jax.config.update("jax_platforms", "cpu")
    for variant, h in [("dae_channelwise", 128), ("ode_channelwise", 128), ("dae_channelwise", 256),
                       ("ode_channelwise", 256)]:
        if sys.argv[2:] and f"{variant}:{h}" not in sys.argv[2:]:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            print("\n".join(cw_witness(variant, CW_CUT if h == 128 else CW_WIDE, pathlib.Path(tmp))), flush=True)

if __name__ == "__main__" and sys.argv[1:2] == ["anchors"]:
    jax.config.update("jax_platforms", "cpu")
    runs = [("cw", v, 128) for v in sorted(DIMS)] + [("cw", v, 256) for v in sorted(DIMS)] + [
        ("tfx", v, 128) for v in ("dae_no_encode", "dae_encode")]
    for kind, variant, h in runs:
        if sys.argv[2:] and variant not in sys.argv[2:] and f"{variant}:{h}" not in sys.argv[2:]:
            continue
        got = {}
        for precision, port in ((BF16, False), ("default", False), (BF16, True)):
            with tempfile.TemporaryDirectory() as tmp:
                got[precision, port] = (
                    cw_anchor_run(variant, CW_CUT if h == 128 else CW_WIDE, precision, pathlib.Path(tmp), port)
                    if kind == "cw" else tfx_anchor_run(variant, precision, pathlib.Path(tmp), port))
        g8 = lambda vs: tuple(float(f"{v:.8g}") for v in vs)
        fmt = lambda r: f"dict(step1={g8(r[0])}, eval1={g8(r[1])})"
        print(f"({variant!r}, {h}): dict(bf16={fmt(got[BF16, False])}, f32={fmt(got['default', False])}, "
              f"port_cpu={fmt(got[BF16, True])}),", flush=True)
