#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``py_psnode_tpu_torch``) on one card.

    python3 chip_smoke.py            # the smoke run, needs one CUDA card
    python3 chip_smoke.py --sweep    # also time every forward launch shape

Phases, each printed as it ends; any failure exits non-zero:
  1. card: name, device count, and nvidia-smi's name and power limit;
  2. build: nvcc builds the forward and the backward library, both at once
     (seconds printed for each);
  3. forward kernel against plain: the kernel and its eager PyTorch version
     on the same seeded random inputs at the motor evaluation shape (B=32,
     T=1001, h=128, xd=3, id=2, events in some rows), for Euler, Midpoint
     and RK4, within |kernel - plain| <= 1e-4 * max(1, |plain|);
  4. backward kernel against plain: seeded random inputs at the training
     shape (B=64, T=1001, h=128, events in some rows, unit-scale
     cotangents), the plain reverse walk in float64, for each solver and
     each output tensor on its own scale, max|kernel - plain| <= 1e-4 *
     max|plain|; a second launch must give bit-identical gradients;
  5. evaluation slice: the port's CLI ``--testing --fused --device cuda``
     on a temporary copy of the motor checkpoint 200 and its test set,
     against the float32 anchors of the JAX package (rtol 1e-3), with the
     forward kernel's launches counted; then the plain (non-fused) path;
  6. training slice: the port's ``Trainer`` (``fused=True``) warm-started
     from a copy of checkpoint 200 for one epoch of two steps on the motor
     training set, Euler then RK4, against the JAX package's float32
     anchors: step 1 and the Euler epoch-1 eval at rtol 1e-3; both
     kernels' launches counted;
  7. times (CUDA events): the forward at B=32, 64 and 1024, the backward at
     B=64 for each solver, and one whole training step (streams, both
     kernels, stream backprop, Adam) at bench.py's shape (B=64, T=1001,
     h=128, RK4) against the plain (non-fused) route.

The line before the last two is the kernels' JSON record, then nvidia-smi's
line, and the last line is ``{"ok": true, "device": {...}}``. Nothing is
written into the repository except the kernel builds under
``py_psnode_tpu_torch/_build/`` (ignored by git).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from py_psnode_tpu_torch.bridge import load_params  # noqa: E402
from py_psnode_tpu_torch.cli.common import main as cli_main  # noqa: E402
from py_psnode_tpu_torch.data import DaeSamples  # noqa: E402
from py_psnode_tpu_torch.models import DAEModel  # noqa: E402
from py_psnode_tpu_torch.ops import fused_dae as F  # noqa: E402
from py_psnode_tpu_torch.ops import fused_dae_vjp as V  # noqa: E402
from py_psnode_tpu_torch.ops.fused_model import fused_dae_apply, rollout_inputs  # noqa: E402
from py_psnode_tpu_torch.train import TrainConfig, Trainer  # noqa: E402
from py_psnode_tpu_torch.train.checkpoints import load_checkpoint_params  # noqa: E402
from py_psnode_tpu_torch.train.losses import dae_no_encode_loss  # noqa: E402
from py_psnode_tpu_torch.train.optim import make_optimizer  # noqa: E402
from py_psnode_tpu_torch.utils import cuda_build  # noqa: E402
from py_psnode_tpu_torch.utils.device import use_full_float32  # noqa: E402

RUN_DIR = REPO / "benchmarks" / "h2h_work_prod_s0"
CKPT = RUN_DIR / "ours_dae_motor" / "model_checkpoint.200"
TEST_DATA = RUN_DIR / "data_dae_motor" / "testing.npz"
TRAIN_DATA = RUN_DIR / "data_dae_motor" / "training.npz"
# x_loss_total / i_loss_total of the JAX package on the CPU (float32) for
# this checkpoint and test set
ANCHORS = {"euler": (0.0225037, 0.0857198), "rk4": (0.0225467, 0.0859806)}
ANCHOR_RTOL = 1e-3
KERNEL_TOL = 1e-4  # |kernel - plain| <= KERNEL_TOL * max(1, |plain|)
# One epoch of training from checkpoint 200 (128 samples, batch 64, lr
# 5e-3, seed 0): step-1 (loss, gradient norm) and the Euler epoch-1 eval
# (x_loss, i_loss) of the JAX package on the CPU in float32; re-derived by
# `python tests/test_torch_train_slice.py` (needs JAX).
TRAIN_STEP1 = {"euler": (0.20542581, 87.125443), "rk4": (0.20590033, 90.731873)}
TRAIN_EVAL1_EULER = (0.40475863, 12.474731)
TRAIN_STEP1_RTOL = 1e-3
# The eval after Adam's first update (about lr * sign(g) per parameter),
# held as the CPU slice holds it
TRAIN_EVAL1_RTOL = 1e-3
# Per output tensor, on its own scale: max|kernel - plain| <= BWD_TOL *
# max|plain|. Each weight gradient sums 64 x 1000 row-steps in another
# order than the float64 plain walk, and each row's cotangent is carried
# back through 1000 steps of float32; a tensor whose plain maximum is 0
# fails, as it would hold the kernel to nothing.
BWD_TOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SOLVERS = ("euler", "midpoint", "rk4")


def say(*parts):
    print(*parts, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, warmup, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, timed with CUDA
    events after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_inputs(B, Tm1, h, xd, idim, seed, dev):
    """Seeded random rollout inputs: lecun-scaled weights, dt = 0.01, and
    events at two steps in a quarter of the rows."""
    rng = np.random.default_rng(seed)
    t = lambda shape, scale: torch.tensor(
        (rng.standard_normal(shape) * scale).astype(np.float32), device=dev
    )
    streams = {k: t((Tm1, B, h), 0.5) for k in ("s_de", "s_ae", "s_ae_ev")}

    def tail(n_out):
        return [
            (t((h, o), 1 / np.sqrt(h)), t((o,), 0.1)) for o in (h, h, n_out)
        ]

    weights = dict(
        wx_de=t((xd, h), 1 / np.sqrt(xd)), wi_de=t((idim, h), 1 / np.sqrt(idim)),
        gx_ae=t((xd, h), 1 / np.sqrt(xd)), de_tail=tail(xd), ae_tail=tail(idim),
    )
    x0, i0 = t((B, xd), 1.0), t((B, idim), 1.0)
    ev = torch.zeros(Tm1, B, dtype=torch.bool, device=dev)
    ev[303, : B // 4] = True
    ev[333, : B // 4] = True
    aux = F.pack_aux(torch.full((Tm1, B, 1), 0.01, device=dev), ev)
    return streams, weights, x0, i0, aux


def model_inputs(batch_repeat, dev):
    """The fused path's rollout inputs for checkpoint 200 on the motor test
    set (repeated ``batch_repeat`` times along the batch), as
    ``fused_dae_apply`` builds them."""
    ds = DaeSamples.load(str(TEST_DATA), cut_length=1001)
    dims = (ds.x.shape[-1], ds.z.shape[-1], ds.v.shape[-1], ds.i.shape[-1])
    model = DAEModel(*dims, hidden_dim=128, device="meta")
    load_params(model, load_checkpoint_params(CKPT), device=dev)
    model.requires_grad_(False)
    rep = lambda a: torch.as_tensor(np.concatenate([a] * batch_repeat), device=dev)
    batch = {k: rep(getattr(ds, k)) for k in ("t", "z", "v", "i", "event_t", "z_jump", "v_jump")}
    with torch.no_grad():
        streams, weights, x0, i0, dt, ev = rollout_inputs(model, batch)
    return streams, weights, x0.contiguous(), i0.contiguous(), F.pack_aux(dt, ev)


def rollout_work(streams, weights, x0, i0, aux, solver):
    """(bytes, FLOP) the rollout needs on these inputs: each input read once
    and the output written once; matrix-product FLOP (2 per multiply-add)
    of one DE evaluation per stage, one AE readout per step, one i
    projection per step, and one AE recompute per event row-step."""
    Tm1, B, h = streams["s_de"].shape
    xd, idim = x0.shape[-1], i0.shape[-1]
    tensors = [*streams.values(), aux, x0, i0, weights["wx_de"], weights["wi_de"], weights["gx_ae"]]
    for W, b in weights["de_tail"] + weights["ae_tail"]:
        tensors += [W, b]
    n_bytes = sum(t.numel() * t.element_size() for t in tensors) + Tm1 * B * (xd + idim) * 4
    tail = lambda net: sum(2 * W.shape[0] * W.shape[1] for W, _ in weights[net])
    de = 2 * xd * h + tail("de_tail")
    ae = 2 * xd * h + tail("ae_tail")
    stages = {"euler": 1, "midpoint": 2, "rk4": 4}[solver]
    row_steps = Tm1 * B
    event_row_steps = int((aux[..., 1] > 0).sum().item())
    flops = row_steps * (stages * de + ae + 2 * idim * h) + event_row_steps * ae
    return n_bytes, flops


def bwd_work(streams, weights, x0, i0, aux, solver):
    """(bytes, FLOP) the reverse walk needs on these inputs. Bytes: each
    input read once (streams, aux, x0, i0, the packed solution, the
    cotangents, the weights), each output written once (three stream
    cotangents, the weight grads, g_x0, g_i0). FLOP (2 per multiply-add):
    per row-step the recomputed forward of every DE stage and of the AE at
    t+1, and their backward, two products per layer (the cotangent through
    the weight and the weight-gradient outer product); per event row-step
    the AE recompute and its backward."""
    Tm1, B, h = streams["s_de"].shape
    xd, idim = x0.shape[-1], i0.shape[-1]
    w = [weights["wx_de"], weights["wi_de"], weights["gx_ae"]]
    for W, b in weights["de_tail"] + weights["ae_tail"]:
        w += [W, b]
    w_bytes = sum(t.numel() * 4 for t in w)
    n_bytes = (6 * Tm1 * B * h + Tm1 * B * 2 + 2 * B * (xd + idim)  # streams in and out, aux, x0/i0, g_x0/g_i0
               + (2 * Tm1 + 1) * B * (xd + idim)) * 4 + 2 * w_bytes  # packed, cot; weights and grads
    tail = lambda net: sum(2 * W.shape[0] * W.shape[1] for W, _ in weights[net])
    de_fwd = 2 * h * (xd + idim) + tail("de_tail")
    de_bwd = 2 * tail("de_tail") + 4 * h * (xd + idim)
    ae_fwd = 2 * h * xd + tail("ae_tail")
    ae_bwd = 2 * tail("ae_tail") + 4 * h * xd
    stages = {"euler": 1, "midpoint": 2, "rk4": 4}[solver]
    event_row_steps = int((aux[..., 1] > 0).sum().item())
    flops = Tm1 * B * (stages * (de_fwd + de_bwd) + ae_fwd + ae_bwd) + event_row_steps * (ae_fwd + ae_bwd)
    return n_bytes, flops


def bound(n_bytes, flops):
    """(bound ms, what bounds it) against the card's published peaks."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def double(tree):
    if isinstance(tree, dict):
        return {k: double(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tuple(double(a) for a in pair) for pair in tree]
    return tree.double()


def bwd_outputs(g):
    """The backward's outputs as (name, tensor) pairs."""
    g_s, g_w, g_x0, g_i0 = g
    names = ["wx_de", "wi_de", "gx_ae"] + [
        f"{net}[{k}].{p}" for net in ("de_tail", "ae_tail") for k in range(len(g_w[net])) for p in "Wb"]
    return ([(f"g_{k}", v) for k, v in g_s.items()] + list(zip(names, V.flatten_weights(g_w)[0]))
            + [("g_x0", g_x0), ("g_i0", g_i0)])


def phase_card():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke.py needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"[card] {name}; devices: {count}; nvidia-smi: {smi}")
    say(f"[card] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name, count, smi


def phase_build():
    """Both libraries at once (one nvcc each), then load them."""
    t0 = time.perf_counter()
    names = ("fused_dae_rollout", "fused_dae_rollout_bwd")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        nvcc_s = dict(zip(names, pool.map(cuda_build.build, names)))
    F._launcher()
    V._launcher()
    for name in names:
        say(f"[build] {name}.cu: nvcc {nvcc_s[name]:.2f} s")
    say(f"[build] both built and loaded in {time.perf_counter() - t0:.2f} s")
    return nvcc_s


def phase_kernel_vs_plain(dev):
    worst_abs = 0.0
    args = random_inputs(32, 1000, 128, 3, 2, seed=0, dev=dev)
    for solver in SOLVERS:
        ref = F.fused_dae_rollout_packed_plain(*args, solver)
        shapes = [(None, None)]
        if solver == "rk4":  # every launch shape once
            shapes = [(r, k) for r in F.ROWS_PER_BLOCK for k in F.K_SPLITS]
        for rows, ks in shapes:
            got = F.fused_dae_rollout_packed_cuda(*args, solver, rows_per_block=rows, k_split=ks)
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                fail(f"kernel {solver} rows={rows} k_split={ks}: shape {tuple(got.shape)} or non-finite values")
            d = (got - ref).abs()
            bound = KERNEL_TOL * torch.clamp(ref.abs(), min=1.0)
            max_abs = d.max().item()
            max_rel = (d / torch.clamp(ref.abs(), min=1e-30)).max().item()
            ok = bool((d <= bound).all())
            say(f"[kernel] {solver:8s} rows={rows} k_split={ks}: max|d| {max_abs:.3e} "
                f"max rel {max_rel:.3e} max|ref| {ref.abs().max().item():.3f} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"kernel {solver} rows={rows} k_split={ks} disagrees with plain beyond {KERNEL_TOL}")
            worst_abs = max(worst_abs, max_abs)
    return worst_abs


def phase_bwd_vs_plain(dev):
    """The backward kernel against the float64 plain walk at the training
    shape, every solver; a relaunch must be bit-identical."""
    worst_abs = 0.0
    args = random_inputs(64, 1000, 128, 3, 2, seed=1, dev=dev)
    cot = torch.tensor(np.random.default_rng(2).standard_normal((1001, 64, 5)).astype(np.float32),
                       device=dev)
    for solver in SOLVERS:
        packed = F.fused_dae_rollout_packed_cuda(*args, solver)
        got = V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver)
        again = V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver)
        t0 = time.perf_counter()
        streams, weights, x0, i0, aux = args
        ref = V.fused_dae_rollout_bwd_plain(double(streams), double(weights), x0.double(), i0.double(),
                                            aux, packed.double(), cot.double(), solver)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        parts = []
        for (name, g), (_, r), (_, g2) in zip(bwd_outputs(got), bwd_outputs(ref), bwd_outputs(again)):
            if g.shape != r.shape or not torch.isfinite(g).all():
                fail(f"backward {solver} {name}: shape {tuple(g.shape)} or non-finite values")
            if not torch.equal(g, g2):
                fail(f"backward {solver} {name}: a relaunch gave other bits")
            d = (g.double() - r).abs().max().item()
            scale = r.abs().max().item()
            parts.append(f"{name} {d:.2e}/{scale:.3e}")
            if not scale > 0:
                fail(f"backward {solver} {name}: the plain gradient is 0, so the check holds nothing")
            if d > BWD_TOL * scale:
                fail(f"backward {solver} {name}: max|d| {d} > {BWD_TOL} * max|plain| = {BWD_TOL * scale}")
            worst_abs = max(worst_abs, d)
        say(f"[bwd-kernel] {solver:8s}: ok, bit-identical on relaunch; plain float64 walk {plain_s:.1f} s; "
            f"max|d| / max|plain| per tensor: {', '.join(parts)}")
    return worst_abs


def phase_slice(dev):
    with tempfile.TemporaryDirectory(prefix="psnode_smoke_") as tmp:
        tmp = pathlib.Path(tmp)
        shutil.copy(CKPT, tmp / CKPT.name)
        shutil.copy(TEST_DATA, tmp / TEST_DATA.name)
        argv = ["--testing", "--device", "cuda", "--model", str(tmp / CKPT.name),
                "--test_data", str(tmp / TEST_DATA.name)]
        launches = None
        for fused, solver in ((True, "euler"), (True, "rk4"), (False, "euler"), (False, "rk4")):
            F.fused_dae_rollout.launches = 0
            t0 = time.perf_counter()
            res = cli_main("dae_no_encode", argv + ["--solver", solver] + (["--fused"] if fused else []))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = F.fused_dae_rollout.launches
            x_loss, i_loss = float(res[0]), float(res[1])
            path = "fused" if fused else "plain"
            say(f"[slice] {path} {solver}: x_loss_total {x_loss:.10f} i_loss_total {i_loss:.10f} "
                f"kernel launches {n} wall {wall:.3f} s")
            ax, ai = ANCHORS[solver]
            if not (np.isfinite([x_loss, i_loss]).all()
                    and abs(x_loss - ax) <= ANCHOR_RTOL * ax and abs(i_loss - ai) <= ANCHOR_RTOL * ai):
                fail(f"{path} {solver} losses {x_loss}, {i_loss} miss the anchors {ax}, {ai} at rtol {ANCHOR_RTOL}")
            if fused and n < 1:
                fail(f"fused {solver} evaluation launched the kernel {n} times")
            if not fused and n:
                fail(f"plain {solver} evaluation launched the kernel {n} times")
            if (fused, solver) == (True, "euler"):
                launches = n  # the main path: the CLI default solver
            with np.load(tmp / "evaluation.npz", allow_pickle=True) as f:
                if len(f["eval"]) != 4:
                    fail("evaluation.npz does not hold [x_loss, i_loss, x_ps, i_ps]")
    return launches


def phase_train(dev):
    """One epoch (two steps) of the port's Trainer, fused, from checkpoint
    200 on the motor training set: Euler, then RK4, each with both kernels'
    counts set to 0 just before and read just after."""
    counts = {}
    with tempfile.TemporaryDirectory(prefix="psnode_train_") as tmp:
        tmp = pathlib.Path(tmp)
        for f in (TRAIN_DATA, TEST_DATA):
            shutil.copy(f, tmp / f.name)
        shutil.copy(CKPT, tmp / "ws.200")
        for solver in ("euler", "rk4"):
            cfg = TrainConfig(
                variant="dae_no_encode", train_data=str(tmp / TRAIN_DATA.name),
                test_data=str(tmp / TEST_DATA.name), model=str(tmp / f"run_{solver}"), num=128,
                batch=64, epoch=200, hidden=128, larger_than=None, seed=0,
                warm_start=str(tmp / "ws.200"), stop_after=1, loss_record_iter=1, solver=solver,
                fused=True, echo_logs=False, device="cuda",
            )
            F.fused_dae_rollout.launches = 0
            V.fused_dae_rollout_bwd.launches = 0
            t0 = time.perf_counter()
            _, run_dir = Trainer(cfg).train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_fwd, n_bwd = F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches
            recs = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text().splitlines()]
            steps = [r for r in recs if r["kind"] == "train"]
            (ev,) = [r for r in recs if r["kind"] == "eval"]
            for r in steps:
                say(f"[train] fused {solver} step {r['batch']}: loss {r['loss']:.8g} x_loss {r['x_loss']:.8g} "
                    f"i_loss {r['i_loss']:.8g} gradient_norm {r['grad_norm']:.8g}")
            say(f"[train] fused {solver} epoch-1 eval: x_loss {ev['x_loss']:.8g} i_loss {ev['i_loss']:.8g}; "
                f"launches: forward {n_fwd}, backward {n_bwd}; wall {wall:.2f} s")
            loss, gnorm = steps[0]["loss"], steps[0]["grad_norm"]
            a_loss, a_gnorm = TRAIN_STEP1[solver]
            if len(steps) != 2 or not (abs(loss - a_loss) <= TRAIN_STEP1_RTOL * a_loss
                                       and abs(gnorm - a_gnorm) <= TRAIN_STEP1_RTOL * a_gnorm):
                fail(f"fused {solver} step 1 (loss {loss}, gradient_norm {gnorm}) misses the anchors "
                     f"({a_loss}, {a_gnorm}) at rtol {TRAIN_STEP1_RTOL}")
            if solver == "euler":
                ax, ai = TRAIN_EVAL1_EULER
                if not (abs(ev["x_loss"] - ax) <= TRAIN_EVAL1_RTOL * ax
                        and abs(ev["i_loss"] - ai) <= TRAIN_EVAL1_RTOL * ai):
                    fail(f"fused euler epoch-1 eval ({ev['x_loss']}, {ev['i_loss']}) misses the anchors "
                         f"({ax}, {ai}) at rtol {TRAIN_EVAL1_RTOL}")
            if n_fwd < 1 or n_bwd < 1:
                fail(f"fused {solver} training launched the forward {n_fwd} and the backward {n_bwd} times")
            if not (run_dir / "model_checkpoint.1").exists():
                fail(f"fused {solver} training wrote no checkpoint")
            counts[solver] = (n_fwd, n_bwd)
    return counts


def step_ms(dev, fused, reps):
    """One training step at bench.py's shape on the motor model (B=64 of
    the training set, T=1001, h=128, RK4): streams, rollout, loss,
    backward and Adam, timed with CUDA events."""
    ds = DaeSamples.load(str(TRAIN_DATA), cut_length=1001)
    dims = (ds.x.shape[-1], ds.z.shape[-1], ds.v.shape[-1], ds.i.shape[-1])
    model = DAEModel(*dims, hidden_dim=128, solver="rk4", device="meta")
    load_params(model, load_checkpoint_params(CKPT), device=dev)
    batch = {k: torch.as_tensor(getattr(ds, k)[:64], device=dev)
             for k in ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump", "mask")}
    opt = make_optimizer(model.parameters(), 5e-3, epochs=1, steps_per_epoch=1)
    args = [batch[k] for k in ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")]
    forward = (lambda: fused_dae_apply(model, batch)) if fused else (lambda: model(*args))

    def step():
        opt.adam.zero_grad()
        loss, _ = dae_no_encode_loss(forward(), batch)
        loss.backward()
        opt.step()

    return cuda_ms(step, 1, reps), 64 * 1000


def phase_times(dev, sweep):
    times = {}
    for rep in (1, 2, 32):  # B=32 (evaluation), 64 (training step), 1024 (fleet)
        args = model_inputs(rep, dev)
        B = args[0]["s_de"].shape[1]
        for solver in SOLVERS:
            k_ms = cuda_ms(lambda: F.fused_dae_rollout_packed_cuda(*args, solver), 2, 10)
            p_ms = cuda_ms(lambda: F.fused_dae_rollout_packed_plain(*args, solver), 1, 2)
            n_bytes, flops = rollout_work(*args, solver)
            bound_ms = max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3
            bound_by = "bytes" if n_bytes / PEAK_BYTES_PER_S > flops / PEAK_F32_FLOPS else "operations"
            times[(B, solver)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
            rows, ks = F.default_launch(B, torch.cuda.get_device_properties(dev).multi_processor_count)
            say(f"[times] B={B} {solver:8s}: kernel {k_ms:.4f} ms (rows={rows}, "
                f"k_split={ks}), plain {p_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
                f"{n_bytes} B, {flops} FLOP), kernel/bound {k_ms / bound_ms:.1f}x, library n/a")
            if sweep:
                for rows in F.ROWS_PER_BLOCK:
                    for ks in F.K_SPLITS:
                        ms = cuda_ms(lambda: F.fused_dae_rollout_packed_cuda(
                            *args, solver, rows_per_block=rows, k_split=ks), 1, 5)
                        say(f"[sweep] B={B} {solver:8s} rows={rows} k_split={ks}: {ms:.4f} ms")

    # the backward at the training batch: checkpoint 200 on the test set
    # twice (B=64), the forward kernel's solution, random cotangents
    args = model_inputs(2, dev)
    cot = torch.tensor(np.random.default_rng(3).standard_normal((1001, 64, 5)).astype(np.float32)
                       * 0.01, device=dev)
    for solver in SOLVERS:
        packed = F.fused_dae_rollout_packed_cuda(*args, solver)
        k_ms = cuda_ms(lambda: V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver), 1, 5)
        p_ms = cuda_ms(lambda: V.fused_dae_rollout_bwd_plain(*args, packed, cot, solver), 0, 1)
        n_bytes, flops = bwd_work(*args, solver)
        bound_ms, bound_by = bound(n_bytes, flops)
        times[("bwd", solver)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        say(f"[times] backward B=64 {solver:8s}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by}; {n_bytes} B, {flops} FLOP), kernel/bound "
            f"{k_ms / bound_ms:.1f}x, library n/a: no single PyTorch call computes this VJP")

    for fused, reps in ((True, 5), (False, 1)):
        ms, traj_steps = step_ms(dev, fused, reps)
        times[("step", fused)] = ms
        say(f"[times] training step B=64 T=1001 h=128 rk4, {'fused' if fused else 'plain'} route: "
            f"{ms:.3f} ms, {traj_steps / ms * 1e3:.1f} trajectory-steps/s")
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="time every forward launch shape")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    name, count, smi = phase_card()
    use_full_float32()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    nvcc_s = phase_build()
    fwd_err = phase_kernel_vs_plain(dev)
    bwd_err = phase_bwd_vs_plain(dev)
    fwd_launches = phase_slice(dev)
    train_launches = phase_train(dev)
    times = phase_times(dev, args.sweep)
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all, nvcc "
        f"{', '.join(f'{k} {v:.2f} s' for k, v in nvcc_s.items())}; card {smi}")
    # the forward as the evaluation slice drives it (B=32, Euler); the
    # backward as the training slice drives it (Euler launches, times at
    # bench.py's solver RK4 and B=64)
    fwd_t, bwd_t = times[(32, "euler")], times[("bwd", "rk4")]
    entry = lambda name, src, tpu, launches, err, t: {
        "name": name, "route": "cuda", "source": src, "replaces": tpu, "launches": launches,
        "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
    }
    record = {"kernels": [
        entry("fused_dae_rollout", "py_psnode_tpu_torch/csrc/fused_dae_rollout.cu",
              "py_psnode_tpu/ops/fused_dae.py:371", fwd_launches, fwd_err, fwd_t),
        entry("fused_dae_rollout_bwd", "py_psnode_tpu_torch/csrc/fused_dae_rollout_bwd.cu",
              "py_psnode_tpu/ops/fused_dae_vjp.py:147", train_launches["euler"][1], bwd_err, bwd_t),
    ]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
