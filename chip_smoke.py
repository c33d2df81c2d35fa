#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``py_psnode_tpu_torch``) on one card.

    python3 chip_smoke.py            # the smoke run, needs one CUDA card
    python3 chip_smoke.py --sweep    # also time every kernel launch shape

Phases, each printed as it ends; any failure exits non-zero:
  1. card: name, device count, and nvidia-smi's name and power limit;
  2. build: nvcc builds the CUDA rollout kernel (seconds printed);
  3. kernel against plain: the kernel and its eager PyTorch version on the
     same seeded random inputs at the motor evaluation shape (B=32,
     T=1001, h=128, xd=3, id=2, events in some rows), for Euler, Midpoint
     and RK4, within |kernel - plain| <= 1e-4 * max(1, |plain|);
  4. slice: the port's CLI ``--testing --fused --device cuda`` on a
     temporary copy of the motor checkpoint 200 and its test set, against
     the float32 anchors of the JAX package (rtol 1e-3), with the kernel's
     launches counted; then the plain (non-fused) port path;
  5. times: kernel and plain rollout at B=32 and B=1024 (CUDA events).

The line before the last two is the kernels' JSON record, then nvidia-smi's
line, and the last line is ``{"ok": true, "device": {...}}``. Nothing is
written into the repository except the kernel build under
``py_psnode_tpu_torch/_build/`` (ignored by git).
"""

from __future__ import annotations

import argparse
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
from py_psnode_tpu_torch.ops.fused_model import rollout_inputs  # noqa: E402
from py_psnode_tpu_torch.train.checkpoints import load_checkpoint_params  # noqa: E402
from py_psnode_tpu_torch.utils import cuda_build  # noqa: E402
from py_psnode_tpu_torch.utils.device import use_full_float32  # noqa: E402

RUN_DIR = REPO / "benchmarks" / "h2h_work_prod_s0"
CKPT = RUN_DIR / "ours_dae_motor" / "model_checkpoint.200"
TEST_DATA = RUN_DIR / "data_dae_motor" / "testing.npz"
# x_loss_total / i_loss_total of the JAX package on the CPU (float32) for
# this checkpoint and test set
ANCHORS = {"euler": (0.0225037, 0.0857198), "rk4": (0.0225467, 0.0859806)}
ANCHOR_RTOL = 1e-3
KERNEL_TOL = 1e-4  # |kernel - plain| <= KERNEL_TOL * max(1, |plain|)
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
    t0 = time.perf_counter()
    nvcc_s = cuda_build.build("fused_dae_rollout")
    F._launcher()
    say(f"[build] fused_dae_rollout.cu: nvcc {nvcc_s:.2f} s, build and load {time.perf_counter() - t0:.2f} s")
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


def phase_times(dev, sweep):
    times = {}
    for rep in (1, 32):
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
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="time every kernel launch shape")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    name, count, smi = phase_card()
    use_full_float32()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    nvcc_s = phase_build()
    max_abs_err = phase_kernel_vs_plain(dev)
    launches = phase_slice(dev)
    times = phase_times(dev, args.sweep)
    main_t = times[(32, "euler")]
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all, nvcc {nvcc_s:.2f} s; card {smi}")
    record = {"kernels": [{
        "name": "fused_dae_rollout",
        "route": "cuda",
        "source": "py_psnode_tpu_torch/csrc/fused_dae_rollout.cu",
        "replaces": "py_psnode_tpu/ops/fused_dae.py:371",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
    }]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
