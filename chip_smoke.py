#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``py_psnode_tpu_torch``) on one card.

    python3 chip_smoke.py            # the smoke run, needs one CUDA card
    python3 chip_smoke.py --sweep    # also time both forwards at every launch shape

Phases, each printed as it ends; any failure exits non-zero:
  1. card: name, device count, and nvidia-smi's name and power limit;
  2. build: nvcc builds the six libraries (the DAE, ODE and channel-wise
     forward and backward) all at once (seconds printed for each);
  3. forward kernel against plain: the kernel and its eager PyTorch version
     on the same seeded random inputs at the motor evaluation shape (B=32,
     T=1001, h=128, xd=3, id=2, events in some rows), for Euler, Midpoint
     and RK4 (RK4 at every rows-a-block the wrapper can choose), within
     |kernel - plain| <= 1e-4 * max(1, |plain|), bit-identical on relaunch;
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
  7. times (CUDA events): the forward at B=32, 64 and 1024 (each solver;
     with --sweep at every rows-a-block, and at B=256 and 512 Euler, the
     evaluation batches of 256- and 512-trajectory test sets), the backward at
     B=64 for each solver beside two bounds (the h x h layers on the
     tensor cores in three TF32 passes, and all of it in float32 on the
     CUDA cores), its three kernels (recompute, walk, contraction) timed
     apart at B=64 RK4 with the contraction beside torch.matmul of the
     same operands (held against it at 1e-4 of its max), the backward at
     B=256 RK4, and one whole training step (streams, both kernels, stream
     backprop, Adam) at bench.py's shape (B=64, T=1001, h=128, RK4)
     against the plain (non-fused) route, with its peak memory;
  8. ODE forward kernel against plain: seeded random inputs at B=32,
     T=1001, h=128, for the no-encode shape (xd=2, three tail layers) with
     each solver and the direct-encode latent shape (xd=h, one tail layer)
     with Euler, within |kernel - plain| <= 1e-4 * max(1, |plain|); then
     the encode shape at lecun scale, the kernel and the float32 plain
     loop each against a float64 plain loop, the kernel at most 4x as far
     from it as the float32 plain loop;
  9. ODE backward kernel against the float64 plain walk at B=64 with
     unit-scale cotangents, each solver, each output tensor on its own
     scale as in phase 4, bit-identical on relaunch;
 10. ODE slice: the port's AVR data (128 training and 32 test samples,
     T=1001, seed 0) and the numpy starting checkpoint (h=128, seed 0);
     the port's Trainer (fused) for one epoch of two steps, Euler then RK4,
     steps 1 and 2 and the epoch-1 eval against the JAX package's anchors
     at rtol 1e-3; then the CLI ``--training --fused`` (Euler) and
     ``--testing --fused`` (Euler and RK4), each with both ODE kernels'
     launches counted; every loss must also lie nearer its own solver's
     anchor than the other's;
 11. ODE times (CUDA events): the forward at B=32 Euler, B=64 Euler and
     RK4 and B=1024 Euler (with --sweep at every rows-a-block, and at
     B=256 and 512), the backward as in phase 7 (B=64 each solver, its three
     kernels apart at RK4 beside torch.matmul, B=256 RK4), and one whole
     training step (B=64, T=1001, h=128, RK4) against the plain route,
     with its peak memory;
 12. channel-wise forward kernel against plain, for each solver, at the AVR
     ODE's channels (xd=2, zd=2) and the motor DAE's (xd=3, zd=1): seeded
     random inputs at h=40, B=5, and the numpy starting checkpoint on 64
     training rows at h=128, T=1001, within 1e-4 * max(1, |plain|) (the
     float32 plain loop lies within 2.6e-6 of a float64 one there);
 13. channel-wise backward kernel against the float64 plain walk at B=64
     (Euler and RK4 over T=1001, Midpoint over T=201, unit-scale
     cotangents), each output tensor on its own scale, bit-identical on
     relaunch;
 14. channel-wise slice: the Trainer (fused) for one epoch, Euler then RK4,
     and the CLIs ``--training --fused`` (Euler, both kernels' launches
     counted) and ``--testing --fused`` (Euler and RK4) of both variants
     from the numpy starting checkpoint (the ODE on the AVR set, batch 64;
     the DAE on 16 motor samples, batch 8), every loss against the JAX
     package's anchors (``CW_ANCHORS``) and nearer its own solver's where
     the two lie between 1e-6 and 1e-3 apart;
 15. channel-wise times (CUDA events): the forward at B=32 Euler, B=64
     Euler and B=64 RK4, the backward at B=64 for each solver, each beside
     two bounds (the h^3 products on the tensor cores in three TF32 passes,
     and all of it in float32 on the CUDA cores); the backward's pair
     contraction alone at the B=64 RK4 walk's size beside torch.einsum of
     the same pairs; kernel 5 at B = 8-64 with 1, 2 and 4 blocks a row
     beside the launcher's choice; and one whole training step per family
     (B=64, T=1001, h=128, RK4) fused and plain, with the step's peak
     memory; the fused step's loss and gradients from the starting weights
     held against the plain step's at rtol 1e-3;
 16. export: ``saved model/`` of ``--saving`` on checkpoint 200, of the
     no-encode CLIs' ``--training --fused --hidden 256`` epochs and of the
     training CLI runs of phases 10 and 14, each held against its
     checkpoint and module and rolled out in the C++ runtime;
 17. direct-encode DAE on the motor set from ``start_checkpoint`` of its
     h=128 model (seed 0), at its latent shape xd = id = h = 128 with one
     tail layer a net: kernel 1 against its plain loop on the 32 test rows
     (each solver, RK4 at every rows-a-block, bit-identical on relaunch);
     kernel 2 against the float64 plain walk on 64 training rows (Euler and
     RK4, BWD_TOL per tensor, bit-identical on relaunch); the CLI
     ``--testing --fused`` (Euler and RK4), the Trainer's ``--training
     --fused`` epoch (batch 64, Euler, steps 1 and 2 and the epoch-1 eval)
     and the CLI ``--saving`` (its nine ``.bin`` files rolled out in the
     C++ runtime against the port's plain model), every loss against the
     JAX package's anchors (``ENC_ANCHORS``) and kernels 1 and 2's launches
     counted on each fused run; then the forward alone at B=32 Euler, both
     kernels alone at B=64 RK4 and one training step (B=64, T=1001, RK4),
     fused and plain, with its peak memory;
 18. direct-encode ODE on the AVR set of phase 10, the same from the CLI on
     (kernels 3 and 4 at xd = h = 128, one tail layer);
 19. teacher forcing (``--input_true_x`` / ``--input_true_i``): kernel 1 in
     its TF-x mode against its plain loop on seeded true states (B=32,
     T=1001, the motor shape with each solver, the direct-encode latent
     shape with Euler and RK4; KERNEL_TOL, bit-identical on relaunch);
     kernel 2 in its TF-x mode against the float64 plain walk (B=64, the
     motor shape, Euler and RK4, with and without the true states'
     cotangents g_xt / g_xt1, and the encode shape with Euler; BWD_TOL on
     every tensor, bit-identical on relaunch); the Trainer (fused, one
     epoch of two steps, Euler) for every combination the JAX package
     dispatches (the motor DAE from checkpoint 200 and the direct-encode
     DAE with TF-x, TF-i and both; both ODEs on the AVR set with TF-x),
     steps 1 and 2 and the teacher-forced epoch-1 eval against the JAX
     package's anchors (``TF_ANCHORS``) at rtol 1e-3, the TF-x DAE runs
     launching kernels 1-2, the TF-i runs kernels 3-4 and the time-parallel
     runs none of kernels 1-4; the CLI ``--training --fused --input_true_x``
     of the motor DAE and ``--testing --fused --input_true_x`` on its
     checkpoint; then at B=64, T=1001, RK4 both TF-x kernels alone beside
     their bounds (and the forward at B=32 Euler) and one TF-x training
     step of each DAE family, fused and plain, with its peak memory, the
     fused step's loss and gradients held against the plain step's;
 20. multiple shooting (``--n_windows`` / ``--gap_weight``, K=20 windows of
     50 steps): kernels 1-4 at the folded batch (B = 20 x 64 = 1 280 rows,
     T-1 = 50, h=128) on seeded inputs with events at step 0 (a window's
     first step) among others, kernels 1 and 3 against their plain loops
     (each solver, RK4 at every rows-a-block, KERNEL_TOL), kernels 2 and 4
     against the float64 plain walk (Euler and RK4, BWD_TOL per tensor),
     bit-identical on relaunch; the Trainer (fused, ``n_windows=20``,
     ``gap_weight=0.3``, one epoch of two steps, Euler) of all six variants
     from the starting weights of phases 6, 10, 14 and 17-18, steps 1 and 2
     and the full-rollout epoch-1 eval against the JAX package's anchors
     (``MS_ANCHORS``) at rtol 1e-3, the DAE runs launching kernels 1-2 and
     the ODE runs kernels 3-4 at 1 280 rows in their training steps, the
     channel-wise runs kernel 5 only in their evaluations and kernel 6
     never; the CLI ``--training --fused --n_windows 20 --gap_weight 0.3``
     of the motor DAE and ``--n_windows 7`` refused with the JAX package's
     error; then, at B=64, T=1001, RK4, kernels 1-4 alone on the launches
     of one fused multishoot step (beside their plain versions, bounds and
     the 64 x 1000 times of phases 7 and 11) and one training step of the
     motor DAE, the AVR ODE and the direct-encode DAE through the fused
     multishoot, the plain multishoot and the non-windowed fused forward,
     each with its peak memory, the fused multishoot step's loss and
     gradients held against the plain one's.

The line before the last two is the kernels' JSON record, then nvidia-smi's
line, and the last line is ``{"ok": true, "device": {...}}``. Nothing is
written into the repository except the kernel builds under
``py_psnode_tpu_torch/_build/`` (ignored by git).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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
from py_psnode_tpu_torch.data import DaeSamples, OdeSamples  # noqa: E402
from py_psnode_tpu_torch.data.synthetic import write_avr_dataset  # noqa: E402
from py_psnode_tpu_torch.export import flatten_channelwise, read_weights_bin  # noqa: E402
from py_psnode_tpu_torch.export import native_runtime as NR  # noqa: E402
from py_psnode_tpu_torch.models import (  # noqa: E402
    ChannelWiseDAEModel,
    ChannelWiseODEModel,
    DAEEncodeModel,
    DAEModel,
    ODEEncodeModel,
    ODEModel,
)
from py_psnode_tpu_torch.models.initializers import init_params  # noqa: E402
from py_psnode_tpu_torch.ops import fused_channelwise as FC  # noqa: E402
from py_psnode_tpu_torch.ops import fused_channelwise_vjp as VC  # noqa: E402
from py_psnode_tpu_torch.ops import fused_dae as F  # noqa: E402
from py_psnode_tpu_torch.ops import fused_dae_vjp as V  # noqa: E402
from py_psnode_tpu_torch.ops import fused_ode as FO  # noqa: E402
from py_psnode_tpu_torch.ops import fused_ode_vjp as VO  # noqa: E402
from py_psnode_tpu_torch.ops.noencode_bwd import STAGES, net_operands  # noqa: E402
from py_psnode_tpu_torch.ops.fused_model import (  # noqa: E402
    cw_rollout_inputs,
    dae_encode_setup,
    fused_cw_dae_apply,
    fused_cw_ode_apply,
    fused_dae_apply,
    fused_dae_encode_apply,
    fused_ode_apply,
    fused_ode_encode_apply,
    ode_encode_rollout_inputs,
    ode_rollout_inputs,
    rollout_inputs,
)
from py_psnode_tpu_torch.ops import teacher_forcing as TF  # noqa: E402
from py_psnode_tpu_torch.train import TrainConfig, Trainer  # noqa: E402
from py_psnode_tpu_torch.train import multishoot_forward as MS  # noqa: E402
from py_psnode_tpu_torch.train.checkpoints import load_checkpoint_params  # noqa: E402
from py_psnode_tpu_torch.train.variants import VARIANTS, export_examples  # noqa: E402
from py_psnode_tpu_torch.train.losses import (  # noqa: E402
    dae_channelwise_loss,
    dae_encode_loss,
    dae_no_encode_loss,
    ode_channelwise_loss,
    ode_encode_loss,
    ode_no_encode_loss,
)
from py_psnode_tpu_torch.train.optim import make_optimizer  # noqa: E402
from py_psnode_tpu_torch.utils import cuda_build  # noqa: E402
from py_psnode_tpu_torch.utils.device import use_full_float32  # noqa: E402
from py_psnode_tpu_torch.utils.noencode_inputs import with_first_step_events  # noqa: E402

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
# The ODE slice (AVR data and the numpy starting checkpoint, both seed 0;
# one epoch of training, batch 64, lr 5e-3, seed 0): step 1 and step 2
# (loss, gradient norm), the epoch-1 eval x_loss, and the --testing
# x_loss_total on the starting checkpoint, of the JAX package on the CPU in
# float32; re-derived by `python tests/test_torch_ode_slice.py` (needs JAX).
ODE_ANCHORS = {
    "euler": dict(step1=(42.697582, 115.89577), step2=(35.27792, 113.6741),
                  eval1_x_loss=18.735991, test_x_loss=37.461788),
    "rk4": dict(step1=(42.720161, 115.87241), step2=(35.205109, 113.66186),
                eval1_x_loss=18.748568, test_x_loss=37.491188),
}
# The direct-encode variants from start_checkpoint of their h=128 models
# (seed 0): the ODE on the AVR data of ODE_ANCHORS, the DAE on the motor set
# (128 training, 32 test samples); one epoch of training, batch 64, lr
# 5e-3, seed 0. Step 1 and step 2 (loss, gradient norm), the epoch-1 eval
# and the --testing losses (x_loss_total, and i_loss_total for the DAE) of
# the JAX package on the CPU in float32; re-derived by `python
# tests/test_torch_ode_encode.py` and `python tests/test_torch_dae_encode.py`
# (need JAX).
ENC_ANCHORS = {
    "ode_encode": {
        "euler": dict(step1=(101.31021, 242.83273), step2=(119222.38, 181.4782), eval1=(156.06993,),
                      test=(45.469639,)),
        "rk4": dict(step1=(101.33388, 242.71843), step2=(119507.25, 181.48962), eval1=(152.79103,),
                    test=(45.487068,)),
    },
    "dae_encode": {
        "euler": dict(step1=(14.658771, 380.28116), step2=(1181.8832, 300.48007), eval1=(126.44679, 21.019417),
                      test=(5.0804763, 1.8751848)),
        "rk4": dict(step1=(14.683273, 380.15518), step2=(1184.6495, 300.51721), eval1=(130.56729, 21.614664),
                    test=(5.1164093, 1.8736318)),
    },
}
# Teacher forcing (phase 19), every combination the JAX package dispatches,
# one epoch of two steps (Euler, batch 64, lr 5e-3, seed 0): the motor DAE
# from checkpoint 200 and the direct-encode DAE from its starting
# checkpoint (the motor set), the ODEs from theirs on the AVR set of
# ODE_ANCHORS; flags "x" (input_true_x), "i" (input_true_i), "xi" (both).
# Step 1 and step 2 (loss, gradient norm) and the teacher-forced epoch-1
# eval (x_loss, and i_loss for a DAE) of the JAX package on the CPU in
# float32; re-derived by `python tests/test_torch_tf_slice.py anchors`
# (needs JAX).
TF_ANCHORS = {
    "dae_no_encode": {
        "x": dict(step1=(0.18992327, 28.449398), step2=(37.592972, 137.90556), eval1=(0.00021556679, 0.59756041)),
        "i": dict(step1=(0.18652777, 84.542191), step2=(98.78833, 184.03008), eval1=(0.62142569, 9.8368073)),
        "xi": dict(step1=(0.18993807, 28.450203), step2=(37.58601, 137.85074), eval1=(0.00024647237, 0.59774137)),
    },
    "dae_encode": {
        "x": dict(step1=(13.127804, 306.38052), step2=(72.295761, 328.36536), eval1=(0.57797396, 23.298218)),
        "i": dict(step1=(17.682583, 378.7027), step2=(786.80896, 273.40555), eval1=(639.07483, 46.74192)),
        "xi": dict(step1=(13.126011, 305.29776), step2=(72.229874, 303.23047), eval1=(0.58926827, 23.261961)),
    },
    "ode_no_encode": {"x": dict(step1=(0.022299383, 0.44636983), step2=(0.021688376, 0.48730695),
                                eval1=(0.015616274,))},
    "ode_encode": {"x": dict(step1=(85.85289, 177.36066), step2=(155.08521, 170.27582), eval1=(9.3136806,))},
}
# Multiple shooting (phase 20): K=20 windows of 50 steps, gap weight 0.3,
# one epoch of two steps (Euler) of every variant from the starting weights
# of phases 6, 10, 14 and 17-18 (batch 64; the DAE channel-wise batch 8 of
# 16 samples). Step 1 and step 2 (loss with the gap term, gradient norm)
# and the epoch-1 eval, a full rollout (x_loss, and i_loss for a DAE), of
# the JAX package on the CPU in float32; re-derived by `python
# tests/test_torch_ms_slice.py anchors` (needs JAX).
MS_WINDOWS, MS_GAP_WEIGHT = 20, 0.3
MS_ANCHORS = {
    "dae_no_encode": dict(step1=(0.28123468, 45.82851), step2=(11.56814, 189.61459), eval1=(2.709034, 22.047993)),
    "dae_encode": dict(step1=(12.908703, 384.24515), step2=(96.672607, 349.67581), eval1=(23.383722, 29.491858)),
    "ode_no_encode": dict(step1=(13.308715, 90.516716), step2=(12.71443, 114.7192), eval1=(16.870262,)),
    "ode_encode": dict(step1=(86.876167, 202.29056), step2=(229.62177, 183.03371), eval1=(37.526005,)),
    "ode_channelwise": dict(step1=(58.874332, 168.33717), step2=(19.640543, 313.87024), eval1=(27.354507,)),
    "dae_channelwise": dict(step1=(4.1592588, 219.6868), step2=(6.9422183, 406.82547),
                            eval1=(6.0395126, 7.8608441)),
}
# Per output tensor, on its own scale: max|kernel - plain| <= BWD_TOL *
# max|plain|. Each weight gradient sums 64 x 1000 row-steps in another
# order than the float64 plain walk, and each row's cotangent is carried
# back through 1000 steps of float32; a tensor whose plain maximum is 0
# fails, as it would hold the kernel to nothing.
BWD_TOL = 1e-4
# Where the float32 rollout is ill-conditioned (the encode shape at lecun
# scale), the kernel's distance to a float64 loop may be at most this many
# times the float32 plain loop's: the two sum in other orders, so neither
# is the reference there.
ODE_F64_RATIO = 4.0
# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, TF32 on
# the tensor cores (dense), HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
SOLVERS = ("euler", "midpoint", "rk4")


def ode_start_checkpoint(path, dims, hidden, seed):
    """Write the ODE no-encode model's starting weights as a flax-layout npz
    checkpoint (``params/de_func/x_dot/dense_k/{kernel,bias}``), drawn with
    numpy so that every machine gets the same bits: each kernel ``[in,
    out]`` a standard normal clipped to +-2 and scaled by ``1/sqrt(in)``,
    each bias zero. ``dims`` is ``(xd, zd)``."""
    xd, zd = dims
    rng = np.random.default_rng(seed)
    widths = [3 * (xd + zd), hidden, hidden, hidden, xd]
    flat = {}
    for k, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
        w = np.clip(rng.standard_normal((n_in, n_out)), -2.0, 2.0) / np.sqrt(n_in)
        flat[f"params/de_func/x_dot/dense_{k}/kernel"] = w.astype(np.float32)
        flat[f"params/de_func/x_dot/dense_{k}/bias"] = np.zeros(n_out, np.float32)
    with open(path, "wb") as f:  # a file object: np.savez appends no ".npz"
        np.savez(f, **flat)
    return pathlib.Path(path)


def start_checkpoint(path, model, seed):
    """Write the starting weights of a port model (on any device, ``meta``
    included) as a flax-layout npz checkpoint, drawn with numpy so that
    every machine gets the same bits: in sorted key order, each dense
    kernel ``[in, out]`` and each per-channel stack ``w_k [C, d_in, f]`` a
    standard normal clipped to +-2 and scaled by ``1/sqrt(fan_in)`` with
    flax's fan-in (``in``, and ``C * d_in`` for a stack), each bias
    zero."""
    shapes = {}
    for name, prm in model.named_parameters():
        *mod, leaf = name.split(".")
        if leaf == "weight":  # nn.Linear [out, in] -> flax kernel [in, out]
            shapes["/".join(mod + ["kernel"])] = ((prm.shape[1], prm.shape[0]), prm.shape[1])
        elif leaf.startswith("w_"):
            shapes["/".join(mod + [leaf])] = (tuple(prm.shape), prm.shape[0] * prm.shape[1])
        else:
            shapes["/".join(mod + [leaf])] = (tuple(prm.shape), None)
    rng = np.random.default_rng(seed)
    flat = {}
    for key in sorted(shapes):
        shape, fan_in = shapes[key]
        if fan_in is None:
            w = np.zeros(shape)
        else:
            w = np.clip(rng.standard_normal(shape), -2.0, 2.0) / np.sqrt(fan_in)
        flat[f"params/{key}"] = w.astype(np.float32)
    with open(path, "wb") as f:  # a file object: np.savez appends no ".npz"
        np.savez(f, **flat)
    return pathlib.Path(path)


def cw_start_checkpoint(path, variant, dims, hidden, seed):
    """:func:`start_checkpoint` of a channel-wise model: ``variant`` is
    ``ode_channelwise`` with ``dims = (xd, zd)`` or ``dae_channelwise`` with
    ``(xd, zd, vd, id)``."""
    cls = ChannelWiseODEModel if variant == "ode_channelwise" else ChannelWiseDAEModel
    return start_checkpoint(path, cls(*dims, hidden_dim=hidden, device="meta"), seed)


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
    events at two steps (303 and 333, modulo T-1) in a quarter of the rows."""
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
    ev[303 % Tm1, : B // 4] = True
    ev[333 % Tm1, : B // 4] = True
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
    """(bytes, FLOP, tensor-core FLOP) the reverse walk needs on these
    inputs. Bytes: each input read once (streams, aux, x0, i0, the packed
    solution, the cotangents, the weights), each output written once (three
    stream cotangents, the weight grads, g_x0, g_i0). FLOP (2 per
    multiply-add): per row-step the recomputed forward of every DE stage
    and of the AE at t+1, and their backward, two products per layer (the
    cotangent through the weight and the weight-gradient outer product);
    per event row-step the AE recompute and its backward. The tensor-core
    FLOP are those of the h x h layers (forward, cotangent and weight
    gradient), which kernel 2 runs in 3xTF32."""
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
    hh = lambda net: 3 * sum(2 * h * h for W, _ in weights[net] if tuple(W.shape) == (h, h))
    tc = Tm1 * B * (stages * hh("de_tail") + hh("ae_tail")) + event_row_steps * hh("ae_tail")
    return n_bytes, flops, tc


def bound(n_bytes, flops, tc_flops=0):
    """(bound ms, what bounds it) against the card's published peaks: the
    bytes at the memory rate, or the FLOP at float32's rate on the CUDA
    cores, of which ``tc_flops`` run on the tensor cores at float32
    accuracy in three TF32 passes (3xTF32), 3 x their FLOP at the TF32
    rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = (flops - tc_flops) / PEAK_F32_FLOPS + 3 * tc_flops / PEAK_TF32_FLOPS
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
    """The six libraries at once (one nvcc each), then load them."""
    t0 = time.perf_counter()
    names = ("fused_dae_rollout", "fused_dae_rollout_bwd", "fused_ode_rollout",
             "fused_ode_rollout_bwd", "fused_cw_rollout", "fused_cw_rollout_bwd")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        nvcc_s = dict(zip(names, pool.map(cuda_build.build, names)))
    for mod in (F, V, FO, VO, FC, VC):
        mod._launcher()
    for name, t in nvcc_s.items():
        say(f"[build] {name}: nvcc {t:.2f} s")
    say(f"[build] all built and loaded in {time.perf_counter() - t0:.2f} s")
    return nvcc_s


def phase_kernel_vs_plain(dev):
    worst_abs = 0.0
    args = random_inputs(32, 1000, 128, 3, 2, seed=0, dev=dev)
    for solver in SOLVERS:
        ref = F.fused_dae_rollout_packed_plain(*args, solver)
        shapes = [None]
        if solver == "rk4":  # every launch shape once
            shapes = list(F.ROWS_PER_BLOCK)
        for rows in shapes:
            got = F.fused_dae_rollout_packed_cuda(*args, solver, rows_per_block=rows)
            again = F.fused_dae_rollout_packed_cuda(*args, solver, rows_per_block=rows)
            torch.cuda.synchronize()
            max_abs = hold_fwd(f"kernel {solver} rows={rows}", got, again, ref)
            max_rel = ((got - ref).abs() / torch.clamp(ref.abs(), min=1e-30)).max().item()
            say(f"[kernel] {solver:8s} rows={rows}: max|d| {max_abs:.3e} "
                f"max rel {max_rel:.3e} max|ref| {ref.abs().max().item():.3f} ok")
            worst_abs = max(worst_abs, max_abs)
    return worst_abs


def hold_fwd(what, got, again, ref):
    """Fail unless a forward kernel's result is finite, of the plain one's
    shape, bit-identical on relaunch and within KERNEL_TOL * max(1,
    |plain|) of it; returns max|d|."""
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{what}: shape {tuple(got.shape)} or non-finite values")
    if not torch.equal(got, again):
        fail(f"{what}: a relaunch gave other bits")
    d = (got - ref).abs()
    if not bool((d <= KERNEL_TOL * ref.abs().clamp(min=1.0)).all()):
        fail(f"{what} disagrees with plain beyond {KERNEL_TOL}: max|d| {d.max().item()}")
    return d.max().item()


def hold_bwd(what, names, got, again, ref):
    """Fail unless each output tensor of a backward kernel is finite, of the
    plain one's shape, bit-identical on relaunch and within BWD_TOL of the
    plain walk on its own scale; returns (worst max|d|, the per-tensor
    report)."""
    worst, parts = 0.0, []
    for name, g, g2, r in zip(names, got, again, ref):
        if g.shape != r.shape or not torch.isfinite(g).all():
            fail(f"{what} {name}: shape {tuple(g.shape)} or non-finite values")
        if not torch.equal(g, g2):
            fail(f"{what} {name}: a relaunch gave other bits")
        d = (g.double() - r).abs().max().item()
        scale = r.abs().max().item()
        parts.append(f"{name} {d:.2e}/{scale:.3e}")
        if not scale > 0:
            fail(f"{what} {name}: the plain gradient is 0, so the check holds nothing")
        if d > BWD_TOL * scale:
            fail(f"{what} {name}: max|d| {d} > {BWD_TOL} * max|plain| = {BWD_TOL * scale}")
        worst = max(worst, d)
    return worst, ", ".join(parts)


# The wide backward kernels' cases, (h, T-1): B=64, RK4; T=201 at h=512,
# where the float64 plain walk of T=1001 is slow
WIDE_BWD = ((256, 1000), (512, 200))


def phase_bwd_vs_plain(dev):
    """The backward kernel against the float64 plain walk at the training
    shape, every solver, and at the wide widths (RK4); a relaunch must be
    bit-identical."""
    worst_abs = 0.0
    cases = [(128, 1000, solver) for solver in SOLVERS] + [(h, Tm1, "rk4") for h, Tm1 in WIDE_BWD]
    for h, Tm1, solver in cases:
        args = random_inputs(64, Tm1, h, 3, 2, seed=1, dev=dev)
        cot = torch.tensor(np.random.default_rng(2).standard_normal((Tm1 + 1, 64, 5)).astype(np.float32),
                           device=dev)
        packed = F.fused_dae_rollout_packed_cuda(*args, solver)
        got = V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver)
        again = V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver)
        t0 = time.perf_counter()
        streams, weights, x0, i0, aux = args
        ref = V.fused_dae_rollout_bwd_plain(double(streams), double(weights), x0.double(), i0.double(),
                                            aux, packed.double(), cot.double(), solver)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        names = [n for n, _ in bwd_outputs(got)]
        flat = lambda g: [v for _, v in bwd_outputs(g)]
        worst, report = hold_bwd(f"backward h={h} {solver}", names, flat(got), flat(again), flat(ref))
        if h == 128:  # the record's max_abs_err: the main path's width
            worst_abs = max(worst_abs, worst)
        say(f"[bwd-kernel] h={h} T={Tm1 + 1} {solver:8s}: ok, bit-identical on relaunch; plain float64 walk "
            f"{plain_s:.1f} s; max|d| / max|plain| per tensor: {report}")
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
    backward and Adam, timed with CUDA events; returns (ms, trajectory-steps,
    peak memory allocated in bytes)."""
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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    return cuda_ms(step, 1, reps), 64 * 1000, torch.cuda.max_memory_allocated(dev)


def timed_steps(model, batch, apply, loss_fn, keys, dev, fused, reps, plain_kw=None):
    """Training steps of ``model`` on ``batch`` (streams, rollout, loss,
    backward and Adam; the fused route ``apply(model, batch)`` or the plain
    ``model(*batch[keys], **plain_kw)``), timed with CUDA events after one
    untimed step; returns (ms, peak bytes allocated, the first step's loss,
    the first step's gradient of each parameter)."""
    opt = make_optimizer(model.parameters(), 5e-3, epochs=1, steps_per_epoch=1)
    plain = lambda: model(*[batch[k] for k in keys], **(plain_kw or {}))
    forward = (lambda: apply(model, batch)) if fused else plain
    first = {}

    def step():
        opt.adam.zero_grad()
        loss, _ = loss_fn(forward(), batch)
        loss.backward()
        if not first:  # the untimed warm-up step, from the starting weights
            first["loss"] = loss.item()
            first["grads"] = {n: torch.zeros_like(q) if q.grad is None else q.grad.detach().clone()
                              for n, q in model.named_parameters()}
        opt.step()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(step, 1, reps)
    return ms, torch.cuda.max_memory_allocated(dev), first["loss"], first["grads"]


def wide_step(tag, family, make_model, batch, apply, loss_fn, keys, dev):
    """One fused RK4 training step at a wide width (fresh lecun weights,
    seed 0) timed with its peak memory, and its first step's loss and
    gradients held against the plain route's from the same weights and
    batch (check_cw_step's bar); returns the fused ms."""
    first = {}
    for fused, reps in ((True, 3), (False, 1)):
        model = init_params(make_model(), "lecun", 0)
        ms, peak, loss, grads = timed_steps(model, batch, apply, loss_fn, keys, dev, fused, reps)
        first[fused] = loss, grads
        say(f"{tag} training step B=64 T=1001 h=256 rk4, {'fused' if fused else 'plain'} route: {ms:.3f} ms, "
            f"{64 * 1000 / ms * 1e3:.1f} "
            f"trajectory-steps/s, peak memory allocated {peak / 2**30:.2f} GiB")
        if fused:
            fused_ms = ms
    check_cw_step(f"{family} h=256", first[True], first[False], tag="[step-check]")
    return fused_ms


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
            rows = F.default_launch(B, torch.cuda.get_device_properties(dev).multi_processor_count)
            say(f"[times] B={B} {solver:8s}: kernel {k_ms:.4f} ms (rows={rows}), plain {p_ms:.3f} ms, "
                f"bound {bound_ms:.5f} ms ({bound_by}; {n_bytes} B, {flops} FLOP), kernel/bound "
                f"{k_ms / bound_ms:.1f}x, library n/a")
            if sweep:
                for rows in F.ROWS_PER_BLOCK:
                    ms = cuda_ms(lambda: F.fused_dae_rollout_packed_cuda(*args, solver, rows_per_block=rows), 1, 5)
                    say(f"[sweep] dae forward B={B} {solver:8s} rows={rows}: {ms:.4f} ms")
    # with --sweep, the evaluation batch of a 256- and a 512-trajectory test
    # set (Trainer._eval_batch_size: a set of at most 512 runs as one batch)
    for rep in (8, 16) if sweep else ():
        args = model_inputs(rep, dev)
        for rows in F.ROWS_PER_BLOCK:
            ms = cuda_ms(lambda: F.fused_dae_rollout_packed_cuda(*args, "euler", rows_per_block=rows), 1, 5)
            say(f"[sweep] dae forward B={32 * rep} euler    rows={rows}: {ms:.4f} ms")

    # the backward at the training batch: checkpoint 200 on the test set
    # twice (B=64), the forward kernel's solution, random cotangents
    args = model_inputs(2, dev)
    cot = torch.tensor(np.random.default_rng(3).standard_normal((1001, 64, 5)).astype(np.float32)
                       * 0.01, device=dev)
    for solver in SOLVERS:
        packed = F.fused_dae_rollout_packed_cuda(*args, solver)
        k_ms = cuda_ms(lambda: V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver), 1, 5)
        p_ms = cuda_ms(lambda: V.fused_dae_rollout_bwd_plain(*args, packed, cot, solver), 0, 1)
        n_bytes, flops, tc = bwd_work(*args, solver)
        times[("bwd", solver)] = bwd_times_line("[times] backward B=64", solver, k_ms, p_ms, n_bytes, flops, tc)
    times["split"] = noencode_split(
        "[times] backward B=64 rk4", lambda st, bufs=None: V._launch_bwd(*args, packed, cot, "rk4", stages=st, bufs=bufs),
        lambda b: dae_contraction(b, args, "rk4"), lambda g: V.flatten_weights(g)[0])
    args256 = model_inputs(8, dev)  # the test set eight times: B=256
    cot256 = torch.tensor(np.random.default_rng(3).standard_normal((1001, 256, 5)).astype(np.float32)
                          * 0.01, device=dev)
    packed = F.fused_dae_rollout_packed_cuda(*args256, "rk4")
    k_ms = cuda_ms(lambda: V.fused_dae_rollout_bwd_cuda(*args256, packed, cot256, "rk4"), 1, 3)
    n_bytes, flops, tc = bwd_work(*args256, "rk4")
    bwd_times_line("[times] backward B=256", "rk4", k_ms, None, n_bytes, flops, tc)
    del args256, cot256, packed

    # the wide kernels: B=64 RK4 at h=256 (T=1001) and h=512 (T=201)
    for h, Tm1 in WIDE_BWD:
        wargs = random_inputs(64, Tm1, h, 3, 2, seed=1, dev=dev)
        wcot = torch.tensor(np.random.default_rng(3).standard_normal((Tm1 + 1, 64, 5)).astype(np.float32)
                            * 0.01, device=dev)
        packed = F.fused_dae_rollout_packed_cuda(*wargs, "rk4")
        k_ms = cuda_ms(lambda: V.fused_dae_rollout_bwd_cuda(*wargs, packed, wcot, "rk4"), 1, 3)
        p_ms = cuda_ms(lambda: V.fused_dae_rollout_bwd_plain(*wargs, packed, wcot, "rk4"), 0, 1)
        what = f"[times] backward B=64 T={Tm1 + 1} h={h}"
        times[("bwd", h)] = bwd_times_line(what, "rk4", k_ms, p_ms, *bwd_work(*wargs, "rk4"))
        times[("split", h)] = noencode_split(
            f"{what} rk4", lambda st, bufs=None: V._launch_bwd(*wargs, packed, wcot, "rk4", stages=st, bufs=bufs),
            lambda b: dae_contraction(b, wargs, "rk4"), lambda g: V.flatten_weights(g)[0])
        del wargs, wcot, packed
    ds = DaeSamples.load(str(TRAIN_DATA), cut_length=1001)
    dims = (ds.x.shape[-1], ds.z.shape[-1], ds.v.shape[-1], ds.i.shape[-1])
    keys = ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")
    batch = {k: torch.as_tensor(getattr(ds, k)[:64], device=dev) for k in keys + ("mask",)}
    times[("step", 256)] = wide_step(
        "[times]", "dae_no_encode",
        lambda: DAEModel(*dims, hidden_dim=256, solver="rk4", device=dev), batch, fused_dae_apply,
        dae_no_encode_loss, keys, dev)

    for fused, reps in ((True, 5), (False, 1)):
        ms, traj_steps, peak = step_ms(dev, fused, reps)
        times[("step", fused)] = ms
        say(f"[times] training step B=64 T=1001 h=128 rk4, {'fused' if fused else 'plain'} route: "
            f"{ms:.3f} ms, {traj_steps / ms * 1e3:.1f} trajectory-steps/s, peak memory allocated "
            f"{peak / 2**30:.2f} GiB")
    return times


def bwd_times_line(what, solver, k_ms, p_ms, n_bytes, flops, tc):
    """Prints a backward kernel's time beside its two bounds (3xTF32 for
    the h x h products, and all on the CUDA cores); returns the record."""
    bound_ms, bound_by = bound(n_bytes, flops, tc)
    cuda_core_ms = bound(n_bytes, flops)[0]
    plain = "not timed" if p_ms is None else f"{p_ms:.3f} ms"
    say(f"{what} {solver:8s}: kernel {k_ms:.4f} ms, plain {plain}, bound {bound_ms:.5f} ms (3xTF32 "
        f"tensor cores for the {tc} FLOP of the h x h layers, the rest float32; {bound_by}; {n_bytes} B, "
        f"{flops} FLOP), kernel/bound {k_ms / bound_ms:.1f}x; CUDA-core float32 bound {cuda_core_ms:.5f} ms, "
        f"kernel/that {k_ms / cuda_core_ms:.1f}x; library n/a: no single PyTorch call computes this VJP")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by, cuda_core_ms=cuda_core_ms)


def dae_contraction(bufs, args, solver):
    """Kernel 2's contraction done plainly on the walk's buffers: the
    gradients in the order of ``flatten_weights`` (``contract_plain``,
    float32 matrix products), and the products' operands ``(U, V, bias)``
    (``net_operands``, the AE at the event on event rows only) for the
    yardstick."""
    streams, weights, x0, i0, aux = args
    Tm1, B, h = streams["s_de"].shape
    R, S, xd, idim = Tm1 * B, STAGES[solver], x0.shape[-1], i0.shape[-1]
    n_de, n_ae = len(weights["de_tail"]), len(weights["ae_tail"])
    L = max(n_de, n_ae)
    res, gres = bufs["res"].view(S + 2, L, R, h), bufs["gres"].view(S + 2, L, R, h)
    gy, xin = bufs["gy"].view(S + 2, R, -1), bufs["xin"].view(S + 2, R, -1)
    ev = aux[..., 1].reshape(R) > 0
    ref = V.flatten_weights(V.contract_plain(res, gres, gy, xin, ev, (n_de, n_ae), xd, idim))[0]
    ops = (net_operands(res, gres, gy, xin, range(S), xd + idim, n_de, xd)
           + net_operands(res, gres, gy, xin, (S, S + 1), xd, n_ae, idim, keep=ev))
    return ref, ops


def noencode_split(what, launch, contraction, flat):
    """A redesigned backward's three kernels timed alone (``launch(stages,
    bufs)``: 1 the recompute, 2 the walk, 4 the contraction) on the
    buffers of one whole run, and the contraction beside ``torch.matmul``
    of the same operands (``contraction(bufs)``: the plain gradients and
    the operands, gathered outside the timing; the yardstick
    ``library_ms``, not called by the port); the contraction's gradients
    (``flat(g_weights)``) held against the plain ones at 1e-4 of their
    max."""
    _, bufs = launch(7)
    ms = {name: cuda_ms(lambda: launch(bit, bufs), 1, 3) for bit, name in
          ((1, "recompute"), (2, "walk"), (4, "contraction"))}
    g_w = launch(4, bufs)[0][1]
    ref, ops = contraction(bufs)
    torch.cuda.synchronize()
    for g, r in zip(flat(g_w), ref):
        d = (g - r).abs().max().item()
        if not d <= 1e-4 * r.abs().max().item():
            fail(f"{what} contraction lies {d} from torch.matmul of its buffers (max {r.abs().max().item()})")
    l_ms = cuda_ms(lambda: [(u.T @ v, v.sum(0) if b else None) for u, v, b in ops], 1, 3)
    n_bytes = sum((u.numel() + v.numel()) * 4 + u.shape[1] * v.shape[1] * 4 for u, v, _ in ops)
    flops = sum(2 * u.shape[0] * u.shape[1] * v.shape[1] + (u.shape[0] * v.shape[1] if b else 0)
                for u, v, b in ops)
    tc = sum(2 * u.shape[0] * u.shape[1] * v.shape[1] for u, v, _ in ops if u.shape[1] == v.shape[1] > 8)
    bound_ms, bound_by = bound(n_bytes, flops, tc)
    say(f"{what}: recompute {ms['recompute']:.3f} ms, walk {ms['walk']:.3f} ms, contraction "
        f"{ms['contraction']:.3f} ms (bound {bound_ms:.4f} ms, {bound_by}: {n_bytes} B of operands, 3xTF32 for the "
        f"{tc} FLOP of its h x h sums; torch.matmul of the same operands {l_ms:.3f} ms, the yardstick, not called "
        f"by the port)")
    return dict(ms, library_ms=l_ms, contraction_bound_ms=bound_ms)

# ------------------------------------------------------------------ the ODE


def ode_random_inputs(B, Tm1, h, xd, n_tail, seed, dev, readout=0.1):
    """Seeded random ODE rollout inputs: lecun-scaled weights with the
    readout (the last tail layer) scaled by ``readout`` more, dt = 0.01.
    The default readout keeps the rolled state bounded over 1000 steps; at
    ``readout=1`` (lecun scale) the 128-wide latent state of the encode
    shape grows to about 3e3, where the float32 sums of any order drift
    apart (phase 8 measures how far)."""
    rng = np.random.default_rng(seed)
    t = lambda shape, scale: torch.tensor(
        (rng.standard_normal(shape) * scale).astype(np.float32), device=dev
    )
    outs = [h] * (n_tail - 1) + [xd]
    scale = [1.0] * (n_tail - 1) + [readout]
    weights = dict(wx_de=t((xd, h), 1 / np.sqrt(xd)),
                   de_tail=[(t((h, o), c / np.sqrt(h)), t((o,), 0.1 * c)) for o, c in zip(outs, scale)])
    return t((Tm1, B, h), 0.5), weights, t((B, xd), 1.0), torch.full((Tm1, B, 1), 0.01, device=dev)


def ode_work(s_de, weights, x0, solver):
    """(forward bytes, forward FLOP, backward bytes, backward FLOP, backward
    tensor-core FLOP) of the ODE rollout on these inputs; the last is the
    part in the h x h layers (forward, cotangent and weight gradient),
    which kernel 4 runs in 3xTF32. Bytes: each input read once and each
    output written once (forward: s_de, dt, x0, weights in, the solution
    rows out; backward: s_de, dt, the solution, its cotangent and the
    weights in, g_s_de, the weight grads and g_x0 out). FLOP (2 per
    multiply-add): per row-step and stage, one evaluation of f (the x
    projection and the tail layers); the backward recomputes it and adds
    two products per layer (the cotangent through the weight and the
    weight-gradient outer product)."""
    Tm1, B, h = s_de.shape
    xd = x0.shape[-1]
    w = [weights["wx_de"]] + [a for pair in weights["de_tail"] for a in pair]
    w_bytes = sum(a.numel() * 4 for a in w)
    tail = sum(2 * W.shape[0] * W.shape[1] for W, _ in weights["de_tail"])
    ev = 2 * xd * h + tail
    stages = {"euler": 1, "midpoint": 2, "rk4": 4}[solver]
    fwd_bytes = (Tm1 * B * (h + 1) + B * xd + Tm1 * B * xd) * 4 + w_bytes
    bwd_bytes = (2 * Tm1 * B * h + Tm1 * B + 2 * (Tm1 + 1) * B * xd + B * xd) * 4 + 2 * w_bytes
    fwd_flops = Tm1 * B * stages * ev
    bwd_flops = Tm1 * B * stages * (ev + 2 * tail + 4 * xd * h)
    bwd_tc = Tm1 * B * stages * 3 * sum(2 * h * h for W, _ in weights["de_tail"] if tuple(W.shape) == (h, h))
    return fwd_bytes, fwd_flops, bwd_bytes, bwd_flops, bwd_tc


def rel_err(a, ref):
    """max |a - ref| / max(1, |ref|), elementwise, as KERNEL_TOL reads it."""
    return ((a.double() - ref.double()).abs() / ref.double().abs().clamp(min=1.0)).max().item()


def phase_ode_kernel_vs_plain(dev):
    """The ODE forward kernel against its plain version: the no-encode shape
    with each solver, the direct-encode latent shape with Euler, at
    KERNEL_TOL. Then the encode shape at lecun scale, where the state grows
    large: the kernel and the float32 plain loop are each held against a
    float64 plain loop, and the kernel may lie at most ODE_F64_RATIO times
    as far from it as the float32 plain loop does."""
    worst_abs = 0.0
    for xd, n_tail, solvers in ((2, 3, SOLVERS), (128, 1, ("euler",))):
        args = ode_random_inputs(32, 1000, 128, xd, n_tail, seed=4, dev=dev)
        for solver in solvers:
            ref = FO.fused_ode_rollout_plain(*args, solver)
            for rows in F.ROWS_PER_BLOCK if solver == "rk4" else (None,):  # RK4: every launch shape
                got = FO.fused_ode_rollout_cuda(*args, solver, rows_per_block=rows)
                again = FO.fused_ode_rollout_cuda(*args, solver, rows_per_block=rows)
                torch.cuda.synchronize()
                max_abs = hold_fwd(f"ODE kernel {solver} xd={xd} rows={rows}", got, again, ref)
                say(f"[ode-kernel] {solver:8s} xd={xd} n_tail={n_tail} rows={rows}: max|d| {max_abs:.3e} "
                    f"max|ref| {ref.abs().max().item():.3f} ok")
                worst_abs = max(worst_abs, max_abs)

    s_de, weights, x0, dt = ode_random_inputs(32, 1000, 128, 128, 1, seed=4, dev=dev, readout=1.0)
    ref64 = FO.fused_ode_rollout_plain(s_de.double(), double(weights), x0.double(), dt, "euler")
    plain = FO.fused_ode_rollout_plain(s_de, weights, x0, dt, "euler")
    got = FO.fused_ode_rollout_cuda(s_de, weights, x0, dt, "euler")
    torch.cuda.synchronize()
    if got.shape != ref64.shape or not torch.isfinite(got).all():
        fail(f"ODE kernel lecun-scale encode shape: shape {tuple(got.shape)} or non-finite values")
    e_kernel, e_plain = rel_err(got, ref64), rel_err(plain, ref64)
    ok = e_kernel <= ODE_F64_RATIO * e_plain
    say(f"[ode-kernel] euler    xd=128 n_tail=1 lecun scale: max|ref64| "
        f"{ref64.abs().max().item():.3f}; max|d|/max(1,|ref64|): kernel {e_kernel:.3e}, float32 plain "
        f"{e_plain:.3e}, kernel - float32 plain {rel_err(got, plain):.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"ODE kernel at lecun scale lies {e_kernel} from the float64 loop, more than "
             f"{ODE_F64_RATIO} x the float32 plain loop's {e_plain}")
    return worst_abs


# The wide ODE backward's cases, (h, xd, n_tail): B=64, T=1001, RK4; the
# no-encode shape and the encode shape xd = h with one tail layer
WIDE_ODE_BWD = ((256, 2, 3), (256, 256, 1))


def phase_ode_bwd_vs_plain(dev):
    """The ODE backward kernel against the float64 plain walk at B=64,
    every solver, and at the wide widths (RK4); a relaunch must be
    bit-identical."""
    worst_abs = 0.0
    flat = lambda g: [g[0], g[2]] + VO.flatten_weights(g[1])
    cases = [(128, 2, 3, solver) for solver in SOLVERS] + [(h, xd, n, "rk4") for h, xd, n in WIDE_ODE_BWD]
    for h, xd, n_tail, solver in cases:
        s_de, weights, x0, dt = ode_random_inputs(64, 1000, h, xd, n_tail, seed=5, dev=dev)
        cot = torch.tensor(np.random.default_rng(6).standard_normal((1001, 64, xd)).astype(np.float32),
                           device=dev)
        names = ["g_s_de", "g_x0", "wx_de"] + [f"de_tail[{k}].{p}" for k in range(n_tail) for p in "Wb"]
        sol = torch.cat([x0[None], FO.fused_ode_rollout_cuda(s_de, weights, x0, dt, solver)])
        got = flat(VO.fused_ode_rollout_bwd_cuda(s_de, weights, dt, sol, cot, solver))
        again = flat(VO.fused_ode_rollout_bwd_cuda(s_de, weights, dt, sol, cot, solver))
        t0 = time.perf_counter()
        ref = flat(VO.fused_ode_rollout_bwd_plain(s_de.double(), double(weights), dt, sol.double(),
                                                  cot.double(), solver))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        worst, report = hold_bwd(f"ODE backward h={h} xd={xd} {solver}", names, got, again, ref)
        if h == 128:
            worst_abs = max(worst_abs, worst)
        say(f"[ode-bwd-kernel] h={h} xd={xd} n_tail={n_tail} {solver:8s}: ok, bit-identical on relaunch; plain "
            f"float64 walk {plain_s:.1f} s; max|d| / max|plain| per tensor: {report}")
    return worst_abs


def near(value, anchor, rtol):
    return abs(value - anchor) <= rtol * abs(anchor)


def check_ode_anchor(what, value, solver, key, rtol, nearest=True):
    """Fail unless ``value`` lies within ``rtol`` of ``solver``'s ODE anchor
    ``key`` (a name, or a (name, index) pair) and, where ``nearest``, nearer
    it than the other solver's: the Euler and RK4 anchors differ by less
    than 1e-3, so the rtol alone cannot tell a run of the wrong solver."""
    name, i = key if isinstance(key, tuple) else (key, None)
    pick = lambda sv: ODE_ANCHORS[sv][name] if i is None else ODE_ANCHORS[sv][name][i]
    own, other = pick(solver), pick("rk4" if solver == "euler" else "euler")
    if not (np.isfinite(value) and near(value, own, rtol)):
        fail(f"ODE {what} {value} misses the {solver} anchor {own} at rtol {rtol}")
    if nearest and not abs(value - own) < abs(value - other):
        fail(f"ODE {what} {value} lies nearer the other solver's anchor {other} than {own}")
    return abs(value - own) / abs(own)


def reset_ode_counts():
    FO.fused_ode_rollout.launches = 0
    VO.fused_ode_rollout_bwd.launches = 0


def ode_counts():
    return FO.fused_ode_rollout.launches, VO.fused_ode_rollout_bwd.launches


def phase_ode_slice(dev, root):
    """The ODE no-encode slice on the AVR data from the starting checkpoint:
    the Trainer (every step logged) for Euler and RK4, then the CLI
    ``--training --fused`` and ``--testing --fused`` (Euler)."""
    data = root / "avr"
    train_f, test_f = write_avr_dataset(data, n_train=128, n_test=32, n_steps=1001, seed=0)
    start = ode_start_checkpoint(root / "start.ckpt", (2, 2), 128, seed=0)
    for solver in ("euler", "rk4"):
        shutil.copy(start, root / f"ws_{solver}")
        cfg = TrainConfig(
            variant="ode_no_encode", train_data=str(train_f), test_data=str(test_f),
            model=str(root / f"run_{solver}"), num=128, batch=64, epoch=200, hidden=128,
            larger_than=None, seed=0, warm_start=str(root / f"ws_{solver}"), stop_after=1,
            loss_record_iter=1, solver=solver, fused=True, echo_logs=False, device="cuda",
        )
        reset_ode_counts()
        t0 = time.perf_counter()
        _, run_dir = Trainer(cfg).train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fwd, n_bwd = ode_counts()
        recs = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text().splitlines()]
        steps = [r for r in recs if r["kind"] == "train"]
        (ev,) = [r for r in recs if r["kind"] == "eval"]
        for r in steps:
            say(f"[ode-train] fused {solver} step {r['batch']}: loss {r['loss']:.8g} "
                f"gradient_norm {r['grad_norm']:.8g}")
        if len(steps) != 2:
            fail(f"ODE fused {solver} training logged {len(steps)} steps, not 2")
        what = f"fused {solver}"
        errs = [
            check_ode_anchor(f"{what} step-1 loss", steps[0]["loss"], solver, ("step1", 0), TRAIN_STEP1_RTOL),
            check_ode_anchor(f"{what} step-1 gradient_norm", steps[0]["grad_norm"], solver,
                             ("step1", 1), TRAIN_STEP1_RTOL, nearest=False),
            check_ode_anchor(f"{what} step-2 loss", steps[1]["loss"], solver, ("step2", 0), TRAIN_EVAL1_RTOL),
            check_ode_anchor(f"{what} step-2 gradient_norm", steps[1]["grad_norm"], solver,
                             ("step2", 1), TRAIN_EVAL1_RTOL, nearest=False),
            check_ode_anchor(f"{what} epoch-1 eval x_loss", ev["x_loss"], solver, "eval1_x_loss",
                             TRAIN_EVAL1_RTOL),
        ]
        say(f"[ode-train] fused {solver} epoch-1 eval: x_loss {ev['x_loss']:.8g}; launches: forward "
            f"{n_fwd}, backward {n_bwd}; wall {wall:.2f} s; rel. err. to the JAX anchors (step-1 "
            f"loss, gradient_norm, step-2 loss, gradient_norm, eval x_loss): "
            f"{', '.join(f'{e:.2e}' for e in errs)}")
        if n_fwd < 1 or n_bwd < 1:
            fail(f"ODE fused {solver} training launched the forward {n_fwd} and the backward {n_bwd} times")

    # the CLI entry points a user calls, with the counts of this run only
    shutil.copy(start, root / "ws_cli")
    argv = ["--training", "--fused", "--device", "cuda", "--train_data", str(train_f),
            "--test_data", str(test_f), "--model", str(root / "run_cli"), "--num", "128",
            "--batch", "64", "--epoch", "200", "--stop_after", "1", "--lr", "5e-3",
            "--larger_than", "none", "--seed", "0", "--warm_start", str(root / "ws_cli")]
    reset_ode_counts()
    t0 = time.perf_counter()
    _, run_dir = cli_main("ode_no_encode", argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = ode_counts()
    recs = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text().splitlines()]
    (ev,) = [r for r in recs if r["kind"] == "eval"]
    err = check_ode_anchor("CLI --training epoch-1 eval x_loss", ev["x_loss"], "euler",
                           "eval1_x_loss", TRAIN_EVAL1_RTOL)
    say(f"[ode-cli] --training --fused: epoch-1 eval x_loss {ev['x_loss']:.8g} (rel. err. {err:.2e}); "
        f"launches: forward {train_launches[0]}, backward {train_launches[1]}; wall {wall:.2f} s")
    if min(train_launches) < 1 or not (run_dir / "model_checkpoint.1").exists():
        fail(f"ODE CLI training launched the kernels {train_launches} times or wrote no checkpoint")

    for solver in ("euler", "rk4"):
        # the eval writes its log beside the checkpoint: one copy per run
        (root / f"test_{solver}").mkdir()
        ckpt = shutil.copy(start, root / f"test_{solver}" / "model_checkpoint.0")
        reset_ode_counts()
        t0 = time.perf_counter()
        res = cli_main("ode_no_encode", ["--testing", "--fused", "--device", "cuda", "--solver", solver,
                                         "--model", str(ckpt), "--test_data", str(test_f)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        test_launches = ode_counts()
        x_loss = float(res[0])
        err = check_ode_anchor(f"CLI --testing {solver} x_loss_total", x_loss, solver, "test_x_loss",
                               ANCHOR_RTOL)
        say(f"[ode-cli] --testing --fused --solver {solver}: x_loss_total {x_loss:.10f} (JAX anchor "
            f"{ODE_ANCHORS[solver]['test_x_loss']}, rel. err. {err:.2e}); launches: forward "
            f"{test_launches[0]}, backward {test_launches[1]}; wall {wall:.3f} s")
        if test_launches[0] < 1 or test_launches[1]:
            fail(f"ODE CLI --testing launched the forward {test_launches[0]} and the backward "
                 f"{test_launches[1]} times")
    return train_launches, (train_f, test_f, start)


def ode_model(start, dev, solver):
    model = ODEModel(2, 2, 128, solver=solver, device="meta")
    return load_params(model, load_checkpoint_params(start), device=dev)


def phase_ode_times(dev, files, sweep):
    """CUDA-event times of both ODE kernels at the slice's shapes (the
    starting checkpoint on the AVR sets) and of one whole training step;
    with ``sweep`` the forward at every rows-a-block too."""
    train_f, test_f, start = files
    test_ds, train_ds = OdeSamples.load(str(test_f)), OdeSamples.load(str(train_f))
    keys = ("t", "x", "z", "event_t", "z_jump")
    model = ode_model(start, dev, "euler").requires_grad_(False)
    times = {}

    def inputs(ds, n):
        idx = np.arange(n) % len(ds)
        batch = {k: torch.as_tensor(getattr(ds, k)[idx], device=dev) for k in keys}
        with torch.no_grad():
            s_de, weights, x0, dt = ode_rollout_inputs(model, batch)
        return s_de, weights, x0.contiguous(), dt.contiguous()

    for B, solver, ds in ((32, "euler", test_ds), (64, "euler", train_ds), (64, "rk4", train_ds),
                          (1024, "euler", test_ds)):
        args = inputs(ds, B)
        k_ms = cuda_ms(lambda: FO.fused_ode_rollout_cuda(*args, solver), 2, 10)
        p_ms = cuda_ms(lambda: FO.fused_ode_rollout_plain(*args, solver), 1, 2)
        n_bytes, flops = ode_work(args[0], args[1], args[2], solver)[:2]
        bound_ms, bound_by = bound(n_bytes, flops)
        times[("fwd", B, solver)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        rows = F.default_launch(B, torch.cuda.get_device_properties(dev).multi_processor_count)
        say(f"[ode-times] forward B={B} {solver:8s}: kernel {k_ms:.4f} ms (rows={rows}), plain {p_ms:.3f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by}; {n_bytes} B, {flops} FLOP), kernel/bound "
            f"{k_ms / bound_ms:.1f}x, library n/a: no single PyTorch call computes this rollout")
        if sweep:
            for rows in F.ROWS_PER_BLOCK:
                ms = cuda_ms(lambda: FO.fused_ode_rollout_cuda(*args, solver, rows_per_block=rows), 1, 5)
                say(f"[sweep] ode forward B={B} {solver:8s} rows={rows}: {ms:.4f} ms")
    for B in (256, 512) if sweep else ():  # evaluation batches, as in phase 7
        args = inputs(test_ds, B)
        for rows in F.ROWS_PER_BLOCK:
            ms = cuda_ms(lambda: FO.fused_ode_rollout_cuda(*args, "euler", rows_per_block=rows), 1, 5)
            say(f"[sweep] ode forward B={B} euler    rows={rows}: {ms:.4f} ms")

    s_de, weights, x0, dt = inputs(train_ds, 64)
    cot = torch.tensor(np.random.default_rng(7).standard_normal((1001, 64, 2)).astype(np.float32)
                       * 0.01, device=dev)
    for solver in SOLVERS:
        sol = torch.cat([x0[None], FO.fused_ode_rollout_cuda(s_de, weights, x0, dt, solver)])
        k_ms = cuda_ms(lambda: VO.fused_ode_rollout_bwd_cuda(s_de, weights, dt, sol, cot, solver), 1, 5)
        p_ms = cuda_ms(lambda: VO.fused_ode_rollout_bwd_plain(s_de, weights, dt, sol, cot, solver), 0, 1)
        times[("bwd", solver)] = bwd_times_line("[ode-times] backward B=64", solver, k_ms, p_ms,
                                                *ode_work(s_de, weights, x0, solver)[2:])
    times["split"] = noencode_split(
        "[ode-times] backward B=64 rk4",
        lambda st, bufs=None: VO._launch_bwd(s_de, weights, dt, sol, cot, "rk4", stages=st, bufs=bufs),
        lambda b: ode_contraction(b, weights, sol), VO.flatten_weights)
    args = inputs(train_ds, 256)
    sol = torch.cat([args[2][None], FO.fused_ode_rollout_cuda(*args, "rk4")])
    cot256 = torch.tensor(np.random.default_rng(7).standard_normal((1001, 256, 2)).astype(np.float32)
                          * 0.01, device=dev)
    k_ms = cuda_ms(lambda: VO.fused_ode_rollout_bwd_cuda(args[0], args[1], args[3], sol, cot256, "rk4"), 1, 3)
    bwd_times_line("[ode-times] backward B=256", "rk4", k_ms, None, *ode_work(*args[:3], "rk4")[2:])
    del args, sol, cot256

    # the wide kernels: B=64 RK4 at h=256, the no-encode shape and the
    # encode shape xd = h (T=1001), and h=512 (T=201)
    for h, xd, n_tail, Tm1 in ((256, 2, 3, 1000), (256, 256, 1, 1000), (512, 2, 3, 200)):
        ws, ww, wx0, wdt = ode_random_inputs(64, Tm1, h, xd, n_tail, seed=5, dev=dev)
        wcot = torch.tensor(np.random.default_rng(7).standard_normal((Tm1 + 1, 64, xd)).astype(np.float32)
                            * 0.01, device=dev)
        wsol = torch.cat([wx0[None], FO.fused_ode_rollout_cuda(ws, ww, wx0, wdt, "rk4")])
        k_ms = cuda_ms(lambda: VO.fused_ode_rollout_bwd_cuda(ws, ww, wdt, wsol, wcot, "rk4"), 1, 3)
        p_ms = cuda_ms(lambda: VO.fused_ode_rollout_bwd_plain(ws, ww, wdt, wsol, wcot, "rk4"), 0, 1)
        what = f"[ode-times] backward B=64 T={Tm1 + 1} h={h} xd={xd}"
        times[("bwd", h, xd)] = bwd_times_line(what, "rk4", k_ms, p_ms, *ode_work(ws, ww, wx0, "rk4")[2:])
        times[("split", h, xd)] = noencode_split(
            f"{what} rk4",
            lambda st, bufs=None: VO._launch_bwd(ws, ww, wdt, wsol, wcot, "rk4", stages=st, bufs=bufs),
            lambda b: ode_contraction(b, ww, wsol), VO.flatten_weights)
        del ws, ww, wx0, wdt, wcot, wsol

    batch = {k: torch.as_tensor(getattr(train_ds, k)[:64], device=dev) for k in keys + ("mask",)}
    for fused, reps in ((True, 5), (False, 1)):
        m = ode_model(start, dev, "rk4")
        opt = make_optimizer(m.parameters(), 5e-3, epochs=1, steps_per_epoch=1)
        forward = ((lambda: fused_ode_apply(m, batch)) if fused
                   else (lambda: m(*[batch[k] for k in keys])))

        def step():
            opt.adam.zero_grad()
            loss, _ = ode_no_encode_loss(forward(), batch)
            loss.backward()
            opt.step()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(step, 1, reps)
        times[("step", fused)] = ms
        say(f"[ode-times] training step B=64 T=1001 h=128 rk4, {'fused' if fused else 'plain'} "
            f"route: {ms:.3f} ms, {64 * 1000 / ms * 1e3:.1f} trajectory-steps/s, peak memory allocated "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    times[("step", 256)] = wide_step(
        "[ode-times]", "ode_no_encode", lambda: ODEModel(2, 2, 256, solver="rk4", device=dev),
        batch, fused_ode_apply, ode_no_encode_loss, keys, dev)
    return times


def ode_contraction(bufs, weights, sol):
    """Kernel 4's contraction done plainly on the walk's buffers (as
    :func:`dae_contraction`)."""
    Tm1, B, xd = sol.shape[0] - 1, sol.shape[1], sol.shape[2]
    n, R, h = len(weights["de_tail"]), Tm1 * B, weights["wx_de"].shape[1]
    S = bufs["res"].numel() // (n * R * h)
    res, gres = bufs["res"].view(S, n, R, h), bufs["gres"].view(S, n, R, h)
    gy, xin = bufs["gy"].view(S, R, xd), bufs["xin"].view(S, R, xd)
    ref = VO.flatten_weights(VO.contract_plain(res, gres, gy, xin, n, xd))
    return ref, net_operands(res, gres, gy, xin, range(S), xd, n, xd)


# ------------------------------------------------------------ channel-wise


CW_VARIANTS = ("ode_channelwise", "dae_channelwise")
CW_DIMS = {"ode_channelwise": (2, 2), "dae_channelwise": (3, 1, 2, 2)}
CW_KEYS = {"ode_channelwise": ("t", "x", "z", "event_t", "z_jump"),
           "dae_channelwise": ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump")}
# One epoch of training from the numpy starting checkpoint: the ODE on the
# AVR set in batches of 64, the DAE on 16 motor samples in batches of 8
# (whose JAX step on the CPU, where the anchors are derived, holds its
# [T, B, h, h] readout activations in a few GB; the card's step at B=64 is
# timed in phase 15)
CW_TRAIN = {"ode_channelwise": dict(num=128, batch=64), "dae_channelwise": dict(num=16, batch=8)}
# The JAX package on the CPU in float32, from the numpy starting checkpoint
# (cw_start_checkpoint, seed 0): step 1 and step 2 (loss, gradient norm), the
# epoch-1 eval and the --testing losses (x_loss_total, and i_loss_total for
# the DAE); re-derived by `python tests/test_torch_cw_slice.py` (needs JAX).
CW_ANCHORS = {
    "ode_channelwise": {
        "euler": dict(step1=(59.124146, 362.23892), step2=(50.36034, 355.64255), eval1=(27.881929,),
                      test=(22.770948,)),
        "rk4": dict(step1=(59.1241, 362.24945), step2=(50.342285, 355.61511), eval1=(27.904562,),
                    test=(22.770893,)),
    },
    "dae_channelwise": {
        "euler": dict(step1=(4.0819025, 328.75537), step2=(142.96591, 401.73727),
                      eval1=(8.6056328, 7.9732785), test=(0.47544611, 2.3678608)),
        "rk4": dict(step1=(4.081902, 328.77106), step2=(142.4919, 401.79456),
                    eval1=(8.6551476, 7.9919271), test=(0.47545066, 2.3678558)),
    },
}
CW_STEPS = 1001  # the slice's series length T
# Two solvers' anchors closer than this (relative) are not told apart: the
# card's losses lie up to 4e-7 from their anchors (the ODE step-1 loss), so
# the step-1 losses of Euler and RK4 (7.8e-7 apart for the ODE, 1.2e-7 for
# the DAE) are not resolved; the --testing anchors (2.1e-6 apart and more,
# card errors up to 1.2e-7) are.
CW_SOLVER_RESOLVED = 1e-6


def cw_setup(root):
    """The channel-wise slice's inputs under ``root``: per variant ``(train,
    test, start checkpoint)``: the AVR set (seed 0) for the ODE, the motor
    set for the DAE, and the numpy starting weights (h=128, seed 0)."""
    train_f, test_f = write_avr_dataset(root / "avr", n_train=128, n_test=32, n_steps=CW_STEPS, seed=0)
    files = {}
    for variant, (tr, te) in zip(CW_VARIANTS, ((train_f, test_f), (TRAIN_DATA, TEST_DATA))):
        start = cw_start_checkpoint(root / f"{variant}.start", variant, CW_DIMS[variant], 128, seed=0)
        files[variant] = (pathlib.Path(tr), pathlib.Path(te), start)
    return files


def cw_model(variant, start, dev, solver="euler"):
    cls = ChannelWiseODEModel if variant == "ode_channelwise" else ChannelWiseDAEModel
    model = cls(*CW_DIMS[variant], hidden_dim=128, solver=solver, device="meta")
    return load_params(model, load_checkpoint_params(start), device=dev)


def cw_batch(variant, files, B, split, dev):
    """``B`` rows of the variant's training or test set (repeated as
    needed), with the mask, on ``dev``."""
    train_f, test_f, _ = files[variant]
    f = train_f if split == "train" else test_f
    ds = OdeSamples.load(str(f)) if variant == "ode_channelwise" else DaeSamples.load(str(f), cut_length=CW_STEPS)
    idx = np.arange(B) % len(ds)
    return {k: torch.as_tensor(getattr(ds, k)[idx], device=dev) for k in CW_KEYS[variant] + ("mask",)}


def cw_inputs(variant, files, B, split, dev):
    """The fused rollout's inputs for the starting checkpoint on ``B`` rows
    of the data, as ``fused_cw_*_apply`` builds them."""
    model = cw_model(variant, files[variant][2], dev).requires_grad_(False)
    with torch.no_grad():
        streams, weights, xh0, dt = cw_rollout_inputs(model, cw_batch(variant, files, B, split, dev))
    return streams, weights, xh0.contiguous(), dt.contiguous()


def cw_random_inputs(B, Tm1, h, xd, zd, seed, dev):
    """Seeded random rollout inputs: lecun-scaled weights, the vertical
    readout scaled by 0.1 more (which keeps the state bounded over 1000
    steps), dt = 0.01."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, sc=1.0: torch.tensor((rng.standard_normal(shape) * sc).astype(np.float32), device=dev)
    C = xd + zd
    stack = lambda: (t(xd, h, h, sc=h ** -0.5), t(xd, h, sc=0.1), t(xd, h, h, sc=h ** -0.5), t(xd, h, sc=0.1))
    weights = dict(a=t(C, h, sc=C ** -0.5),
                   vert=[(t(h, h, sc=h ** -0.5), t(h, sc=0.1)), (t(h, h, sc=h ** -0.5), t(h, sc=0.1)),
                         (t(h, xd, sc=0.1 * h ** -0.5), t(xd, sc=0.01))],
                   ext=stack(), head=stack())
    streams = dict(fz=t(Tm1, B, zd, h, sc=0.5), s_constV=t(B, h, h, sc=0.5))
    return streams, weights, t(B, xd, h), torch.full((Tm1, B, 1), 0.01, device=dev)


def cw_cut(args, Tm1):
    """The first ``Tm1`` steps of rollout inputs."""
    streams, weights, x0, dt = args
    return dict(streams, fz=streams["fz"][:Tm1].contiguous()), weights, x0, dt[:Tm1].contiguous()


def cw_eval_flops(h, xd, zd):
    """FLOP (2 per multiply-add) of one evaluation of the dynamics for one
    batch row: ext 2 xd h^2, the folded first layer C h^2, two h^3 layers,
    the readout xd h^2 and the head 2 xd h^2 multiply-adds."""
    return 2 * (2 * h ** 3 + (5 * xd + xd + zd) * h * h)


def cw_eval_tc_flops(h):
    """The part of ``cw_eval_flops`` in the two h x h x h products, which
    kernels 5 and 6 run on the tensor cores."""
    return 4 * h ** 3


def cw_work(streams, weights, x0, solver):
    """(forward bytes, forward FLOP, backward bytes, backward FLOP, forward
    tensor-core FLOP, backward tensor-core FLOP) of the channel-wise rollout
    on these inputs; the last two are the parts of the FLOP in the h x h x h
    products. Bytes: each input read once and
    each output written once (forward: fz, dt, s_constV, x0 and the weights
    in, the solution rows out; backward: fz, dt, s_constV, the solution,
    its cotangent and the weights in, g_fz, g_s_constV, the weight grads
    and g_x0 out). FLOP per row-step: S evaluations forward; backward, the
    S stage evaluations once and twice their products for the cotangents
    and the weight grads (3, 6 and 12 evaluation-equivalents for Euler,
    Midpoint and RK4). The kernel's own recomputation (the stage points
    re-evaluated, a0 recomputed per stage) is its design's cost, not the
    function's, and is not counted."""
    fz, sV = streams["fz"], streams["s_constV"]
    Tm1, B, zd, h = fz.shape
    xd = x0.shape[1]
    w_bytes = sum(a.numel() * 4 for a in FC.flatten_weights(weights))
    ev = cw_eval_flops(h, xd, zd)
    S = {"euler": 1, "midpoint": 2, "rk4": 4}[solver]
    sol = Tm1 * B * xd * h
    fwd_bytes = (fz.numel() + Tm1 * B + sV.numel() + x0.numel() + sol) * 4 + w_bytes
    bwd_bytes = (2 * fz.numel() + Tm1 * B + 2 * sV.numel() + 2 * (sol + x0.numel()) + x0.numel()) * 4 \
        + 2 * w_bytes
    fwd_flops = Tm1 * B * S * ev
    bwd_flops = Tm1 * B * 3 * S * ev
    tc = cw_eval_tc_flops(h)
    return fwd_bytes, fwd_flops, bwd_bytes, bwd_flops, Tm1 * B * S * tc, Tm1 * B * 3 * S * tc


def contraction_work(pairs):
    """(bytes, FLOP, tensor-core FLOP) of contracting ``pairs [rows, 4, 2,
    xd, h]`` into the per-channel gradients: the pairs read once and dW [4,
    xd, h, h] and db written once; a multiply-add per (row, layer, channel,
    k, j), the product U^T V that tensor cores can run at float32 accuracy
    in 3xTF32, and an add per (row, layer, channel, j)."""
    rows, P, _, xd, h = pairs.shape
    n_bytes = (pairs.numel() + P * xd * h * (h + 1)) * 4
    tc = rows * P * xd * 2 * h * h
    return n_bytes, tc + rows * P * xd * h, tc


def cw_bwd_outputs(g):
    g_s, g_w, g_x0 = g
    names = ["a", "vert[0].W", "vert[0].b", "vert[1].W", "vert[1].b", "vert[2].W", "vert[2].b"] + [
        f"{net}.{k}" for net in ("ext", "head") for k in ("w0", "b0", "w1", "b1")]
    return [("g_fz", g_s["fz"]), ("g_s_constV", g_s["s_constV"]), ("g_x0", g_x0)] + list(
        zip(names, FC.flatten_weights(g_w)))


def phase_cw_kernel_vs_plain(dev, files):
    """Kernel 5 against its plain version for each solver, at the ODE's
    channels (xd=2, zd=2) and the motor DAE's (xd=3, zd=1): seeded random
    inputs at h=40, B=5, and the starting checkpoint on 64 training rows at
    h=128, all at T=1001, within KERNEL_TOL."""
    worst_abs = 0.0
    for variant in CW_VARIANTS:
        xd, zd = CW_DIMS[variant][:2]
        cases = (("random h=40 B=5", cw_random_inputs(5, CW_STEPS - 1, 40, xd, zd, seed=11, dev=dev)),
                 ("start checkpoint h=128 B=64", cw_inputs(variant, files, 64, "train", dev)))
        for label, args in cases:
            for solver in SOLVERS:
                ref = FC.fused_cw_rollout_plain(*args, solver)
                got = FC.fused_cw_rollout_cuda(*args, solver)
                torch.cuda.synchronize()
                if got.shape != ref.shape or not torch.isfinite(got).all():
                    fail(f"cw kernel {variant} {label} {solver}: shape {tuple(got.shape)} or non-finite values")
                d = (got - ref).abs()
                max_abs = d.max().item()
                ok = bool((d <= KERNEL_TOL * torch.clamp(ref.abs(), min=1.0)).all())
                say(f"[cw-kernel] {variant} {label} {solver:8s}: max|d| {max_abs:.3e} max rel "
                    f"{rel_err(got, ref):.3e} max|ref| {ref.abs().max().item():.3f} {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"cw kernel {variant} {label} {solver} disagrees with plain beyond {KERNEL_TOL}")
                worst_abs = max(worst_abs, max_abs)
    return worst_abs


def phase_cw_bwd_vs_plain(dev, files):
    """Kernel 6 against the float64 plain walk at B=64 (the starting
    checkpoint on 64 training rows, unit-scale cotangents): Euler and RK4
    over all 1000 steps, Midpoint over the first 200; each output tensor on
    its own scale; a relaunch must be bit-identical."""
    worst_abs = 0.0
    for variant in CW_VARIANTS:
        full = cw_inputs(variant, files, 64, "train", dev)
        for solver, Tm1 in (("euler", CW_STEPS - 1), ("midpoint", min(200, CW_STEPS - 1)),
                            ("rk4", CW_STEPS - 1)):
            streams, weights, x0, dt = cw_cut(full, Tm1)
            sol = torch.cat([x0[None], FC.fused_cw_rollout_cuda(streams, weights, x0, dt, solver)])
            rng = np.random.default_rng(12)
            cot = torch.tensor(rng.standard_normal(tuple(sol.shape)).astype(np.float32), device=dev)
            got = cw_bwd_outputs(VC.fused_cw_rollout_bwd_cuda(streams, weights, dt, sol, cot, solver))
            again = cw_bwd_outputs(VC.fused_cw_rollout_bwd_cuda(streams, weights, dt, sol, cot, solver))
            t0 = time.perf_counter()
            w64 = FC.unflatten_weights([a.double() for a in FC.flatten_weights(weights)])
            ref = cw_bwd_outputs(VC.fused_cw_rollout_bwd_plain(
                {k: v.double() for k, v in streams.items()}, w64, dt, sol.double(), cot.double(), solver))
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            # the float32 plain walk's own distance to the float64 one, for scale
            f32 = cw_bwd_outputs(VC.fused_cw_rollout_bwd_plain(streams, weights, dt, sol, cot, solver))
            f32_worst = max((a.double() - r).abs().max().item() / r.abs().max().item()
                            for (_, a), (_, r) in zip(f32, ref))
            parts, k_worst = [], 0.0
            for (name, g), (_, g2), (_, r) in zip(got, again, ref):
                if g.shape != r.shape or not torch.isfinite(g).all():
                    fail(f"cw backward {variant} {solver} {name}: shape {tuple(g.shape)} or non-finite values")
                if not torch.equal(g, g2):
                    fail(f"cw backward {variant} {solver} {name}: a relaunch gave other bits")
                d = (g.double() - r).abs().max().item()
                scale = r.abs().max().item()
                parts.append(f"{name} {d:.2e}/{scale:.3e}")
                k_worst = max(k_worst, d / scale) if scale > 0 else k_worst
                if not scale > 0:
                    fail(f"cw backward {variant} {solver} {name}: the plain gradient is 0, so the check holds nothing")
                if d > BWD_TOL * scale:
                    fail(f"cw backward {variant} {solver} {name}: max|d| {d} > {BWD_TOL} * max|plain| = "
                         f"{BWD_TOL * scale}")
                worst_abs = max(worst_abs, d)
            say(f"[cw-bwd-kernel] {variant} {solver:8s} T={Tm1 + 1}: ok, bit-identical on relaunch; plain "
                f"float64 walk {plain_s:.1f} s; worst max|d|/max|plain|: kernel {k_worst:.2e}, float32 plain "
                f"walk {f32_worst:.2e}; per tensor: {', '.join(parts)}")
    return worst_abs


def reset_cw_counts():
    FC.fused_cw_rollout.launches = 0
    VC.fused_cw_rollout_bwd.launches = 0


def cw_counts():
    return FC.fused_cw_rollout.launches, VC.fused_cw_rollout_bwd.launches


def check_cw_anchor(what, value, variant, solver, key, i, rtol):
    """Fail unless ``value`` lies within ``rtol`` of the anchor and, where
    the two solvers' anchors differ by less than 1e-3 but more than
    CW_SOLVER_RESOLVED (relative), nearer its own solver's anchor than the
    other's. Returns the relative error."""
    table = {**CW_ANCHORS, **ENC_ANCHORS}[variant]
    own = table[solver][key][i]
    other = table["rk4" if solver == "euler" else "euler"][key][i]
    if not (np.isfinite(value) and near(value, own, rtol)):
        fail(f"{variant} {what} {value} misses the {solver} anchor {own} at rtol {rtol}")
    gap = abs(own - other) / abs(own)
    if CW_SOLVER_RESOLVED < gap < 1e-3 and not abs(value - own) < abs(value - other):
        fail(f"{variant} {what} {value} lies nearer the other solver's anchor {other} than {own}")
    return abs(value - own) / abs(own)


def phase_cw_slice(dev, files, root):
    """Both channel-wise variants through their entry points: the Trainer
    (every step logged) for one epoch with Euler and RK4, then the CLI
    ``--training --fused`` (Euler; the main path of kernels 5 and 6, whose
    counts are set to 0 just before and read just after) and ``--testing
    --fused`` (Euler and RK4). Every loss is held to its JAX anchor."""
    main_launches = {}
    for variant in CW_VARIANTS:
        train_f, test_f, start = files[variant]
        size = CW_TRAIN[variant]
        n_loss = 2 if variant == "dae_channelwise" else 1
        for solver in ("euler", "rk4"):
            shutil.copy(start, root / f"{variant}_ws_{solver}")
            cfg = TrainConfig(
                variant=variant, train_data=str(train_f), test_data=str(test_f),
                model=str(root / f"{variant}_run_{solver}"), num=size["num"], batch=size["batch"],
                epoch=200, hidden=128, larger_than=None, seed=0,
                warm_start=str(root / f"{variant}_ws_{solver}"), stop_after=1, loss_record_iter=1,
                solver=solver, fused=True, echo_logs=False, device="cuda",
            )
            reset_cw_counts()
            t0 = time.perf_counter()
            _, run_dir = Trainer(cfg).train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_fwd, n_bwd = cw_counts()
            recs = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text().splitlines()]
            steps = [r for r in recs if r["kind"] == "train"]
            (ev,) = [r for r in recs if r["kind"] == "eval"]
            if len(steps) != 2:
                fail(f"{variant} fused {solver} training logged {len(steps)} steps, not 2")
            what = f"fused {solver}"
            errs = [check_cw_anchor(f"{what} step-1 loss", steps[0]["loss"], variant, solver, "step1", 0,
                                    TRAIN_STEP1_RTOL),
                    check_cw_anchor(f"{what} step-1 gradient_norm", steps[0]["grad_norm"], variant, solver,
                                    "step1", 1, TRAIN_STEP1_RTOL),
                    check_cw_anchor(f"{what} step-2 loss", steps[1]["loss"], variant, solver, "step2", 0,
                                    TRAIN_EVAL1_RTOL),
                    check_cw_anchor(f"{what} step-2 gradient_norm", steps[1]["grad_norm"], variant, solver,
                                    "step2", 1, TRAIN_EVAL1_RTOL)]
            errs += [check_cw_anchor(f"{what} epoch-1 eval {k}", ev[k], variant, solver, "eval1", i,
                                     TRAIN_EVAL1_RTOL) for i, k in enumerate(("x_loss", "i_loss")[:n_loss])]
            say(f"[cw-train] {variant} fused {solver}: steps (loss, gradient_norm) "
                f"{[(r['loss'], r['grad_norm']) for r in steps]}; epoch-1 eval "
                f"{[ev[k] for k in ('x_loss', 'i_loss')[:n_loss]]}; launches: forward {n_fwd}, backward "
                f"{n_bwd}; wall {wall:.2f} s; rel. err. to the JAX anchors {', '.join(f'{e:.2e}' for e in errs)}")
            if n_fwd < 1 or n_bwd < 1:
                fail(f"{variant} fused {solver} training launched the forward {n_fwd} and the backward "
                     f"{n_bwd} times")

        # the CLI entry points a user calls, with the counts of this run only
        shutil.copy(start, root / f"{variant}_ws_cli")
        argv = ["--training", "--fused", "--device", "cuda", "--train_data", str(train_f),
                "--test_data", str(test_f), "--model", str(root / f"{variant}_run_cli"),
                "--num", str(size["num"]), "--batch", str(size["batch"]), "--epoch", "200",
                "--stop_after", "1", "--lr", "5e-3", "--larger_than", "none", "--seed", "0",
                "--warm_start", str(root / f"{variant}_ws_cli")]
        reset_cw_counts()
        t0 = time.perf_counter()
        _, run_dir = cli_main(variant, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        main_launches[variant] = cw_counts()
        recs = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text().splitlines()]
        (ev,) = [r for r in recs if r["kind"] == "eval"]
        errs = [check_cw_anchor(f"CLI --training epoch-1 eval {k}", ev[k], variant, "euler", "eval1", i,
                                TRAIN_EVAL1_RTOL) for i, k in enumerate(("x_loss", "i_loss")[:n_loss])]
        say(f"[cw-cli] {variant} --training --fused: epoch-1 eval {[ev[k] for k in ('x_loss', 'i_loss')[:n_loss]]} "
            f"(rel. err. {', '.join(f'{e:.2e}' for e in errs)}); launches: forward {main_launches[variant][0]}, "
            f"backward {main_launches[variant][1]}; wall {wall:.2f} s")
        if min(main_launches[variant]) < 1 or not (run_dir / "model_checkpoint.1").exists():
            fail(f"{variant} CLI training launched the kernels {main_launches[variant]} times or wrote no checkpoint")

        for solver in ("euler", "rk4"):
            # the eval writes its log beside the checkpoint: one copy per run
            (root / f"{variant}_test_{solver}").mkdir()
            ckpt = shutil.copy(start, root / f"{variant}_test_{solver}" / "model_checkpoint.0")
            reset_cw_counts()
            t0 = time.perf_counter()
            res = cli_main(variant, ["--testing", "--fused", "--device", "cuda", "--solver", solver,
                                     "--model", str(ckpt), "--test_data", str(test_f)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = cw_counts()
            losses = [float(v) for v in res[:n_loss]]
            errs = [check_cw_anchor(f"CLI --testing {solver} loss {i}", v, variant, solver, "test", i,
                                    ANCHOR_RTOL) for i, v in enumerate(losses)]
            say(f"[cw-cli] {variant} --testing --fused --solver {solver}: losses {losses} (JAX anchors "
                f"{list(CW_ANCHORS[variant][solver]['test'])}, rel. err. {', '.join(f'{e:.2e}' for e in errs)}); "
                f"launches: forward {n[0]}, backward {n[1]}; wall {wall:.3f} s")
            if n[0] < 1 or n[1]:
                fail(f"{variant} CLI --testing launched the forward {n[0]} and the backward {n[1]} times")
    return main_launches


def cw_step(variant, files, dev, fused, reps):
    """One training step of the variant at B=64, T=1001, h=128, RK4 from
    the starting checkpoint (timed_steps); returns (ms, peak bytes
    allocated, the first step's loss, the first step's gradient of each
    parameter)."""
    model = cw_model(variant, files[variant][2], dev, "rk4")
    batch = cw_batch(variant, files, 64, "train", dev)
    if variant == "ode_channelwise":
        apply, loss_fn = fused_cw_ode_apply, ode_channelwise_loss
    else:
        apply, loss_fn = fused_cw_dae_apply, dae_channelwise_loss
    return timed_steps(model, batch, apply, loss_fn, CW_KEYS[variant], dev, fused, reps)


def phase_cw_times(dev, files):
    """CUDA-event times of kernels 5 and 6 on the starting checkpoints and
    of one whole training step per family, fused and plain."""
    times = {}
    for variant in CW_VARIANTS:
        for B, solver, split in ((32, "euler", "test"), (64, "euler", "train"), (64, "rk4", "train")):
            args = cw_inputs(variant, files, B, split, dev)
            k_ms = cuda_ms(lambda: FC.fused_cw_rollout_cuda(*args, solver), 1, 3)
            one_ms = cuda_ms(lambda: FC._launch(*args, solver, 1), 1, 3)
            kc = FC.chosen_cluster(B, args[2].shape[2], args[2].shape[1], args[0]["fz"].shape[2])
            p_ms = cuda_ms(lambda: FC.fused_cw_rollout_plain(*args, solver), 0, 1)
            n_bytes, flops, _, _, tc, _ = cw_work(*args[:3], solver)
            bound_ms, bound_by = bound(n_bytes, flops, tc)
            cuda_core_ms = bound(n_bytes, flops)[0]
            times[(variant, "fwd", B, solver)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
            say(f"[cw-times] {variant} forward B={B} {solver:8s}: kernel {k_ms:.3f} ms ({kc} blocks a row; one block a "
                f"row {one_ms:.3f} ms), plain {p_ms:.3f} ms, "
                f"bound {bound_ms:.4f} ms (3xTF32 tensor cores for the {tc} FLOP of the h^3 products, the rest "
                f"float32; {bound_by}; {n_bytes} B, {flops} FLOP), kernel/bound {k_ms / bound_ms:.2f}x; "
                f"CUDA-core float32 bound {cuda_core_ms:.4f} ms, kernel/that {k_ms / cuda_core_ms:.2f}x; "
                f"library n/a: no single PyTorch call computes this rollout")
        streams, weights, x0, dt = cw_inputs(variant, files, 64, "train", dev)
        rng = np.random.default_rng(13)
        cot = torch.tensor(rng.standard_normal((dt.shape[0] + 1,) + tuple(x0.shape)).astype(np.float32)
                           * 0.01, device=dev)
        for solver in SOLVERS:
            sol = torch.cat([x0[None], FC.fused_cw_rollout_cuda(streams, weights, x0, dt, solver)])
            k_ms = cuda_ms(lambda: VC.fused_cw_rollout_bwd_cuda(streams, weights, dt, sol, cot, solver), 1, 2)
            one_ms = cuda_ms(lambda: VC._launch_bwd(streams, weights, dt, sol, cot, solver, 1),
                             1, 2)
            kc = FC.chosen_cluster(64, x0.shape[2], x0.shape[1], streams["fz"].shape[2], backward=True)
            p_ms = cuda_ms(lambda: VC.fused_cw_rollout_bwd_plain(streams, weights, dt, sol, cot, solver), 0, 1)
            _, _, n_bytes, flops, _, tc = cw_work(streams, weights, x0, solver)
            bound_ms, bound_by = bound(n_bytes, flops, tc)
            cuda_core_ms = bound(n_bytes, flops)[0]
            times[(variant, "bwd", solver)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
            say(f"[cw-times] {variant} backward B=64 {solver:8s}: kernel {k_ms:.3f} ms (the walk, {kc} blocks a row, "
                f"and the contraction; one block a row {one_ms:.3f} ms), plain {p_ms:.3f} ms, bound {bound_ms:.4f} "
                f"ms (3xTF32 tensor cores for the {tc} FLOP of the h^3 products, the rest float32; {bound_by}; "
                f"{n_bytes} B, {flops} FLOP), kernel/bound "
                f"{k_ms / bound_ms:.2f}x; CUDA-core float32 bound {cuda_core_ms:.4f} ms, kernel/that "
                f"{k_ms / cuda_core_ms:.2f}x; library n/a: no single PyTorch call computes this VJP")
        times[(variant, "contract")] = contraction_times(variant, 64 * 4 * dt.shape[0], x0.shape[1], x0.shape[2], dev)
        cluster_times(variant, files, dev)
        first = {}
        for fused, reps in ((True, 2), (False, 1)):
            ms, peak, loss, grads = cw_step(variant, files, dev, fused, reps)
            times[(variant, "step", fused)] = ms
            first[fused] = loss, grads
            say(f"[cw-times] {variant} training step B=64 T={CW_STEPS} h=128 rk4, {'fused' if fused else 'plain'} "
                f"route: {ms:.3f} ms, {64 * (CW_STEPS - 1) / ms * 1e3:.1f} trajectory-steps/s, peak memory allocated "
                f"{peak / 2**30:.2f} GiB")
        check_cw_step(variant, first[True], first[False])
    return times


def contraction_times(variant, rows, xd, h, dev):
    """Kernel 6's contraction alone on seeded random pairs (drawn on the
    card) of the B=64 RK4
    walk's size (``rows`` = (T-1) 4 B): the CUDA kernels, their plain
    version, and ``torch.einsum`` of the same pairs as a yardstick
    (``library_ms``; the port never calls it); the kernel held against
    einsum at 1e-4 of its max."""
    gen = torch.Generator(device=dev).manual_seed(14)
    pairs = torch.randn((rows, 4, 2, xd, h), generator=gen, device=dev)
    u, v = pairs[:, :, 0], pairs[:, :, 1]
    einsum = lambda: (torch.einsum("nqck,nqcj->qckj", u, v), v.sum(0))
    got, ref = VC.contract_channel_pairs_cuda(pairs), einsum()
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        d = (g - r).abs().max().item()
        if not d <= 1e-4 * r.abs().max().item():
            fail(f"{variant} pair contraction lies {d} from einsum (max {r.abs().max().item()})")
    k_ms = cuda_ms(lambda: VC.contract_channel_pairs_cuda(pairs), 1, 3)
    p_ms = cuda_ms(lambda: VC.contract_channel_pairs_plain(pairs), 0, 1)
    l_ms = cuda_ms(einsum, 1, 3)
    n_bytes, flops, tc = contraction_work(pairs)
    bound_ms, bound_by = bound(n_bytes, flops, tc)
    cuda_core_ms = bound(n_bytes, flops)[0]
    say(f"[cw-times] {variant} backward's pair contraction, {rows} rows of the B=64 RK4 walk ({pairs.numel() * 4} "
        f"B): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, torch.einsum {l_ms:.3f} ms (yardstick, not called by "
        f"the port), bound {bound_ms:.4f} ms (3xTF32 tensor cores for the {tc} FLOP of U^T V, the rest float32; "
        f"{bound_by}; {n_bytes} B, {flops} FLOP), kernel/bound {k_ms / bound_ms:.2f}x; CUDA-core float32 bound "
        f"{cuda_core_ms:.4f} ms")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound_ms, bound_by=bound_by)


def cluster_times(variant, files, dev):
    """Kernel 5 at B = 8, 24, 32 and 64 (the starting checkpoint on test
    rows, Euler, T=1001) with 1, 2 and 4 blocks a row and with the
    launcher's choice: the evidence for the choice."""
    for B in (8, 24, 32, 64):
        args = cw_inputs(variant, files, B, "test", dev)
        ms = {c: cuda_ms(lambda: FC._launch(*args, "euler", c), 1, 2) for c in (1, 2, 4, 0)}
        kc = FC.chosen_cluster(B, args[2].shape[2], args[2].shape[1], args[0]["fz"].shape[2])
        say(f"[cw-clusters] {variant} forward B={B} euler: one block a row {ms[1]:.3f} ms, 2 {ms[2]:.3f} ms, 4 "
            f"{ms[4]:.3f} ms; the launcher's choice {kc}: {ms[0]:.3f} ms")


def check_cw_step(variant, fused, plain, tag="[cw-step-check]"):
    """The fused route's first training step at B=64, RK4 (the batch the
    anchors' DAE runs do not reach) against the plain route's from the
    same weights and batch: the loss, and each parameter's gradient on its
    own scale, within TRAIN_STEP1_RTOL."""
    (f_loss, f_grads), (p_loss, p_grads) = fused, plain
    d_loss = abs(f_loss - p_loss) / abs(p_loss)
    worst_name, worst = None, 0.0
    for name, g in p_grads.items():
        d = (f_grads[name] - g).abs().max().item()
        scale = g.abs().max().item()
        if not np.isfinite(d) or d > TRAIN_STEP1_RTOL * scale:
            fail(f"{variant} fused step's gradient of {name} lies {d} from the plain step's (max|plain| {scale})")
        if scale > 0 and d / scale >= worst:
            worst_name, worst = name, d / scale
    say(f"{tag} {variant} B=64 rk4, fused against plain from the same weights and batch: loss {f_loss} "
        f"/ {p_loss} (rel. {d_loss:.2e}); worst gradient max|d|/max|plain| {worst:.2e} ({worst_name})")
    if not np.isfinite(f_loss) or d_loss > TRAIN_STEP1_RTOL:
        fail(f"{variant} fused step's loss {f_loss} misses the plain step's {p_loss} at rtol {TRAIN_STEP1_RTOL}")


# ---------------------------------------------------------------- export

EXPORT_ROWS, EXPORT_STEPS = 8, 101  # the native rollouts' test rows and steps
# tests/test_native_runtime.py's bar: the C++ runtime's float32 loop sums
# in its own order
NATIVE_RTOL, NATIVE_ATOL = 2e-4, 2e-5
# a .pt2 program on the CPU against the port's submodule on the CPU: the
# same float32 operations, the kernels' transposes aside
PROGRAM_RTOL = 1e-6


def model_dims(model):
    return {k: getattr(model, k) for k in ("x_dim", "z_dim", "v_dim", "i_dim") if hasattr(model, k)}


def check_saved(what, variant, saved, ckpt, model):
    """Hold ``saved`` (a ``saved model/`` directory of ``variant``) against
    the checkpoint ``ckpt`` it was written from and the port's module
    ``model`` (on the CPU, loaded from it): the file set; every
    ``.weights.npz`` equal bit for bit to the checkpoint's arrays; every
    ``.weights.bin`` read back equal to them (per channel for the
    channel-wise family); every ``.pt2`` reloaded, fed the npz weights and
    random arguments of its example shapes, within PROGRAM_RTOL of the
    submodule."""
    examples = export_examples(variant, model, model_dims(model))
    want_files = {f"{s}.{ext}" for s in examples for ext in ("pt2", "weights.npz", "weights.bin")}
    if VARIANTS[variant].encode:  # the direct-encode and channel-wise recipes
        want_files.add("dim.txt")
        if (saved / "dim.txt").read_text() != str(model.hidden_dim):
            fail(f"{what}: dim.txt holds {(saved / 'dim.txt').read_text()!r}, not {model.hidden_dim}")
    if {f.name for f in saved.iterdir()} != want_files:
        fail(f"{what}: {sorted(f.name for f in saved.iterdir())} in {saved}, want {sorted(want_files)}")
    with np.load(ckpt) as f:
        flat = {k: f[k] for k in f.files}
    rng = np.random.default_rng(17)
    worst = 0.0
    for sub, shapes in examples.items():
        prefix = f"params/{sub}/"
        want = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
        with np.load(saved / f"{sub}.weights.npz") as f:
            got = {k: f[k] for k in f.files}
        if sorted(got) != sorted(want) or not all(
                got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want):
            fail(f"{what}: {sub}.weights.npz differs from the checkpoint's params/{sub}")
        tree = {}
        for key, a in want.items():
            node = tree
            *path, leaf = key.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = a
        want_bin = flatten_channelwise(tree) if VARIANTS[variant].channel_wise else want
        got_bin = read_weights_bin(saved / f"{sub}.weights.bin")
        if sorted(got_bin) != sorted(want_bin) or not all(np.array_equal(got_bin[k], want_bin[k]) for k in want_bin):
            fail(f"{what}: {sub}.weights.bin does not read back as the checkpoint's arrays")
        args = [torch.zeros(()) if a.ndim == 0 else torch.tensor(rng.standard_normal(a.shape).astype(np.float32))
                for a in shapes]
        program = torch.export.load(saved / f"{sub}.pt2").module()
        with torch.no_grad():
            out = program({k: torch.tensor(v) for k, v in got.items()}, *args)
            ref = getattr(model, sub)(*args)
        scale = ref.abs().max().item()
        d = (out - ref).abs()
        if out.shape != ref.shape or not bool((d <= PROGRAM_RTOL * (ref.abs() + scale)).all()):
            fail(f"{what}: {sub}.pt2 lies {d.max().item()} from the port's submodule (max {scale})")
        worst = max(worst, d.max().item() / scale)
    return worst


def check_native(what, variant, saved, model, data):
    """The port's binding of the C++ runtime loads the ``.bin`` files of
    ``saved`` and rolls the family out over the first EXPORT_ROWS rows and
    EXPORT_STEPS steps of ``data`` (a test set; no events) as the port's
    plain model on the CPU does, within NATIVE_RTOL / NATIVE_ATOL; returns
    the largest |native - plain|."""
    kind = VARIANTS[variant].kind
    ds = (DaeSamples if kind == "dae" else OdeSamples).load(str(data), cut_length=EXPORT_STEPS)
    keys = ("t", "x", "z", "v", "i") if kind == "dae" else ("t", "x", "z")
    b = {k: np.ascontiguousarray(getattr(ds, k)[:EXPORT_ROWS], np.float32) for k in keys}
    if not np.array_equal(b["t"], np.broadcast_to(b["t"][:1], b["t"].shape)):
        fail(f"{what}: the test rows do not share one time grid, which the native rollouts take")
    with torch.no_grad():
        ref = model(*(torch.tensor(b[k]) for k in keys))
    got = NR.rollout(variant, saved, b, model.solver)
    want = (ref,) if isinstance(ref, torch.Tensor) else ref[: len(got)]
    worst = 0.0
    for g, w in zip(got, want):
        w = w.numpy()
        if g.shape != w.shape or not np.allclose(g, w, rtol=NATIVE_RTOL, atol=NATIVE_ATOL):
            fail(f"{what}: the native rollout lies {np.abs(g - w).max()} from the port's plain rollout")
        worst = max(worst, float(np.abs(g - w).max()))
    return worst


def port_model(variant, hidden, ckpt):
    """The variant's module at the slice's widths on the CPU, loaded from
    ``ckpt``."""
    dims = {"ode_no_encode": (2, 2), "dae_no_encode": (3, 1, 2, 2)}.get(variant) or {**CW_DIMS, **ENC_DIMS}[variant]
    cls = {"ode_no_encode": ODEModel, "dae_no_encode": DAEModel, "ode_channelwise": ChannelWiseODEModel,
           "dae_channelwise": ChannelWiseDAEModel, "ode_encode": ODEEncodeModel,
           "dae_encode": DAEEncodeModel}[variant]
    model = cls(*dims, hidden_dim=hidden, device="meta")
    return load_params(model, load_checkpoint_params(ckpt), device="cpu").requires_grad_(False)


def export_seconds(run_dir):
    """The export_s of each epoch_time record of a training run."""
    recs = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text().splitlines()]
    return [r["export_s"] for r in recs if r["kind"] == "epoch_time"]


def phase_export(dev, root, ode_files, cw_files):
    """Phase 16: ``saved model/`` as the port writes it. The CLI ``--saving
    --device cuda`` on a copy of checkpoint 200; the CLI ``--training
    --fused --hidden 256`` of both no-encode families (one epoch from
    seed-0 weights: the wide backwards on the main path, the kernels'
    launches counted); and the directories the ``--training --fused`` CLI
    runs of phases 10 and 14 left. Each is held against its checkpoint and
    module (check_saved) and rolled out in the C++ runtime (check_native);
    each training run's export seconds per epoch are printed."""
    save_dir = root / "save"
    save_dir.mkdir()
    ckpt = shutil.copy(CKPT, save_dir / CKPT.name)
    t0 = time.perf_counter()
    saved = cli_main("dae_no_encode", ["--saving", "--device", "cuda", "--model", str(ckpt),
                                       "--test_data", str(TEST_DATA)])
    wall = time.perf_counter() - t0
    if saved != save_dir / "saved model":
        fail(f"--saving exported into {saved}, not beside the checkpoint")
    model = port_model("dae_no_encode", 128, ckpt)
    e_prog = check_saved("--saving", "dae_no_encode", saved, ckpt, model)
    e_nat = check_native("--saving", "dae_no_encode", saved, model, TEST_DATA)
    say(f"[export] --saving --device cuda on checkpoint 200: {sorted(f.name for f in saved.iterdir())} in "
        f"{wall:.2f} s; npz and bin equal to the checkpoint; .pt2 against the module max|d|/max {e_prog:.2e}; "
        f"native dae_rollout ({EXPORT_ROWS} rows, {EXPORT_STEPS} steps) max|d| {e_nat:.2e}")

    ode_train, ode_test, _ = ode_files
    runs = []
    for variant, train_f, test_f in (("dae_no_encode", TRAIN_DATA, TEST_DATA),
                                     ("ode_no_encode", ode_train, ode_test)):
        run = root / f"{variant}_h256"
        argv = ["--training", "--fused", "--device", "cuda", "--hidden", "256", "--train_data", str(train_f),
                "--test_data", str(test_f), "--model", str(run), "--num", "128", "--batch", "64",
                "--epoch", "200", "--stop_after", "1", "--larger_than", "none", "--seed", "0"]
        counts = (F.fused_dae_rollout, V.fused_dae_rollout_bwd) if variant == "dae_no_encode" else (
            FO.fused_ode_rollout, VO.fused_ode_rollout_bwd)
        for c in counts:
            c.launches = 0
        t0 = time.perf_counter()
        cli_main(variant, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = [c.launches for c in counts]
        recs = [json.loads(line) for line in (run / "train_metrics.jsonl").read_text().splitlines()]
        (ev,) = [r for r in recs if r["kind"] == "eval"]
        say(f"[export] {variant} --training --fused --hidden 256: epoch-1 eval x_loss {ev['x_loss']:.8g}; "
            f"launches: forward {n[0]}, backward {n[1]}; wall {wall:.2f} s")
        if min(n) < 1 or not np.isfinite(ev["x_loss"]):
            fail(f"{variant} at h=256 launched the kernels {n} times or gave the eval {ev['x_loss']}")
        runs.append((variant, 256, run, test_f))
    runs.append(("ode_no_encode", 128, root / "ode" / "run_cli", ode_test))
    for variant in CW_VARIANTS:
        runs.append((variant, 128, root / "cw" / f"{variant}_run_cli", cw_files[variant][1]))
    for variant, hidden, run, test_f in runs:
        what = f"{variant} h={hidden} --training"
        model = port_model(variant, hidden, run / "model_checkpoint.1")
        e_prog = check_saved(what, variant, run / "saved model", run / "model_checkpoint.1", model)
        e_nat = check_native(what, variant, run / "saved model", model, test_f)
        say(f"[export] {what}: saved model/ equal to model_checkpoint.1, .pt2 max|d|/max {e_prog:.2e}, native "
            f"rollout max|d| {e_nat:.2e}; export_s per epoch {export_seconds(run)}")


# ------------------------------------------------------------ direct-encode


ENC_VARIANTS = ("dae_encode", "ode_encode")
ENC_DIMS = {"ode_encode": (2, 2), "dae_encode": (3, 1, 2, 2)}
ENC_KEYS = {"ode_encode": CW_KEYS["ode_channelwise"], "dae_encode": CW_KEYS["dae_channelwise"]}
ENC_LOSS = {"ode_encode": ode_encode_loss, "dae_encode": dae_encode_loss}
ENC_APPLY = {"ode_encode": fused_ode_encode_apply, "dae_encode": fused_dae_encode_apply}


def enc_model(variant, start, dev, solver="euler"):
    cls = ODEEncodeModel if variant == "ode_encode" else DAEEncodeModel
    model = cls(*ENC_DIMS[variant], hidden_dim=128, solver=solver, device="meta")
    return load_params(model, load_checkpoint_params(start), device=dev)


def enc_batch(variant, data, B, dev):
    """``B`` rows of the data set ``data`` (repeated as needed), with the
    mask, on ``dev``."""
    ds = OdeSamples.load(str(data)) if variant == "ode_encode" else DaeSamples.load(str(data), cut_length=1001)
    idx = np.arange(B) % len(ds)
    return {k: torch.as_tensor(getattr(ds, k)[idx], device=dev) for k in ENC_KEYS[variant] + ("mask",)}


def enc_dae_args(model, batch):
    """Kernel 1's arguments for the direct-encode DAE on ``batch``, as
    ``fused_dae_encode_apply`` builds them: ``(streams, weights, xh0, i0,
    aux)`` at xd = id = h, one tail layer a net."""
    with torch.no_grad():
        s = dae_encode_setup(model, batch)
    return s["streams"], s["weights"], s["xh0"].contiguous(), s["i0"].contiguous(), F.pack_aux(s["dt"], s["ev"])


def enc_ode_args(model, batch):
    """Kernel 3's arguments for the direct-encode ODE on ``batch``:
    ``(s_de, weights, xh0, dt)`` at xd = h, one tail layer."""
    with torch.no_grad():
        s_de, weights, xh0, dt, _ = ode_encode_rollout_inputs(model, batch)
    return s_de, weights, xh0.contiguous(), dt.contiguous()


def phase_enc_kernels(dev, start):
    """Phase 17, part 1: kernels 1 and 2 at the direct-encode DAE's latent
    shape (xd = id = h = 128, one tail layer a net: the DE's first layer
    256 wide, the backward's wide kernels) on the starting checkpoint's
    inputs from the motor set (events in some rows). Kernel 1 against its
    plain loop on the 32 test rows, each solver (RK4 at every rows a
    block), bit-identical on relaunch; kernel 2 against the float64 plain
    walk on 64 training rows with unit-scale cotangents, Euler and RK4,
    each output tensor within BWD_TOL of its own scale, bit-identical on
    relaunch. Returns (forward max|d|, backward max|d|)."""
    model = enc_model("dae_encode", start, dev).requires_grad_(False)
    args = enc_dae_args(model, enc_batch("dae_encode", TEST_DATA, 32, dev))
    fwd_worst = 0.0
    for solver in SOLVERS:
        t0 = time.perf_counter()
        ref = F.fused_dae_rollout_packed_plain(*args, solver)
        plain_s = time.perf_counter() - t0
        for rows in F.ROWS_PER_BLOCK if solver == "rk4" else (None,):
            got = F.fused_dae_rollout_packed_cuda(*args, solver, rows_per_block=rows)
            again = F.fused_dae_rollout_packed_cuda(*args, solver, rows_per_block=rows)
            torch.cuda.synchronize()
            d = hold_fwd(f"encode kernel 1 {solver} rows={rows}", got, again, ref)
            fwd_worst = max(fwd_worst, d)
            say(f"[enc-kernel] dae forward B=32 T=1001 xd=id=h=128 n_tail=1 {solver:8s} rows={rows}: max|d| {d:.3e} "
                f"max|plain| {ref.abs().max().item():.3f}, bit-identical on relaunch; plain loop {plain_s:.1f} s")
    streams, weights, x0, i0, aux = args = enc_dae_args(model, enc_batch("dae_encode", TRAIN_DATA, 64, dev))
    bwd_worst = 0.0
    for solver in ("euler", "rk4"):
        cot = torch.tensor(np.random.default_rng(2).standard_normal((1001, 64, 256)).astype(np.float32), device=dev)
        packed = F.fused_dae_rollout_packed_cuda(*args, solver)
        got = V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver)
        again = V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver)
        t0 = time.perf_counter()
        ref = V.fused_dae_rollout_bwd_plain(double(streams), double(weights), x0.double(), i0.double(), aux,
                                            packed.double(), cot.double(), solver)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        names = [n for n, _ in bwd_outputs(got)]
        flat = lambda g: [v for _, v in bwd_outputs(g)]
        worst, report = hold_bwd(f"encode backward {solver}", names, flat(got), flat(again), flat(ref))
        bwd_worst = max(bwd_worst, worst)
        say(f"[enc-kernel] dae backward B=64 T=1001 xd=id=h=128 n_tail=1 {solver:8s}: ok, bit-identical on "
            f"relaunch; plain float64 walk {plain_s:.1f} s; max|d| / max|plain| per tensor: {report}")
    return fwd_worst, bwd_worst


def enc_counts(variant):
    fwd, bwd = (F.fused_dae_rollout, V.fused_dae_rollout_bwd) if variant == "dae_encode" else (
        FO.fused_ode_rollout, VO.fused_ode_rollout_bwd)
    return fwd, bwd


def reset_enc_counts(variant):
    for c in enc_counts(variant):
        c.launches = 0


def read_enc_counts(variant):
    return tuple(c.launches for c in enc_counts(variant))


def phase_enc_slice(dev, variant, files, root):
    """Phases 17-18: a direct-encode variant through its entry points from
    its starting checkpoint: the CLI ``--testing --fused`` (Euler and RK4),
    the Trainer's ``--training --fused`` epoch (batch 64, Euler, every step
    logged), the CLI ``--saving`` of its checkpoint (held by check_saved
    and rolled out in the C++ runtime by check_native), each loss held to
    its JAX anchor (ENC_ANCHORS) at rtol 1e-3 and, where the two solvers'
    anchors lie between CW_SOLVER_RESOLVED and 1e-3 apart, nearer its own;
    each fused run's launches of the variant's kernel pair counted (set to
    0 just before, read just after). Returns the training run's launches."""
    train_f, test_f, start = files
    n_loss = 2 if variant == "dae_encode" else 1
    tag = "[enc-" + variant[:3] + "]"
    for solver in ("euler", "rk4"):
        (root / f"{variant}_test_{solver}").mkdir()
        ckpt = shutil.copy(start, root / f"{variant}_test_{solver}" / "model_checkpoint.0")
        reset_enc_counts(variant)
        t0 = time.perf_counter()
        res = cli_main(variant, ["--testing", "--fused", "--device", "cuda", "--solver", solver, "--model", str(ckpt),
                                 "--test_data", str(test_f)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_enc_counts(variant)
        losses = [float(v) for v in res[:n_loss]]
        errs = [check_cw_anchor(f"CLI --testing {solver} loss {i}", v, variant, solver, "test", i, ANCHOR_RTOL)
                for i, v in enumerate(losses)]
        say(f"{tag} --testing --fused --solver {solver}: losses {losses} (JAX anchors "
            f"{list(ENC_ANCHORS[variant][solver]['test'])}, rel. err. {', '.join(f'{e:.2e}' for e in errs)}); "
            f"launches: forward {n[0]}, backward {n[1]}; wall {wall:.3f} s")
        if n[0] < 1 or n[1]:
            fail(f"{variant} CLI --testing launched the forward {n[0]} and the backward {n[1]} times")

    shutil.copy(start, root / f"{variant}_ws")
    cfg = TrainConfig(
        variant=variant, train_data=str(train_f), test_data=str(test_f), model=str(root / f"{variant}_run"),
        num=128, batch=64, epoch=200, hidden=128, larger_than=None, seed=0, warm_start=str(root / f"{variant}_ws"),
        stop_after=1, loss_record_iter=1, solver="euler", fused=True, echo_logs=False, device="cuda",
    )
    reset_enc_counts(variant)
    t0 = time.perf_counter()
    _, run_dir = Trainer(cfg).train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_enc_counts(variant)
    recs = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if r["kind"] == "train"]
    (ev,) = [r for r in recs if r["kind"] == "eval"]
    if len(steps) != 2:
        fail(f"{variant} fused training logged {len(steps)} steps, not 2")
    errs = [check_cw_anchor(f"fused euler step-{k + 1} {name}", steps[k][name], variant, "euler", f"step{k + 1}", i,
                            TRAIN_STEP1_RTOL if k == 0 else TRAIN_EVAL1_RTOL)
            for k in range(2) for i, name in enumerate(("loss", "grad_norm"))]
    errs += [check_cw_anchor(f"fused euler epoch-1 eval {k}", ev[k], variant, "euler", "eval1", i, TRAIN_EVAL1_RTOL)
             for i, k in enumerate(("x_loss", "i_loss")[:n_loss])]
    say(f"{tag} --training --fused (Trainer, batch 64, euler): steps (loss, gradient_norm) "
        f"{[(r['loss'], r['grad_norm']) for r in steps]}; epoch-1 eval {[ev[k] for k in ('x_loss', 'i_loss')[:n_loss]]}; "
        f"launches: forward {launches[0]}, backward {launches[1]}; wall {wall:.2f} s; export_s per epoch "
        f"{export_seconds(run_dir)}; rel. err. to the JAX anchors {', '.join(f'{e:.2e}' for e in errs)}")
    if min(launches) < 1 or not (run_dir / "model_checkpoint.1").exists():
        fail(f"{variant} fused training launched the kernels {launches} times or wrote no checkpoint")

    ckpt = run_dir / "model_checkpoint.1"
    t0 = time.perf_counter()
    saved = cli_main(variant, ["--saving", "--device", "cuda", "--model", str(ckpt), "--test_data", str(test_f)])
    wall = time.perf_counter() - t0
    model = port_model(variant, 128, ckpt)
    e_prog = check_saved(f"{variant} --saving", variant, saved, ckpt, model)
    e_nat = check_native(f"{variant} --saving", variant, saved, model, test_f)
    say(f"{tag} --saving --device cuda on model_checkpoint.1: {len(list(saved.iterdir()))} files in {wall:.2f} s, "
        f"npz and bin equal to the checkpoint; .pt2 against the module max|d|/max {e_prog:.2e}; native rollout of "
        f"the .bin files ({EXPORT_ROWS} rows, {EXPORT_STEPS} steps) max|d| {e_nat:.2e}")
    return launches


def phase_enc_times(dev, variant, files):
    """Phases 17-18, times (CUDA events): the forward kernel alone on the
    starting checkpoint's inputs at B=32 Euler (the test set), the
    variant's kernel pair alone at B=64 RK4 (the forward, and the backward
    with unit-scale cotangents), each beside its bound, and one
    whole training step (B=64, T=1001, h=128, RK4) fused and plain with its
    peak memory; the fused step's loss and gradients from the starting
    weights held against the plain step's at rtol 1e-3 (check_cw_step)."""
    train_f, test_f, start = files
    tag = "[enc-" + variant[:3] + "-times]"
    batch = enc_batch(variant, train_f, 64, dev)
    model = enc_model(variant, start, dev, "rk4").requires_grad_(False)
    times = {}
    # the forward as --testing --fused drives it: the 32 test rows, Euler
    if variant == "dae_encode":
        args = enc_dae_args(model, enc_batch(variant, test_f, 32, dev))
        e_ms = cuda_ms(lambda: F.fused_dae_rollout_packed_cuda(*args, "euler"), 2, 10)
    else:
        args = enc_ode_args(model, enc_batch(variant, test_f, 32, dev))
        e_ms = cuda_ms(lambda: FO.fused_ode_rollout_cuda(*args, "euler"), 2, 10)
    times["eval_fwd"] = e_ms
    say(f"{tag} forward kernel B=32 T=1001 euler (the --testing batch): {e_ms:.3f} ms")
    if variant == "dae_encode":
        args = enc_dae_args(model, batch)
        cot = torch.tensor(np.random.default_rng(7).standard_normal((1001, 64, 256)).astype(np.float32), device=dev)
        packed = F.fused_dae_rollout_packed_cuda(*args, "rk4")
        f_ms = cuda_ms(lambda: F.fused_dae_rollout_packed_cuda(*args, "rk4"), 1, 5)
        b_ms = cuda_ms(lambda: V.fused_dae_rollout_bwd_cuda(*args, packed, cot, "rk4"), 1, 3)
        f_bound = bound(*rollout_work(*args, "rk4"))
        b_bound = bound(*bwd_work(*args, "rk4"))
        del args, cot, packed
    else:
        args = enc_ode_args(model, batch)
        sol = torch.cat([args[2][None], FO.fused_ode_rollout_cuda(*args, "rk4")])
        cot = torch.tensor(np.random.default_rng(7).standard_normal((1001, 64, 128)).astype(np.float32), device=dev)
        f_ms = cuda_ms(lambda: FO.fused_ode_rollout_cuda(*args, "rk4"), 1, 5)
        b_ms = cuda_ms(lambda: VO.fused_ode_rollout_bwd_cuda(args[0], args[1], args[3], sol, cot, "rk4"), 1, 3)
        work = ode_work(args[0], args[1], args[2], "rk4")
        f_bound, b_bound = bound(*work[:2]), bound(*work[2:])
        del args, cot, sol
    times["fwd"], times["bwd"] = f_ms, b_ms
    say(f"{tag} forward kernel B=64 T=1001 rk4: {f_ms:.3f} ms, bound {f_bound[0]:.5f} ms ({f_bound[1]}); backward "
        f"kernel: {b_ms:.3f} ms, bound {b_bound[0]:.5f} ms ({b_bound[1]}, the h x h products at 3xTF32)")
    first = {}
    for fused, reps in ((True, 3), (False, 1)):
        m = enc_model(variant, start, dev, "rk4")
        ms, peak, loss, grads = timed_steps(m, batch, ENC_APPLY[variant], ENC_LOSS[variant], ENC_KEYS[variant], dev,
                                            fused, reps)
        first[fused] = loss, grads
        times[("step", fused)], times[("peak", fused)] = ms, peak
        say(f"{tag} training step B=64 T=1001 h=128 rk4, {'fused' if fused else 'plain'} route: {ms:.3f} ms, "
            f"{64 * 1000 / ms * 1e3:.1f} trajectory-steps/s, peak memory allocated {peak / 2**30:.2f} GiB")
    check_cw_step(variant, first[True], first[False], tag=tag)
    return times


def phase_encode(dev, root, ode_files):
    """Phases 17 (the direct-encode DAE on the motor set) and 18 (the
    direct-encode ODE on the AVR set of phase 10), each from start_checkpoint
    of its h=128 model (seed 0)."""
    t0 = time.perf_counter()
    files = {
        "dae_encode": (TRAIN_DATA, TEST_DATA, start_checkpoint(
            root / "dae_encode.start", DAEEncodeModel(3, 1, 2, 2, hidden_dim=128, device="meta"), seed=0)),
        "ode_encode": (*ode_files[:2], start_checkpoint(
            root / "ode_encode.start", ODEEncodeModel(2, 2, hidden_dim=128, device="meta"), seed=0)),
    }
    out = {"kernel_err": phase_enc_kernels(dev, files["dae_encode"][2])}
    for variant in ENC_VARIANTS:
        out[variant] = dict(launches=phase_enc_slice(dev, variant, files[variant], root),
                            times=phase_enc_times(dev, variant, files[variant]))
    say(f"[enc] phases 17-18 in {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------ teacher forcing

TF_FLAGS = {"x": dict(input_true_x=True), "i": dict(input_true_i=True),
            "xi": dict(input_true_x=True, input_true_i=True)}
TF_COMBOS = [("dae_no_encode", f) for f in ("x", "i", "xi")] + [("dae_encode", f) for f in ("x", "i", "xi")] + [
    ("ode_no_encode", "x"), ("ode_encode", "x")]
TF_KEYS = {"dae_no_encode": ENC_KEYS["dae_encode"], "dae_encode": ENC_KEYS["dae_encode"]}


def true_states(Tm1, B, xd, seed, dev):
    """Seeded unit-scale true states ``x_true [T, B, xd]`` for kernels 1-2
    in their TF-x mode."""
    rng = np.random.default_rng(seed + 1000)
    return torch.tensor(rng.standard_normal((Tm1 + 1, B, xd)).astype(np.float32), device=dev)


def tf_counts():
    return (F.fused_dae_rollout.launches, V.fused_dae_rollout_bwd.launches, FO.fused_ode_rollout.launches,
            VO.fused_ode_rollout_bwd.launches)


def reset_tf_counts():
    for c in (F.fused_dae_rollout, V.fused_dae_rollout_bwd, FO.fused_ode_rollout, VO.fused_ode_rollout_bwd):
        c.launches = 0


def tf_enc_args(model, batch):
    """Kernel 1's TF-x arguments for the direct-encode DAE on ``batch``, as
    ``fused_dae_encode_tf_x_apply`` builds them: ``((streams, weights, xh0,
    i0, aux), x_true)``, the true states the encoded ``x``."""
    with torch.no_grad():
        s = dae_encode_setup(model, batch, tf_x=True)
    args = (s["streams"], s["weights"], s["xh0"].contiguous(), s["i0"].contiguous(), F.pack_aux(s["dt"], s["ev"]))
    return args, s["xhT"].contiguous()


def tf_bwd_outputs(g, g_true):
    """The TF-x backward's outputs as (name, tensor) pairs."""
    out = bwd_outputs(g[:4])
    return out + ([("g_xt", g[4][0]), ("g_xt1", g[4][1])] if g_true else [])


def phase_tf_kernels(dev, enc_start):
    """Phase 19, part 1: kernel 1 in its TF-x mode against its plain loop
    (the motor shape at B=32, T=1001 on seeded inputs and true states, each
    solver; the direct-encode shape on its starting checkpoint's 32 test
    rows, the true states the encoded x, Euler and RK4); kernel 2 in its
    TF-x mode against the float64 plain walk at B=64 (the motor shape,
    Euler and RK4, with and without g_xt / g_xt1; the encode shape, Euler,
    with them; events at step 0 in the even rows added: under TF-x only
    they give the rolled x0 a cotangent), unit-scale cotangents. Returns (forward max|d|, backward
    max|d|) of the motor shape."""
    fwd_worst = 0.0
    cases = [("motor", random_inputs(32, 1000, 128, 3, 2, seed=0, dev=dev), true_states(1000, 32, 3, 0, dev), SOLVERS)]
    model = enc_model("dae_encode", enc_start, dev).requires_grad_(False)
    cases.append(("encode", *tf_enc_args(model, enc_batch("dae_encode", TEST_DATA, 32, dev)), ("euler", "rk4")))
    for shape, args, x_true, solvers in cases:
        for solver in solvers:
            t0 = time.perf_counter()
            ref = F.fused_dae_rollout_packed_plain(*args, solver, x_true)
            plain_s = time.perf_counter() - t0
            got = F.fused_dae_rollout_packed_cuda(*args, solver, x_true=x_true)
            again = F.fused_dae_rollout_packed_cuda(*args, solver, x_true=x_true)
            torch.cuda.synchronize()
            d = hold_fwd(f"TF-x kernel 1 {shape} {solver}", got, again, ref)
            if shape == "motor":
                fwd_worst = max(fwd_worst, d)
            say(f"[tf-kernel] forward TF-x {shape} B=32 T=1001 {solver:8s}: max|d| {d:.3e} max|plain| "
                f"{ref.abs().max().item():.3f}, bit-identical on relaunch; plain loop {plain_s:.1f} s")
    bwd_worst = 0.0
    cases = [("motor", random_inputs(64, 1000, 128, 3, 2, seed=1, dev=dev), true_states(1000, 64, 3, 1, dev),
              ("euler", "rk4"), (True, False))]
    cases.append(("encode", *tf_enc_args(model, enc_batch("dae_encode", TRAIN_DATA, 64, dev)), ("euler",), (True,)))
    for shape, args, x_true, solvers, g_trues in cases:
        args = (*args[:4], with_first_step_events(args[4]))
        streams, weights, x0, i0, aux = args
        width = x0.shape[-1] + i0.shape[-1]
        cot = torch.tensor(np.random.default_rng(2).standard_normal((1001, 64, width)).astype(np.float32), device=dev)
        for solver in solvers:
            packed = F.fused_dae_rollout_packed_cuda(*args, solver, x_true=x_true)
            t0 = time.perf_counter()
            ref = V.fused_dae_rollout_bwd_plain(double(streams), double(weights), x0.double(), i0.double(), aux,
                                                packed.double(), cot.double(), solver, x_true.double(), True)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            for g_true in g_trues:
                got = V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver, x_true, g_true)
                again = V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver, x_true, g_true)
                flat = lambda g: [v for _, v in tf_bwd_outputs(g, g_true)]
                names = [n for n, _ in tf_bwd_outputs(got, g_true)]
                worst, report = hold_bwd(f"TF-x backward {shape} {solver} g_true={g_true}", names, flat(got),
                                         flat(again), flat(ref))
                if shape == "motor":
                    bwd_worst = max(bwd_worst, worst)
                say(f"[tf-kernel] backward TF-x {shape} B=64 T=1001 {solver:8s} true-state cotangents "
                    f"{'written' if g_true else 'not asked'}: ok, bit-identical on relaunch; plain float64 walk "
                    f"{plain_s:.1f} s; max|d| / max|plain| per tensor: {report}")
    return fwd_worst, bwd_worst


def tf_launches_ok(variant, flags, n):
    """A TF-x DAE run launches kernels 1-2 and none of 3-4, a TF-i run
    kernels 3-4 and none of 1-2, a time-parallel run none of 1-4."""
    if variant.startswith("dae") and flags == "x":
        return min(n[:2]) >= 1 and not any(n[2:])
    if flags == "i":
        return min(n[2:]) >= 1 and not any(n[:2])
    return not any(n)


def phase_tf_slice(dev, files):
    """Phase 19, part 2: the Trainer (fused, one epoch of two steps, Euler,
    every step logged) for each combination of TF_COMBOS, steps 1 and 2
    and the teacher-forced epoch-1 eval against TF_ANCHORS at rtol 1e-3,
    each run's launches of kernels 1-4 counted (set to 0 just before, read
    just after); then the CLI ``--training --fused --input_true_x`` of the
    motor DAE and ``--testing --fused --input_true_x`` on its checkpoint.
    Returns the launches of the motor DAE's TF-x Trainer run."""
    launches = None
    root = files["root"]
    for variant, flags in TF_COMBOS:
        train_f, test_f, start = files[variant]
        ws = shutil.copy(start, root / f"{variant}_{flags}_ws")
        cfg = TrainConfig(
            variant=variant, train_data=str(train_f), test_data=str(test_f), model=str(root / f"{variant}_{flags}"),
            num=128, batch=64, epoch=200, hidden=128, larger_than=None, seed=0, warm_start=str(ws), stop_after=1,
            loss_record_iter=1, solver="euler", fused=True, echo_logs=False, device="cuda", **TF_FLAGS[flags],
        )
        reset_tf_counts()
        t0 = time.perf_counter()
        _, run_dir = Trainer(cfg).train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = tf_counts()
        recs = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text().splitlines()]
        steps = [r for r in recs if r["kind"] == "train"]
        (ev,) = [r for r in recs if r["kind"] == "eval"]
        if len(steps) != 2:
            fail(f"{variant} TF {flags} training logged {len(steps)} steps, not 2")
        anchors = TF_ANCHORS[variant][flags]
        got = dict(step1=(steps[0]["loss"], steps[0]["grad_norm"]), step2=(steps[1]["loss"], steps[1]["grad_norm"]),
                   eval1=tuple(ev[k] for k in ("x_loss", "i_loss") if k in ev))
        errs = []
        for key, rtol in (("step1", TRAIN_STEP1_RTOL), ("step2", TRAIN_EVAL1_RTOL), ("eval1", TRAIN_EVAL1_RTOL)):
            for v, a in zip(got[key], anchors[key]):
                if not (np.isfinite(v) and near(v, a, rtol)):
                    fail(f"{variant} TF {flags} {key} {got[key]} misses the JAX anchors {anchors[key]} at rtol {rtol}")
                errs.append(abs(v - a) / abs(a))
        say(f"[tf-train] {variant} {'+'.join(k for k in TF_FLAGS[flags])} --fused (Trainer, batch 64, euler): "
            f"steps {got['step1']}, {got['step2']}; epoch-1 eval {got['eval1']}; worst rel. err. to the JAX anchors "
            f"{max(errs):.2e}; launches of kernels 1-4: {n}; wall {wall:.2f} s")
        if not tf_launches_ok(variant, flags, n):
            fail(f"{variant} TF {flags} launched kernels 1-4 {n} times, not as its dispatch names them")
        if (variant, flags) == ("dae_no_encode", "x"):
            launches = n[:2]

    train_f, test_f, start = files["dae_no_encode"]
    ws = shutil.copy(start, root / "cli_ws")
    reset_tf_counts()
    t0 = time.perf_counter()
    _, run_dir = cli_main("dae_no_encode", [
        "--training", "--fused", "--input_true_x", "--device", "cuda", "--train_data", str(train_f), "--test_data",
        str(test_f), "--model", str(root / "cli_run"), "--num", "128", "--batch", "64", "--epoch", "200",
        "--stop_after", "1", "--larger_than", "none", "--warm_start", str(ws)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = tf_counts()
    if not tf_launches_ok("dae_no_encode", "x", n) or not (run_dir / "model_checkpoint.1").exists():
        fail(f"CLI --training --fused --input_true_x launched kernels 1-4 {n} times or wrote no checkpoint")
    reset_tf_counts()
    res = cli_main("dae_no_encode", ["--testing", "--fused", "--input_true_x", "--device", "cuda", "--model",
                                     str(run_dir / "model_checkpoint.1"), "--test_data", str(test_f)])
    torch.cuda.synchronize()
    m = tf_counts()
    losses, anchors = (float(res[0]), float(res[1])), TF_ANCHORS["dae_no_encode"]["x"]["eval1"]
    if not all(np.isfinite(v) and near(v, a, ANCHOR_RTOL) for v, a in zip(losses, anchors)):
        fail(f"CLI --testing --fused --input_true_x losses {losses} miss the anchors {anchors} at rtol {ANCHOR_RTOL}")
    if m[0] < 1 or any(m[1:]):
        fail(f"CLI --testing --fused --input_true_x launched kernels 1-4 {m} times")
    say(f"[tf-cli] --training --fused --input_true_x (motor DAE, checkpoint 200, one epoch): launches of kernels "
        f"1-4 {n}, wall {wall:.2f} s; --testing --fused --input_true_x on its model_checkpoint.1: x_loss_total "
        f"{losses[0]:.10g} i_loss_total {losses[1]:.10g} (the JAX run's teacher-forced epoch-1 eval {anchors}), "
        f"launches {m}")
    return launches


def motor_batch(B, dev):
    """``B`` rows of the motor training set with the mask, on ``dev``."""
    ds = DaeSamples.load(str(TRAIN_DATA), cut_length=1001)
    return {k: torch.as_tensor(getattr(ds, k)[:B], device=dev) for k in TF_KEYS["dae_no_encode"] + ("mask",)}


def motor_model(dev, solver):
    model = DAEModel(3, 1, 2, 2, hidden_dim=128, solver=solver, device="meta")
    return load_params(model, load_checkpoint_params(CKPT), device=dev)


def phase_tf_times(dev, files):
    """Phase 19, times (CUDA events): kernel 1 in its TF-x mode on
    checkpoint 200's inputs (the true states the data's x) at B=32 Euler
    (the test set) and B=64 RK4 (the training set), kernel 2 in its TF-x
    mode at B=64 RK4 (no true-state cotangent, as the no-encode path asks
    for none), each beside its bound and its plain version, and both at the
    direct-encode shape (its starting checkpoint, the backward with the
    true states' cotangents) beside their bounds; then one TF-x
    training step (B=64, T=1001, RK4) of the motor DAE and of the
    direct-encode DAE, fused and plain, with its peak memory, the fused
    step's loss and gradients held against the plain step's."""
    times = {}
    model = motor_model(dev, "rk4").requires_grad_(False)
    ds = DaeSamples.load(str(TEST_DATA), cut_length=1001)
    test = {k: torch.as_tensor(getattr(ds, k), device=dev) for k in TF_KEYS["dae_no_encode"]}
    for B, solver, batch in ((32, "euler", test), (64, "rk4", motor_batch(64, dev))):
        with torch.no_grad():
            s = TF._dae_tf_setup(model, batch, True)
        args = (s["streams"], s["weights"], s["x0"].contiguous(), s["i0"].contiguous(), F.pack_aux(s["dt"], s["ev"]))
        x_true = s["xT"].contiguous()
        tf_bytes = 2 * x_true[1:].numel() * 4  # x_true[:-1] and x_true[1:], each read once
        f_ms = cuda_ms(lambda: F.fused_dae_rollout_packed_cuda(*args, solver, x_true=x_true), 1, 5)
        fp_ms = cuda_ms(lambda: F.fused_dae_rollout_packed_plain(*args, solver, x_true), 0, 1)
        n_bytes, flops = rollout_work(*args, solver)
        f_bound = bound(n_bytes + tf_bytes, flops)
        times[("fwd", B, solver)] = dict(ms=f_ms, plain_ms=fp_ms, bound_ms=f_bound[0], bound_by=f_bound[1])
        say(f"[tf-times] kernel 1 TF-x B={B} T=1001 {solver}: {f_ms:.3f} ms, plain {fp_ms:.1f} ms, bound "
            f"{f_bound[0]:.5f} ms ({f_bound[1]}), kernel/bound {f_ms / f_bound[0]:.1f}x")
    packed = F.fused_dae_rollout_packed_cuda(*args, "rk4", x_true=x_true)
    cot = torch.tensor(np.random.default_rng(7).standard_normal((1001, 64, 5)).astype(np.float32), device=dev)
    b_ms = cuda_ms(lambda: V.fused_dae_rollout_bwd_cuda(*args, packed, cot, "rk4", x_true), 1, 3)
    bp_ms = cuda_ms(lambda: V.fused_dae_rollout_bwd_plain(*args, packed, cot, "rk4", x_true), 0, 1)
    n_bytes, flops, tc = bwd_work(*args, "rk4")
    b_bound = bound(n_bytes + tf_bytes, flops, tc)
    times[("bwd", 64, "rk4")] = dict(ms=b_ms, plain_ms=bp_ms, bound_ms=b_bound[0], bound_by=b_bound[1])
    say(f"[tf-times] kernel 2 TF-x B=64 T=1001 rk4 (no true-state cotangent): {b_ms:.3f} ms, plain {bp_ms:.1f} ms, "
        f"bound {b_bound[0]:.5f} ms ({b_bound[1]}, the h x h products at 3xTF32), kernel/bound "
        f"{b_ms / b_bound[0]:.1f}x")
    # the direct-encode shape, as its TF-x training drives the pair: the
    # true states the encoded x, their cotangents written
    enc = enc_model("dae_encode", files["dae_encode"][2], dev, "rk4").requires_grad_(False)
    args, x_true = tf_enc_args(enc, enc_batch("dae_encode", TRAIN_DATA, 64, dev))
    tf_bytes = 2 * x_true[1:].numel() * 4
    packed = F.fused_dae_rollout_packed_cuda(*args, "rk4", x_true=x_true)
    cot = torch.tensor(np.random.default_rng(7).standard_normal((1001, 64, 256)).astype(np.float32), device=dev)
    f_ms = cuda_ms(lambda: F.fused_dae_rollout_packed_cuda(*args, "rk4", x_true=x_true), 1, 5)
    b_ms = cuda_ms(lambda: V.fused_dae_rollout_bwd_cuda(*args, packed, cot, "rk4", x_true, True), 1, 3)
    n_bytes, flops = rollout_work(*args, "rk4")
    f_bound = bound(n_bytes + tf_bytes, flops)
    n_bytes, flops, tc = bwd_work(*args, "rk4")
    b_bound = bound(n_bytes + 2 * tf_bytes, flops, tc)  # x_true's two views in, g_xt and g_xt1 out
    times[("enc_fwd", 64, "rk4")], times[("enc_bwd", 64, "rk4")] = f_ms, b_ms
    say(f"[tf-times] direct-encode shape (xd = id = h = 128, one tail layer) B=64 T=1001 rk4: kernel 1 TF-x "
        f"{f_ms:.3f} ms, bound {f_bound[0]:.5f} ms ({f_bound[1]}); kernel 2 TF-x with g_xt / g_xt1 {b_ms:.3f} ms, "
        f"bound {b_bound[0]:.5f} ms ({b_bound[1]}, 3xTF32)")
    del args, packed, cot, enc
    steps = (("dae_no_encode", lambda: motor_model(dev, "rk4"), motor_batch(64, dev), TF.fused_dae_tf_x_apply,
              dae_no_encode_loss),
             ("dae_encode", lambda: enc_model("dae_encode", files["dae_encode"][2], dev, "rk4"),
              enc_batch("dae_encode", TRAIN_DATA, 64, dev), TF.fused_dae_encode_tf_x_apply, dae_encode_loss))
    for variant, make, batch, apply, loss_fn in steps:
        first = {}
        for fused, reps in ((True, 3), (False, 1)):
            ms, peak, loss, grads = timed_steps(make(), batch, apply, loss_fn, TF_KEYS[variant], dev, fused, reps,
                                                plain_kw=dict(input_true_x=True))
            first[fused] = loss, grads
            times[(variant, "step", fused)], times[(variant, "peak", fused)] = ms, peak
            say(f"[tf-times] {variant} TF-x training step B=64 T=1001 h=128 rk4, {'fused' if fused else 'plain'} "
                f"route: {ms:.3f} ms, {64 * 1000 / ms * 1e3:.1f} trajectory-steps/s, peak memory allocated "
                f"{peak / 2**30:.2f} GiB")
        check_cw_step(f"{variant} TF-x", first[True], first[False], tag="[tf-step-check]")
    return times


def phase_tf(dev, root, ode_files):
    """Phase 19: teacher forcing, from the checkpoints and data of phases
    6, 10 and 17-18 (the direct-encode starting checkpoints drawn again)."""
    t0 = time.perf_counter()
    files = {
        "root": root,
        "dae_no_encode": (TRAIN_DATA, TEST_DATA, CKPT),
        "dae_encode": (TRAIN_DATA, TEST_DATA, start_checkpoint(
            root / "dae_encode.start", DAEEncodeModel(3, 1, 2, 2, hidden_dim=128, device="meta"), seed=0)),
        "ode_no_encode": ode_files,
        "ode_encode": (*ode_files[:2], start_checkpoint(
            root / "ode_encode.start", ODEEncodeModel(2, 2, hidden_dim=128, device="meta"), seed=0)),
    }
    out = dict(kernel_err=phase_tf_kernels(dev, files["dae_encode"][2]), launches=phase_tf_slice(dev, files),
               times=phase_tf_times(dev, files))
    say(f"[tf] phase 19 in {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------- multishoot

MS_VARIANTS = ("dae_no_encode", "dae_encode", "ode_no_encode", "ode_encode", "ode_channelwise", "dae_channelwise")
MS_B, MS_L = MS_WINDOWS * 64, 1000 // MS_WINDOWS  # the folded batch and window length of B=64, T=1001
MS_APPLY = {"dae_no_encode": (MS.fused_multishoot_dae_apply, MS.multishoot_dae_apply, fused_dae_apply,
                              dae_no_encode_loss),
            "ode_no_encode": (MS.fused_multishoot_ode_apply, MS.multishoot_ode_apply, fused_ode_apply,
                              ode_no_encode_loss),
            "dae_encode": (MS.fused_multishoot_dae_encode_apply, MS.multishoot_dae_encode_apply,
                           fused_dae_encode_apply, dae_encode_loss)}


@contextlib.contextmanager
def kernel_calls():
    """Records the arguments of every launch of kernels 1-4 through their
    wrappers, by kernel number: ``{k: [(args, kwargs), ...]}``."""
    calls = {k: [] for k in range(1, 5)}
    wrappers = ((F, "fused_dae_rollout_packed_cuda", 1), (V, "fused_dae_rollout_bwd_cuda", 2),
                (FO, "fused_ode_rollout_cuda", 3), (VO, "fused_ode_rollout_bwd_cuda", 4))
    originals = [getattr(mod, name) for mod, name, _ in wrappers]
    for (mod, name, k), orig in zip(wrappers, originals):
        def record(*args, _orig=orig, _k=k, **kwargs):
            calls[_k].append((args, kwargs))
            return _orig(*args, **kwargs)
        setattr(mod, name, record)
    try:
        yield calls
    finally:
        for (mod, name, _), orig in zip(wrappers, originals):
            setattr(mod, name, orig)


def call_rows(call):
    """The batch rows of a recorded launch (its ``s_de [T-1, B, h]``)."""
    first = call[0][0]
    return (first["s_de"] if isinstance(first, dict) else first).shape[1]


def all_counts():
    """Launches of kernels 1-6."""
    return tf_counts() + cw_counts()


def reset_all_counts():
    reset_tf_counts()
    reset_cw_counts()


def phase_ms_kernels(dev):
    """Phase 20, part 1: kernels 1-4 at the folded shape (B = 20 x 64 = 1 280
    rows, T-1 = 50, h=128) on seeded inputs: kernel 1 (the motor shape,
    events at steps 3 and 33 in a quarter of the rows and at step 0 in the
    even rows) against its plain loop, each solver, RK4 at every
    rows-a-block; kernel 2 against the float64 plain walk (Euler and RK4,
    unit-scale cotangents); kernels 3-4 the same at xd=2 with three tail
    layers. KERNEL_TOL / BWD_TOL, bit-identical on relaunch. Returns
    max|d| by kernel number."""
    err = {}
    args = random_inputs(MS_B, MS_L, 128, 3, 2, seed=20, dev=dev)
    args = (*args[:4], with_first_step_events(args[4]))
    n_ev0 = int(args[4][0, :, 1].sum().item())
    for solver in SOLVERS:
        ref = F.fused_dae_rollout_packed_plain(*args, solver)
        for rows in F.ROWS_PER_BLOCK if solver == "rk4" else (None,):
            got = F.fused_dae_rollout_packed_cuda(*args, solver, rows_per_block=rows)
            again = F.fused_dae_rollout_packed_cuda(*args, solver, rows_per_block=rows)
            torch.cuda.synchronize()
            d = hold_fwd(f"folded kernel 1 {solver} rows={rows}", got, again, ref)
            err[1] = max(err.get(1, 0.0), d)
            say(f"[ms-kernel] kernel 1 B={MS_B} T={MS_L + 1} {solver:8s} rows={rows}: max|d| {d:.3e} max|plain| "
                f"{ref.abs().max().item():.3f}, bit-identical on relaunch ({n_ev0} rows with a step-0 event)")
    streams, weights, x0, i0, aux = args
    cot = torch.tensor(np.random.default_rng(22).standard_normal((MS_L + 1, MS_B, 5)).astype(np.float32),
                       device=dev)
    for solver in ("euler", "rk4"):
        packed = F.fused_dae_rollout_packed_cuda(*args, solver)
        got = V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver)
        again = V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver)
        t0 = time.perf_counter()
        ref = V.fused_dae_rollout_bwd_plain(double(streams), double(weights), x0.double(), i0.double(), aux,
                                            packed.double(), cot.double(), solver)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        flat = lambda g: [v for _, v in bwd_outputs(g)]
        worst, report = hold_bwd(f"folded kernel 2 {solver}", [n for n, _ in bwd_outputs(got)], flat(got),
                                 flat(again), flat(ref))
        err[2] = max(err.get(2, 0.0), worst)
        say(f"[ms-kernel] kernel 2 B={MS_B} T={MS_L + 1} {solver:8s}: ok, bit-identical on relaunch; plain "
            f"float64 walk {plain_s:.1f} s; max|d| / max|plain| per tensor: {report}")
    del args, streams, packed, cot, got, again, ref

    s_de, weights, x0, dt = ode_random_inputs(MS_B, MS_L, 128, 2, 3, seed=21, dev=dev)
    for solver in SOLVERS:
        ref = FO.fused_ode_rollout_plain(s_de, weights, x0, dt, solver)
        for rows in F.ROWS_PER_BLOCK if solver == "rk4" else (None,):
            got = FO.fused_ode_rollout_cuda(s_de, weights, x0, dt, solver, rows_per_block=rows)
            again = FO.fused_ode_rollout_cuda(s_de, weights, x0, dt, solver, rows_per_block=rows)
            torch.cuda.synchronize()
            d = hold_fwd(f"folded kernel 3 {solver} rows={rows}", got, again, ref)
            err[3] = max(err.get(3, 0.0), d)
            say(f"[ms-kernel] kernel 3 B={MS_B} T={MS_L + 1} xd=2 {solver:8s} rows={rows}: max|d| {d:.3e} "
                f"max|plain| {ref.abs().max().item():.3f}, bit-identical on relaunch")
    cot = torch.tensor(np.random.default_rng(23).standard_normal((MS_L + 1, MS_B, 2)).astype(np.float32),
                       device=dev)
    names = ["g_s_de", "g_x0", "wx_de"] + [f"de_tail[{k}].{p}" for k in range(3) for p in "Wb"]
    flat = lambda g: [g[0], g[2]] + VO.flatten_weights(g[1])
    for solver in ("euler", "rk4"):
        sol = torch.cat([x0[None], FO.fused_ode_rollout_cuda(s_de, weights, x0, dt, solver)])
        got = flat(VO.fused_ode_rollout_bwd_cuda(s_de, weights, dt, sol, cot, solver))
        again = flat(VO.fused_ode_rollout_bwd_cuda(s_de, weights, dt, sol, cot, solver))
        t0 = time.perf_counter()
        ref = flat(VO.fused_ode_rollout_bwd_plain(s_de.double(), double(weights), dt, sol.double(), cot.double(),
                                                  solver))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        worst, report = hold_bwd(f"folded kernel 4 {solver}", names, got, again, ref)
        err[4] = max(err.get(4, 0.0), worst)
        say(f"[ms-kernel] kernel 4 B={MS_B} T={MS_L + 1} xd=2 {solver:8s}: ok, bit-identical on relaunch; plain "
            f"float64 walk {plain_s:.1f} s; max|d| / max|plain| per tensor: {report}")
    return err


def ms_launches_ok(variant, n, rows, eval_batches):
    """A fused DAE multishoot run launches kernels 1-2, an ODE one kernels
    3-4, each training step at the folded batch; a channel-wise one
    launches kernel 5 once for each of its ``eval_batches`` evaluation
    batches (two evaluations) and kernel 6 never. Returns (ok, the folded
    launches of its kernel pair)."""
    if "channelwise" in variant:
        return not any(n[:4]) and n[5] == 0 and n[4] == 2 * eval_batches, (0, 0)
    pair = {"dae": (1, 2), "ode": (3, 4)}[variant.split("_")[0]]
    fwd, bwd = pair
    folded = (sum(call_rows(c) == MS_B for c in rows[fwd]), sum(call_rows(c) == MS_B for c in rows[bwd]))
    others = [n[k - 1] for k in range(1, 7) if k not in pair]
    ok = folded == (2, 2) and len(rows[bwd]) == 2 and not any(others)
    return ok, folded


def phase_ms_slice(dev, files, root):
    """Phase 20, part 2: the Trainer (fused, ``n_windows=20``,
    ``gap_weight=0.3``, one epoch of two steps, Euler, every step logged)
    for each variant, steps 1 and 2 and the full-rollout epoch-1 eval
    against MS_ANCHORS at rtol 1e-3, the launches of kernels 1-6 counted
    (set to 0 just before, read just after; the rows of each launch of
    kernels 1-4 recorded); then the CLI ``--training --fused --n_windows
    20 --gap_weight 0.3`` of the motor DAE, and ``--n_windows 7`` refused
    with the JAX package's error. Returns the folded launches of kernels
    1-2 (the motor DAE's run) and 3-4 (the ODE's), and kernel 5's launches
    in the channel-wise ODE's run."""
    out = {}
    for variant in MS_VARIANTS:
        train_f, test_f, start = files[variant]
        size = CW_TRAIN.get(variant, dict(num=128, batch=64))
        ws = shutil.copy(start, root / f"{variant}_ws")
        cfg = TrainConfig(
            variant=variant, train_data=str(train_f), test_data=str(test_f), model=str(root / variant), epoch=200,
            hidden=128, larger_than=None, seed=0, warm_start=str(ws), stop_after=1, loss_record_iter=1,
            solver="euler", fused=True, echo_logs=False, device="cuda", n_windows=MS_WINDOWS,
            gap_weight=MS_GAP_WEIGHT, **size,
        )
        trainer = Trainer(cfg)
        test_ds = trainer.load_test_dataset()
        eval_batches = -(-len(test_ds) // trainer._eval_batch_size(test_ds))
        reset_all_counts()
        t0 = time.perf_counter()
        with kernel_calls() as rows:
            _, run_dir = trainer.train()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = all_counts()
        recs = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text().splitlines()]
        steps = [r for r in recs if r["kind"] == "train"]
        (ev,) = [r for r in recs if r["kind"] == "eval"]
        if len(steps) != 2:
            fail(f"{variant} multishoot training logged {len(steps)} steps, not 2")
        anchors = MS_ANCHORS[variant]
        got = dict(step1=(steps[0]["loss"], steps[0]["grad_norm"]), step2=(steps[1]["loss"], steps[1]["grad_norm"]),
                   eval1=tuple(ev[k] for k in ("x_loss", "i_loss") if k in ev))
        errs = []
        for key in ("step1", "step2", "eval1"):
            for v, a in zip(got[key], anchors[key]):
                if not (np.isfinite(v) and near(v, a, ANCHOR_RTOL)):
                    fail(f"{variant} multishoot {key} {got[key]} misses the JAX anchors {anchors[key]} at rtol "
                         f"{ANCHOR_RTOL}")
                errs.append(abs(v - a) / abs(a))
        ok, folded = ms_launches_ok(variant, n, rows, eval_batches)
        say(f"[ms-train] {variant} --fused --n_windows {MS_WINDOWS} --gap_weight {MS_GAP_WEIGHT} (Trainer, batch "
            f"{size['batch']}, euler): steps {got['step1']}, {got['step2']}; epoch-1 eval (full rollout) "
            f"{got['eval1']}; worst rel. err. to the JAX anchors {max(errs):.2e}; launches of kernels 1-6: {n}, "
            f"of its kernel pair at {MS_B if size['batch'] == 64 else '-'} rows: {folded}; rows of kernels 1-4: "
            f"{ {k: [call_rows(c) for c in v] for k, v in rows.items() if v} }; wall {wall:.2f} s")
        if not ok:
            fail(f"{variant} multishoot launched kernels 1-6 {n} times ({folded} at {MS_B} rows), not as its "
                 f"dispatch names them")
        out[variant] = folded if "channelwise" not in variant else n[4]

    train_f, test_f, start = files["dae_no_encode"]
    common = ["--training", "--fused", "--device", "cuda", "--train_data", str(train_f), "--test_data", str(test_f),
              "--num", "128", "--batch", "64", "--epoch", "200", "--stop_after", "1", "--larger_than", "none",
              "--warm_start", str(shutil.copy(start, root / "cli_ws")), "--gap_weight", str(MS_GAP_WEIGHT)]
    reset_all_counts()
    t0 = time.perf_counter()
    with kernel_calls() as rows:
        _, run_dir = cli_main("dae_no_encode", common + ["--n_windows", str(MS_WINDOWS), "--model",
                                                        str(root / "cli_run")])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = all_counts()
    (ev,) = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text().splitlines()
             if json.loads(line)["kind"] == "eval"]
    losses, anchors = (ev["x_loss"], ev["i_loss"]), MS_ANCHORS["dae_no_encode"]["eval1"]
    ok, folded = ms_launches_ok("dae_no_encode", n, rows, 1)
    if not ok or not (run_dir / "model_checkpoint.1").exists():
        fail(f"CLI --training --fused --n_windows launched kernels 1-6 {n} times or wrote no checkpoint")
    if not all(np.isfinite(v) and near(v, a, ANCHOR_RTOL) for v, a in zip(losses, anchors)):
        fail(f"CLI --training --fused --n_windows epoch-1 eval {losses} misses the anchors {anchors}")
    want = "(T-1)=1000 not divisible by n_windows=7"
    try:
        cli_main("dae_no_encode", common + ["--n_windows", "7", "--model", str(root / "cli_run7")])
    except ValueError as e:
        if str(e) != want:
            fail(f"CLI --n_windows 7 raised {e!r}, not the JAX package's {want!r}")
    else:
        fail("CLI --n_windows 7 trained, though 1000 % 7 != 0")
    say(f"[ms-cli] --training --fused --n_windows {MS_WINDOWS} --gap_weight {MS_GAP_WEIGHT} (motor DAE, checkpoint "
        f"200, one epoch): epoch-1 eval {losses} (anchors {anchors}); launches of kernels 1-6 {n}, {folded} at "
        f"{MS_B} rows; wall {wall:.2f} s; --n_windows 7 raised ValueError({want!r})")
    return out


def ms_step(variant, make, batch, keys, dev):
    """Phase 20, steps: one training step (B=64, T=1001, RK4, Adam) of
    ``variant`` through the fused multishoot forward, the plain multishoot
    forward and the non-windowed fused forward, each timed with its peak
    memory; the fused multishoot step's loss and gradients held against the
    plain one's. Returns {route: (ms, peak bytes)}."""
    fused_ms, plain_ms, fused, loss_fn = MS_APPLY[variant]
    ms_loss = lambda og, b: (loss_fn(og[0], b)[0] + MS_GAP_WEIGHT * torch.mean(og[1] ** 2), {})
    routes = (("fused multishoot", lambda m, b: fused_ms(m, b, MS_WINDOWS), ms_loss, 3),
              ("plain multishoot", lambda m, b: plain_ms(m, b, MS_WINDOWS), ms_loss, 1),
              ("fused, no windows", fused, loss_fn, 3))
    out, first = {}, {}
    for route, apply, loss, reps in routes:
        ms, peak, loss0, grads = timed_steps(make(), batch, apply, loss, keys, dev, True, reps)
        out[route], first[route] = (ms, peak), (loss0, grads)
        say(f"[ms-times] {variant} training step B=64 T=1001 h=128 rk4 K={MS_WINDOWS}, {route}: {ms:.3f} ms, "
            f"{64 * 1000 / ms * 1e3:.1f} trajectory-steps/s, peak memory allocated {peak / 2**30:.2f} GiB")
    check_cw_step(f"{variant} multishoot", first["fused multishoot"], first["plain multishoot"],
                  tag="[ms-step-check]")
    return out


def phase_ms_times(dev, files, times, ode_times):
    """Phase 20, times (CUDA events, RK4): kernels 1-4 alone at the folded
    shape on the main path's own inputs (the launches of one fused
    multishoot step, recorded: the motor DAE from checkpoint 200, the ODE
    and the direct-encode DAE from their starting checkpoints, 64 training
    rows each), each beside its plain version, its bound and the 64 x 1000
    time of phases 7 and 11; the no-encode forwards at every rows-a-block
    and the no-encode backwards' three kernels apart; then :func:`ms_step`
    for the three variants. Returns the kernels' records by (variant,
    kernel) and the steps' by variant."""
    out = {}
    enc = files["dae_encode"][2]
    models = {"dae_no_encode": (motor_model, motor_batch(64, dev), TF_KEYS["dae_no_encode"]),
              "ode_no_encode": (lambda d, s: ode_model(files["ode_no_encode"][2], d, s),
                                enc_batch("ode_encode", files["ode_no_encode"][0], 64, dev), ENC_KEYS["ode_encode"]),
              "dae_encode": (lambda d, s: enc_model("dae_encode", enc, d, s),
                             enc_batch("dae_encode", TRAIN_DATA, 64, dev), ENC_KEYS["dae_encode"])}
    full = {1: times[(64, "rk4")], 2: times[("bwd", "rk4")], 3: ode_times[("fwd", 64, "rk4")],
            4: ode_times[("bwd", "rk4")]}
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for variant, (make, batch, _) in models.items():
        fused_ms, _, _, loss_fn = MS_APPLY[variant]
        model = make(dev, "rk4")
        with kernel_calls() as calls:
            out_g = fused_ms(model, batch, MS_WINDOWS)
            loss = loss_fn(out_g[0], batch)[0] + MS_GAP_WEIGHT * torch.mean(out_g[1] ** 2)
            loss.backward()
            torch.cuda.synchronize()
        for k, cuda_fn, plain_fn in ((1, F.fused_dae_rollout_packed_cuda, F.fused_dae_rollout_packed_plain),
                                     (2, V.fused_dae_rollout_bwd_cuda, V.fused_dae_rollout_bwd_plain),
                                     (3, FO.fused_ode_rollout_cuda, FO.fused_ode_rollout_plain),
                                     (4, VO.fused_ode_rollout_bwd_cuda, VO.fused_ode_rollout_bwd_plain)):
            if not calls[k]:
                continue
            (args, kw), = calls[k]
            k_ms = cuda_ms(lambda: cuda_fn(*args, **kw), 1, 5)
            p_ms = cuda_ms(lambda: plain_fn(*args, **kw), 0, 1)
            if k == 1:
                n_bytes, flops, tc = (*rollout_work(*args[:6]), 0)
            elif k == 2:
                n_bytes, flops, tc = bwd_work(*args[:5], args[7])
            elif k == 3:
                n_bytes, flops, tc = (*ode_work(*args[:3], args[4])[:2], 0)
            else:
                s_de, weights, dt, sol, cot, solver = args
                n_bytes, flops, tc = ode_work(s_de, weights, sol[0], solver)[2:]
            b_ms, b_by = bound(n_bytes, flops, tc)
            out[(variant, k)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
            what = f"[ms-times] {variant} kernel {k} at {call_rows(calls[k][0])} x {MS_L}"
            unfolded = ("" if variant == "dae_encode" else f"; at 64 x 1000 (phase {7 if k < 3 else 11}): "
                        f"{full[k]['ms']:.4f} ms, bound {full[k]['bound_ms']:.5f} ms; folded/unfolded "
                        f"{k_ms / full[k]['ms']:.3f}")
            say(f"{what} (the multishoot step's launch, rk4): {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound "
                f"{b_ms:.5f} ms ({b_by}{', 3xTF32' if tc else ''}; {n_bytes} B, {flops} FLOP), kernel/bound "
                f"{k_ms / b_ms:.1f}x{unfolded}")
            if variant == "dae_encode":
                continue
            if k in (1, 3):  # how the forward trades rows a block for waves at this batch
                by_rows = {rows: cuda_ms(lambda: cuda_fn(*args, **kw, rows_per_block=rows), 1, 5)
                           for rows in F.ROWS_PER_BLOCK}
                say(f"{what} rk4 by rows a block (the launcher takes {F.default_launch(MS_B, n_sms)}): "
                    + ", ".join(f"{rows}: {ms:.4f} ms" for rows, ms in by_rows.items()))
            elif k == 2:
                noencode_split(f"{what} rk4", lambda st, bufs=None: V._launch_bwd(*args[:8], stages=st, bufs=bufs),
                               lambda b: dae_contraction(b, args[:5], "rk4"), lambda g: V.flatten_weights(g)[0])
            else:
                noencode_split(f"{what} rk4", lambda st, bufs=None: VO._launch_bwd(*args, stages=st, bufs=bufs),
                               lambda b: ode_contraction(b, args[1], args[3]), VO.flatten_weights)
        del calls, out_g, loss, model
    for variant, (make, batch, keys) in models.items():
        out[variant] = ms_step(variant, lambda: make(dev, "rk4"), batch, keys, dev)
    return out


def phase_ms(dev, root, ode_files, cw_files, times, ode_times):
    """Phase 20: multiple shooting, from the checkpoints and data of phases
    6, 10, 14 and 17-18 (the direct-encode starting checkpoints drawn
    again)."""
    t0 = time.perf_counter()
    files = {
        "dae_no_encode": (TRAIN_DATA, TEST_DATA, CKPT),
        "dae_encode": (TRAIN_DATA, TEST_DATA, start_checkpoint(
            root / "dae_encode.start", DAEEncodeModel(3, 1, 2, 2, hidden_dim=128, device="meta"), seed=0)),
        "ode_no_encode": ode_files,
        "ode_encode": (*ode_files[:2], start_checkpoint(
            root / "ode_encode.start", ODEEncodeModel(2, 2, hidden_dim=128, device="meta"), seed=0)),
        **cw_files,
    }
    out = dict(kernel_err=phase_ms_kernels(dev), launches=phase_ms_slice(dev, files, root),
               times=phase_ms_times(dev, files, times, ode_times))
    say(f"[ms] phase 20 in {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="time both forwards at every launch shape")
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
    ode_fwd_err = phase_ode_kernel_vs_plain(dev)
    ode_bwd_err = phase_ode_bwd_vs_plain(dev)
    with tempfile.TemporaryDirectory(prefix="psnode_smoke_") as tmp:
        root = pathlib.Path(tmp)
        (root / "ode").mkdir()
        (root / "cw").mkdir()
        ode_launches, ode_files = phase_ode_slice(dev, root / "ode")
        ode_times = phase_ode_times(dev, ode_files, args.sweep)
        cw_files = cw_setup(root / "cw")
        cw_fwd_err = phase_cw_kernel_vs_plain(dev, cw_files)
        cw_bwd_err = phase_cw_bwd_vs_plain(dev, cw_files)
        cw_launches = phase_cw_slice(dev, cw_files, root / "cw")
        cw_times = phase_cw_times(dev, cw_files)
        phase_export(dev, root, ode_files, cw_files)
        (root / "enc").mkdir()
        phase_encode(dev, root / "enc", ode_files)
        (root / "tf").mkdir()
        tf = phase_tf(dev, root / "tf", ode_files)
        (root / "ms").mkdir()
        ms = phase_ms(dev, root / "ms", ode_files, cw_files, times, ode_times)
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
    # rows 1-2 in their TF-x mode as phase 19's motor DAE drives them: the
    # forward at B=32 Euler (the --testing batch), the backward at B=64 RK4;
    # launches from the TF-x Trainer run
    tfx = lambda k, t: {f"tfx_{key}": v for key, v in dict(
        launches=tf["launches"][k], max_abs_err=tf["kernel_err"][k], ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"]).items()}
    # rows 1-4 at phase 20's folded shape (K=20 windows of B=64: 1 280 rows,
    # 50 steps, RK4): launches at that shape in the motor DAE's (rows 1-2)
    # and the AVR ODE's (rows 3-4) fused multishoot Trainer run
    folded = lambda k, variant, launches: {f"ms_{key}": v for key, v in dict(
        launches=launches, max_abs_err=ms["kernel_err"][k], **ms["times"][(variant, k)]).items()}
    record = {"kernels": [
        {**entry("fused_dae_rollout", "py_psnode_tpu_torch/csrc/fused_dae_rollout.cu",
                 "py_psnode_tpu/ops/fused_dae.py:371", fwd_launches, fwd_err, fwd_t),
         **tfx(0, tf["times"][("fwd", 32, "euler")]), **folded(1, "dae_no_encode", ms["launches"]["dae_no_encode"][0])},
        {**entry("fused_dae_rollout_bwd", "py_psnode_tpu_torch/csrc/fused_dae_rollout_bwd.cu",
                 "py_psnode_tpu/ops/fused_dae_vjp.py:147", train_launches["euler"][1], bwd_err, bwd_t),
         **tfx(1, tf["times"][("bwd", 64, "rk4")]), **folded(2, "dae_no_encode", ms["launches"]["dae_no_encode"][1])},
        # the ODE kernels as the CLI's --training --fused drives them (B=64,
        # Euler, the CLI's default solver)
        {**entry("fused_ode_rollout", "py_psnode_tpu_torch/csrc/fused_ode_rollout.cu",
                 "py_psnode_tpu/ops/fused_ode.py:125", ode_launches[0], ode_fwd_err,
                 ode_times[("fwd", 64, "euler")]), **folded(3, "ode_no_encode", ms["launches"]["ode_no_encode"][0])},
        {**entry("fused_ode_rollout_bwd", "py_psnode_tpu_torch/csrc/fused_ode_rollout_bwd.cu",
                 "py_psnode_tpu/ops/fused_ode.py:171", ode_launches[1], ode_bwd_err,
                 ode_times[("bwd", "euler")]), **folded(4, "ode_no_encode", ms["launches"]["ode_no_encode"][1])},
        # the channel-wise kernels as the ODE channel-wise CLI's --training
        # --fused drives them (B=64, Euler)
        # ms_eval_launches: its launches in the channel-wise ODE's fused
        # multishoot run, all in the full-rollout evaluations
        {**entry("fused_cw_rollout", "py_psnode_tpu_torch/csrc/fused_cw_rollout.cu",
                 "py_psnode_tpu/ops/fused_channelwise.py:258", cw_launches["ode_channelwise"][0], cw_fwd_err,
                 cw_times[("ode_channelwise", "fwd", 64, "euler")]),
         "ms_eval_launches": ms["launches"]["ode_channelwise"]},
        entry("fused_cw_rollout_bwd", "py_psnode_tpu_torch/csrc/fused_cw_rollout_bwd.cu",
              "py_psnode_tpu/ops/fused_channelwise.py:370", cw_launches["ode_channelwise"][1], cw_bwd_err,
              cw_times[("ode_channelwise", "bwd", "euler")]),
    ]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
