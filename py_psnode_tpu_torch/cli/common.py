"""Shared CLI (counterpart of ``py_psnode_tpu/cli/common.py``): the
reference CLI scripts' flags and the mode dispatch: ``--training``,
``--testing`` and ``--saving`` (export a checkpoint into ``saved model/``
beside it; needs ``--model`` and ``--test_data``).

Flags: --device --id --training --testing --saving --drawing --train_data
--test_data --model --num --batch --hidden --epoch --step, plus the JAX
package's --warm_start --stop_after --solver --lr --seed --fused
--robust_loss --robust_limit --gradient_clip --init_style --larger_than
--channel_impl --input_true_x --input_true_i --n_windows --gap_weight, with
its names and defaults. The JAX flags of paths that are not ported
(--devices --dcn_size --checkpointer --auto_resume --remat) are accepted at
their defaults and raise "not ported yet" otherwise.
``--device`` defaults to ``cuda``; ``cpu`` must be asked for.
"""

from __future__ import annotations

import argparse

from py_psnode_tpu_torch.train import TrainConfig, Trainer
from py_psnode_tpu_torch.utils.device import use_full_float32


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda",
                        help='Device: "cuda" (default; "gpu" is the same) or '
                             '"cpu". There is no fallback from cuda to cpu.')
    parser.add_argument("--id", type=int, default=0,
                        help="Device index within the backend. Default 0.")
    parser.add_argument("--training", action="store_true",
                        help="Call training process, --train_data and --test_data needed.")
    parser.add_argument("--testing", action="store_true",
                        help="Call testing process, --model and --test_data needed.")
    parser.add_argument("--saving", action="store_true",
                        help="Call saving process: export --model (a checkpoint "
                             "file, or a run directory resolved to its best-eval "
                             "epoch) into 'saved model/' beside it; --model and "
                             "--test_data needed.")
    parser.add_argument("--drawing", action="store_true",
                        help="Draw true-vs-pred curves during testing.")
    parser.add_argument("--train_data", type=str,
                        default="./results/samples_neural_gen_2_training.npz",
                        help="Training data file path (.npz)")
    parser.add_argument("--test_data", type=str,
                        default="./results/samples_neural_gen_2_testing.npz",
                        help="Testing data file path (.npz)")
    parser.add_argument("--model", type=str, default="saved_models/test",
                        help="Model dump/load path. Training: a directory is "
                             "created, an existing checkpoint file resumes "
                             "training into <name>_branch/. Testing: a "
                             "checkpoint file model_checkpoint.<epoch>, or a "
                             "run directory (resolved to its best-eval epoch).")
    parser.add_argument("--num", type=int, default=3200,
                        help="Training set size. Default 3200.")
    parser.add_argument("--batch", type=int, default=64,
                        help="Mini-batch size. Default 64.")
    parser.add_argument("--hidden", type=int, default=128,
                        help="Hidden dimensionality. Default 128.")
    parser.add_argument("--epoch", type=int, default=400,
                        help="Number of training epochs. Default 400.")
    parser.add_argument("--step", type=int, default=1001,
                        help="Length of the series. Default 1001.")
    parser.add_argument("--warm_start", type=str, default=None,
                        help="Initialize params from this checkpoint (file, or "
                             "a run dir resolved to its best-eval epoch) and "
                             "train into --model (fresh optimizer, epoch 1).")
    parser.add_argument("--stop_after", type=int, default=0,
                        help="Stop after this many epochs while keeping the "
                             "full --epoch lr schedule. 0 = run all epochs.")
    parser.add_argument("--solver", type=str, default="euler",
                        help="Fixed-grid stepper: euler | midpoint | rk4. Default euler.")
    parser.add_argument("--lr", type=float, default=5e-3,
                        help="Learning rate. Default 5e-3.")
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of the initialization and the batch order.")
    parser.add_argument("--fused", action="store_true",
                        help="Route the rollout and its backward through the "
                             "fused kernels (the CUDA kernels on the card).")
    parser.add_argument("--robust_loss", action="store_true",
                        help="Wrap the loss in the robust guard: NaN losses "
                             "take a zero-gradient step; losses above the "
                             "limit are gradient-direction-normalized.")
    parser.add_argument("--robust_limit", type=float, default=None,
                        help="Robust-guard threshold (with --robust_loss). Default 1.0.")
    parser.add_argument("--gradient_clip", type=float, default=None,
                        help="Opt-in pre-update per-parameter-tensor L2 clip.")
    parser.add_argument("--init_style", default="lecun", choices=("lecun", "torch"),
                        help="Weight init: flax default (lecun_normal, zero "
                             "biases) or torch nn.Linear's.")
    parser.add_argument("--larger_than", type=str, default="variant",
                        help='contain_larger_than/show_larger_than filter: a '
                             'float, "none", or "variant" (per-variant '
                             'reference constant).')
    parser.add_argument("--channel_impl", type=str, default="einsum",
                        choices=("einsum", "blockdiag"),
                        help="Channel-wise variants: per-channel matmul form, "
                             "one grouped einsum per layer or one "
                             "block-diagonal product (same numbers).")
    parser.add_argument("--input_true_x", action="store_true",
                        help="Teacher forcing: feed the TRUE previous state "
                             "to every solver step (ref my_solvers.py:74).")
    parser.add_argument("--input_true_i", action="store_true",
                        help="Teacher forcing (DAE only): feed the TRUE "
                             "lagged algebraic output to every step "
                             "(ref my_solvers.py:113,118).")
    parser.add_argument("--n_windows", type=int, default=0,
                        help="Multiple-shooting window count K (0 = plain "
                             "BPTT). (step-1) must be divisible by K. "
                             "Decision rule: try --robust_loss BPTT first "
                             "(converges ~10x lower at the full reference "
                             "envelope, ACCURACY.md); use K=20 with "
                             "--gap_weight 0.3 when the epoch/wall-clock "
                             "budget is small or guarded BPTT still "
                             "diverges.")
    parser.add_argument("--gap_weight", type=float, default=1.0,
                        help="Multiple-shooting continuity-gap penalty "
                             "weight (with --n_windows).")
    # flags of the JAX package's paths that are not ported yet
    for flag, kw in _NOT_PORTED_FLAGS.items():
        parser.add_argument(flag, help="Not ported yet.", **kw)
    return parser


# flag -> argparse keywords with the JAX package's default
_NOT_PORTED_FLAGS = {
    "--devices": dict(type=int, default=0),
    "--dcn_size": dict(type=int, default=0),
    "--checkpointer": dict(type=str, default="npz"),
    "--auto_resume": dict(action="store_true"),
    "--remat": dict(type=str, default="true"),
}


def _check_ported(args):
    for flag, kw in _NOT_PORTED_FLAGS.items():
        value = getattr(args, flag[2:])
        if value != kw.get("default", False) and not (flag == "--devices" and value == 1):
            raise NotImplementedError(f"{flag} {value} is not ported yet")


def _parse_larger_than(value: str):
    v = value.strip().lower()
    if v == "variant":
        return "variant"
    if v in ("none", "off"):
        return None
    try:
        return float(value)
    except ValueError:
        raise SystemExit(
            f'--larger_than expects a float, "none", or "variant"; got {value!r}'
        ) from None


def device_name(device: str, index: int) -> str:
    """``--device``/``--id`` as a torch device string: ``cuda`` or ``gpu``
    (any case; the reference's command lines say ``gpu``) is ``cuda:<id>``,
    ``cpu`` is ``cpu``; anything else exits with an error."""
    d = device.lower()
    if d in ("cuda", "gpu"):
        return f"cuda:{index}"
    if d == "cpu":
        return "cpu"
    raise SystemExit(f'Argument "--device" is illegal. Expected "cuda", "gpu" or "cpu" but {device}')


def main(variant: str, argv=None):
    args = build_parser().parse_args(argv)
    use_full_float32()
    device = device_name(args.device, args.id)
    _check_ported(args)
    cfg = TrainConfig(
        variant=variant,
        train_data=args.train_data,
        test_data=args.test_data,
        model=args.model,
        num=args.num,
        batch=args.batch,
        hidden=args.hidden,
        epoch=args.epoch,
        stop_after=args.stop_after or None,
        warm_start=args.warm_start,
        step=args.step,
        learning_rate=args.lr,
        solver=args.solver,
        drawing=args.drawing,
        seed=args.seed,
        fused=args.fused,
        larger_than=_parse_larger_than(args.larger_than),
        robust_loss=args.robust_loss,
        robust_limit=args.robust_limit,
        gradient_clip=args.gradient_clip,
        init_style=args.init_style,
        channel_impl=args.channel_impl,
        input_true_x=args.input_true_x,
        input_true_i=args.input_true_i,
        n_windows=args.n_windows or None,
        gap_weight=args.gap_weight,
        device=device,
    )
    if args.training:
        if not (args.train_data and args.test_data):
            raise SystemExit("Training set or testing set missing! Please check.")
        return Trainer(cfg).train()
    if args.testing:
        if not (args.model and args.test_data):
            raise SystemExit("Model or testing set missing! Please check.")
        return Trainer(cfg).test()
    if args.saving:
        if not (args.model and args.test_data):
            raise SystemExit("Model or testing set missing! Please check.")
        return Trainer(cfg).save()
    raise SystemExit('Unknown task. Set "--training" or "--testing".')
