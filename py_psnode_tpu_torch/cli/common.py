"""Shared CLI (counterpart of ``py_psnode_tpu/cli/common.py``): the
reference drivers' flags and the mode dispatch. Only ``--testing`` is
ported; ``--training`` and ``--saving`` raise.

Flags: --device --id --training --testing --saving --drawing --train_data
--test_data --model --num --batch --hidden --epoch --step, plus --solver,
--fused and --larger_than. ``--device`` defaults to ``cuda``; ``cpu`` must
be asked for.
"""

from __future__ import annotations

import argparse

from py_psnode_tpu_torch.train import TrainConfig, Trainer
from py_psnode_tpu_torch.utils.device import use_full_float32


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda",
                        help='Device: "cuda" (default) or "cpu". There is no '
                             "fallback from cuda to cpu.")
    parser.add_argument("--id", type=int, default=0,
                        help="Device index within the backend. Default 0.")
    parser.add_argument("--training", action="store_true",
                        help="Call training process (not ported yet).")
    parser.add_argument("--testing", action="store_true",
                        help="Call testing process, --model and --test_data needed.")
    parser.add_argument("--saving", action="store_true",
                        help="Call saving process (not ported yet).")
    parser.add_argument("--drawing", action="store_true",
                        help="Draw true-vs-pred curves during testing.")
    parser.add_argument("--train_data", type=str,
                        default="./results/samples_neural_gen_2_training.npz",
                        help="Training data file path (.npz)")
    parser.add_argument("--test_data", type=str,
                        default="./results/samples_neural_gen_2_testing.npz",
                        help="Testing data file path (.npz)")
    parser.add_argument("--model", type=str, default="saved_models/test",
                        help="Checkpoint file model_checkpoint.<epoch>, or a "
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
    parser.add_argument("--solver", type=str, default="euler",
                        help="Fixed-grid stepper: euler | midpoint | rk4. Default euler.")
    parser.add_argument("--fused", action="store_true",
                        help="Route the rollout through the fused forward "
                             "(the CUDA kernel on the card).")
    parser.add_argument("--larger_than", type=str, default="variant",
                        help='show_larger_than filter: a float, "none", or '
                             '"variant" (per-variant reference constant).')
    return parser


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


def main(variant: str, argv=None):
    args = build_parser().parse_args(argv)
    use_full_float32()
    device = args.device.lower()
    if device not in ("cuda", "cpu"):
        raise SystemExit(f'Argument "--device" is illegal. Expected "cuda" or "cpu" but {args.device}')
    if args.training or args.saving:
        raise NotImplementedError(
            "--training and --saving are not ported yet; the port serves --testing"
        )
    if not args.testing:
        raise SystemExit('Unknown task. Set "--testing".')
    if not (args.model and args.test_data):
        raise SystemExit("Model or testing set missing! Please check.")
    cfg = TrainConfig(
        variant=variant,
        test_data=args.test_data,
        model=args.model,
        hidden=args.hidden,
        step=args.step,
        solver=args.solver,
        drawing=args.drawing,
        fused=args.fused,
        larger_than=_parse_larger_than(args.larger_than),
        device=f"cuda:{args.id}" if device == "cuda" else "cpu",
    )
    return Trainer(cfg).test()
