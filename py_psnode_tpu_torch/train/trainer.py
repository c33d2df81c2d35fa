"""Trainer, test mode only (counterpart of ``py_psnode_tpu/train/trainer.py``:
``TrainConfig``, ``build_model``, ``_eval_batch_size`` :682,
``_make_eval_apply`` :702 and ``test`` :1131).

``Trainer.test`` loads a ``model_checkpoint.{epoch}`` npz, evaluates it on
the test set and writes ``Model_<ckpt>_Evaluation.log`` and
``evaluation.npz`` next to the checkpoint, as the JAX package does.
Training, export, data parallelism and the orbax backend are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from py_psnode_tpu_torch.bridge import load_params
from py_psnode_tpu_torch.data import DaeSamples
from py_psnode_tpu_torch.train import evaluate as E
from py_psnode_tpu_torch.train.checkpoints import (
    load_checkpoint_params,
    resolve_checkpoint,
)
from py_psnode_tpu_torch.train.variants import Variant, dataset_dims, get_variant
from py_psnode_tpu_torch.utils.device import resolve_device
from py_psnode_tpu_torch.utils.logging import Logger


@dataclasses.dataclass
class TrainConfig:
    """The fields the test path reads (names as in the JAX package)."""

    variant: str
    test_data: str = ""
    model: str = "saved_models/test"
    hidden: int = 128
    step: int = 1001
    solver: str = "euler"
    drawing: bool = False
    # route the DAE no-encode forward through the fused rollout (the CUDA
    # kernel on the card)
    fused: bool = False
    # contain_larger_than / show_larger_than filter; "variant" uses the
    # per-variant reference constant
    larger_than: object = "variant"
    # "cuda", "cuda:N" or "cpu"; nothing falls back from cuda to cpu
    device: str = "cuda"


class Trainer:
    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.variant: Variant = get_variant(cfg.variant)
        self.device = resolve_device(cfg.device)
        self.larger_than = (
            self.variant.larger_than if cfg.larger_than == "variant" else cfg.larger_than
        )

    def load_test_dataset(self):
        return DaeSamples.load(self.cfg.test_data, cut_length=self.cfg.step)

    def build_model(self, ds):
        """The variant's module on the ``meta`` device (no weights yet);
        :meth:`test` materializes it from the checkpoint."""
        return self.variant.make_model(
            dataset_dims(self.variant, ds), self.cfg.hidden, solver=self.cfg.solver, device="meta"
        )

    def _forward_fn(self, model):
        cfg, variant = self.cfg, self.variant
        if cfg.fused and variant.name == "dae_no_encode":
            from py_psnode_tpu_torch.ops import fused_dae_apply

            return lambda batch: fused_dae_apply(model, batch, solver=cfg.solver)
        return lambda batch: model(*[batch.get(k) for k in variant.batch_args])

    def _eval_batch_size(self, test_ds):
        """Reference eval-batch rule (N/10); small sets run as one batch."""
        n = len(test_ds)
        return n if n <= 512 else max(int(n / 10), 1)

    def _make_eval_apply(self, model, test_ds):
        """Index-based eval function: the test set is moved to the device
        once and per-sample losses reduce there, so only small loss arrays
        (plus predictions when drawing) come back to the host."""
        variant = self.variant
        forward = self._forward_fn(model)
        keys = variant.batch_args + ("mask",)
        ddata = {
            k: torch.as_tensor(getattr(test_ds, k), device=self.device) for k in keys
        }

        def apply_fn_factory(want_preds=False):
            def call(idx):
                idx_t = torch.as_tensor(idx, device=self.device)
                batch = {k: v[idx_t] for k, v in ddata.items()}
                with torch.no_grad():
                    x_pred, i_pred = forward(batch)
                    mask = batch["mask"]
                    res = {
                        "x_loss_ps": torch.sum((x_pred - batch["x"]) ** 2 * mask, dim=1),
                        "i_loss_ps": torch.sum((i_pred - batch["i"]) ** 2 * mask, dim=1),
                    }
                if want_preds:
                    res["x_pred"], res["i_pred"] = x_pred, i_pred
                return res

            return call

        return apply_fn_factory

    def test(self):
        """--testing mode (ref :406-433): load checkpoint file, evaluate."""
        cfg = self.cfg
        test_ds = self.load_test_dataset()
        eval_batch = self._eval_batch_size(test_ds)
        model = self.build_model(test_ds)
        # a run DIRECTORY resolves to its best-eval epoch (early-stop restore)
        model_path = resolve_checkpoint(pathlib.Path(cfg.model))
        load_params(model, load_checkpoint_params(model_path), device=self.device)
        model.requires_grad_(False).eval()
        pic_path = model_path.parent / "pics" if cfg.drawing else None
        logger = Logger(
            model_path.parent,
            test_log_name=f"Model_{model_path.name}_Evaluation.log",
        )
        logger.testing_log(f"Model {model_path} Evaluation")
        logger.testing_log(f"Use testing data: {cfg.test_data}")
        logger.testing_log("=" * 86)
        result = E.evaluate_dae(
            self._make_eval_apply(model, test_ds)(want_preds=pic_path is not None),
            test_ds, eval_batch, logger,
            desc=f"Model {model_path.name} Evaluation", pic_path=pic_path,
            show_larger_than=self.larger_than,
        )
        logger.testing_log("=" * 86)
        logger.close()
        # the testing-mode results file; the key set (with the reference's
        # stray "dtype" key) is kept for .npz compatibility
        np.savez(
            model_path.parent / "evaluation.npz",
            train_error_list=np.asarray([], dtype=object),
            eval=result, dtype=np.asarray(object),
        )
        return result
