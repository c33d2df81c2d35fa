"""Trainer (counterpart of ``py_psnode_tpu/train/trainer.py``: ``TrainConfig``,
``build_model``, ``_make_train_step`` :577-680, ``_eval_batch_size`` :682,
``_make_eval_apply`` :702, ``train`` :796-1129, ``test`` :1131 and ``save`` :1178).

``Trainer.train`` trains any of the six variants (the ODE and DAE
no-encode, direct-encode and channel-wise models) on one device: Adam + StepLR, the zero-loss freeze and the optional robust-loss guard, the
training set resident on the device and gathered by index, rolling
record-window log lines, an npz checkpoint, an eval and the export of
``saved model/`` each epoch (and once more after the last),
``train_and_eval.npz``, ``train_metrics.jsonl`` and the training-process
summary. ``Trainer.test`` loads a ``model_checkpoint.{epoch}`` npz,
evaluates it and writes ``Model_<ckpt>_Evaluation.log`` and
``evaluation.npz`` next to the checkpoint; ``Trainer.save`` exports a
checkpoint into ``saved model/`` beside it. Teacher forcing
(``input_true_x`` / ``input_true_i``) trains and evaluates the four
non-channel-wise variants, the fused route by the JAX package's dispatch
(``_teacher_forced_forward``); the channel-wise family defines none and
refuses it as the JAX package does. Multiple shooting (``n_windows``,
``gap_weight``) trains all six variants, the four non-channel-wise ones
through the fused kernels where ``fused`` (``_multishoot_forward``); the
evaluations stay full rollouts. ``matmul_precision="bfloat16"`` with
``fused`` runs the kernels of every fused path (1-4, the TF-x and TF-i
ones, 5-6) in their bf16 compute mode in training and in every evaluation
(the JAX package's ``_forward_fn``; channel-wise multishoot trains its
windows plain and evaluates on kernel 5); the plain route, the
precomputes, the encoders and the optimizer stay float32 under every
precision (the JAX package on the CPU computes them so). Not ported yet:
orbax checkpoints, ``auto_resume`` and data parallelism.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
import time
from typing import Optional

import numpy as np
import torch

from py_psnode_tpu_torch.bridge import load_params
from py_psnode_tpu_torch.data import DaeSamples, OdeSamples
from py_psnode_tpu_torch.models.initializers import init_params
from py_psnode_tpu_torch.ops import teacher_forcing as TF
from py_psnode_tpu_torch.ops.fused_dae import is_bf16
from py_psnode_tpu_torch.train import evaluate as E
from py_psnode_tpu_torch.train import multishoot_forward as MS
from py_psnode_tpu_torch.train.checkpoints import (
    load_checkpoint_params,
    resolve_checkpoint,
    save_params_npz,
)
from py_psnode_tpu_torch.train.optim import (
    make_optimizer,
    reference_grad_norm,
    robust_scalar_guard,
    zero_nonfinite_grads,
)
from py_psnode_tpu_torch.train.variants import Variant, dataset_dims, get_variant
from py_psnode_tpu_torch.utils.batching import pad_batch
from py_psnode_tpu_torch.utils.device import resolve_device
from py_psnode_tpu_torch.utils.logging import Logger
from py_psnode_tpu_torch.utils.profiling import JsonlMetrics

# per variant kind: the evaluation and the end-of-training summary
_EVALUATE = {
    "dae": (E.evaluate_dae, E.output_training_process_dae),
    "ode": (E.evaluate_ode, E.output_training_process_ode),
}


@dataclasses.dataclass
class TrainConfig:
    """The ported fields of the JAX package's ``TrainConfig``, same names
    and defaults (``device`` is the port's own)."""

    variant: str
    train_data: str = ""
    test_data: str = ""
    model: str = "saved_models/test"
    num: int = 3200
    batch: int = 64
    hidden: int = 128
    epoch: int = 400
    # stop after this many epochs, keeping the full ``epoch`` lr schedule
    stop_after: Optional[int] = None
    # initialize from this checkpoint (file or run directory) and train into
    # ``model`` with a fresh optimizer, from epoch 1
    warm_start: Optional[str] = None
    step: int = 1001
    learning_rate: float = 5e-3
    sch_gamma: float = 0.7
    loss_record_iter: int = 10
    gradient_clip: Optional[float] = None  # opt-in pre-update per-tensor clip
    solver: str = "euler"
    drawing: bool = False
    seed: int = 0
    echo_logs: bool = True
    # contain_larger_than / show_larger_than filter; "variant" uses the
    # per-variant reference constant
    larger_than: object = "variant"
    # skip updates whose grads hold NaN/Inf (optax.apply_if_finite)
    skip_nonfinite: bool = False
    # the scalar robust-loss guard (optim.robust_scalar_guard), limit 1.0
    # unless robust_limit is set
    robust_loss: bool = False
    robust_limit: Optional[float] = None
    init_style: str = "lecun"  # "lecun" (flax default) | "torch"
    jsonl_metrics: bool = True  # train_metrics.jsonl beside the text logs
    # route the forward and backward of every ported variant through the
    # fused rollout (the CUDA kernels on the card)
    fused: bool = False
    # "default" | "bfloat16" | "float32" | "highest": with fused=True,
    # "bfloat16" selects the kernels' bf16 compute mode (kernels 1-4: streams
    # and 2-D weights rounded to bf16; kernels 5-6: the 2-D weights; float32
    # sums and gradients); everything else runs in float32 under every value
    matmul_precision: str = "default"
    # the channel-wise variants' per-channel matmul form: "einsum" or
    # "blockdiag" (models.funcs.PerChannelMLP)
    channel_impl: str = "einsum"
    # keep the training set on the device and gather batches by index
    device_data: bool = True
    device_data_max_bytes: int = 2 << 30
    # teacher forcing: the true previous state (input_true_x) and/or the
    # true lagged algebraic output (input_true_i, DAE only) feed each step
    input_true_x: bool = False
    input_true_i: bool = False
    # multiple shooting: K windows trained at once ((step-1) divisible by
    # K), the window-boundary continuity defects penalized by gap_weight
    n_windows: Optional[int] = None
    gap_weight: float = 1.0
    # fields of paths that are not ported yet; a non-default value raises
    n_devices: Optional[int] = None
    checkpointer: str = "npz"
    auto_resume: bool = False
    # "cuda", "cuda:N" or "cpu"; nothing falls back from cuda to cpu
    device: str = "cuda"


def _not_ported(cfg: TrainConfig):
    if cfg.n_devices is not None and cfg.n_devices > 1:
        return "data-parallel training (n_devices > 1)"
    if cfg.checkpointer != "npz":
        return f"the {cfg.checkpointer!r} checkpointer"
    if cfg.auto_resume:
        return "auto_resume"
    return None


def _check_precision(cfg: TrainConfig):
    """An unknown ``matmul_precision`` raises ``ValueError``."""
    is_bf16(cfg.matmul_precision)


def _check_teacher_forcing(cfg: TrainConfig, variant: Variant):
    """The JAX package's refusals of teacher forcing, its messages in its
    order (``Trainer._teacher_forced_forward``)."""
    if not (cfg.input_true_x or cfg.input_true_i):
        return
    if variant.kind == "ode" and cfg.input_true_i:
        raise ValueError(
            "input_true_i applies to DAE variants only (ODEs have no "
            "algebraic output)"
        )
    if variant.channel_wise:
        raise ValueError(
            "the channel-wise family defines no teacher forcing "
            "(ref neural_base.py has none for it)"
        )
    if cfg.n_windows:
        raise ValueError(
            "teacher forcing and multi-shooting are mutually exclusive "
            "(multi-shooting IS windowed teacher forcing)"
        )


# the fused teacher-forced forwards by (variant, input_true_x,
# input_true_i): the JAX package's dispatch matrix
_TF_FUSED = {
    ("ode_no_encode", True, False): TF.tf_parallel_ode_apply,
    ("ode_encode", True, False): TF.tf_parallel_ode_encode_apply,
    ("dae_no_encode", True, True): TF.tf_parallel_dae_apply,
    ("dae_no_encode", True, False): TF.fused_dae_tf_x_apply,
    ("dae_no_encode", False, True): TF.fused_dae_tf_i_apply,
    ("dae_encode", True, True): TF.tf_parallel_dae_encode_apply,
    ("dae_encode", True, False): TF.fused_dae_encode_tf_x_apply,
    ("dae_encode", False, True): TF.fused_dae_encode_tf_i_apply,
}
# those of them that run kernels 1-4 and take matmul_precision (the
# time-parallel ones run none)
_TF_KERNEL = {TF.fused_dae_tf_x_apply, TF.fused_dae_tf_i_apply, TF.fused_dae_encode_tf_x_apply,
              TF.fused_dae_encode_tf_i_apply}

# the fused multishoot forwards; the channel-wise ones run plain under
# either fused setting, as in the JAX package
_MS_FUSED = {
    "ode_no_encode": MS.fused_multishoot_ode_apply,
    "dae_no_encode": MS.fused_multishoot_dae_apply,
    "ode_encode": MS.fused_multishoot_ode_encode_apply,
    "dae_encode": MS.fused_multishoot_dae_encode_apply,
}
_MS_PLAIN = {
    "ode_no_encode": MS.multishoot_ode_apply,
    "dae_no_encode": MS.multishoot_dae_apply,
    "ode_encode": MS.multishoot_ode_encode_apply,
    "dae_encode": MS.multishoot_dae_encode_apply,
    "ode_channelwise": MS.multishoot_cw_ode_apply,
    "dae_channelwise": MS.multishoot_cw_dae_apply,
}


class Trainer:
    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.variant: Variant = get_variant(cfg.variant)
        _check_teacher_forcing(cfg, self.variant)
        _check_precision(cfg)
        missing = _not_ported(cfg)
        if missing:
            raise NotImplementedError(f"{missing} is not ported yet")
        self.device = resolve_device(cfg.device)
        self.larger_than = (
            self.variant.larger_than if cfg.larger_than == "variant" else cfg.larger_than
        )

    # ------------------------------------------------------------------ data

    def load_train_dataset(self):
        cfg = self.cfg
        cls = DaeSamples if self.variant.kind == "dae" else OdeSamples
        return cls.load(
            cfg.train_data, num_sample=cfg.num, cut_length=cfg.step,
            contain_larger_than=self.larger_than,
        )

    def load_test_dataset(self):
        """The DAE test set is cut to ``step``; the ODE test set runs at full
        length (ref script1:289)."""
        if self.variant.kind == "dae":
            return DaeSamples.load(self.cfg.test_data, cut_length=self.cfg.step)
        return OdeSamples.load(self.cfg.test_data)

    # ----------------------------------------------------------------- model

    def build_model(self, ds, init: bool = True):
        """The variant's module on the trainer's device, initialized in
        ``init_style`` from ``seed``; with ``init=False`` on the ``meta``
        device (no weights yet: a checkpoint fills it)."""
        cfg = self.cfg
        kw = dict(solver=cfg.solver, device=self.device if init else "meta")
        if self.variant.channel_wise:
            kw["channel_impl"] = cfg.channel_impl
        elif cfg.channel_impl != "einsum":
            raise ValueError("channel_impl applies to the channel-wise variants only")
        model = self.variant.make_model(dataset_dims(self.variant, ds), cfg.hidden, **kw)
        return init_params(model, cfg.init_style, cfg.seed) if init else model

    def _forward_fn(self, model):
        """The forward of training and of every evaluation (teacher-forced
        as well where a TF flag is set, as in the JAX package)."""
        cfg, variant = self.cfg, self.variant
        if cfg.input_true_x or cfg.input_true_i:
            return self._teacher_forced_forward(model)
        if cfg.fused:
            return lambda batch: variant.fused_apply(model, batch, solver=cfg.solver,
                                                     precision=cfg.matmul_precision)
        return lambda batch: model(*[batch.get(k) for k in variant.batch_args])

    def _teacher_forced_forward(self, model):
        """The fused route through the dispatch matrix ``_TF_FUSED``, else
        the model's plain rollout with the TF switches."""
        cfg, variant = self.cfg, self.variant
        tf_x, tf_i = cfg.input_true_x, cfg.input_true_i
        if cfg.fused:
            apply = _TF_FUSED[(variant.name, tf_x, tf_i)]
            kw = dict(precision=cfg.matmul_precision) if apply in _TF_KERNEL else {}
            return lambda batch: apply(model, batch, solver=cfg.solver, **kw)
        kwargs = {"input_true_x": tf_x}
        if variant.kind == "dae":
            kwargs["input_true_i"] = tf_i
        return lambda batch: model(*[batch.get(k) for k in variant.batch_args], **kwargs)

    def _multishoot_forward(self, model):
        """The training forward under ``n_windows``: ``batch -> (out,
        gaps)`` by the JAX package's dispatch."""
        cfg, name = self.cfg, self.variant.name
        fused = (_MS_FUSED if cfg.fused else {}).get(name)
        if fused is not None:
            return lambda batch: fused(model, batch, cfg.n_windows, solver=cfg.solver,
                                       precision=cfg.matmul_precision)
        apply = _MS_PLAIN.get(name)
        if apply is None:
            raise ValueError(f"multi-shooting has no forward for variant {name}")
        return lambda batch: apply(model, batch, cfg.n_windows, solver=cfg.solver)

    # ------------------------------------------------------------ train step

    def _make_train_step(self, model, opt, device_data=None):
        """One update: forward, loss (guarded when ``robust_loss``),
        backward, the logged gradient norm, the optimizer step. Returns
        ``step(batch)``, or ``step(idx, sample_w)`` that gathers the batch
        from ``device_data``; each returns ``(aux, grad_norm)`` as device
        scalars."""
        cfg, variant = self.cfg, self.variant
        params = opt.params
        robust_limit = 1.0 if cfg.robust_limit is None else float(cfg.robust_limit)
        if cfg.n_windows:
            ms_forward = self._multishoot_forward(model)

            def loss_of(batch):
                out, gaps = ms_forward(batch)
                loss, aux = variant.loss_fn(out, batch)
                gap_loss = cfg.gap_weight * torch.mean(gaps**2) if gaps.shape[0] else loss.new_zeros(())
                return loss + gap_loss, dict(aux, gap_loss=gap_loss, loss=aux["loss"] + gap_loss)

        else:
            forward = self._forward_fn(model)

            def loss_of(batch):
                return variant.loss_fn(forward(batch), batch)

        def step(batch):
            for p in params:
                p.grad = None
            loss, aux = loss_of(batch)
            if cfg.robust_loss:
                loss, tripped = robust_scalar_guard(loss, robust_limit)
                aux = dict(aux, robust_tripped=tripped.float())
            loss.backward()
            grads = []
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            if cfg.robust_loss:
                # a forward NaN reaches the grads as 0 * NaN through the
                # guard's where(); it must not poison Adam's moments
                zero_nonfinite_grads(grads)
            gnorm = reference_grad_norm(grads)
            # Zero-loss freeze (stronger than the reference, as in the JAX
            # package): when loss == 0 the parameters keep their values,
            # while the optimizer state still advances.
            keep = loss.detach() != 0.0
            old = [p.detach().clone() for p in params]
            opt.step()
            with torch.no_grad():
                for p, o in zip(params, old):
                    p.copy_(torch.where(keep, p, o))
            return {k: v.detach() for k, v in aux.items()}, gnorm

        if device_data is None:
            return step

        def step_idx(idx, sample_w):
            batch = {k: v[idx] for k, v in device_data.items()}
            batch["sample_w"] = sample_w
            # padded rows repeat the last real index; zero their mask so
            # that masked loss terms match the host path's pad_batch
            batch["mask"] = batch["mask"] * sample_w[:, None, None]
            return step(batch)

        return step_idx

    def _eval_batch_size(self, test_ds):
        """Reference eval-batch rule (N/10); small sets run as one batch. A
        variant with ``eval_batch_capped`` (the DAE channel-wise readout
        holds ``[T, b, h, h]`` activations) evaluates at most the training
        batch at once."""
        n = len(test_ds)
        b = n if n <= 512 else max(int(n / 10), 1)
        return min(b, self.cfg.batch) if self.variant.eval_batch_capped else b

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
                    out = forward(batch)
                    # a DAE gives (x, i[, x_re[, i_re]]); an ODE x or (x, x_re)
                    if variant.kind == "dae":
                        x_pred, i_pred = out[0], out[1]
                    else:
                        x_pred, i_pred = (out[0] if isinstance(out, tuple) else out), None
                    mask = batch["mask"]
                    res = {"x_loss_ps": torch.sum((x_pred - batch["x"]) ** 2 * mask, dim=1)}
                    if i_pred is not None:
                        res["i_loss_ps"] = torch.sum((i_pred - batch["i"]) ** 2 * mask, dim=1)
                if want_preds:
                    res["x_pred"] = x_pred
                    if i_pred is not None:
                        res["i_pred"] = i_pred
                return res

            return call

        return apply_fn_factory

    def _prep_batch(self, batch, pad_to):
        n_real = batch["t"].shape[0]
        batch = pad_batch(batch, pad_to)
        batch["sample_w"] = (np.arange(batch["t"].shape[0]) < n_real).astype(np.float32)
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    # ------------------------------------------------------------------ train

    def train(self):
        """--training mode (ref :282-405). Returns ``(model, model_path)``."""
        cfg, variant = self.cfg, self.variant
        train_ds = self.load_train_dataset()
        test_ds = self.load_test_dataset()
        eval_batch = self._eval_batch_size(test_ds)
        model = self.build_model(train_ds)
        dims = dataset_dims(variant, train_ds)
        steps_per_epoch = -(-len(train_ds) // cfg.batch)

        # --model <existing checkpoint file> resumes into <name>_branch/
        # (ref :297-305); --warm_start initializes without the branch dir
        model_path = pathlib.Path(cfg.model)
        is_ckpt_dir = model_path.is_dir() and re.fullmatch(r"model_checkpoint\.\d+", model_path.name)
        if model_path.exists() and (not model_path.is_dir() or is_ckpt_dir):
            load_params(model, load_checkpoint_params(model_path), device=self.device)
            model_path = model_path.parent / (model_path.name + "_branch")
        elif cfg.warm_start:
            ws = resolve_checkpoint(pathlib.Path(cfg.warm_start))
            load_params(model, load_checkpoint_params(ws), device=self.device)
        opt = make_optimizer(
            model.parameters(), cfg.learning_rate, cfg.epoch, steps_per_epoch,
            cfg.sch_gamma, cfg.gradient_clip, skip_nonfinite=cfg.skip_nonfinite,
        )
        model_path.mkdir(parents=True, exist_ok=True)

        logger = Logger(model_path, "training.log", "testing.log", echo=cfg.echo_logs)
        metrics = JsonlMetrics(model_path / "train_metrics.jsonl") if cfg.jsonl_metrics else None
        logger.training_log(
            f"training_data: {cfg.train_data}, testing_data: {cfg.test_data}, "
            f"train_size: {cfg.num}, batch_size: {cfg.batch}, "
            f"hidden_dim: {cfg.hidden}, epoch: {cfg.epoch}, "
            f"cut_length: {cfg.step}, learning_rate: {cfg.learning_rate}"
        )

        data_keys = variant.batch_args + ("mask",)
        n_bytes = sum(getattr(train_ds, k).nbytes for k in data_keys)
        use_device_data = cfg.device_data and n_bytes <= cfg.device_data_max_bytes
        device_data = None
        if use_device_data:
            device_data = {
                k: torch.as_tensor(getattr(train_ds, k), device=self.device) for k in data_keys
            }
        train_step = self._make_train_step(model, opt, device_data=device_data)
        apply_fn_factory = self._make_eval_apply(model, test_ds)
        pic_path = model_path / "pics" if cfg.drawing else None
        eval_fn, summarize = _EVALUATE[variant.kind]

        def evaluate(desc):
            return eval_fn(
                apply_fn_factory(want_preds=bool(cfg.drawing)), test_ds, eval_batch, logger,
                desc=desc, pic_path=pic_path, show_larger_than=self.larger_than,
            )

        train_error_list, eval_error_list = [], []
        nrec = cfg.loss_record_iter
        log_keys = variant.loss_keys + (("robust_tripped",) if cfg.robust_loss else ())
        records = {k: np.zeros(nrec) for k in log_keys}
        grad_record = np.zeros(nrec)

        logger.testing_log("=" * 86)
        logger.testing_log("Initial evaluate on testing set.")
        eval_error_list.append(evaluate("Testing_Epoch_0"))
        logger.testing_log("=" * 86)
        logger.training_log(f"Start training {variant.name} model")
        logger.training_log("=" * 86)

        last_epoch = cfg.epoch
        if cfg.stop_after is not None:
            last_epoch = min(last_epoch, int(cfg.stop_after))

        def epoch_steps(epoch):
            """Per-batch train_step argument tuples of this epoch."""
            if use_device_data:
                order = np.random.default_rng(cfg.seed + epoch).permutation(len(train_ds))
                for s in range(0, len(order), cfg.batch):
                    idx = order[s : s + cfg.batch]
                    n_real = len(idx)
                    if n_real < cfg.batch:
                        idx = np.concatenate([idx, np.repeat(idx[-1:], cfg.batch - n_real)])
                    w = (np.arange(cfg.batch) < n_real).astype(np.float32)
                    yield (torch.as_tensor(idx, device=self.device),
                           torch.as_tensor(w, device=self.device))
            else:
                for batch in train_ds.batches(cfg.batch, shuffle=True, seed=cfg.seed + epoch):
                    yield (self._prep_batch(batch, cfg.batch),)

        def emit_window(epoch, i_b, window):
            # one host read for the whole window
            vals = torch.stack(
                [a[k].float() for _, a, _ in window for k in log_keys]
                + [g.float() for _, _, g in window]
            ).cpu().numpy()
            nk = len(log_keys)
            for row, (j, _, _) in enumerate(window):
                for ki, k in enumerate(log_keys):
                    records[k][j % nrec] = vals[row * nk + ki]
                grad_record[j % nrec] = vals[len(window) * nk + row]
            means = {k: records[k].mean() for k in log_keys}
            parts = ", ".join(f"{k}: {means[k]:14.10f}" for k in log_keys)
            logger.training_log(
                f"Training epoch {epoch}: Batch{i_b + 1 - nrec:4} to {i_b + 1:4}: {parts}, "
                f"gradient_norm: {grad_record.mean():14.10f}."
            )
            train_error_list.append([means[k] for k in variant.loss_keys])
            if metrics is not None:
                metrics.log(kind="train", epoch=epoch, batch=i_b + 1,
                            grad_norm=float(grad_record.mean()),
                            **{k: float(v) for k, v in means.items()})

        for epoch in range(1, last_epoch + 1):
            t_phase = time.perf_counter()
            pending = []
            for i_batch, step_args in enumerate(epoch_steps(epoch)):
                aux, gnorm = train_step(*step_args)
                pending.append((i_batch, aux, gnorm))
                if (i_batch + 1) % nrec == 0:
                    emit_window(epoch, i_batch, pending)
                    pending = []
            logger.training_log("-" * 86)
            t_steps, t_phase = time.perf_counter() - t_phase, time.perf_counter()

            save_params_npz(model_path / f"model_checkpoint.{epoch}", model)
            t_ckpt, t_phase = time.perf_counter() - t_phase, time.perf_counter()
            logger.testing_log("=" * 86)
            logger.testing_log(f"Training Epoch {epoch}, evaluate on testing set.")
            eval_error_list.append(evaluate(f"Testing_Epoch_{epoch}"))
            logger.testing_log("=" * 86)
            t_eval, t_phase = time.perf_counter() - t_phase, time.perf_counter()
            np.savez(
                str(model_path / "train_and_eval.npz"),
                train=np.array(train_error_list, dtype=object),
                eval=np.array(eval_error_list, dtype=object),
            )
            if metrics is not None:
                ev = eval_error_list[-1]
                rec = {"kind": "eval", "epoch": epoch, "x_loss": float(ev[0])}
                if variant.kind == "dae":
                    rec["i_loss"] = float(ev[1])
                metrics.log(**rec)
            # the run's first export rewrites the .pt2 programs: a directory
            # reused at other widths keeps the earlier run's
            variant.export_fn(model, dims, model_path / "saved model", epoch == 1)
            if metrics is not None:
                # export_s includes the train_and_eval.npz rewrite
                metrics.log(
                    kind="epoch_time", epoch=epoch,
                    steps_s=round(t_steps, 4), ckpt_s=round(t_ckpt, 4),
                    eval_s=round(t_eval, 4),
                    export_s=round(time.perf_counter() - t_phase, 4),
                )

        variant.export_fn(model, dims, model_path / "saved model", last_epoch < 1)
        summarize(logger, eval_error_list)
        logger.close()
        if metrics is not None:
            metrics.close()
        return model, model_path

    # ------------------------------------------------------------------- test

    def test(self):
        """--testing mode (ref :406-433): load checkpoint file, evaluate."""
        cfg = self.cfg
        test_ds = self.load_test_dataset()
        eval_batch = self._eval_batch_size(test_ds)
        model = self.build_model(test_ds, init=False)
        # a run DIRECTORY resolves to its best-eval epoch (early-stop restore)
        model_path = resolve_checkpoint(pathlib.Path(cfg.model))
        load_params(model, load_checkpoint_params(model_path), device=self.device)
        model.requires_grad_(False).eval()
        pic_path = model_path.parent / "pics" if cfg.drawing else None
        logger = Logger(
            model_path.parent,
            test_log_name=f"Model_{model_path.name}_Evaluation.log",
            echo=cfg.echo_logs,
        )
        logger.testing_log(f"Model {model_path} Evaluation")
        logger.testing_log(f"Use testing data: {cfg.test_data}")
        logger.testing_log("=" * 86)
        eval_fn, _ = _EVALUATE[self.variant.kind]
        result = eval_fn(
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

    # ------------------------------------------------------------------- save

    def save(self):
        """--saving mode (ref :434-450): load the checkpoint ``model`` (a run
        directory resolves to its best-eval epoch) and export it into
        ``saved model/`` beside it; returns that directory."""
        test_ds = self.load_test_dataset()
        model = self.build_model(test_ds, init=False)
        model_path = resolve_checkpoint(pathlib.Path(self.cfg.model))
        load_params(model, load_checkpoint_params(model_path), device=self.device)
        out = model_path.parent / "saved model"
        self.variant.export_fn(model, dataset_dims(self.variant, test_ds), out, True)
        return out
