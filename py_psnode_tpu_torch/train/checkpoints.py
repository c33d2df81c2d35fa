"""Checkpoint discovery and loading (counterpart of
``py_psnode_tpu/train/checkpoints.py:21-104``).

The port reads the single-file npz snapshots ``model_checkpoint.{epoch}``;
orbax checkpoint directories are not ported yet.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np

from py_psnode_tpu_torch.bridge import load_params_npz


def list_checkpoints(model_dir):
    """All ``model_checkpoint.{epoch}`` entries as ``(epoch, path)``,
    newest first."""
    model_dir = pathlib.Path(model_dir)
    if not model_dir.exists():
        return []
    found = []
    for p in model_dir.iterdir():
        m = re.fullmatch(r"model_checkpoint\.(\d+)", p.name)
        if m:
            found.append((int(m.group(1)), p))
    return sorted(found, reverse=True)


def best_checkpoint(model_dir):
    """The saved checkpoint with the lowest finite eval x-loss, read from the
    run's ``train_and_eval.npz`` history (eval row ``r`` follows
    ``model_checkpoint.r``; row 0 is the pre-training eval). Returns
    ``(epoch, path, eval_x)`` or None."""
    model_dir = pathlib.Path(model_dir)
    hist_f = model_dir / "train_and_eval.npz"
    saved = dict(list_checkpoints(model_dir))
    if not hist_f.exists() or not saved:
        return None
    with np.load(hist_f, allow_pickle=True) as hist:
        evals = hist["eval"]
    best = None
    for row, e in enumerate(evals):
        if row == 0 or row not in saved:
            continue
        x = float(np.asarray(e[0], np.float64))
        if np.isfinite(x) and (best is None or x < best[2]):
            best = (row, saved[row], x)
    return best


def resolve_checkpoint(path) -> pathlib.Path:
    """A ``model_checkpoint.{epoch}`` path passes through; a run directory
    resolves to its best-eval checkpoint."""
    path = pathlib.Path(path)
    if not path.is_dir() or re.fullmatch(r"model_checkpoint\.\d+", path.name):
        return path
    best = best_checkpoint(path)
    if best is None:
        raise FileNotFoundError(
            f"{path} is a directory but holds no (train_and_eval.npz + "
            "model_checkpoint.<epoch>) pair with a finite eval — point "
            "--model at a checkpoint file or a completed run dir"
        )
    epoch, ckpt, eval_x = best
    print(
        f"--model {path}: selected best-eval checkpoint epoch {epoch} "
        f"(eval x_loss {eval_x:.6g}) -> {ckpt}",
        flush=True,
    )
    return ckpt


def load_checkpoint_params(path):
    """Model params of an npz checkpoint as a nested dict of numpy arrays
    (``{"params": {...}}``, flax layout)."""
    path = pathlib.Path(path)
    if not path.exists():
        raise FileNotFoundError(f"{path} does not exist!")
    return load_params_npz(path)
