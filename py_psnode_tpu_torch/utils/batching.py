"""Batch padding (counterpart of ``py_psnode_tpu.parallel.mesh.pad_batch``,
copied without the device mesh)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def pad_batch(batch: Dict[str, np.ndarray], multiple: int) -> Dict[str, np.ndarray]:
    """Pad the batch axis to a multiple by repeating the last row with a
    zeroed mask, so shapes stay static and padded rows contribute nothing
    to masked losses."""
    n = next(iter(batch.values())).shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch
    out = {}
    for k, v in batch.items():
        tail = np.repeat(v[-1:], pad, axis=0)
        if k == "mask":
            tail = np.zeros_like(tail)
        out[k] = np.concatenate([v, tail], axis=0)
    return out
