"""ODE and DAE sample datasets over the PSOPS ``.npz`` trajectory schema
(numpy copy of ``py_psnode_tpu/data/schema.py``), and the ODE file writer.

Schema:

  * ``t [N, T, 1]`` time grids; a ``-1`` sentinel marks early-terminated
    trajectories (padding)
  * ``x [N, T, x_dim]`` differential states, ``z [N, T, z_dim]`` exogenous
    inputs, ``v [N, T, v_dim]`` / ``i [N, T, i_dim]`` algebraic input/output
  * ``event_t [N, E]`` disturbance times, ``z_jump [N, E, z_dim]`` and
    ``v_jump [N, E, v_dim]`` post-jump input values
  * ``mask [N, T, *]`` loss mask (ODE: optional, ones where absent)
  * ``name`` per-channel ``(label, unit)`` pairs for plot titles

Behaviours kept from the reference: seeded ``default_rng(42)`` subsampling
of ``num_sample`` rows, ``cut_length`` truncation of the time axis, and the
``contain_larger_than`` redraw, capped at ``_MAX_REDRAWS`` draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

_MAX_REDRAWS = 1000


def _subsample(rng, total_num, num_sample, x, contain_larger_than):
    for _ in range(_MAX_REDRAWS):
        index = np.arange(total_num)
        if num_sample is not None:
            index = rng.choice(index, num_sample, replace=False)
        if contain_larger_than is None or np.any(x[index] > contain_larger_than):
            return index
    raise ValueError(
        f"no draw of {num_sample} samples contains x > {contain_larger_than}"
    )


@dataclasses.dataclass
class _SamplesBase:
    data_name: np.ndarray

    def __len__(self):
        return self.t.shape[0]

    @property
    def n_steps(self):
        return self.t.shape[1]

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield batch dicts of host numpy arrays."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, n, batch_size):
            idx = order[s : s + batch_size]
            if drop_remainder and len(idx) < batch_size:
                return
            yield {k: getattr(self, k)[idx] for k in self._batch_keys}


@dataclasses.dataclass
class OdeSamples(_SamplesBase):
    """ODE trajectory dataset (ref ODE_Curves_Sample, neural_base.py:10-40)."""

    t: np.ndarray
    x: np.ndarray
    z: np.ndarray
    event_t: np.ndarray
    z_jump: np.ndarray
    mask: np.ndarray

    _batch_keys = ("t", "x", "z", "event_t", "z_jump", "mask")

    @classmethod
    def load(
        cls,
        data_path: str,
        num_sample: Optional[int] = None,
        cut_length: Optional[int] = None,
        contain_larger_than: Optional[float] = None,
        seed: int = 42,
        dtype=np.float32,
    ) -> "OdeSamples":
        rng = np.random.default_rng(seed)
        with np.load(data_path, allow_pickle=True) as f:
            total_num = f["t"].shape[0]
            index = _subsample(rng, total_num, num_sample, f["x"], contain_larger_than)
            fin = f["t"].shape[1] if cut_length is None else min(cut_length, f["t"].shape[1])
            cut = lambda k: f[k][index][:, :fin].astype(dtype)
            x = cut("x")
            return cls(
                data_name=f["name"],
                t=cut("t"),
                x=x,
                z=cut("z"),
                event_t=f["event_t"][index].astype(dtype),
                z_jump=f["z_jump"][index].astype(dtype),
                mask=cut("mask") if "mask" in f.files else np.ones_like(x),
            )


@dataclasses.dataclass
class DaeSamples(_SamplesBase):
    """DAE trajectory dataset (ref DAE_Curves_Sample, neural_base.py:136-166)."""

    t: np.ndarray
    x: np.ndarray
    z: np.ndarray
    v: np.ndarray
    i: np.ndarray
    event_t: np.ndarray
    z_jump: np.ndarray
    v_jump: np.ndarray
    mask: np.ndarray

    _batch_keys = ("t", "x", "z", "v", "i", "event_t", "z_jump", "v_jump", "mask")

    @classmethod
    def load(
        cls,
        data_path: str,
        num_sample: Optional[int] = None,
        cut_length: Optional[int] = None,
        contain_larger_than: Optional[float] = None,
        seed: int = 42,
        dtype=np.float32,
    ) -> "DaeSamples":
        rng = np.random.default_rng(seed)
        with np.load(data_path, allow_pickle=True) as f:
            total_num = f["t"].shape[0]
            index = _subsample(rng, total_num, num_sample, f["x"], contain_larger_than)
            fin = f["t"].shape[1] if cut_length is None else min(cut_length, f["t"].shape[1])
            cut = lambda k: f[k][index][:, :fin].astype(dtype)
            return cls(
                data_name=f["name"],
                t=cut("t"),
                x=cut("x"),
                z=cut("z"),
                v=cut("v"),
                i=cut("i"),
                event_t=f["event_t"][index].astype(dtype),
                z_jump=f["z_jump"][index].astype(dtype),
                v_jump=f["v_jump"][index].astype(dtype),
                mask=cut("mask"),
            )


def save_ode_samples(path, *, t, x, z, event_t, z_jump, mask=None, name=None):
    """Write an ODE sample file in the reference ``.npz`` schema."""
    arrays = dict(t=t, x=x, z=z, event_t=event_t, z_jump=z_jump)
    if mask is not None:
        arrays["mask"] = mask
    arrays["name"] = _names_array(name, x.shape[-1])
    np.savez(path, **arrays)


def _names_array(name: Optional[Sequence], n_channels: int) -> np.ndarray:
    if name is None:
        name = [(f"ch{k}", "p.u.") for k in range(n_channels)]
    return np.array(list(name), dtype=object)
