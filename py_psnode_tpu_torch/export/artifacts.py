"""Trained-submodule export for embedding into external simulators
(counterpart of ``py_psnode_tpu/export/artifacts.py``).

Per submodule, into the ``saved model/`` directory:

  * ``<name>.pt2``          — ``torch.export`` program of the submodule with
    its weights as an *input*: a flat ``{path: array}`` dict in the flax
    layout (``.../kernel [in, out]``, ``.../bias``, per-channel ``w_k`` /
    ``b_k``), the keys of ``<name>.weights.npz``, followed by the
    submodule's own arguments at batch 1. It takes the JAX package's
    ``<name>.stablehlo`` role. Its shapes are those of one run's weights:
    the first export of a run writes it (``write_program``), later ones
    only where it is missing. Traced on the CPU from CPU copies. Load it
    with ``torch.export.load(path).module()(weights, *args)``.
  * ``<name>.weights.npz``  — flat ``{path: array}`` parameter snapshot,
    the JAX package's keys and arrays
  * ``<name>.weights.bin``  — dependency-free flat binary
    (:mod:`py_psnode_tpu_torch.export.binfmt`) for the C++ mini-runtime,
    byte-identical to the JAX package's for the same weights
  * ``dim.txt``             — hidden-size sidecar (the channel-wise family)

The trees here are the port's flax-layout trees
(:func:`py_psnode_tpu_torch.bridge.flax_params`), tensors or arrays.
Nothing on this path is best-effort: a failure raises.
"""

from __future__ import annotations

import copy
import pathlib
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from py_psnode_tpu_torch.bridge import flatten_params as _flatten_tree
from py_psnode_tpu_torch.export.binfmt import write_weights_bin


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a)


def flatten_params(params: Mapping) -> Dict[str, np.ndarray]:
    """A flax-layout tree as ``{"a/b/kernel": array}`` (float32 numpy on the
    host), the JAX package's ``flatten_params``."""
    return {k: _numpy(v) for k, v in _flatten_tree(params).items()}


def flatten_channelwise(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A channel-wise subtree flattened for the flat-bin runtime, as the JAX
    package's ``flatten_channelwise`` does: each ``PerChannelMLP`` stack
    (``w_k [C, in, out]``, ``b_k [C, out]``) sliced into C nets named
    ``<sub>/c<channel>/dense_<k>/{kernel,bias}``; the plain nets pass
    through. Only the ``.bin`` uses the sliced naming."""
    out = {}
    if not isinstance(params, Mapping):
        out[prefix[:-1]] = _numpy(params)
        return out
    stacked = sorted((k for k in params if k.startswith("w_")), key=lambda k: int(k[2:]))
    if stacked and all(f"b_{k[2:]}" in params for k in stacked):
        extras = set(params) - set(stacked) - {f"b_{k[2:]}" for k in stacked}
        if extras:
            raise ValueError(
                f"PerChannelMLP subtree {prefix!r} mixes stacked layers with "
                f"other entries {sorted(extras)}; cannot slice safely"
            )
        ws = [_numpy(params[k]) for k in stacked]
        bs = [_numpy(params[f"b_{k[2:]}"]) for k in stacked]
        for c in range(ws[0].shape[0]):
            for li in range(len(stacked)):
                out[f"{prefix}c{c}/dense_{li}/kernel"] = ws[li][c]
                out[f"{prefix}c{c}/dense_{li}/bias"] = bs[li][c]
        return out
    for k, v in params.items():
        out.update(flatten_channelwise(v, f"{prefix}{k}/"))
    return out


def state_dict_of(flat: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Flax-layout flat weights as the module's state dict: ``a/b/kernel
    [in, out]`` becomes ``a.b.weight [out, in]``; biases and per-channel
    stacks keep their layout."""
    sd = {}
    for key, w in flat.items():
        *path, leaf = key.split("/")
        if leaf == "kernel":
            sd[".".join(path + ["weight"])] = w.t()
        else:
            sd[".".join(path + [leaf])] = w
    return sd


class _WeightsAsInput(nn.Module):
    """``module(*args)`` with its weights given as a flat flax-layout dict
    (the program ``<name>.pt2`` holds)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, weights: Dict[str, torch.Tensor], *args):
        return torch.func.functional_call(self.module, state_dict_of(weights), args)


def export_program(path, module: nn.Module, flat: Mapping[str, np.ndarray], example_args: Sequence):
    """Write ``torch.export`` of ``module`` with its weights as an input
    (:class:`_WeightsAsInput`) at ``example_args`` (numpy or tensors) to
    ``path``, traced on the CPU from CPU copies."""
    cpu = copy.deepcopy(module).to("cpu")
    weights = {k: torch.tensor(v) for k, v in flat.items()}
    args = tuple(torch.as_tensor(a, dtype=torch.float32) for a in example_args)
    program = torch.export.export(_WeightsAsInput(cpu), (weights, *args))
    # torch.export.save warns of a name that does not end in .pt2
    tmp = pathlib.Path(path).with_name(pathlib.Path(path).stem + ".tmp.pt2")
    torch.export.save(program, tmp)
    tmp.replace(path)


def export_submodule(path, name: str, module: nn.Module, sub_params: Mapping, example_args: Sequence,
                     write_program: bool, bin_flat: Optional[Mapping] = None):
    """Write the artifacts of one submodule: ``module`` holds the trained
    weights, ``sub_params`` is its flax-layout tree. The weight snapshots
    are always rewritten; ``<name>.pt2`` where ``write_program`` or where
    it is missing. ``bin_flat``, where given, is what the ``.bin`` holds in
    place of the npz's flat weights (the channel-wise family's
    :func:`flatten_channelwise`)."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = flatten_params(sub_params)
    program = path / f"{name}.pt2"
    if write_program or not program.exists():
        export_program(program, module, flat, example_args)
    np.savez(path / f"{name}.weights.npz", **flat)
    write_weights_bin(path / f"{name}.weights.bin", flat if bin_flat is None else bin_flat)


def write_dim_txt(path, hidden_dim: int):
    pathlib.Path(path).mkdir(parents=True, exist_ok=True)
    (pathlib.Path(path) / "dim.txt").write_text(str(hidden_dim))
