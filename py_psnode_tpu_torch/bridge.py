"""Weight bridge: flax parameter trees and ``model_checkpoint.N`` npz files
into the port's modules, and back to the flax layout.

A checkpoint npz (``py_psnode_tpu/export/artifacts.py:72-74``) holds flat
keys such as ``params/de_func/x_dot/dense_0/kernel``. The port's modules
keep the flax names, so that key maps to the state-dict entry
``de_func.x_dot.dense_0.weight``. Flax stores a dense kernel as
``[in, out]`` and torch's ``Linear.weight`` is ``[out, in]``: the bridge
transposes. The stacked weights of a per-channel net (``.../w_k [C, d_in,
f]`` and ``.../b_k [C, f]``, ``PerChannelMLP``) keep their layout and name
both ways. Orbax checkpoint directories are not supported by the port yet.
"""

from __future__ import annotations

import pathlib
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_ORBAX_DIR = re.compile(r"model_checkpoint\.\d+")
_STACKED = re.compile(r"[wb]_\d+")  # PerChannelMLP's w_k [C, d_in, f] and b_k [C, f]


def unflatten_params(flat: Mapping[str, np.ndarray]) -> Dict:
    """``{"a/b/c": arr}`` → nested ``{"a": {"b": {"c": arr}}}``."""
    tree: Dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict → ``{"a/b/c": leaf}``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_params(v, key))
        else:
            out[key] = v
    return out


def load_params_npz(path) -> Dict:
    """Read a flat ``params/...`` npz checkpoint into a nested dict of
    numpy arrays. Raises for an orbax checkpoint directory."""
    path = pathlib.Path(path)
    if path.is_dir():
        kind = "an orbax checkpoint directory" if _ORBAX_DIR.fullmatch(path.name) else "a directory"
        raise ValueError(
            f"{path} is {kind}; the port reads npz checkpoints "
            "(model_checkpoint.<epoch> files) only, orbax checkpoints are "
            "not ported yet"
        )
    with np.load(path) as f:
        return unflatten_params({k: f[k] for k in f.files})


def state_dict_from_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax-layout tree (with or without the top ``"params"`` level) →
    torch state dict: ``kernel [in, out]`` becomes ``weight [out, in]``;
    per-channel stacks ``w_k``/``b_k`` pass through unchanged."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    sd = {}
    for key, arr in flatten_params(params).items():
        *path, leaf = key.split("/")
        t = torch.tensor(np.asarray(arr))  # a copy: npz arrays may be read-only
        if leaf == "kernel":
            sd[".".join(path + ["weight"])] = t.t().contiguous()
        elif leaf == "bias" or _STACKED.fullmatch(leaf):
            sd[".".join(path + [leaf])] = t
        else:
            raise ValueError(
                f"unexpected parameter {key!r} (want .../kernel, .../bias, .../w_k or .../b_k)"
            )
    return sd


def load_params(module: nn.Module, params: Mapping, device=None) -> nn.Module:
    """Copy a flax-layout tree into ``module`` (strict: every parameter must
    be present and no extra one). A module built on the ``meta`` device is
    materialized on ``device`` first."""
    if device is not None or any(p.is_meta for p in module.parameters()):
        module.to_empty(device=device or "cpu")
    module.load_state_dict(state_dict_from_params(params), strict=True)
    return module


def flax_params(module: nn.Module) -> Dict:
    """The module's weights as a nested flax-layout dict of tensors
    (``kernel [in, out]`` contiguous, ``bias``, per-channel ``w_k``/``b_k``
    as they are), without the top ``"params"`` level. Kernels are copies;
    biases and stacks are the parameters."""
    flat = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        if leaf == "weight":
            flat["/".join(path + ["kernel"])] = p.t().contiguous()
        else:
            flat["/".join(path + [leaf])] = p
    return unflatten_params(flat)
