"""Carry a JAX parameter tree across into the port.

``params_from_jax(cfg, tree)`` takes the JAX ``DecoderLM`` parameters as
numpy arrays — ``jax.tree.map(np.asarray, model.init(key))`` — and returns
the port's state dict (CPU tensors, same dtypes), ready for
``DecoderLM.load_state_dict``, so both packages compute the same function.
The stacked ``(L, ...)`` leaves keep their layout; only the nesting becomes
dotted names (``layers.attn.wq``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import build_model
from repro_torch.models.common import flatten_tree


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: no torch.from_numpy
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_jax(cfg: ModelConfig, params_np: dict) -> dict[str, torch.Tensor]:
    """JAX ``DecoderLM`` parameter tree (numpy leaves) -> the port's state
    dict. Raises when the names or shapes differ from the port's specs."""
    specs = flatten_tree(build_model(cfg, device="meta").param_specs())
    flat = flatten_tree(params_np)
    if set(flat) != set(specs):
        raise ValueError(f"parameter names differ: only in JAX tree "
                         f"{sorted(set(flat) - set(specs))}, only in port "
                         f"{sorted(set(specs) - set(flat))}")
    state = {}
    for name, spec in specs.items():
        t = _to_tensor(flat[name])
        if tuple(t.shape) != spec.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {spec.shape}")
        state[name] = t
    return state
