"""Carry a JAX parameter tree across into the port.

``params_from_jax(cfg, tree)`` takes the JAX ``DecoderLM`` or ``EncDecLM``
parameters as numpy arrays — ``jax.tree.map(np.asarray, model.init(key))``
— and returns the port's state dict (CPU tensors, same dtypes), ready for
the port model's ``load_state_dict``, so both packages compute the same
function. The stacked ``(L, ...)`` leaves keep their layout; only the
nesting becomes dotted names (``layers.attn.wq``, ``decoder.xattn.wq``,
the moe family's ``layers.moe.router`` and ``layers.moe.w_gate`` (L, E,
D, F), the vlm family's unstacked ``vision_proj``).

``train_state_from_jax(cfg, state)`` carries a whole JAX train state
``{"params", "opt": {"m", "v"}, "step"}`` (numpy leaves) across into the
port's train-state tree (``train/step.py``): the parameters and both
moment trees through the same name and shape checks, nested again like
the JAX tree, and the step as an int32 scalar.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import build_model
from repro_torch.models.common import flatten_tree, unflatten_tree


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: no torch.from_numpy
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_jax(cfg: ModelConfig, params_np: dict) -> dict[str, torch.Tensor]:
    """JAX ``DecoderLM`` or ``EncDecLM`` parameter tree (numpy leaves) ->
    the port's state dict. Raises when the names or shapes differ from the port's specs."""
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


def train_state_from_jax(cfg: ModelConfig, state_np: dict) -> dict:
    """JAX train state (numpy leaves) -> the port's train state (CPU
    tensors, same dtypes, the JAX tree's nesting)."""
    tree = lambda t: unflatten_tree(params_from_jax(cfg, t))  # noqa: E731
    return {"params": tree(state_np["params"]),
            "opt": {k: tree(state_np["opt"][k]) for k in ("m", "v")},
            "step": torch.tensor(int(np.asarray(state_np["step"])),
                                 dtype=torch.int32)}
