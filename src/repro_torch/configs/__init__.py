"""Registry of the 10 assigned architectures (+ shape suite)."""

from __future__ import annotations

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_supported,
    describe,
    reduced,
)

from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3
from repro_torch.configs.phi3_medium_14b import CONFIG as _phi3
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.llama3_8b import CONFIG as _llama3
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.internvl2_26b import CONFIG as _internvl2
from repro_torch.configs.zamba2_2p7b import CONFIG as _zamba2
from repro_torch.configs.mamba2_1p3b import CONFIG as _mamba2

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _grok,
        _dbrx,
        _qwen3,
        _phi3,
        _smollm,
        _llama3,
        _whisper,
        _internvl2,
        _zamba2,
        _mamba2,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    # tolerate -reduced suffix and _ vs -
    base = name.replace("_", "-").removesuffix("-reduced")
    if base in ARCHS:
        cfg = ARCHS[base]
        return reduced(cfg) if name.endswith("-reduced") else cfg
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "cell_supported",
    "describe",
    "get_arch",
    "get_shape",
    "reduced",
]
