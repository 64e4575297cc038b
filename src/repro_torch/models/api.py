"""Model facade: one object per architecture with a stable surface.

    model = build_model(cfg, device="cuda")
    params = model.init(seed)           # seeded random weights (state dict)
    model.load_state_dict(params_from_jax(cfg, tree))  # or the JAX weights

    aparams = model.abstract()          # meta tensors (dry run)
    axes = model.axes()                 # logical-axis tuples (sharding)
    specs = input_specs(cfg, shape)     # dry-run inputs per shape cell

Every decoder family (dense, moe, vlm, ssm, hybrid: ``DecoderLM``) and the
encoder-decoder (``EncDecLM``, whisper) is ported. The port has no
``make_batch``: its trainer takes ``vision_embeds`` (batch x
:func:`frontend_len` x d_model) and ``frames`` from ``data/pipeline.py``.
:func:`cache_len` is the JAX package's (of a sequence length, not a
shape): a vlm's vision positions count toward the context.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import DecoderLM

Model = DecoderLM | EncDecLM


def build_model(cfg: ModelConfig, *, params: dict | None = None,
                **kw) -> Model:
    """The config's model (``kw``: ``device``, ``attn_impl``,
    ``ssd_impl``). With ``params``, a state dict, the model is registered
    on the meta device and then holds them through
    :meth:`LMBase.load_params`, so building it allocates nothing beyond
    what loading needs (an engine on internvl2-26b's 40 GB would otherwise
    hold a second, empty copy while it loads)."""
    cls = EncDecLM if cfg.is_encoder_decoder else DecoderLM
    if params is None:
        return cls(cfg, **kw)
    model = cls(cfg, **{**kw, "device": "meta"})
    model.device = resolve_device(kw.get("device", "cuda"))
    model.load_params(params)
    return model


def frontend_len(cfg: ModelConfig) -> int:
    """The positions ahead of the tokens: a vlm's vision embeddings
    (``num_frontend_tokens``), which count toward the context; 0 for every
    other family."""
    return cfg.num_frontend_tokens if cfg.family == "vlm" else 0


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Total context length: a vlm carries its vision prefix in the
    cache."""
    return seq_len + frontend_len(cfg)


# ---------------------------------------------------------------------------
# dry-run inputs: meta tensors per shape cell (the JAX package's specs)
# ---------------------------------------------------------------------------

# logical axes of each batch field
BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "targets": ("batch", "seq"),
    "vision_embeds": ("batch", "seq", None),
    "frames": ("batch", "seq", None),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch of a train or prefill cell: tokens and targets (B, S)
    int32; vlm also ``vision_embeds`` (B, F, D), encdec ``frames`` (B, S,
    D), in the model's dtype."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    specs = {"tokens": _meta((b, s), torch.int32),
             "targets": _meta((b, s), torch.int32)}
    if cfg.family == "vlm":
        specs["vision_embeds"] = _meta((b, cfg.num_frontend_tokens,
                                        cfg.d_model), dt)
    if cfg.is_encoder_decoder:
        specs["frames"] = _meta((b, s, cfg.d_model), dt)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Inputs of one decode step: tokens (B, 1) and the cache."""
    b = shape.global_batch
    model = build_model(cfg, device="meta")
    return {"tokens": _meta((b, 1), torch.int32),
            "cache": model.abstract_cache(b, cache_len(cfg, shape.seq_len))}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    if shape.kind in ("train", "prefill"):
        return train_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
