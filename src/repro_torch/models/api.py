"""Model facade: one object per architecture with a stable surface.

    model = build_model(cfg, device="cuda")
    params = model.init(seed)           # seeded random weights (state dict)
    model.load_state_dict(params_from_jax(cfg, tree))  # or the JAX weights

Every decoder family (dense, moe, vlm, ssm, hybrid: ``DecoderLM``) and the
encoder-decoder (``EncDecLM``, whisper) is ported. The port has no
``make_batch``: its trainer takes ``vision_embeds`` (batch x
:func:`frontend_len` x d_model) and ``frames`` from ``data/pipeline.py``.
:func:`cache_len` is the JAX package's: a vlm's vision positions count
toward the context.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
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
