"""Model facade: one object per architecture with a stable surface.

    model = build_model(cfg, device="cuda")
    params = model.init(seed)           # seeded random weights (state dict)
    model.load_state_dict(params_from_jax(cfg, tree))  # or the JAX weights

The dense and ssm decoders are ported; the encoder-decoder (whisper)
family waits for ROADMAP A.11.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import DecoderLM

Model = DecoderLM


def build_model(cfg: ModelConfig, **kw) -> Model:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(ROADMAP A.11)")
    return DecoderLM(cfg, **kw)
