"""Model facade: one object per architecture with a stable surface.

    model = build_model(cfg, device="cuda")
    params = model.init(seed)           # seeded random weights (state dict)
    model.load_state_dict(params_from_jax(cfg, tree))  # or the JAX weights

The dense, ssm and hybrid decoders are ported; the moe and vlm families
wait for ROADMAP A.7, the encoder-decoder (whisper) family for A.11.
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
