"""Model facade: one object per architecture with a stable surface.

    model = build_model(cfg, device="cuda")
    params = model.init(seed)           # seeded random weights (state dict)
    model.load_state_dict(params_from_jax(cfg, tree))  # or the JAX weights

The dense, ssm and hybrid decoders (``DecoderLM``) and the
encoder-decoder (``EncDecLM``, whisper) are ported; the moe and vlm
families wait for ROADMAP A.7. The port has no ``make_batch``: its
trainer takes ``frames`` from ``data/pipeline.py``.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import DecoderLM

Model = DecoderLM | EncDecLM


def build_model(cfg: ModelConfig, **kw) -> Model:
    if cfg.is_encoder_decoder:
        return EncDecLM(cfg, **kw)
    return DecoderLM(cfg, **kw)
