"""internvl2-26b — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

Vision frontend (InternViT) is a STUB per the assignment: input_specs()
provides precomputed (batch, num_frontend_tokens, d_model) patch embeddings,
prepended to the token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    frontend="vision_patches",
    num_frontend_tokens=256,
    rope_theta=1000000.0,
)
