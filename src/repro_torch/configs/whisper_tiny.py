"""whisper-tiny — enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].

The conv frontend is a stub per the assignment: input_specs() provides
precomputed (batch, frames, d_model) frame embeddings to the encoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    frontend="audio_frames",
    rope_theta=10000.0,
)
