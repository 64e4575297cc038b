"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf].

54 Mamba2 layers; ONE shared transformer (attn+MLP) block whose weights are
re-used at every `attn_every`-th layer (Zamba2's weight-shared global block).
MHA: 32 heads, kv=32, head_dim 80.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=10000.0,
)
