"""Architecture + shape configuration system.

One ``ModelConfig`` per assigned architecture lives in
``src/repro/configs/<id>.py``; all are registered in ``configs/__init__``.
``reduced()`` derives the smoke-test config for any architecture (same family,
tiny dims). ``ShapeConfig`` defines the four assigned input-shape cells.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    expand: int = 2

    # --- hybrid (Zamba2): shared attention block applied every k SSM layers ---
    attn_every: int = 0

    # --- encoder/decoder ---
    is_encoder_decoder: bool = False

    # --- modality frontend (STUB: input_specs provides embeddings) ---
    frontend: Literal["none", "audio_frames", "vision_patches"] = "none"
    num_frontend_tokens: int = 0

    # --- head padding (perf): pad q/kv heads so they shard over the model
    # axis; extra heads are zero-init in o_proj (output-identical at init).
    # Constraint: padded group size must equal the original (mapping-preserving)
    num_heads_padded: int = 0
    num_kv_heads_padded: int = 0

    # --- misc ---
    qk_norm: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat_policy: str = "nothing"  # nothing|dots|full  (see train/step.py)

    # ------------------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 512k-context decode cell?"""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def eff_heads(self) -> int:
        if self.num_heads_padded:
            assert self.num_heads_padded % max(self.num_kv_heads_padded or self.num_kv_heads, 1) == 0
            if self.num_kv_heads:
                assert (self.num_heads_padded // (self.num_kv_heads_padded or self.num_kv_heads)
                        == self.num_heads // self.num_kv_heads), "padding must preserve GQA mapping"
            return self.num_heads_padded
        return self.num_heads

    @property
    def eff_kv_heads(self) -> int:
        return self.num_kv_heads_padded or self.num_kv_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic total parameter count (embedding + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = 3 * d * f  # SwiGLU: gate, up, down
        if self.family == "moe":
            per_layer = attn + self.num_experts * mlp + d * self.num_experts
        elif self.family == "ssm":
            din, n, h = self.d_inner, self.ssm_state, self.ssm_heads
            # in_proj (z,x,B,C,dt) + conv + out_proj (Mamba2)
            per_layer = d * (2 * din + 2 * n + h) + (din + 2 * n) * self.conv_width + din * d
        elif self.family == "hybrid":
            din, n, h = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer = d * (2 * din + 2 * n + h) + (din + 2 * n) * self.conv_width + din * d
        else:
            per_layer = attn + mlp
        total = emb + self.num_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            # one SHARED attention+mlp block (weights shared across applications)
            total += (attn + mlp)
        if self.is_encoder_decoder:
            # encoder stack (same dims) + cross-attention in decoder
            total += self.num_layers * (attn + mlp)  # encoder layers
            total += self.num_layers * attn          # cross-attn blocks
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = 3 * d * f
        inactive = self.num_layers * (self.num_experts - self.experts_per_token) * mlp
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The assigned shape suite (identical for all 10 LM-family architectures).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) runnable? Returns (ok, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attention: 512k context is quadratic)"
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test config: same family/topology, tiny dims, CPU-runnable."""
    kw = dict(
        name=cfg.name + "-reduced",
        num_layers=2 if not cfg.attn_every else 2 * max(1, min(cfg.attn_every, 2)),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        dtype="float32",
        rope_theta=cfg.rope_theta,
    )
    if cfg.family in ("moe",):
        kw.update(num_experts=4, experts_per_token=min(2, cfg.experts_per_token))
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32, expand=2)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.num_frontend_tokens:
        kw.update(num_frontend_tokens=8)
    return replace(cfg, **kw)


def describe(cfg: ModelConfig) -> str:
    n = cfg.param_count()
    na = cfg.active_param_count()
    extra = f" (active {na/1e9:.1f}B)" if na != n else ""
    return f"{cfg.name}: {cfg.family}, {cfg.num_layers}L d={cfg.d_model} N={n/1e9:.1f}B{extra}"
