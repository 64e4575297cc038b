"""Shared model building blocks: declarative params, norms, RoPE, sampling.

Each model declares a ``param_specs()`` tree of :class:`ParamSpec` (shape,
init rule, logical axes), the same declaration as ``repro/models/common.py``,
so a JAX parameter tree and the port's state line up name for name.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None
    dtype: str | None = None  # None -> model default

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {"layers.attn.wq": leaf, ...}: the port's state-dict
    names for a spec tree or a JAX parameter tree."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flatten_tree(val, name + "."))
        else:
            out[name] = val
    return out


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given integer positions. Shapes (..., head_dim//2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2) (broadcast over heads)."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half)
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:  # (B, S, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP. x (..., D); weights (D,F), (D,F), (F,D)."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


# ---------------------------------------------------------------------------
# the (seed, token_index) noise stream: JAX's threefry2x32, in int64
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds), the block function behind
    ``jax.random``'s default PRNG. Every argument is an int64 tensor holding
    uint32 values; they broadcast. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def gumbel_noise(seeds: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Row b: ``jax.random.gumbel(fold_in(PRNGKey(seeds[b]), idx[b]), (n,))``
    bit for bit in the key and the random bits (the default partitionable
    threefry), f32 logs after. seeds/idx (B,) int -> (B, n) f32."""
    dev = seeds.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    # PRNGKey(seed) = (seed >> 32, seed & 0xFFFFFFFF) = (0, seed) for int32
    k0, k1 = zero, seeds.long() & _M32
    # fold_in(key, i) = threefry(key, (0, i))
    k0, k1 = _threefry2x32(k0, k1, zero, idx.long() & _M32)
    count = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    b0, b1 = _threefry2x32(k0[:, None], k1[:, None], zero, count)
    bits = b0 ^ b1
    # uniform in [tiny, 1): 23 random mantissa bits under exponent 0
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(_TINY, dtype=torch.float32, device=dev)
    span = torch.tensor(1.0, dtype=torch.float32, device=dev) - lo
    u = torch.maximum(lo, (one - 1.0) * span + lo)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# sampling (the fused sample step shared by every serving engine)
# ---------------------------------------------------------------------------


def sample_tokens(
    logits: torch.Tensor,   # (B, Vp) — padded vocab ok, sliced to `vocab`
    temps: torch.Tensor,    # (B,) f32; <= 0 means greedy (filters ignored)
    top_ks: torch.Tensor,   # (B,) int32; 0 disables top-k
    top_ps: torch.Tensor,   # (B,) f32; 1.0 disables top-p
    seeds: torch.Tensor,    # (B,) int32 per-request RNG seed
    idx: torch.Tensor,      # (B,) int32 token index within each request
    vocab: int,
) -> torch.Tensor:
    """Per-row temperature / top-k / top-p sampling, one batched pass.

    The noise is keyed off ``(seed, token_index)`` per row — never off an
    engine-global counter — and is JAX's own bit stream
    (:func:`gumbel_noise`), so a request reproduces the same tokens as the
    JAX engine no matter which slot it lands in, how it is batched, or
    whether it was preempted and regenerated. Gumbel-max over the filtered
    logits; greedy rows (``temps <= 0``) take the plain argmax (first index
    on ties, as ``jnp.argmax``). Returns (B,) int32."""
    lg = logits[..., :vocab].float()
    greedy = lg.argmax(dim=-1).to(torch.int32)
    v = lg.shape[-1]
    desc = lg.sort(dim=-1, descending=True).values
    # top-k: keep logits >= the k-th largest (k=0 -> keep all)
    k = torch.where(top_ks > 0, top_ks, torch.full_like(top_ks, v))
    kth = desc.gather(-1, (k.long() - 1).clamp(0, v - 1)[:, None])
    row = lg.masked_fill(lg < kth, float("-inf"))
    t = temps.float().clamp_min(1e-6)[:, None]
    # top-p (nucleus) over the top-k-filtered distribution: keep the
    # smallest prefix of descending probabilities whose mass reaches p
    probs = torch.softmax(row / t, dim=-1)
    p_desc = probs.sort(dim=-1, descending=True).values
    csum = p_desc.cumsum(dim=-1)
    first = (csum >= top_ps[:, None]).to(torch.int32).argmax(dim=-1)
    cutoff = torch.where(top_ps >= 1.0, torch.zeros_like(top_ps),
                         p_desc.gather(-1, first[:, None].long())[:, 0])
    row = row.masked_fill(probs < cutoff[:, None], float("-inf"))
    g = gumbel_noise(seeds, idx, v)
    sampled = (row / t + g).argmax(dim=-1).to(torch.int32)
    return torch.where(temps > 0.0, sampled, greedy)


def pick_tokens(logits, temps, top_ks, top_ps, seeds, idx, vocab: int,
                greedy_only: bool) -> torch.Tensor:
    """The engines' token pick: a batch known to be all greedy pays a plain
    argmax; any other runs :func:`sample_tokens` (whose greedy rows still
    reduce to the same argmax). Returns (B,) int32."""
    if greedy_only:
        return logits[..., :vocab].argmax(dim=-1).to(torch.int32)
    return sample_tokens(logits, temps, top_ks, top_ps, seeds, idx, vocab)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; asking for CUDA without a card raises
    instead of quietly running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is "
                           f"available; pass device='cpu' to run on the CPU")
    return device
