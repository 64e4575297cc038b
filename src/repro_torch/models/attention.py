"""Attention blocks: GQA + RoPE (+ optional qk-norm), over a whole
sequence, a dense per-sequence KV cache, or the serving page pool.

Each mirrors ``repro/models/attention.py`` and attends through
``kernels.ops`` (the hand-written kernel for CUDA tensors, the plain version
for CPU tensors):

* whole sequence (prefill): ``self_attention`` and
  ``self_attention_with_cache_write`` (which also returns the K/V that seed
  a cache), through the flash kernel;
* dense cache (lockstep decode): ``decode_self_attention`` writes the new
  K/V into the layer's ``(B, Smax, KVH, Dh)`` cache IN PLACE and attends
  with ``decode_attention_raw`` (plain f32 einsums, as in the JAX package:
  it has no Pallas kernel there either);
* page pool (continuous batching): the three paged entry points write the
  rows' new K/V into this layer's page pool IN PLACE, then attend through
  the paged kernels.

An int8 pool (``k_scale``/``v_scale`` beside ``k``/``v``) quantizes the
new rows on the way in, one f32 scale per (row, kv head), and the paged
kernels dequantize as they load, as in the JAX package.

Rows that must not write (idle slots, dead rows, chunk padding, null-page
table entries) write into the pool's SINK page instead: the pool carries
one extra page past the ``num_pages`` the block tables can name (see
``serving/kv_cache.py``), so the scatter needs no boolean row filter (which
would synchronise with the host every layer) and no out-of-bounds index.
Nothing ever reads the sink.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.common import ParamSpec, apply_rope, rms_norm, rope_table

NEG_INF = -1e30


def attn_param_specs(cfg: ModelConfig, stacked: int | None = None) -> dict:
    """QKV/O projections (+ qk-norm scales). ``stacked``: leading layer dim.

    Uses the *effective* (possibly padded) head counts; padded o-proj rows
    are zero-init so padding is output-identical at init.
    """
    d, h, kvh, hd = cfg.d_model, cfg.eff_heads, cfg.eff_kv_heads, cfg.head_dim
    pre = (stacked,) if stacked else ()
    pax = ("stack",) if stacked else ()
    wo_init = "zeros" if cfg.num_heads_padded else "normal"
    specs = {
        "wq": ParamSpec(pre + (d, h, hd), pax + ("embed", "heads", "head_dim")),
        "wk": ParamSpec(pre + (d, kvh, hd), pax + ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec(pre + (d, kvh, hd), pax + ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec(pre + (h, hd, d), pax + ("heads", "head_dim", "embed"),
                        init=wo_init),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec(pre + (hd,), pax + (None,), init="ones")
        specs["k_norm"] = ParamSpec(pre + (hd,), pax + (None,), init="ones")
    return specs


def _project_qkv(p, x, cfg: ModelConfig, positions: torch.Tensor | None,
                 rope: bool):
    """x (B,S,D) -> q (B,S,H,Dh), k/v (B,S,KVH,Dh), rope-rotated."""
    b, s, d = x.shape

    def proj(w):
        return (x @ w.reshape(d, -1)).reshape(b, s, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        assert positions is not None
        cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(..., H, Dh) attention output -> (..., D) through wo (H, Dh, D)."""
    return out.reshape(*out.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def self_attention(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    causal: bool = True,
    rope: bool = True,
    positions: torch.Tensor | None = None,  # (S,) int
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Full-sequence self-attention (train / prefill)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, rope)
    out = ops.flash_attention(q, k, v, causal=causal, impl=attn_impl)
    return _out_proj(out, p["wo"])


def self_attention_with_cache_write(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor | None = None,  # (S,) int
    attn_impl: str = "auto",
    rope: bool = True,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Prefill: the causal attention output AND the K/V ((B, S, KVH, Dh)
    each, rope-rotated) that seed the cache. Positions default to
    ``arange(S)``: a left-padded row attends its pad tokens, as in the JAX
    package."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, rope)
    out = ops.flash_attention(q, k, v, causal=True, impl=attn_impl)
    return _out_proj(out, p["wo"]), (k, v)


def decode_attention_raw(
    q: torch.Tensor,        # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, Smax, KVH, Dh)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # int scalar: valid positions (incl. current)
    scale: float,
) -> torch.Tensor:
    """One-token attention over a dense KV cache, in f32: positions
    ``>= cache_len`` (one length for every row) are masked. Returns
    (B, 1, H, Dh) f32."""
    b, _, h, hd = q.shape
    smax, kvh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kvh, h // kvh, hd).float() * scale
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    valid = torch.arange(smax, device=q.device) < cache_len
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.float())
    return out.reshape(b, 1, h, hd)


def decode_self_attention(
    p: dict,
    x: torch.Tensor,      # (B, 1, D)
    layer_cache: dict,    # {"k": (B, Smax, KVH, Dh), "v": ...}, updated in place
    pos: torch.Tensor,    # int scalar: index of the current token
    cfg: ModelConfig,
    *,
    rope: bool = True,
) -> tuple[torch.Tensor, dict]:
    """Lockstep decode: write the new token's K/V at ``pos`` into the
    layer's cache IN PLACE (the JAX version returns an updated copy), then
    attend over positions ``<= pos``. Like ``dynamic_update_slice``, the
    write position is clamped into ``[0, Smax - 1]``; the mask still uses
    ``pos + 1``. Returns (output (B, 1, D), ``layer_cache``)."""
    positions = pos.reshape(1)
    q, k, v = _project_qkv(p, x, cfg, positions, rope)
    kc, vc = layer_cache["k"], layer_cache["v"]
    at = positions.long().clamp(0, kc.shape[1] - 1)
    kc.index_copy_(1, at, k.to(kc.dtype))
    vc.index_copy_(1, at, v.to(vc.dtype))
    out = decode_attention_raw(q, kc, vc, pos + 1, cfg.head_dim ** -0.5)
    return _out_proj(out.to(x.dtype), p["wo"]), layer_cache


def _paged_scatter(layer_pages: dict, k_rows: torch.Tensor,
                   v_rows: torch.Tensor, phys: torch.Tensor,
                   off: torch.Tensor) -> None:
    """Write per-row K/V (rows, KVH, Dh) into this layer's page pool in
    place at (phys, off). Rows routed to the sink page land where nobody
    reads; every other (page, offset) pair is unique, so the write order
    does not matter. An int8 pool quantizes the rows and writes their
    scales alongside."""
    idx = (phys.long(), off.long())
    if "k_scale" in layer_pages:
        k_rows, k_sc = ref.quantize_kv(k_rows)
        v_rows, v_sc = ref.quantize_kv(v_rows)
        layer_pages["k_scale"].index_put_(idx, k_sc)
        layer_pages["v_scale"].index_put_(idx, v_sc)
    layer_pages["k"].index_put_(idx, k_rows.to(layer_pages["k"].dtype))
    layer_pages["v"].index_put_(idx, v_rows.to(layer_pages["v"].dtype))


def _scales(layer_pages: dict) -> dict:
    """The int8 pool's scales as the paged ops' keywords (none for a pool
    of the model's dtype)."""
    return {"k_scale": layer_pages.get("k_scale"),
            "v_scale": layer_pages.get("v_scale")}


def _sink(layer_pages: dict) -> int:
    return layer_pages["k"].shape[0] - 1


def _table_at(tables: torch.Tensor, logical: torch.Tensor) -> torch.Tensor:
    """tables[r, logical[r]] per row, the logical page clamped into the
    table (only rows that then go to the sink can exceed it)."""
    col = logical.long().clamp(0, tables.shape[1] - 1)[:, None]
    return tables.gather(1, col)[:, 0]


def decode_self_attention_paged(
    p: dict,
    x: torch.Tensor,             # (S, 1, D) one token per in-flight slot
    layer_pages: dict,           # {"k": (P+1,page,KVH,Dh), "v": ...[, scales]}, in place
    block_tables: torch.Tensor,  # (S, MP) int32
    lengths: torch.Tensor,       # (S,) int32 tokens already cached per slot
    cfg: ModelConfig,
    *,
    rope: bool = True,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Continuous-batching decode: write the new K/V into each slot's current
    page, then attend over the block table. Per-slot positions (= lengths)
    drive RoPE, so slots at different depths coexist in one batch. Idle
    slots (block-table entry 0 = the null page) write into the sink."""
    positions = lengths[:, None]  # (S, 1) absolute position of the new token
    q, k, v = _project_qkv(p, x, cfg, positions, rope)
    page = layer_pages["k"].shape[1]
    phys = _table_at(block_tables, lengths // page)
    phys = torch.where(phys == 0, _sink(layer_pages), phys)
    _paged_scatter(layer_pages, k[:, 0], v[:, 0], phys, lengths % page)
    out = ops.paged_attention(
        q[:, 0], layer_pages["k"], layer_pages["v"], block_tables,
        lengths + 1, **_scales(layer_pages), scale=cfg.head_dim ** -0.5,
        impl=attn_impl,
    ).to(x.dtype)  # (S, H, Dh)
    return _out_proj(out, p["wo"])[:, None, :]


def prefill_chunk_attention_paged(
    p: dict,
    x: torch.Tensor,            # (1, C, D) one chunk of ONE sequence's prompt
    layer_pages: dict,          # {"k": (P+1,page,KVH,Dh), "v": ...[, scales]}, in place
    block_table: torch.Tensor,  # (MP,) int32 the sequence's block-table row
    start: torch.Tensor,        # int32 scalar: positions already in the pages
    valid: torch.Tensor,        # int32 scalar: real (non-padded) chunk tokens
    cfg: ModelConfig,
    *,
    rope: bool = True,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Chunked prefill: write the chunk's K/V into the sequence's pages,
    then attend each chunk position over the paged prefix + the chunk itself
    (causal). RoPE uses absolute positions ``start + i``. Padded positions
    (>= valid) write into the sink and return garbage the caller discards."""
    c = x.shape[1]
    ci = torch.arange(c, dtype=torch.int32, device=x.device)
    positions = start + ci
    q, k, v = _project_qkv(p, x, cfg, positions, rope)
    page = layer_pages["k"].shape[1]
    logical = (positions // page).long().clamp_max(block_table.shape[0] - 1)
    phys = torch.where(ci < valid, block_table[logical], _sink(layer_pages))
    _paged_scatter(layer_pages, k[0], v[0], phys, positions % page)
    out = ops.paged_prefill_attention(
        q[0], layer_pages["k"], layer_pages["v"], block_table, start, valid,
        **_scales(layer_pages), scale=cfg.head_dim ** -0.5, impl=attn_impl,
    ).to(x.dtype)  # (C, H, Dh)
    return _out_proj(out, p["wo"])[None]


def mixed_step_attention_paged(
    p: dict,
    x: torch.Tensor,             # (R, 1, D) one token per row (decode + chunk)
    layer_pages: dict,           # {"k": (P+1,page,KVH,Dh), "v": ...[, scales]}, in place
    block_tables: torch.Tensor,  # (R, MP) int32, one block-table row per row
    positions: torch.Tensor,     # (R,) int32 absolute position per row, -1 = dead
    cfg: ModelConfig,
    *,
    rope: bool = True,
    attn_impl: str = "auto",
    num_decode: int | None = None,
) -> torch.Tensor:
    """Fused mixed step: decode rows AND one prefill chunk's rows write their
    K/V in one scatter, THEN every row attends its own block table up to its
    own position. Because the scatter lands before any row reads, chunk row
    i sees chunk rows ``< i`` exactly as the chunk-only path does. Dead
    rows (``positions = -1``) write into the sink and return exact zeros.

    ``num_decode`` forwards the structure hint to
    :func:`repro_torch.kernels.ops.paged_mixed_attention`: the plain version
    gathers the chunk's K/V once, and with bf16 q the kernel reads the
    chunk's pages once per kv head (decode rows through the split decode
    kernel, chunk rows through the tensor-core chunk kernel)."""
    live = positions >= 0
    pos = positions.clamp_min(0)
    q, k, v = _project_qkv(p, x, cfg, pos[:, None], rope)
    page = layer_pages["k"].shape[1]
    phys = _table_at(block_tables, pos // page)
    phys = torch.where(live & (phys != 0), phys, _sink(layer_pages))
    _paged_scatter(layer_pages, k[:, 0], v[:, 0], phys, pos % page)
    out = ops.paged_mixed_attention(
        q[:, 0], layer_pages["k"], layer_pages["v"], block_tables, positions,
        **_scales(layer_pages), scale=cfg.head_dim ** -0.5, impl=attn_impl,
        num_decode=num_decode,
    ).to(x.dtype)  # (R, H, Dh)
    return _out_proj(out, p["wo"])[:, None, :]
