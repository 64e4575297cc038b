"""Plain PyTorch versions of the paged-attention kernels.

These are the ground truth the hand-written CUDA kernels are held against
(``chip_smoke.py`` compares them on the card) and the path every op takes
when its tensors lie on the CPU. They keep the JAX package's layouts,
masks and exact-zero conventions (``repro/kernels/ref.py``):

* ``paged_attention_ref``         — single-token decode over a block-table
  page pool; idle slots (length 0) yield zeros.
* ``paged_prefill_attention_ref`` — chunked prefill: a chunk of C queries of
  one sequence over its paged prefix + itself (causal); padded queries
  (``i >= valid``) yield zeros.
* ``paged_mixed_attention_ref``   — fused mixed step: R independent rows,
  each a (block-table row, last attended position) pair; ``last_pos < 0``
  marks a dead row (exact zeros).
* ``paged_mixed_attention_split_ref`` — the same function evaluated as
  decode rows + one chunk, gathering the chunk's K/V once (what
  ``ops.paged_mixed_attention`` runs on the CPU when given ``num_decode``).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _masked_attention(qg, keys, vals, ok):
    """qg (N, KVH, G, D) f32 pre-scaled, keys/vals (N, S, KVH, D) per row
    or (S, KVH, D) shared by every row, ok (N, S) bool -> (N, KVH, G, D)
    f32, with explicit normalization (not torch.softmax) so an all-masked
    row gives exact zeros."""
    kv = "nskd" if keys.dim() == 4 else "skd"
    scores = torch.einsum(f"nkgd,{kv}->nkgs", qg, keys.float())
    mask = ok[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum(f"nkgs,{kv}->nkgd", p / l.clamp_min(1e-30),
                        vals.float())


def paged_attention_ref(
    q: torch.Tensor,             # (B, H, D) one query token per sequence
    k_pages: torch.Tensor,       # (P, page, KVH, D) shared page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, MP) int32 physical page per logical page
    lengths: torch.Tensor,       # (B,) int32 valid positions per sequence
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Decode oracle: positions >= length are masked; length 0 gives zeros.
    Returns (B, H, D) in q.dtype."""
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    mp = block_tables.shape[1]
    scale = scale if scale is not None else d ** -0.5
    bt = block_tables.long()
    keys = k_pages[bt].reshape(b, mp * page, kvh, d)
    vals = v_pages[bt].reshape(b, mp * page, kvh, d)
    qg = q.reshape(b, kvh, h // kvh, d).float() * scale
    pos = torch.arange(mp * page, device=q.device)
    ok = pos[None, :] < lengths[:, None]
    out = _masked_attention(qg, keys, vals, ok)
    return out.reshape(b, h, d).to(q.dtype)


def paged_prefill_attention_ref(
    q: torch.Tensor,            # (C, H, D) one chunk of queries for ONE sequence
    k_pages: torch.Tensor,      # (P, page, KVH, D) shared page pool
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (MP,) int32 the sequence's block-table row
    start: torch.Tensor | int,  # scalar: positions already cached
    valid: torch.Tensor | int,  # scalar: real (non-padded) chunk tokens
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Chunked-prefill oracle: query i (absolute position start+i) attends
    every cached position <= start+i; padded queries (i >= valid) give
    zeros. The chunk's own K/V must already be in the pages. Returns
    (C, H, D) in q.dtype."""
    c, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    mp = block_table.shape[0]
    scale = scale if scale is not None else d ** -0.5
    bt = block_table.long()
    keys = k_pages[bt].reshape(mp * page, kvh, d)
    vals = v_pages[bt].reshape(mp * page, kvh, d)
    qg = q.reshape(c, kvh, h // kvh, d).float() * scale
    kpos = torch.arange(mp * page, device=q.device)[None, :]
    ci = torch.arange(c, device=q.device)[:, None]
    ok = (kpos <= start + ci) & (ci < valid)
    out = _masked_attention(qg, keys, vals, ok)
    return out.reshape(c, h, d).to(q.dtype)


def paged_mixed_attention_ref(
    q: torch.Tensor,             # (R, H, D) one query row per batch row
    k_pages: torch.Tensor,       # (P, page, KVH, D) shared page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (R, MP) int32 block-table row per query row
    last_pos: torch.Tensor,      # (R,) int32 last attendable position, -1 = dead
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Mixed-batch oracle: every row attends positions <= last_pos[r]; dead
    rows (-1) give exact zeros. Decode is ``last_pos = lengths - 1``; a
    chunk is C consecutive rows sharing one block-table row. Returns
    (R, H, D) in q.dtype."""
    r, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    mp = block_tables.shape[1]
    scale = scale if scale is not None else d ** -0.5
    bt = block_tables.long()
    keys = k_pages[bt].reshape(r, mp * page, kvh, d)
    vals = v_pages[bt].reshape(r, mp * page, kvh, d)
    qg = q.reshape(r, kvh, h // kvh, d).float() * scale
    pos = torch.arange(mp * page, device=q.device)
    ok = pos[None, :] <= last_pos[:, None]
    out = _masked_attention(qg, keys, vals, ok)
    return out.reshape(r, h, d).to(q.dtype)


def paged_mixed_attention_split_ref(
    q: torch.Tensor,             # (R, H, D): num_decode decode rows, then a chunk
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (R, MP) int32; chunk rows repeat one row
    last_pos: torch.Tensor,      # (R,) int32; dead chunk rows are a suffix
    num_decode: int,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """``paged_mixed_attention_ref`` for the structured case the fused engine
    step builds: rows ``[num_decode, R)`` are one prefill chunk sharing a
    block-table row with contiguous live positions and a dead suffix. The
    decode rows go through :func:`paged_attention_ref`, the chunk through
    :func:`paged_prefill_attention_ref`, so the chunk's K/V is gathered once
    instead of once per row. Same values as the generic oracle."""
    s = num_decode
    dec = paged_attention_ref(
        q[:s], k_pages, v_pages, block_tables[:s], last_pos[:s] + 1,
        scale=scale,
    )
    # dead chunk rows are a suffix, so the live count and the cursor fall
    # out of last_pos; valid == 0 masks every chunk row to zeros
    valid = (last_pos[s:] >= 0).sum()
    start = last_pos[s].clamp_min(0)
    chk = paged_prefill_attention_ref(
        q[s:], k_pages, v_pages, block_tables[s], start, valid, scale=scale,
    )
    return torch.cat([dec, chk], dim=0)
