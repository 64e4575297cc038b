"""Plain PyTorch versions of the attention and Mamba2 SSD kernels.

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
* ``paged_verify_attention_ref`` — a speculation bundle (the last
  committed token + k drafts of one sequence) through the mixed oracle:
  verify == chunk == a decode loop.
* ``paged_mixed_attention_split_ref`` — the same function evaluated as
  decode rows + one chunk, gathering the chunk's K/V once (what
  ``ops.paged_mixed_attention`` runs on the CPU when given ``num_decode``).
* ``flash_attention_ref``     — dense GQA attention, full score matrix
  (causal queries are the last Sq of the Skv positions).
* ``flash_attention_chunked`` — the same function as an online softmax over
  ``chunk_kv``-sized K/V blocks, in the JAX package's op order
  (``ops.flash_attention`` runs it on the CPU, as the JAX op runs
  ``ref.flash_attention_chunked`` there).
* ``ssd_sequential``  — the literal Mamba2 recurrence, one token at a time.
* ``ssd_chunked``     — the block (chunked) decomposition of the same scan,
  in the JAX package's op order (``ops.ssd_scan`` runs it on the CPU, as
  the JAX engine runs ``ref.ssd_chunked`` there).
* ``ssd_decode_step`` — the one-token recurrence of serving decode.
* ``quantize_kv`` / ``dequantize_pages`` — the int8 KV pages of the tiered
  cache: one f32 absmax scale per (position, kv head) over head_dim. The
  paged ops run the int8 pool on the CPU as ``dequantize_pages`` followed
  by the unchanged f32 paged versions, as the JAX ops do.
"""

from __future__ import annotations

import numpy as np
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


def paged_verify_attention_ref(
    q: torch.Tensor,            # (C, H, D) bundle queries: t_last + k drafts
    k_pages: torch.Tensor,      # (P, page, KVH, D) shared page pool
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (MP,) int32 the sequence's block-table row
    start: torch.Tensor | int,  # scalar: cached length L before the bundle
    valid: torch.Tensor | int,  # scalar: 1 + number of drafted tokens
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Speculative-verify oracle: row i is the query at absolute position
    ``start + i`` (row 0 the last committed token, rows 1..k the drafts)
    and attends what an i-step decode loop would see: the cached prefix
    plus the bundle rows ``<= i`` (their K/V already in the pages). That is
    the mixed oracle with the table broadcast to every row and ``last_pos
    = start + i``, dead past ``valid``, so verify == chunk attention == an
    unrolled decode loop. Returns (C, H, D) in q.dtype; padded rows are
    exact zeros."""
    c = q.shape[0]
    idx = torch.arange(c, device=q.device)
    last_pos = torch.where(idx < valid, start + idx, -1).to(torch.int32)
    tables = block_table.expand(c, block_table.shape[0])
    return paged_mixed_attention_ref(q, k_pages, v_pages, tables, last_pos,
                                     scale=scale)


# ---------------------------------------------------------------------------
# int8 KV page quantization (tiered cache)
# ---------------------------------------------------------------------------

# 1/127 in f32: the JAX reference writes ``absmax / 127.0``, and XLA
# compiles a division by a constant into a multiplication by its f32
# reciprocal under ``jit`` (where the JAX engine runs it); the two differ in
# the last bit of some scales, so the port multiplies as the jitted code does
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the head_dim (last) axis.

    x (..., D) -> (q int8 (..., D), scale f32 (...,)): scale = absmax / 127
    floored at 1e-8 (all-zero rows quantize to zeros), q = x / scale
    rounded half to even and clipped to +-127, in f32 whatever x's dtype.
    Gives the same bytes and scales as ``jax.jit(repro.kernels.ref.
    quantize_kv)``; the worst per-element round-trip error is scale / 2."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) * _INV_127).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_pages(pages: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 pages (..., D) * per-row scales (...,) -> f32 pages: the plain
    form of the dequantization the paged kernels fuse into their page
    loads."""
    return pages.float() * scales[..., None]


# ---------------------------------------------------------------------------
# dense (flash) attention
# ---------------------------------------------------------------------------


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Naive oracle: the whole (Sq, Skv) score matrix in f32, K/V repeated
    over the group. Causal queries are the LAST Sq of the Skv positions
    (``Sq < Skv`` continues a cached prefix). Returns (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    k = k.repeat_interleave(h // kvh, dim=2)
    v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(~(kpos <= qpos), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def flash_attention_chunked(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    chunk_kv: int = 512,
) -> torch.Tensor:
    """Online-softmax attention over ``chunk_kv``-sized K/V blocks, kv heads
    not repeated. The op order is the JAX reference's: q cast to f32 and
    scaled before the dot, masked scores set to ``NEG_INF``, ``l`` floored
    at 1e-30, the output cast back to q's dtype. Like it, this needs Skv to
    be a multiple of ``min(chunk_kv, Skv)``. Returns (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    group = h // kvh
    chunk_kv = min(chunk_kv, skv)
    assert skv % chunk_kv == 0, (skv, chunk_kv)
    qg = q.reshape(b, sq, kvh, group, d).float() * scale
    qpos = torch.arange(sq, device=q.device) + (skv - sq)
    acc = torch.zeros((b, sq, kvh, group, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, sq, kvh, group), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, kvh, group), dtype=torch.float32, device=q.device)
    for start in range(0, skv, chunk_kv):
        kblk = k[:, start:start + chunk_kv].float()
        vblk = v[:, start:start + chunk_kv].float()
        logits = torch.einsum("bqhgd,bkhd->bqhgk", qg, kblk)
        if causal:
            kpos = start + torch.arange(chunk_kv, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]  # (sq, ckv)
            logits = torch.where(mask[None, :, None, None, :], logits,
                                 torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p,
                                                   vblk)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------


def ssd_sequential(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)       softplus-activated step sizes
    A: torch.Tensor,      # (H,)            negative decay rates
    Bm: torch.Tensor,     # (B, S, N)       input projection (G=1 group)
    Cm: torch.Tensor,     # (B, S, N)       output projection
    init_state: torch.Tensor | None = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Literal recurrence: h_t = exp(dt_t A) h_{t-1} + dt_t * x_t B_t^T ;
    y_t = h_t C_t. Returns (y (B,S,H,P) in x.dtype, final state f32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bm.float(), Cm.float()
    state = (init_state.float() if init_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32,
                              device=x.device))
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None, :])  # (b,h)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum': L[..., i, j] = sum_{k=j+1..i} dA[..., k] for
    i >= j else -inf. dA (..., Q) -> (..., Q, Q) lower-triangular log-decay
    matrix."""
    q = dA.shape[-1]
    cs = dA.cumsum(dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # cs_i - cs_j = sum_{j+1..i}
    iota = torch.arange(q, device=dA.device)
    mask = iota[:, None] >= iota[None, :]
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    init_state: torch.Tensor | None = None,
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Block decomposition of the SSD recurrence (matches ssd_sequential).

    Splits S into chunks of length Q; the within-chunk term is a masked
    attention-like product, the cross-chunk term a scan over chunk states.
    S must be a multiple of the chunk (``ops.ssd_scan`` pads with dt=0)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk

    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf = Bm.float().reshape(b, nc, chunk, n)
    Cf = Cm.float().reshape(b, nc, chunk, n)
    Af = A.float()

    dA = (dtf * Af[None, None, None, :]).movedim(-1, -2)    # (b,nc,h,q)
    L = torch.exp(_segsum(dA))                              # (b,nc,h,q,q)
    dA_cs = dA.cumsum(dim=-1)                               # (b,nc,h,q)
    dA_total = dA_cs[..., -1]                               # (b,nc,h)

    # ---- intra-chunk (diagonal blocks) ----
    scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)         # (b,nc,q,q)
    scores = scores[:, :, None] * L                          # (b,nc,h,q,q)
    xdt = xf * dtf[..., None]                                # (b,nc,q,h,p)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores, xdt)

    # ---- chunk states: contribution of each chunk to the carried state ----
    decay_to_end = torch.exp(dA_cs[..., -1:] - dA_cs)        # (b,nc,h,q)
    states = torch.einsum("bchq,bcqn,bcqhp->bchpn", decay_to_end, Bf, xdt)

    # ---- scan chunk states, keeping the state ENTERING each chunk ----
    carry = (init_state.float() if init_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32,
                              device=x.device))
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * torch.exp(dA_total[:, c])[..., None, None] \
            + states[:, c]
    entering = torch.stack(entering, dim=1)                  # (b,nc,h,p,n)

    # ---- inter-chunk output: y_off[i] = (C_i . state_in) * exp(dA_cs[i]) ----
    decay_from_start = torch.exp(dA_cs)                      # (b,nc,h,q)
    y_off = torch.einsum("bcqn,bchpn,bchq->bcqhp", Cf, entering,
                         decay_from_start)

    y = (y_diag + y_off).reshape(b, s, h, p).to(x.dtype)
    return y, carry


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N) f32
    x_t: torch.Tensor,    # (B, H, P)
    dt_t: torch.Tensor,   # (B, H)
    A: torch.Tensor,      # (H,)
    B_t: torch.Tensor,    # (B, N)
    C_t: torch.Tensor,    # (B, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD recurrence for serving. Returns (y (B,H,P) in x's
    dtype, new state f32)."""
    dtf = dt_t.float()
    decay = torch.exp(dtf * A.float()[None, :])
    upd = torch.einsum("bh,bhp,bn->bhpn", dtf, x_t.float(), B_t.float())
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, C_t.float())
    return y.to(x_t.dtype), state
