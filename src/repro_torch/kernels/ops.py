"""Public attention and Mamba2 SSD ops: the hand-written CUDA kernel for
CUDA tensors, the plain PyTorch version for CPU tensors.

Ops: ``flash_attention`` (dense whole-sequence attention: whole-prompt
prefill), ``paged_attention`` (single-token decode over the serving page
pool),
``paged_prefill_attention`` (chunked prefill), ``paged_mixed_attention``
(decode rows + one prefill chunk, one dispatch per engine step),
``ssd_scan`` / ``ssd_decode_step`` (Mamba2).

``impl``:
  * "auto" — where the tensors lie decides: a CUDA tensor launches the
    kernel of :mod:`repro_torch.kernels.flash_attention`,
    :mod:`repro_torch.kernels.paged_attention` or
    :mod:`repro_torch.kernels.ssd_scan` (which raises on
    anything it does not take; there is no fallback), a CPU tensor runs
    :mod:`repro_torch.kernels.ref`.
  * "ref"  — the plain version on any device (tests, ``chip_smoke.py``'s
    kernel-against-plain comparison, ``--attn-impl/--ssd-impl ref``).

Contract: :mod:`repro_torch.kernels.ref` is the ground truth; on the card
each kernel matches it within the bounds ``chip_smoke.py`` states (1e-3 in
f32, as ``repro/kernels/ops.py`` states for the Pallas kernels).

int8 pages: the three paged ops take ``k_scale``/``v_scale`` (f32, one
scale per (page, position, kv head)) with int8 pools. The kernel fuses the
dequantization into its page loads; the plain path runs
``ref.dequantize_pages`` and then the unchanged f32 versions, as the JAX
ops do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.paged_attention import (
    paged_attention_bkgd,
    paged_mixed_attention_rkgd,
    paged_prefill_attention_ckgd,
)
from repro_torch.kernels.ssd_scan import ssd_decode_step_bh, ssd_scan_bshp

IMPLS = ("auto", "ref")


def _use_plain(t: torch.Tensor, impl: str, op: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"{op}: unknown impl {impl!r} (have {IMPLS})")
    if impl == "ref" or t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {t.device}")
    return False


def _use_ref(q: torch.Tensor, impl: str, k_pages: torch.Tensor, k_scale,
             v_scale, op: str) -> bool:
    """``_use_plain`` after checking the scales: both or neither, and
    exactly when the pages are int8."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{op}: k_scale and v_scale come in pairs")
    if (k_scale is not None) != (k_pages.dtype == torch.int8):
        raise ValueError(
            f"{op}: scales go with int8 pages and only with them (pages "
            f"{k_pages.dtype}, scales {'given' if k_scale is not None else 'none'})")
    return _use_plain(q, impl, op)


def _dequantized(k_pages, v_pages, k_scale, v_scale):
    """The pool the plain versions read: f32 pages for an int8 pool."""
    if k_scale is None:
        return k_pages, v_pages
    return (ref.dequantize_pages(k_pages, k_scale),
            ref.dequantize_pages(v_pages, v_scale))


def _grouped(q: torch.Tensor, kvh: int) -> torch.Tensor:
    n, h, d = q.shape
    assert kvh and h % kvh == 0, (
        f"q heads ({h}) must be a multiple of kv heads ({kvh})")
    return q.reshape(n, kvh, h // kvh, d)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    impl: str = "auto",
    block_kv: int = 256,
) -> torch.Tensor:
    """Multi-head / grouped-query attention. Returns (B, Sq, H, D).

    Keeps the JAX op's length contract: its reference scans K/V in blocks
    of ``min(block_kv, Skv)`` and refuses an Skv that is not a multiple of
    that block (``repro/kernels/ref.py`` ``flash_attention_chunked``, and
    the Pallas kernel likewise), so this op raises ``ValueError`` for the
    same inputs on every path and both packages serve the same lengths.
    The kernel itself masks ragged tiles (call
    :func:`repro_torch.kernels.flash_attention.flash_attention_bhsd`
    directly for those)."""
    skv = k.shape[1]
    chunk = min(block_kv, skv)
    if chunk and skv % chunk:
        raise ValueError(
            f"flash_attention: Skv={skv} is not a multiple of "
            f"min(block_kv={block_kv}, Skv): the reference scans K/V in "
            f"blocks of {chunk} and refuses this length")
    if _use_plain(q, impl, "flash_attention"):
        return ref.flash_attention_chunked(q, k, v, causal=causal,
                                           scale=scale, chunk_kv=block_kv)
    out = flash_attention_bhsd(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal, scale=scale)
    return out.transpose(1, 2)


def paged_attention(
    q: torch.Tensor,             # (B, H, D) one query token per sequence
    k_pages: torch.Tensor,       # (P, page, KVH, D) shared page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, MP) int32
    lengths: torch.Tensor,       # (B,) int32 valid positions per sequence
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Single-token decode attention over a paged KV cache. Returns
    (B, H, D); idle slots (length 0) return zeros, never NaN."""
    if _use_ref(q, impl, k_pages, k_scale, v_scale, "paged_attention"):
        return ref.paged_attention_ref(
            q, *_dequantized(k_pages, v_pages, k_scale, v_scale),
            block_tables, lengths, scale=scale)
    out = paged_attention_bkgd(
        _grouped(q, k_pages.shape[2]), k_pages, v_pages, block_tables,
        lengths, k_scale=k_scale, v_scale=v_scale, scale=scale)
    return out.reshape(q.shape)


def paged_prefill_attention(
    q: torch.Tensor,            # (C, H, D) one prefill chunk of ONE sequence
    k_pages: torch.Tensor,      # (P, page, KVH, D) shared page pool
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (MP,) int32 the sequence's block-table row
    start: torch.Tensor,        # int32 scalar: positions already cached
    valid: torch.Tensor,        # int32 scalar: real tokens in this chunk
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Chunked-prefill attention over a paged KV cache. Returns (C, H, D).
    The chunk's own K/V must already be in the pages; query i attends
    positions ``<= start + i``, padded queries (``i >= valid``) give zeros."""
    if _use_ref(q, impl, k_pages, k_scale, v_scale,
                "paged_prefill_attention"):
        return ref.paged_prefill_attention_ref(
            q, *_dequantized(k_pages, v_pages, k_scale, v_scale),
            block_table, start, valid, scale=scale)
    out = paged_prefill_attention_ckgd(
        _grouped(q, k_pages.shape[2]), k_pages, v_pages, block_table,
        start, valid, k_scale=k_scale, v_scale=v_scale, scale=scale)
    return out.reshape(q.shape)


def paged_mixed_attention(
    q: torch.Tensor,             # (R, H, D) one query row per batch row
    k_pages: torch.Tensor,       # (P, page, KVH, D) shared page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (R, MP) int32, one block-table row per row
    last_pos: torch.Tensor,      # (R,) int32 last attendable position, -1 = dead
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
    impl: str = "auto",
    num_decode: int | None = None,
) -> torch.Tensor:
    """Fused mixed-step attention over a paged KV cache. Returns (R, H, D);
    dead rows (``last_pos = -1``) return exact zeros.

    ``num_decode`` is an optional structure hint, the caller's promise:
    rows ``[num_decode, R)`` form one prefill chunk (one shared block-table
    row, contiguous live positions, dead suffix). The plain version then
    gathers the chunk's K/V once (:func:`ref.paged_mixed_attention_split_ref`);
    with bf16 q the kernel runs the decode rows through the split decode
    kernel and the chunk rows through the tensor-core chunk kernel, which
    reads the chunk's pages once per kv head. Without it (or with f32 q)
    every row goes through the split decode kernel on its own table row."""
    if _use_ref(q, impl, k_pages, k_scale, v_scale, "paged_mixed_attention"):
        k_pages, v_pages = _dequantized(k_pages, v_pages, k_scale, v_scale)
        r = q.shape[0]
        if num_decode is None or not 0 < num_decode < r:
            return ref.paged_mixed_attention_ref(
                q, k_pages, v_pages, block_tables, last_pos, scale=scale)
        return ref.paged_mixed_attention_split_ref(
            q, k_pages, v_pages, block_tables, last_pos, num_decode,
            scale=scale)
    out = paged_mixed_attention_rkgd(
        _grouped(q, k_pages.shape[2]), k_pages, v_pages, block_tables,
        last_pos, k_scale=k_scale, v_scale=v_scale, scale=scale,
        num_decode=num_decode)
    return out.reshape(q.shape)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------


def ssd_scan(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,   # (H,)
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 256,
    impl: str = "auto",
    init_state: torch.Tensor | None = None,  # (B, H, P, N) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B,S,H,P), final_state (B,H,P,N) f32).

    S need not divide ``chunk``: the tail is padded with dt=0 positions,
    which are exact identities on the recurrence (decay exp(0·a)=1, update
    dt·x=0), and the padded outputs are sliced off. ``init_state``
    continues a scan from a carried state (chunked prefill). The plain
    version pads here and runs ``ref.ssd_chunked`` at ``min(chunk, S)``,
    as the JAX op runs it on the CPU. On the card the kernel ignores
    ``chunk``: it walks 64-token sub-chunks (the result does not depend
    on the chunk length up to rounding), zero-fills its own ragged last
    one the same way, and loads ``init_state`` as its carried state. bf16
    with P and N multiples of 16 and N <= 256 runs on tensor cores (bf16
    operands, f32 sums, the carried state f32 throughout); other shapes
    and f32 run the CUDA-core kernel in f32 (``kernels/ssd_scan.py``)."""
    if _use_plain(x, impl, "ssd_scan"):
        s = x.shape[1]
        chunk_eff = min(chunk, s)
        pad = (chunk_eff - s % chunk_eff) % chunk_eff
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, pad))
        y, fs = ref.ssd_chunked(x, dt, A, Bm, Cm, init_state, chunk=chunk_eff)
        return (y[:, :s] if pad else y), fs
    if init_state is not None:
        init_state = init_state.float().contiguous()
    return ssd_scan_bshp(
        x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
        Bm.to(x.dtype).contiguous(), Cm.to(x.dtype).contiguous(), init_state)


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N) f32
    x_t: torch.Tensor,    # (B, H, P)
    dt_t: torch.Tensor,   # (B, H)
    A: torch.Tensor,      # (H,)
    B_t: torch.Tensor,    # (B, N)
    C_t: torch.Tensor,    # (B, N)
    *,
    impl: str = "auto",
    active: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence, advancing ``state`` (f32) IN PLACE.
    Returns (y (B,H,P), ``state``). The JAX op returns a new state and its
    engine donates the bank; here the bank is updated where it lies, so
    the kernel writes only the rows that change. (``ref.ssd_decode_step``
    is the out-of-place plain form.)

    ``active`` (B,) int gates the state writeback per row: a row with 0
    keeps its old state untouched (its y still comes from the advanced
    state), as the JAX engine's ``_mask_state`` gates its bank."""
    if _use_plain(state, impl, "ssd_decode_step"):
        y, new = ref.ssd_decode_step(state, x_t, dt_t, A, B_t, C_t)
        if active is not None:
            keep = active.to(torch.bool).reshape(-1, 1, 1, 1)
            new = torch.where(keep, new, state)
        state.copy_(new)
        return y, state
    return ssd_decode_step_bh(
        state, x_t.contiguous(), dt_t.float().contiguous(),
        A.float().contiguous(), B_t.to(x_t.dtype).contiguous(),
        C_t.to(x_t.dtype).contiguous(),
        active=None if active is None else active.to(torch.int32).contiguous())
