"""Public paged-attention ops: the hand-written CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors.

Ops: ``paged_attention`` (single-token decode over the serving page pool),
``paged_prefill_attention`` (chunked prefill), ``paged_mixed_attention``
(decode rows + one prefill chunk, one dispatch per engine step).

``impl``:
  * "auto" — where the tensors lie decides: a CUDA tensor launches the
    kernel of :mod:`repro_torch.kernels.paged_attention` (which raises on
    anything it does not take; there is no fallback), a CPU tensor runs
    :mod:`repro_torch.kernels.ref`.
  * "ref"  — the plain version on any device (tests, and ``chip_smoke.py``'s
    kernel-against-plain comparison).

Contract: :mod:`repro_torch.kernels.ref` is the ground truth; on the card
each kernel matches it within the bounds ``chip_smoke.py`` states (1e-3 in
f32, as ``repro/kernels/ops.py`` states for the Pallas kernels).

The int8-page variant (``k_scale``/``v_scale``) is not ported yet
(ROADMAP A.5) and raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import (
    paged_attention_bkgd,
    paged_mixed_attention_rkgd,
    paged_prefill_attention_ckgd,
)

IMPLS = ("auto", "ref")


def _use_ref(q: torch.Tensor, impl: str, k_scale, v_scale, op: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"{op}: unknown impl {impl!r} (have {IMPLS})")
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            f"{op}: int8 pages (k_scale/v_scale) are not ported yet "
            f"(ROADMAP A.5)")
    if impl == "ref" or q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {q.device}")
    return False


def _grouped(q: torch.Tensor, kvh: int) -> torch.Tensor:
    n, h, d = q.shape
    assert kvh and h % kvh == 0, (
        f"q heads ({h}) must be a multiple of kv heads ({kvh})")
    return q.reshape(n, kvh, h // kvh, d)


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
    if _use_ref(q, impl, k_scale, v_scale, "paged_attention"):
        return ref.paged_attention_ref(
            q, k_pages, v_pages, block_tables, lengths, scale=scale)
    out = paged_attention_bkgd(
        _grouped(q, k_pages.shape[2]), k_pages, v_pages, block_tables,
        lengths, scale=scale)
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
    if _use_ref(q, impl, k_scale, v_scale, "paged_prefill_attention"):
        return ref.paged_prefill_attention_ref(
            q, k_pages, v_pages, block_table, start, valid, scale=scale)
    out = paged_prefill_attention_ckgd(
        _grouped(q, k_pages.shape[2]), k_pages, v_pages, block_table,
        start, valid, scale=scale)
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

    ``num_decode`` is an optional structure hint: rows ``[num_decode, R)``
    form one prefill chunk (one shared block-table row, contiguous live
    positions, dead suffix). The plain version then gathers the chunk's
    K/V once (:func:`ref.paged_mixed_attention_split_ref`); the kernel is
    row-generic and ignores it."""
    if _use_ref(q, impl, k_scale, v_scale, "paged_mixed_attention"):
        r = q.shape[0]
        if num_decode is None or not 0 < num_decode < r:
            return ref.paged_mixed_attention_ref(
                q, k_pages, v_pages, block_tables, last_pos, scale=scale)
        return ref.paged_mixed_attention_split_ref(
            q, k_pages, v_pages, block_tables, last_pos, num_decode,
            scale=scale)
    out = paged_mixed_attention_rkgd(
        _grouped(q, k_pages.shape[2]), k_pages, v_pages, block_tables,
        last_pos, scale=scale)
    return out.reshape(q.shape)
