"""ctypes wrappers for the paged-attention CUDA kernels (``csrc/paged_attention.cu``).

Three kernels over the serving page pool, each replacing a Pallas TPU
kernel of the JAX package:

* ``paged_attention_bkgd``         — decode (``repro/kernels/paged_attention.py``
  ``paged_attention_bkgd``);
* ``paged_prefill_attention_ckgd`` — chunked prefill of one sequence
  (``paged_prefill_attention_ckgd``);
* ``paged_mixed_attention_rkgd``   — the fused mixed step
  (``paged_mixed_attention_rkgd``).

Shapes follow the JAX kernels: q arrives grouped ``(N, KVH, G, D)`` and the
output has the same shape and dtype. The pages are of q's dtype, or int8
with f32 ``k_scale``/``v_scale`` of shape ``(P, page, KVH)`` (the int8
branch of the Pallas kernels; the kernel dequantizes each page as it loads
it). Head dims 64, 80 and 128.

Decode, and every mixed row without the chunk hint, runs the split page
walk: one block per (row, kv head, split) on CUDA cores, a split being a
run of consecutive logical pages, then a merge kernel that combines the
splits by logsumexp. :func:`decode_splits` picks the split count on the
host from the table width alone (about two blocks per SM), and the wrapper
allocates the f32 partials. The chunked prefill with bf16 q runs a
tensor-core kernel (``mma.sync`` products, ``cp.async`` tiles assembled
from the pages), and so do the chunk rows of a bf16 mixed step given the
engine's ``num_decode`` hint; f32 q prefill runs a CUDA-core kernel. The
``cp.async`` kernels need 16-byte aligned tensors, as torch allocates
them; a launch with any other reports error -2. Each wrapper checks
device, dtype, shape and contiguity, launches on
``torch.cuda.current_stream()``, raises when the launch reports an error,
and adds one to its entry of :data:`LAUNCHES` per call. They accept CUDA
tensors only: the plain versions for the CPU live in
:mod:`repro_torch.kernels.ref` and the choice between the two is
:mod:`repro_torch.kernels.ops`'.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches per kernel since the last reset_launches()
LAUNCHES = {"paged_attention_bkgd": 0, "paged_prefill_attention_ckgd": 0,
            "paged_mixed_attention_rkgd": 0}

HEAD_DIMS = (64, 80, 128)
MAX_GROUP = 8  # q heads per kv head the split kernel takes
BLOCKS_PER_SM = 2  # the split rule's target
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None
_sms: dict[int, int] = {}  # device index -> SM count


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def decode_splits(rows: int, kvh: int, mp: int, n_sms: int) -> tuple[int, int]:
    """The split rule of the decode kernel: ``(splits, pages_per_split)``
    for ``rows`` rows of ``kvh`` kv heads over ``mp``-entry block tables on
    a card of ``n_sms`` SMs. Enough splits for about BLOCKS_PER_SM blocks
    on every SM, at most one a page, none empty: split ``s`` covers logical
    pages ``[s * pages_per_split, (s + 1) * pages_per_split)``. It reads
    the table width only, never the lengths, so it needs nothing from the
    device."""
    mp = max(mp, 1)
    pairs = max(rows * kvh, 1)
    want = max(1, min(mp, -(-BLOCKS_PER_SM * n_sms // pairs)))
    pps = -(-mp // want)
    return -(-mp // pps), pps


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _splits_and_partials(rows, kvh, group, d, mp, device):
    """The split rule's choice for ``rows`` rows and, for more than one
    split, the f32 partials the kernel fills: rows x KVH x splits x G x
    (D + 2) (acc, then m and l)."""
    splits, pps = decode_splits(rows, kvh, mp, _sm_count(device))
    partials = None
    if splits > 1:
        partials = torch.empty(rows * kvh * splits * group * (d + 2),
                               dtype=torch.float32, device=device)
    return splits, pps, partials


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        # q, k, v, k_scale, v_scale, tables, lengths, out, partials;
        # b, kvh, group, head_dim, page, mp, splits, pages_per_split
        lib.paged_attention_decode.argtypes = (
            [_P] * 9 + [_I] * 8 + [ctypes.c_float, _I, _P])
        # ... the same with num_decode after pages_per_split
        lib.paged_attention_mixed.argtypes = (
            [_P] * 9 + [_I] * 9 + [ctypes.c_float, _I, _P])
        # q, k, v, k_scale, v_scale, table, start, valid, out
        lib.paged_attention_prefill.argtypes = (
            [_P] * 9 + [_I] * 6 + [ctypes.c_float, _I, _P])
        for fn in (lib.paged_attention_decode, lib.paged_attention_mixed,
                   lib.paged_attention_prefill):
            fn.restype = _I
        _lib = lib
    return _lib


def _check(q, k_pages, v_pages, ints: dict, k_scale=None, v_scale=None):
    """Validate the operands shared by all three kernels; returns
    (kvh, group, d, page, dtype code, k_scale pointer, v_scale pointer),
    the pointers None (null) for pages of q's dtype."""
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"q must be (N, KVH, G, D) and pages (P, page, KVH, "
                         f"D); got {tuple(q.shape)}, {tuple(k_pages.shape)}")
    n, kvh, group, d = q.shape
    _, page, pkvh, pd = k_pages.shape
    if (pkvh, pd) != (kvh, d) or v_pages.shape != k_pages.shape:
        raise ValueError(f"page pool {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported (kernels: {HEAD_DIMS})")
    quant = k_pages.dtype == torch.int8
    page_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPES or k_pages.dtype != page_dtype \
            or v_pages.dtype != page_dtype:
        raise TypeError(f"q must be one of {list(_DTYPES)} and k/v pages of "
                        f"q's dtype or int8; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    scales = {}
    if quant or k_scale is not None or v_scale is not None:
        if not quant or k_scale is None or v_scale is None:
            raise ValueError("k_scale and v_scale go with int8 pages, both "
                             "or neither")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or t.shape != k_pages.shape[:3]:
                raise ValueError(f"{name} must be f32 {tuple(k_pages.shape[:3])}"
                                 f"; got {t.dtype} {tuple(t.shape)}")
            scales[name] = t
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages, **scales,
               **ints}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device} "
                             f"(got {t.device}); the CPU path is ref.py")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    return (kvh, group, d, page, _DTYPES[q.dtype],
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None)


def _check_group(group: int) -> None:
    if group > MAX_GROUP:
        raise ValueError(f"{group} q heads per kv head: the decode kernel "
                         f"takes at most {MAX_GROUP}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")


def _stream(q) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def paged_attention_bkgd(
    q: torch.Tensor,             # (B, KVH, G, D) grouped query, one token per seq
    k_pages: torch.Tensor,       # (P, page, KVH, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, MP) int32
    lengths: torch.Tensor,       # (B,) int32
    *,
    k_scale: torch.Tensor | None = None,  # (P, page, KVH) f32, int8 pages
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    kvh, group, d, page, dt, ks, vs = _check(
        q, k_pages, v_pages,
        {"block_tables": block_tables, "lengths": lengths}, k_scale, v_scale)
    b = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")
    _check_group(group)
    mp = block_tables.shape[1]
    splits, pps, partials = _splits_and_partials(b, kvh, group, d, mp,
                                                 q.device)
    out = torch.empty_like(q)
    err = _library().paged_attention_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _ptr(partials), b, kvh, group, d, page, mp, splits, pps,
        scale if scale is not None else d ** -0.5, dt, _stream(q))
    _raise_on(err, "paged_attention_bkgd")
    build.count_launch((LAUNCHES, "paged_attention_bkgd"))
    return out


def paged_prefill_attention_ckgd(
    q: torch.Tensor,            # (C, KVH, G, D) grouped chunk queries, ONE seq
    k_pages: torch.Tensor,      # (P, page, KVH, D)
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (MP,) int32 the sequence's block-table row
    start: torch.Tensor,        # int32 device scalar: positions already cached
    valid: torch.Tensor,        # int32 device scalar: real chunk tokens
    *,
    k_scale: torch.Tensor | None = None,  # (P, page, KVH) f32, int8 pages
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    kvh, group, d, page, dt, ks, vs = _check(
        q, k_pages, v_pages,
        {"block_table": block_table, "start": start, "valid": valid},
        k_scale, v_scale)
    if block_table.dim() != 1 or start.numel() != 1 or valid.numel() != 1:
        raise ValueError("block_table must be (MP,), start/valid scalars")
    c = q.shape[0]
    out = torch.empty_like(q)
    err = _library().paged_attention_prefill(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
        block_table.data_ptr(), start.data_ptr(), valid.data_ptr(),
        out.data_ptr(), c, kvh, group, d, page, block_table.shape[0],
        scale if scale is not None else d ** -0.5, dt, _stream(q))
    _raise_on(err, "paged_prefill_attention_ckgd")
    build.count_launch((LAUNCHES, "paged_prefill_attention_ckgd"))
    return out


def paged_mixed_attention_rkgd(
    q: torch.Tensor,             # (R, KVH, G, D) grouped query, one row per row
    k_pages: torch.Tensor,       # (P, page, KVH, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (R, MP) int32, one block-table row per row
    last_pos: torch.Tensor,      # (R,) int32 last attendable position, -1 = dead
    *,
    k_scale: torch.Tensor | None = None,  # (P, page, KVH) f32, int8 pages
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
    num_decode: int | None = None,
) -> torch.Tensor:
    """``num_decode``: the fused step's structure hint, the caller's promise
    (as in JAX) that rows ``[num_decode, R)`` are one prefill chunk sharing
    the block-table row ``block_tables[num_decode]``, with contiguous
    positions and dead rows as a suffix. With bf16 q and ``0 < num_decode
    < R`` the decode rows take the split kernel and the chunk rows the
    tensor-core chunk kernel, which reads the chunk's pages once per kv
    head; nothing checks the promise. Otherwise (f32 q, or no hint) every
    row takes the split kernel on its own table row and ``last_pos``."""
    kvh, group, d, page, dt, ks, vs = _check(
        q, k_pages, v_pages,
        {"block_tables": block_tables, "last_pos": last_pos}, k_scale,
        v_scale)
    _check_group(group)
    r = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != r \
            or last_pos.shape != (r,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"last_pos {tuple(last_pos.shape)} do not match {r} "
                         f"rows")
    hint = num_decode if (q.dtype == torch.bfloat16 and num_decode is not None
                          and 0 < num_decode < r) else 0
    mp = block_tables.shape[1]
    splits, pps, partials = _splits_and_partials(hint or r, kvh, group, d,
                                                 mp, q.device)
    out = torch.empty_like(q)
    err = _library().paged_attention_mixed(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
        block_tables.data_ptr(), last_pos.data_ptr(), out.data_ptr(),
        _ptr(partials), r, kvh, group, d, page, mp, splits, pps, hint,
        scale if scale is not None else d ** -0.5, dt, _stream(q))
    _raise_on(err, "paged_mixed_attention_rkgd")
    build.count_launch((LAUNCHES, "paged_mixed_attention_rkgd"))
    return out
