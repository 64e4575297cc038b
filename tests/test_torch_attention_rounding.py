"""The bf16 tensor-core attention kernels' roundings fit inside the card's
2e-2 bound, with a 2x margin.

``flash_attention.cu`` and ``paged_attention.cu``'s chunked prefill (bf16
q) round where the plain versions do not: QK^T takes bf16 operands (exact
products, f32 sums), and each tile's probabilities P are rounded to bf16
before P.V (l sums them unrounded). int8 pages are staged as their int8
values, which bf16 holds exactly; each score column is multiplied by its
K scale and each probability by its V scale before that rounding, so no K
or V value is rounded. A block's key range may be split over two warp
groups, each with its own online softmax over alternate 64-key tiles,
merged by logsumexp at the end. ``_tiled_bf16`` emulates exactly that in
plain PyTorch on the CPU; at the shapes ``chip_smoke.py``'s phases 3 and 6
check on the card (inputs seeded with numpy), it stays within 1e-2 of
``ref.flash_attention_chunked`` and ``ref.paged_prefill_attention_ref``
computed in f32 on the same inputs, so the card's 2e-2 bound (which adds
the output's own bf16 rounding) holds with room to spare.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

TILE = 64  # keys per warp group's tile
LOG2E = 1.4426950408889634
BOUND = 1e-2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _tiled_bf16(q, keys, vals, lim, scale, groups, k_scale=None,
                v_scale=None):
    """The kernels' arithmetic: q (..., R, D), keys/vals (..., N, D), all
    f32 holding bf16 values; lim (R,) the last key each row attends (-1:
    dead row); k_scale/v_scale (..., N): the per-key scales of int8
    keys/vals, or None. Returns (..., R, D) f32, before the output's bf16
    cast."""
    n = keys.shape[-2]
    ones = torch.ones(keys.shape[:-1])
    k_scale = ones if k_scale is None else k_scale
    v_scale = ones if v_scale is None else v_scale
    sl2 = scale * LOG2E
    kpos = torch.arange(n)
    states = []
    for g in range(groups):
        m = torch.full(q.shape[:-1], -1e30)
        l = torch.zeros(q.shape[:-1])
        acc = torch.zeros(q.shape)
        for t in range(g, math.ceil(n / TILE), groups):
            sl = slice(t * TILE, (t + 1) * TILE)
            ok = kpos[sl][None, :] <= lim[:, None]  # (R, tile)
            s = (q @ keys[..., sl, :].transpose(-1, -2)) * k_scale[..., None, sl]
            s = torch.where(ok, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1) * sl2)
            p = torch.where(ok, torch.exp2(s * sl2 - m_new[..., None]), 0.0)
            c = torch.exp2(m - m_new)
            l = l * c + p.sum(-1)
            acc = acc * c[..., None] + _bf16(p * v_scale[..., None, sl]) \
                @ vals[..., sl, :]
            m = m_new
        states.append((m, l, acc))
    m, l, acc = states[0]
    for om, ol, oacc in states[1:]:
        m_new = torch.maximum(m, om)
        a, b = torch.exp2(m - m_new), torch.exp2(om - m_new)
        l, acc, m = l * a + ol * b, acc * a[..., None] + oacc * b[..., None], m_new
    return acc / l.clamp_min(1e-30)[..., None]


# phase 6's flash checks: (B, Sq, Skv, causal) per width (H, KVH, D)
_SMOLLM = ([(8, s, s, True) for s in (1, 64, 100, 256, 300, 512)]
           + [(8, 64, 320, True), (8, 37, 300, False)]
           + [(1, s, s, True) for s in (128, 256, 512, 1024)])
_D80 = [(2, 100, 100, True), (1, 256, 256, True), (2, 37, 300, False),
        (1, 64, 320, True)]
_D128 = _D80 + [(1, 512, 512, True), (8, 256, 256, True)]
FLASH_CASES = ([("smollm", (15, 5, 64), c) for c in _SMOLLM]
               + [("zamba2", (32, 32, 80), c) for c in _D80]
               + [("llama3", (32, 8, 128), c) for c in _D128])


@pytest.mark.parametrize(
    "width,heads,case", FLASH_CASES,
    ids=[f"{w}-B{c[0]}-{c[1]}x{c[2]}-{'causal' if c[3] else 'full'}"
         for w, _, c in FLASH_CASES])
def test_flash_bf16_roundings_within_bound(width, heads, case):
    h, kvh, d = heads
    b, sq, skv, causal = case
    rng = np.random.default_rng(sq * 1009 + skv * 7 + d)
    q, k, v = (_bf16(torch.from_numpy(rng.standard_normal(shape, np.float32)))
               for shape in ((b, h, sq, d), (b, kvh, skv, d),
                             (b, kvh, skv, d)))
    want = ref.flash_attention_chunked(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, chunk_kv=256 if skv % 256 == 0 else skv).transpose(1, 2)
    pos = torch.arange(sq)
    lim = pos + (skv - sq) if causal else torch.full((sq,), skv - 1)
    kx, vx = (x.repeat_interleave(h // kvh, dim=1) for x in (k, v))
    for groups in (1, 2):
        got = _tiled_bf16(q, kx, vx, lim, d ** -0.5, groups)
        err = (got - want).abs().max().item()
        assert err <= BOUND, (groups, err)


# phase 3's prefill checks: widths (KVH, G, D, page), 704-position tables
# over 400 pages, chunks (start, valid) of 64 rows
PAGED_WIDTHS = {"smollm": (5, 3, 64, 16), "llama3": (8, 4, 128, 8),
                "zamba2": (32, 1, 80, 16)}
CHUNKS = [(23, 41), (0, 64), (300, 0)]
PAGED_CASES = [(w, quant, ch) for w in PAGED_WIDTHS for quant in (False, True)
               for ch in CHUNKS]


@pytest.mark.parametrize(
    "width,quant,chunk", PAGED_CASES,
    ids=[f"{w}-{'int8' if qt else 'bf16'}-start{c[0]}-valid{c[1]}"
         for w, qt, c in PAGED_CASES])
def test_paged_prefill_bf16_roundings_within_bound(width, quant, chunk):
    kvh, group, d, page = PAGED_WIDTHS[width]
    start, valid = chunk
    c, n_pages, mp = 64, 400, 704 // page
    rng = np.random.default_rng(kvh * 131 + d + start)
    pools = [torch.from_numpy(rng.standard_normal((n_pages, page, kvh, d),
                                                  np.float32))
             for _ in range(2)]
    scales = [None, None]
    if quant:  # what the kernel reads: int8 pages and f32 scales
        quantized = [ref.quantize_kv(p) for p in pools]
        pools = [ref.dequantize_pages(*qs) for qs in quantized]
        staged = [qv.float() for qv, _ in quantized]  # exact in bf16
        scales = [sc for _, sc in quantized]
    else:
        pools = staged = [_bf16(p) for p in pools]
    table = torch.from_numpy(rng.permutation(n_pages - 1)[:mp] + 1).int()
    q = _bf16(torch.from_numpy(rng.standard_normal((c, kvh * group, d),
                                                   np.float32)))
    want = ref.paged_prefill_attention_ref(q, pools[0], pools[1], table,
                                           start, valid)

    def per_head(x):  # (P, page, KVH, ...) -> (H, positions, ...)
        x = x[table.long()].reshape(mp * page, kvh, *x.shape[3:])
        return x.transpose(0, 1).repeat_interleave(group, dim=0)

    keys, vals = (per_head(p) for p in staged)
    k_scale, v_scale = (None if sc is None else per_head(sc) for sc in scales)
    rows = torch.arange(c)
    lim = torch.where(rows < valid, start + rows, -1)
    for groups in (1, 2):
        got = _tiled_bf16(q.transpose(0, 1), keys, vals, lim, d ** -0.5,
                          groups, k_scale, v_scale).transpose(0, 1)
        err = (got - want).abs().max().item()
        assert err <= BOUND, (groups, err)
        assert (got[valid:] == 0).all()
