"""The split page walk of the port's decode kernel, on the CPU.

``csrc/paged_attention.cu``'s decode kernel cuts each row's block table
into splits of consecutive pages (``decode_splits``), runs one block per
(row, kv head, split) whose 4 warps each keep an online softmax over their
keys of every 32-key stage (log2 units, q pre-scaled by scale * log2 e),
merges the warps in shared memory and then the splits in a second kernel,
by logsumexp in split order. The kernel runs only on the card
(``test_torch_kernel_fuzz_cuda.py``); here the rule is checked for
coverage, and a torch emulation of the same split-and-merge arithmetic, in
f64 and f32, is held against the Pallas kernel in interpret mode and the
JAX oracle on seeded numpy inputs: lengths 0, 1, page +- 1 and a full
table, splits empty past a row's length, int8 pages with scales; f32
within 1e-5, length-0 rows exact zeros. The fused step's hinted form
(decode rows split-walked, chunk rows each masked at its own last
position over the chunk's one table row) is held against the Pallas mixed
kernel with a dead decode row and a dead chunk suffix.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    BLOCKS_PER_SM,
    decode_splits,
)

TOL = 1e-5
STAGE_KEYS, WARPS = 32, 4  # the kernel's stage and its warps' share
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# the split rule
# ---------------------------------------------------------------------------

# (rows, kv heads, page) of the three widths' decode steps: smollm-360m,
# llama3-8b, zamba2-2.7b
WIDTHS = {"smollm": (8, 5, 16), "llama3": (8, 8, 8), "zamba2": (8, 32, 16)}


@pytest.mark.parametrize("mp", [44, 64, 88])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_decode_splits_cover_every_live_page(width, mp):
    rows, kvh, page = WIDTHS[width]
    n_sms = 132
    splits, pps = decode_splits(rows, kvh, mp, n_sms)
    # no block count past the rule's: ~BLOCKS_PER_SM a SM, at most a page
    # a split, no split empty of table entries
    assert 1 <= splits <= min(mp, -(-BLOCKS_PER_SM * n_sms // (rows * kvh)))
    assert (splits - 1) * pps < mp <= splits * pps
    for length in range(mp * page + 1):
        live = -(-length // page)
        owners = [[s for s in range(splits)
                   if s * pps <= p < (s + 1) * pps] for p in range(live)]
        assert all(len(o) == 1 for o in owners), (length, owners)
        # the merge reads the splits that start before the length
        n_live = -(-length // (pps * page))
        assert n_live == len({o[0] for o in owners})


def test_decode_splits_main_path():
    """8 slots x 5 kv heads over 44-entry tables on 132 SMs: 7 splits of 7
    pages (280 blocks where one per (row, head) gave 40)."""
    assert decode_splits(8, 5, 44, 132) == (7, 7)
    assert decode_splits(72, 5, 44, 132) == (1, 44)  # generic mixed step
    assert decode_splits(0, 5, 0, 132) == (1, 1)


# ---------------------------------------------------------------------------
# the split-and-merge arithmetic
# ---------------------------------------------------------------------------

def _merge(states):
    """logsumexp merge of (m, l, acc) states (log2 units), in order."""
    m = torch.stack([s[0] for s in states]).amax(0)
    l = sum(s[1] * torch.exp2(s[0] - m) for s in states)
    acc = sum(s[2] * torch.exp2(s[0] - m)[:, None] for s in states)
    return m, l, acc


def split_decode_emulation(q, k_pages, v_pages, tables, lengths, *, n_sms,
                           dtype, k_scale=None, v_scale=None, scale=None):
    """The decode kernel's arithmetic in ``dtype``: q (B, KVH, G, D), pages
    (P, page, KVH, D) (int8 with f32 scales, dequantized element by
    element), tables (B, MP), lengths (B,) -> (B, KVH, G, D)."""
    b, kvh, g, d = q.shape
    page, mp = k_pages.shape[1], tables.shape[1]
    splits, pps = decode_splits(b, kvh, mp, n_sms)
    scale = scale if scale is not None else d ** -0.5
    qs = q.to(dtype) * (scale / math.log(2.0))
    kf, vf = k_pages.to(dtype), v_pages.to(dtype)
    if k_scale is not None:
        kf = kf * k_scale.to(dtype)[..., None]
        vf = vf * v_scale.to(dtype)[..., None]
    out = torch.zeros(b, kvh, g, d, dtype=dtype)
    for row in range(b):
        n_keys = min(max(int(lengths[row]), 0), mp * page)
        for h in range(kvh):
            parts = []
            for sp in range(splits):
                k_lo = sp * pps * page
                k_hi = min(k_lo + pps * page, n_keys)
                if k_hi <= k_lo:
                    continue  # the merge never reads it
                n_stages = -(-(k_hi - k_lo) // STAGE_KEYS)
                warps = []
                for w in range(WARPS):
                    m = torch.full((g,), NEG_INF, dtype=dtype)
                    l = torch.zeros(g, dtype=dtype)
                    acc = torch.zeros(g, d, dtype=dtype)
                    for t in range(n_stages):
                        keys = k_lo + t * STAGE_KEYS + w * 8 + torch.arange(8)
                        live = keys < k_hi
                        kk = keys.clamp_max(mp * page - 1)
                        phys = tables[row, kk // page].long()
                        kt = kf[phys, kk % page, h] * live[:, None]
                        vt = vf[phys, kk % page, h] * live[:, None]
                        s = qs[row, h] @ kt.T  # (g, 8)
                        s = torch.where(live[None, :], s,
                                        torch.tensor(-math.inf, dtype=dtype))
                        mn = torch.maximum(m, s.amax(-1))
                        corr = torch.exp2(m - mn)
                        p = torch.exp2(s - mn[:, None])
                        l = l * corr + p.sum(-1)
                        acc = acc * corr[:, None] + p @ vt
                        m = mn
                    warps.append((m, l, acc))
                parts.append(_merge(warps))
            if parts:
                _, l, acc = _merge(parts)
                out[row, h] = acc / l.clamp_min(1e-30)[:, None]
    return out


def _decode_inputs(rng, page, quant, lengths, kvh=2, g=3, d=16, mp=6):
    b = len(lengths)
    n_pages = b * mp + 1
    q = rng.standard_normal((b, kvh, g, d)).astype(np.float32)
    k = rng.standard_normal((n_pages, page, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, page, kvh, d)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, n_pages))[:mp]
                       for _ in range(b)]).astype(np.int32)
    sc = {}
    if quant:
        (kq, ks), (vq, vs) = (ref.quantize_kv(torch.from_numpy(x))
                              for x in (k, v))
        k, v = kq.numpy(), vq.numpy()
        sc = dict(k_scale=ks.numpy(), v_scale=vs.numpy())
    return q, k, v, tables, np.asarray(lengths, np.int32), sc


def _lengths(page, mp=6):
    """0, 1, page +- 1, a full table, and lengths that leave later splits
    empty (a split past the row's length writes nothing)."""
    return [0, 1, page - 1, page, page + 1, mp * page, 2 * page + 3]


# 7 rows x 2 kv heads over 6-entry tables: 6 splits of a page, 3 of two
# pages, or one split (written directly, no merge)
@pytest.mark.parametrize("n_sms", [132, 20, 2],
                         ids=["page-splits", "2-page-splits", "one-split"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("page", [8, 16])
def test_split_emulation_matches_pallas_and_oracle(page, quant, n_sms):
    rng = np.random.default_rng(10 * page + quant)
    q, k, v, tables, lengths, sc = _decode_inputs(rng, page, quant,
                                                  _lengths(page))
    assert decode_splits(7, 2, 6, n_sms)[0] == {132: 6, 20: 3, 2: 1}[n_sms]
    j = {n: jnp.asarray(a) for n, a in sc.items()}
    pallas = np.asarray(jpa.paged_attention_bkgd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lengths), interpret=True, **j))
    kd, vd = k, v
    if quant:
        kd = np.asarray(jref.dequantize_pages(jnp.asarray(k), j["k_scale"]))
        vd = np.asarray(jref.dequantize_pages(jnp.asarray(v), j["v_scale"]))
    b, kvh, g, d = q.shape
    oracle = np.asarray(jref.paged_attention_ref(
        jnp.asarray(q.reshape(b, kvh * g, d)), jnp.asarray(kd),
        jnp.asarray(vd), jnp.asarray(tables),
        jnp.asarray(lengths))).reshape(q.shape)
    t = {n: torch.from_numpy(a) for n, a in sc.items()}
    for dtype in (torch.float64, torch.float32):
        emu = split_decode_emulation(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tables), torch.from_numpy(lengths),
            n_sms=n_sms, dtype=dtype, **t).numpy()
        np.testing.assert_allclose(emu, pallas, atol=TOL, rtol=0)
        np.testing.assert_allclose(emu, oracle, atol=TOL, rtol=0)
        assert (emu[lengths == 0] == 0).all()


def test_split_emulation_of_the_main_shape():
    """The main path's rule (7 splits of 7 pages over 44-entry tables at 8
    rows x 5 kv heads, 132 SMs), the last split partly past every length,
    against the port's plain decode version."""
    rng = np.random.default_rng(44)
    lengths = [0, 1, 100, 250, 631, 15, 17, 704]
    q, k, v, tables, lengths, _ = _decode_inputs(rng, 16, False, lengths,
                                                 kvh=5, g=3, d=8, mp=44)
    b, kvh, g, d = q.shape
    want = ref.paged_attention_ref(
        torch.from_numpy(q.reshape(b, kvh * g, d)), torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(tables),
        torch.from_numpy(lengths)).reshape(q.shape)
    emu = split_decode_emulation(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(lengths), n_sms=132,
        dtype=torch.float32)
    torch.testing.assert_close(emu, want, atol=TOL, rtol=0)
    assert (emu[0] == 0).all()


# ---------------------------------------------------------------------------
# the fused step with the engine's hint
# ---------------------------------------------------------------------------

def hinted_mixed_emulation(q, k_pages, v_pages, tables, last_pos, num_decode,
                           *, n_sms, dtype):
    """Rows [0, s): the split decode walk with length last_pos + 1; rows
    [s, R): each masked at its own last_pos over the one table row
    tables[s] (the tensor-core chunk kernel's per-row limit policy)."""
    s = num_decode
    dec = split_decode_emulation(q[:s], k_pages, v_pages, tables[:s],
                                 last_pos[:s] + 1, n_sms=n_sms, dtype=dtype)
    r, kvh, g, d = q.shape
    page, mp = k_pages.shape[1], tables.shape[1]
    row = tables[s].long()
    keys = k_pages[row].reshape(mp * page, kvh, d).to(dtype)
    vals = v_pages[row].reshape(mp * page, kvh, d).to(dtype)
    qc = q[s:].to(dtype) * d ** -0.5
    scores = torch.einsum("ckgd,nkd->ckgn", qc, keys)
    ok = torch.arange(mp * page)[None, :] <= last_pos[s:, None]
    scores = torch.where(ok[:, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=dtype))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p * ok[:, None, None, :]
    chk = torch.einsum("ckgn,nkd->ckgd", p, vals) / p.sum(
        -1, keepdim=True).clamp_min(1e-30)
    return torch.cat([dec, chk])


@pytest.mark.parametrize("page", [8, 16])
def test_hinted_mixed_emulation_matches_pallas(page):
    rng = np.random.default_rng(70 + page)
    s, c, kvh, g, d, mp = 4, 9, 2, 3, 16, 5
    r = s + c
    n_pages = r * mp + 1
    q = rng.standard_normal((r, kvh, g, d)).astype(np.float32)
    k = rng.standard_normal((n_pages, page, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, page, kvh, d)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, n_pages))[:mp]
                       for _ in range(s + 1)]).astype(np.int32)
    tables = np.concatenate([tables[:s], np.repeat(tables[s:], c, 0)])
    start, valid = page + 3, 6  # the chunk straddles a page; 3 dead rows
    last = np.concatenate([
        np.array([page + 1, -1, 1, mp * page - 1]),  # a dead decode row
        np.where(np.arange(c) < valid, start + np.arange(c), -1),
    ]).astype(np.int32)
    pallas = np.asarray(jpa.paged_mixed_attention_rkgd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(last), interpret=True))
    for dtype in (torch.float64, torch.float32):
        emu = hinted_mixed_emulation(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tables), torch.from_numpy(last), s, n_sms=132,
            dtype=dtype).numpy()
        np.testing.assert_allclose(emu, pallas, atol=TOL, rtol=0)
        assert (emu[last < 0] == 0).all()
    # the port's op takes the same hint on the CPU (the plain split form)
    got = ops.paged_mixed_attention(
        torch.from_numpy(q.reshape(r, kvh * g, d)), torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(tables), torch.from_numpy(last),
        num_decode=s).numpy().reshape(q.shape)
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=0)
    assert (got[last < 0] == 0).all()
