"""Differential fuzzing of the port's paged decode, chunked-prefill and mixed
CUDA kernels and of its SSD scan on the card, against the port's plain versions
(``repro_torch.kernels.ref``).

The sweeps are those of the JAX package's ``tests/test_kernel_fuzz.py``
(decode: batch, GQA grouping, page size, table width, forked tables; mixed:
decode rows, dead rows, one chunk of rows sharing a table), with head dims
mapped into the kernels' {64, 80, 128} and pages into {8, 16}, plus wide
tables (44-88 entries) that the split decode kernel cuts into several
splits, and fixed cases at dbrx-132b's and internvl2-26b's widths (48 q
over 8 kv heads: a group of 6, which the kernels' group-8 instances take
with two rows idle; D 128, page 16) in the decode, chunk, mixed and flash
sweeps. Each case runs f32 and bf16 q over a pool of q's dtype and over an
int8 pool with f32 scales; mixed runs both with and without the engine's
``num_decode`` hint (where the case has decode rows and a chunk), and
again with a dead suffix of chunk rows. Bounds: f32 1e-3, bf16 2e-2 (f32
accumulation, bf16 output), dead rows and length-0 rows exact zeros.

The chunked prefill runs the JAX package's prefill sweep (edge cases and
24 seeded ones: chunks of 1-32 rows from fresh or deep history, padded
and all-padding chunks, GQA and MQA, forked tables) with the same head-dim
and page maps, over pools of q's dtype and int8 pools (whose f32 calls
also stay within the JAX sweep's 8e-2 of attention over the unquantized
pool); and a verify-width sweep: bundles of C = k + 1 rows (k 1-8, the
engine's draft depths) with valid < C and valid = C, at the smollm,
llama3 and zamba2 widths, against ``ref.paged_verify_attention_ref``.

The SSD scan runs the JAX package's SSD sweeps (fresh and carried state,
S not a multiple of the chunk) with P mapped into {16, 64}, N into {16,
64}, S tripled (up to five of the kernel's 64-token sub-chunks), plus N
128 cases and one bf16 case at P 8, against ``ref.ssd_chunked``: bf16
within 5e-2, f32 within 1e-3 (atol and rtol, the JAX package's SSD
bounds). Every bf16 case whose P and N the tensor-core kernel takes must
go through it (``LAUNCHES_BY_PATH``), the rest through the CUDA-core
template.

The SSD scan's gradient arm trains through ``ops.ssd_scan`` on the same
sweep (the kernel's forward inside ``SSDScanFunction``, one launch, none
in backward), from zero and from an ``init_state``, with a loss whose
upstream gradient depends on y and on the final state, against the plain
version's own autograd: the x, dt, A, Bm, Cm (and state) gradients within
the SSD bounds of each gradient's largest magnitude (at least 1). The SSD
decode step runs the JAX package's decode sweep (batch 1-4, heads 1-8, P
8-64, N 16-32), f32 and bf16, ungated and with idle slots, in place,
against ``ref.ssd_decode_step``; idle slots keep their state bit for bit.

The flash kernel runs the JAX package's flash sweep (batch 1-2, Sq 16-192,
Skv >= Sq up to two blocks further, GQA 1-2, causal and not) with head
dims mapped into {64, 80, 128}, f32 and bf16, against
``ref.flash_attention_ref``; its gradient arm trains through
``ops.flash_attention`` on the same cases (the kernel's forward inside
``FlashAttentionFunction``, one launch, none in backward) with a loss whose
upstream gradient depends on the output, against the plain version's own
autograd: q, k and v gradients within the same bounds, taken relative to
each gradient's largest magnitude (at least 1).

Marked ``cuda``; no JAX here, so this runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_fuzz_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402

TOLS = {"float32": 1e-3, "bfloat16": 2e-2}
D_MAP = {8: 64, 16: 80, 32: 128}
PAGE_MAP = {4: 8, 8: 8, 16: 16}


def _cdiv(a, b):
    return -(-a // b)


FLASH_D_MAP = {16: 64, 32: 80, 64: 128}


# ---------------------------------------------------------------------------
# flash: (b, sq, skv, h, kvh, d, causal, block), the JAX sweep
# ---------------------------------------------------------------------------

def _flash_sweep():
    cases = []
    rng = np.random.default_rng(0xF1A54)
    for _ in range(10):
        bq = int(rng.choice([16, 32, 64]))
        nq = int(rng.integers(1, 4))
        nk = nq + int(rng.integers(0, 3))  # Skv >= Sq (prefill continuation)
        kvh = int(rng.choice([1, 2, 4]))
        cases.append((
            int(rng.integers(1, 3)), bq * nq, bq * nk,
            kvh * int(rng.choice([1, 2])), kvh,
            FLASH_D_MAP[int(rng.choice([16, 32, 64]))],
            bool(rng.integers(0, 2)), bq,
        ))
    # internvl2-26b / dbrx-132b: 48 q over 8 kv heads at D 128
    return cases + [(1, 256, 512, 48, 8, 128, True, 256),
                    (2, 96, 160, 48, 8, 128, False, 32)]


def _flash_case(params, dtype):
    b, sq, skv, h, kvh, d, causal, _ = params
    rng = np.random.default_rng(sum(params))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .cuda().to(getattr(torch, dtype))
               for shape in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))
    return q, k, v


_FLASH_IDS = lambda p: "b{}q{}k{}h{}g{}d{}{}blk{}".format(  # noqa: E731
    *p[:6], "c" if p[6] else "f", p[7])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", _flash_sweep(), ids=_FLASH_IDS)
def test_flash_kernel_fuzz(params, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import flash_attention_bhsd

    causal = params[6]
    q, k, v = _flash_case(params, dtype)
    got = flash_attention_bhsd(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous(), causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    _check(got.transpose(1, 2), want, torch.zeros_like(want, dtype=torch.bool),
           TOLS[dtype], f"flash {dtype} {params}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", _flash_sweep(), ids=_FLASH_IDS)
def test_flash_gradient_fuzz(params, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import flash_attention as fk

    skv, causal = params[2], params[6]
    base = _flash_case(params, dtype)
    w = torch.randn(base[0].shape, generator=torch.Generator(
        device="cuda").manual_seed(sum(params)), device="cuda")

    def grads(attend):
        q, k, v = (t.detach().clone().requires_grad_() for t in base)
        out = attend(q, k, v)
        loss = (0.5 * out.float().square() + w * out.float()).sum()
        return out, torch.autograd.grad(loss, (q, k, v))

    fk.reset_launches()
    out, got = grads(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=causal, block_kv=skv))
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    assert fk.LAUNCHES["flash_attention_bhsd"] == 1  # forward only
    _, want = grads(lambda q, k, v: ref.flash_attention_chunked(
        q, k, v, causal=causal, chunk_kv=skv))
    torch.cuda.synchronize()
    for name, g, r in zip("qkv", got, want):
        # relative to the gradient's scale (at least 1): a dv row sums the
        # upstream gradient over every query attending its key, and a bf16
        # gradient of 4-8 has 2^-5 ulps
        err = ((g.float() - r.float()).abs().max()
               / r.float().abs().max().clamp_min(1.0)).item()
        assert err <= TOLS[dtype], (
            f"flash d{name} {dtype} {params}: max err {err:.3e} of the "
            f"gradient's scale")


# ---------------------------------------------------------------------------
# decode: (b, h, kvh, d, page, mp, alias)
# ---------------------------------------------------------------------------

def _decode_sweep():
    cases = [
        (1, 4, 2, 16, 8, 1, False),
        (3, 4, 2, 16, 8, 4, False),
        (4, 8, 1, 8, 16, 2, False),
        (4, 4, 4, 32, 4, 6, True),
        (6, 4, 2, 16, 8, 3, True),
    ]
    rng = np.random.default_rng(0xDEC0DE)
    for _ in range(16):
        kvh = int(rng.choice([1, 2, 4]))
        cases.append((
            int(rng.integers(1, 7)), kvh * int(rng.choice([1, 2, 4])), kvh,
            int(rng.choice([8, 16, 32])), int(rng.choice([4, 8, 16])),
            int(rng.integers(1, 5)), bool(rng.integers(0, 2)),
        ))
    cases = [(b, h, kvh, D_MAP[d], PAGE_MAP[p], mp, a)
             for b, h, kvh, d, p, mp, a in cases]
    # the engines' widths at their table widths: several splits a row
    cases += [(8, 15, 5, 64, 16, 44, False), (8, 32, 8, 128, 8, 88, True),
              (4, 32, 32, 80, 16, 44, False), (2, 8, 1, 64, 8, 88, True)]
    # dbrx-132b / internvl2-26b: group 6 at D 128
    cases += [(8, 48, 8, 128, 16, 28, False), (3, 48, 8, 128, 16, 44, True)]
    return cases


def _pool(rng, num_pages, page, kvh, d, dtype, quant):
    k = torch.from_numpy(rng.standard_normal((num_pages, page, kvh, d))
                         .astype(np.float32)).cuda()
    v = torch.from_numpy(rng.standard_normal((num_pages, page, kvh, d))
                         .astype(np.float32)).cuda()
    if quant:
        (kq, ks), (vq, vs) = ref.quantize_kv(k), ref.quantize_kv(v)
        return kq, vq, dict(k_scale=ks, v_scale=vs)
    return k.to(dtype), v.to(dtype), {}


def _decode_case(params, seed, dtype, quant):
    b, h, kvh, d, page, mp, alias = params
    rng = np.random.default_rng(seed)
    num_pages = b * mp + 2
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    kp, vp, sc = _pool(rng, num_pages, page, kvh, d, dtype, quant)
    # lengths: an idle slot (0), a full table, the rest random
    lens = rng.integers(1, mp * page + 1, b).astype(np.int32)
    if b > 1:
        lens[0] = 0
    if b > 2:
        lens[1] = mp * page
    bt = np.zeros((b, mp), np.int32)
    nxt = 1
    for i in range(b):
        for p in range(_cdiv(int(lens[i]), page)):
            if alias and i > 1 and p < _cdiv(int(lens[1]), page) - 1:
                bt[i, p] = bt[1, p]  # shared prefix pages with row 1
            else:
                bt[i, p] = nxt
                nxt += 1
    return (q.cuda().to(dtype), kp, vp, torch.from_numpy(bt).cuda(),
            torch.from_numpy(lens).cuda(), sc)


def _check(got, want, dead, tol, what):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol}"
    assert (got[dead] == 0).all(), f"{what}: dead rows not exact zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["pool", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", _decode_sweep(),
                         ids=lambda p: "b{}h{}k{}d{}p{}m{}{}".format(
                             *p[:6], "a" if p[6] else ""))
def test_paged_decode_kernel_fuzz(params, dtype, quant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    for seed in (0, 1):
        q, kp, vp, bt, lens, sc = _decode_case(params, seed, dt, quant)
        got = ops.paged_attention(q, kp, vp, bt, lens, **sc)
        want = ops.paged_attention(q, kp, vp, bt, lens, impl="ref", **sc)
        _check(got, want, lens == 0, TOLS[dtype],
               f"decode {params} seed {seed} {dtype} int8={quant}")


# ---------------------------------------------------------------------------
# mixed: (r, h, kvh, d, page, mp, n_dead, chunk_rows)
# ---------------------------------------------------------------------------

def _mixed_sweep():
    cases = [
        (1, 4, 2, 16, 8, 1, 0, 0),
        (3, 4, 2, 16, 8, 4, 1, 0),
        (4, 8, 1, 8, 16, 2, 0, 4),
        (6, 4, 4, 32, 4, 2, 1, 3),
        (5, 4, 2, 16, 8, 3, 4, 0),
    ]
    rng = np.random.default_rng(0x313DED)
    for _ in range(16):
        kvh = int(rng.choice([1, 2, 4]))
        r = int(rng.integers(1, 9))
        page = int(rng.choice([4, 8, 16]))
        mp = int(rng.integers(1, 5))
        ck = min(int(rng.integers(0, r + 1)), mp * page)
        cases.append((
            r, kvh * int(rng.choice([1, 2, 4])), kvh,
            int(rng.choice([8, 16, 32])), page, mp,
            int(rng.integers(0, r - ck + 1)), ck,
        ))
    cases = [(r, h, kvh, D_MAP[d], PAGE_MAP[p], mp, x, ck)
             for r, h, kvh, d, p, mp, x, ck in cases]
    # the engine's fused step: 8 decode rows (one idle) + a 64-row chunk
    cases += [(72, 15, 5, 64, 16, 44, 1, 64), (40, 32, 8, 128, 8, 88, 0, 32),
              (24, 32, 32, 80, 16, 44, 2, 16)]
    # dbrx-132b's fused step: group 6 at D 128
    cases += [(72, 48, 8, 128, 16, 28, 1, 64), (11, 48, 8, 128, 16, 44, 2, 3)]
    return cases


def _mixed_case(params, seed, dtype, quant, dead_chunk):
    r, h, kvh, d, page, mp, n_dead, ck = params
    rng = np.random.default_rng(seed)
    num_pages = r * mp + 2
    q = torch.from_numpy(rng.standard_normal((r, h, d)).astype(np.float32))
    kp, vp, sc = _pool(rng, num_pages, page, kvh, d, dtype, quant)
    last = rng.integers(0, mp * page, r).astype(np.int32)
    bt = np.zeros((r, mp), np.int32)
    nxt = 1
    for i in range(r - ck):
        for p in range(_cdiv(int(last[i]) + 1, page)):
            bt[i, p] = nxt
            nxt += 1
    if ck:
        # chunk rows: one shared table, consecutive positions
        start = int(rng.integers(0, max(mp * page - ck, 1)))
        last[r - ck:] = start + np.arange(ck)
        pages = _cdiv(start + ck, page)
        bt[r - ck:, :pages] = np.arange(nxt, nxt + pages)
        if dead_chunk:
            last[r - ck // 2:] = -1  # a dead suffix of the chunk
    order = rng.permutation(r - ck)  # dead rows anywhere among the decodes
    last[order[:n_dead]] = -1
    return (q.cuda().to(dtype), kp, vp, torch.from_numpy(bt).cuda(),
            torch.from_numpy(last).cuda(), sc)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["pool", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", _mixed_sweep(),
                         ids=lambda p: "r{}h{}k{}d{}p{}m{}x{}c{}".format(*p))
def test_paged_mixed_kernel_fuzz(params, dtype, quant):
    """Generic (no hint) and, where the case has decode rows and a chunk,
    hinted (``num_decode = R - chunk rows``), each with and without a dead
    suffix of chunk rows, against the generic plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    r, ck = params[0], params[7]
    hints = [None] + ([r - ck] if 0 < ck < r else [])
    for seed in (0, 1):
        for dead_chunk in ((False, True) if ck >= 2 else (False,)):
            q, kp, vp, bt, last, sc = _mixed_case(params, seed, dt, quant,
                                                  dead_chunk)
            want = ops.paged_mixed_attention(q, kp, vp, bt, last, impl="ref",
                                             **sc)
            for hint in hints:
                got = ops.paged_mixed_attention(q, kp, vp, bt, last,
                                                num_decode=hint, **sc)
                _check(got, want, last < 0, TOLS[dtype],
                       f"mixed {params} seed {seed} {dtype} int8={quant} "
                       f"num_decode={hint} dead_chunk={dead_chunk}")


# ---------------------------------------------------------------------------
# chunked prefill: (c, start, valid, h, kvh, d, page, extra table entries)
# ---------------------------------------------------------------------------

QTOL = 8e-2  # int8 against the unquantized pool (tests/test_kernel_fuzz.py)

_PREFILL_EDGES = [
    (1, 0, 1, 4, 2, 16, 8, 1),    # single query, no history
    (1, 17, 1, 4, 1, 8, 8, 0),    # C=1 deep in history, MQA
    (3, 5, 3, 4, 4, 16, 8, 2),    # odd chunk, history mid-page, MHA
    (8, 0, 8, 4, 2, 16, 8, 0),    # chunk == page, aligned
    (8, 3, 8, 4, 2, 16, 8, 1),    # chunk straddles a page boundary
    (8, 29, 5, 8, 2, 16, 8, 1),   # multi-page history ending mid-page + pad
    (16, 8, 16, 8, 4, 32, 8, 0),  # chunk spans two whole pages
    (16, 15, 1, 4, 2, 16, 16, 1),  # one live token landing last-in-page
    (5, 0, 0, 4, 2, 16, 8, 1),    # fully padded chunk -> exact zeros
    (32, 40, 32, 4, 2, 16, 16, 0),  # big chunk over 2.5 pages of history
]


def _prefill_sweep():
    cases = list(_PREFILL_EDGES)
    rng = np.random.default_rng(0xC0FFEE)
    for _ in range(24):
        page = int(rng.choice([4, 8, 16]))
        c = int(rng.integers(1, 33))
        start = int(rng.integers(0, 4 * page))
        valid = int(rng.integers(1, c + 1))
        group = int(rng.choice([1, 2, 4]))
        kvh = int(rng.choice([1, 2, 4]))
        d = int(rng.choice([8, 16, 32]))
        cases.append((c, start, valid, kvh * group, kvh, d, page,
                      int(rng.integers(0, 3))))
    cases = [(c, st, v, h, kvh, D_MAP[d], PAGE_MAP[p], x)
             for c, st, v, h, kvh, d, p, x in cases]
    # dbrx-132b's chunks and verify bundles: group 6 at D 128
    return cases + [(64, 23, 41, 48, 8, 128, 16, 1),
                    (64, 0, 64, 48, 8, 128, 16, 0),
                    (5, 300, 4, 48, 8, 128, 16, 2)]


def _prefill_case(params, seed, dtype, quant, forked=False):
    """Pool and block table of one chunk call; ``forked`` aliases a twin's
    pages with a privately copied tail (non-monotonic page order)."""
    c, start, valid, h, kvh, d, page, extra = params
    rng = np.random.default_rng(seed)
    need = _cdiv(max(start + valid, 1), page)
    num_pages = need * (2 if forked else 1) + 3
    q = torch.from_numpy(rng.standard_normal((c, h, d)).astype(np.float32))
    kp, vp, sc = _pool(rng, num_pages, page, kvh, d, dtype, quant)
    perm = rng.permutation(np.arange(1, num_pages))
    bt = np.zeros((need + extra,), np.int32)
    bt[:need] = perm[:need]
    if forked and need > 1:
        bt[need - 1] = perm[need]
    i32 = dict(dtype=torch.int32, device="cuda")
    return (q.cuda().to(dtype), kp, vp, torch.from_numpy(bt).cuda(),
            torch.tensor(start, **i32), torch.tensor(valid, **i32), sc)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["pool", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", _prefill_sweep(),
                         ids=lambda p: "c{}s{}v{}h{}k{}d{}p{}x{}".format(*p))
def test_paged_prefill_kernel_fuzz(params, dtype, quant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    c, valid = params[0], params[2]
    dead = torch.arange(c, device="cuda") >= valid
    for seed, forked in ((0, False), (1, True)):
        q, kp, vp, bt, st, va, sc = _prefill_case(params, seed, dt, quant,
                                                  forked)
        got = ops.paged_prefill_attention(q, kp, vp, bt, st, va, **sc)
        want = ops.paged_prefill_attention(q, kp, vp, bt, st, va,
                                           impl="ref", **sc)
        what = f"prefill {params} seed {seed} {dtype} int8={quant}"
        _check(got, want, dead, TOLS[dtype], what)
        if quant and dtype == "float32":  # the quantization error itself
            kf, vf = (ref.dequantize_pages(kp, sc["k_scale"]),
                      ref.dequantize_pages(vp, sc["v_scale"]))
            err = (ops.paged_prefill_attention(q, kf, vf, bt, st, va,
                                               impl="ref")
                   - got).abs().max().item()
            assert err <= QTOL, f"{what}: int8 vs f32 pool {err:.3e}"


def _verify_sweep():
    """Bundles of C = k + 1 rows at the engines' widths (kv heads, q heads,
    D, page): every draft depth k 1-8, padded (valid < C) and full."""
    widths = [(5, 15, 64, 16), (8, 32, 128, 8), (32, 32, 80, 16)]
    rng = np.random.default_rng(0x5BEC)
    cases = []
    for k in range(1, 9):
        kvh, h, d, page = widths[k % 3]
        start = int(rng.integers(1, 6 * page))
        for valid in sorted({1, max(1, k // 2), k, k + 1}):
            cases.append((k + 1, start, valid, h, kvh, d, page, 1))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["pool", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", _verify_sweep(),
                         ids=lambda p: "c{}s{}v{}h{}k{}d{}p{}x{}".format(*p))
def test_paged_verify_width_fuzz(params, dtype, quant):
    """The chunk kernel at speculative-verify widths (C 2-9, far below its
    64-row blocks) against the verify oracle, on plain and forked tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    c, valid = params[0], params[2]
    dead = torch.arange(c, device="cuda") >= valid
    for seed, forked in ((0, False), (1, True)):
        q, kp, vp, bt, st, va, sc = _prefill_case(params, seed, dt, quant,
                                                  forked)
        got = ops.paged_prefill_attention(q, kp, vp, bt, st, va, **sc)
        kf, vf = kp, vp
        if quant:
            kf = ref.dequantize_pages(kp, sc["k_scale"])
            vf = ref.dequantize_pages(vp, sc["v_scale"])
        want = ref.paged_verify_attention_ref(q, kf, vf, bt, st, va)
        _check(got, want, dead, TOLS[dtype],
               f"verify {params} seed {seed} {dtype} int8={quant}")


# ---------------------------------------------------------------------------
# SSD scan: (b, s, h, p, n, chunk of the plain version)
# ---------------------------------------------------------------------------

SSD_TOLS = {"float32": 1e-3, "bfloat16": 5e-2}
SSD_P_MAP = {8: 16, 16: 64}
SSD_N_MAP = {16: 16, 32: 64}


def _ssd_sweep():
    """tests/test_kernel_fuzz.py's SSD sweep, mapped to the port's widths."""
    cases = []
    rng = np.random.default_rng(0x55D)
    for _ in range(8):
        chunk = int(rng.choice([8, 16, 32]))
        cases.append((
            int(rng.integers(1, 3)), chunk * int(rng.integers(1, 4))
            + int(rng.choice([0, 3])), int(rng.choice([1, 2, 4])),
            int(rng.choice([8, 16])), int(rng.choice([16, 32])), chunk,
        ))
    cases = [(b, 3 * s, h, SSD_P_MAP[p], SSD_N_MAP[n], c)
             for b, s, h, p, n, c in cases]
    # mamba2-1.3b's N, and P 8: a shape only the CUDA-core template takes
    cases += [(1, 64, 4, 64, 128, 64), (2, 200, 2, 64, 128, 32),
              (1, 131, 2, 16, 128, 64), (1, 100, 2, 8, 16, 32)]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True], ids=["fresh", "init"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", _ssd_sweep(),
                         ids=lambda p: "b{}s{}h{}p{}n{}c{}".format(*p))
def test_ssd_scan_kernel_fuzz(params, dtype, init):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, s, h, p, n, chunk = params
    dt_ = getattr(torch, dtype)
    rng = np.random.default_rng(sum(params) ^ (0x1517 if init else 0))
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (0.1 + 0.9 * rng.random((b, s, h))).astype(np.float32)
    A = (-1.0 * rng.random((h,)) - 0.1).astype(np.float32)
    Bm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    Cm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    cuda = [torch.from_numpy(a).cuda() for a in (x, dt, A, Bm, Cm, h0)]
    x, dt, A, Bm, Cm, h0 = cuda
    x, Bm, Cm = x.to(dt_), Bm.to(dt_), Cm.to(dt_)
    h0 = h0 if init else None
    sk.reset_launches()
    y, fs = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=h0)
    path = dict(sk.LAUNCHES_BY_PATH)
    yr, fsr = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=h0, chunk=chunk,
                           impl="ref")
    torch.cuda.synchronize()
    tol = SSD_TOLS[dtype]
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(fs, fsr, atol=tol, rtol=tol)
    mma = sk.scan_rows(dt_, p, n) > 0
    assert mma == (dtype == "bfloat16" and p % 16 == 0), params
    assert path == {"mma": int(mma), "cuda_core": int(not mma)}, path


def _ssd_case(params, dtype, init):
    """The sweep case's inputs on the card: x, Bm, Cm in ``dtype``."""
    b, s, h, p, n, _ = params
    rng = np.random.default_rng(sum(params) ^ (0x1517 if init else 0))
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (0.1 + 0.9 * rng.random((b, s, h))).astype(np.float32)
    A = (-1.0 * rng.random((h,)) - 0.1).astype(np.float32)
    Bm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    Cm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a).cuda()
                            for a in (x, dt, A, Bm, Cm, h0))
    dt_ = getattr(torch, dtype)
    return x.to(dt_), dt, A, Bm.to(dt_), Cm.to(dt_), (h0 if init else None)


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True], ids=["fresh", "init"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", _ssd_sweep(),
                         ids=lambda p: "b{}s{}h{}p{}n{}c{}".format(*p))
def test_ssd_scan_gradient_fuzz(params, dtype, init):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    chunk = params[5]
    base = _ssd_case(params, dtype, init)
    g = torch.Generator(device="cuda").manual_seed(sum(params))
    wy = torch.randn(base[0].shape, generator=g, device="cuda")
    ws = torch.randn(base[0].shape[0], *base[0].shape[2:], params[4],
                     generator=g, device="cuda")

    def grads(scan):
        inputs = [t if t is None else t.detach().clone().requires_grad_()
                  for t in base]
        y, fs = scan(*inputs)
        loss = (0.5 * y.float().square() + wy * y.float()).sum() \
            + (ws * fs).sum()
        return y, torch.autograd.grad(
            loss, [t for t in inputs if t is not None])

    sk.reset_launches()
    y, got = grads(lambda *a: ops.ssd_scan(*a[:5], init_state=a[5],
                                           chunk=chunk))
    assert type(y.grad_fn).__name__ == "SSDScanFunctionBackward"
    assert sk.LAUNCHES["ssd_scan_bshp"] == 1  # forward only
    _, want = grads(lambda *a: ops.ssd_scan(*a[:5], init_state=a[5],
                                            chunk=chunk, impl="ref"))
    torch.cuda.synchronize()
    tol = SSD_TOLS[dtype]
    for name, a, r in zip(("x", "dt", "A", "Bm", "Cm", "init_state"), got,
                          want):
        assert a.dtype == r.dtype, name
        err = ((a.float() - r.float()).abs().max()
               / r.float().abs().max().clamp_min(1.0)).item()
        assert err <= tol, (
            f"ssd d{name} {dtype} {params}: max err {err:.3e} of the "
            f"gradient's scale")


def _ssd_decode_sweep():
    """tests/test_kernel_fuzz.py's SSD decode sweep: (b, h, p, n)."""
    rng = np.random.default_rng(0xDECD)
    return [(int(rng.integers(1, 5)), int(rng.choice([1, 2, 4, 8])),
             int(rng.choice([8, 16, 64])), int(rng.choice([16, 32])))
            for _ in range(6)]


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True], ids=["all", "idle"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", _ssd_decode_sweep(),
                         ids=lambda p: "b{}h{}p{}n{}".format(*p))
def test_ssd_decode_kernel_fuzz(params, dtype, gated):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, h, p, n = params
    rng = np.random.default_rng(sum(params))
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x_t = rng.standard_normal((b, h, p)).astype(np.float32)
    dt_t = (0.1 + 0.9 * rng.random((b, h))).astype(np.float32)
    A = (-1.0 * rng.random((h,)) - 0.1).astype(np.float32)
    B_t = (rng.standard_normal((b, n)) / np.sqrt(n)).astype(np.float32)
    C_t = (rng.standard_normal((b, n)) / np.sqrt(n)).astype(np.float32)
    state, x_t, dt_t, A, B_t, C_t = (torch.from_numpy(a).cuda() for a in (
        state, x_t, dt_t, A, B_t, C_t))
    dt_ = getattr(torch, dtype)
    x_t, B_t, C_t = x_t.to(dt_), B_t.to(dt_), C_t.to(dt_)
    active = (torch.arange(b, device="cuda", dtype=torch.int32) % 2
              if gated else None)
    yr, sr = ops.ssd_decode_step(state.clone(), x_t, dt_t, A, B_t, C_t,
                                 active=active, impl="ref")
    before = state.clone()
    sk.reset_launches()
    y, s_out = ops.ssd_decode_step(state, x_t, dt_t, A, B_t, C_t,
                                   active=active)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_decode_step_bh"] == 1
    assert s_out.data_ptr() == state.data_ptr()
    tol = SSD_TOLS[dtype]
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, sr, atol=tol, rtol=tol)
    if gated:
        idle = active == 0
        assert torch.equal(state[idle], before[idle])
