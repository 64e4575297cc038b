"""Differential fuzzing of the port's paged decode and mixed CUDA kernels and
of its SSD scan on the card, against the port's plain versions
(``repro_torch.kernels.ref``).

The sweeps are those of the JAX package's ``tests/test_kernel_fuzz.py``
(decode: batch, GQA grouping, page size, table width, forked tables; mixed:
decode rows, dead rows, one chunk of rows sharing a table), with head dims
mapped into the kernels' {64, 80, 128} and pages into {8, 16}, plus wide
tables (44-88 entries) that the split decode kernel cuts into several
splits. Each case runs f32 and bf16 q over a pool of q's dtype and over an
int8 pool with f32 scales; mixed runs both with and without the engine's
``num_decode`` hint (where the case has decode rows and a chunk), and
again with a dead suffix of chunk rows. Bounds: f32 1e-3, bf16 2e-2 (f32
accumulation, bf16 output), dead rows and length-0 rows exact zeros.

The SSD scan runs the JAX package's SSD sweeps (fresh and carried state,
S not a multiple of the chunk) with P mapped into {16, 64}, N into {16,
64}, S tripled (up to five of the kernel's 64-token sub-chunks), plus N
128 cases and one bf16 case at P 8, against ``ref.ssd_chunked``: bf16
within 5e-2, f32 within 1e-3 (atol and rtol, the JAX package's SSD
bounds). Every bf16 case whose P and N the tensor-core kernel takes must
go through it (``LAUNCHES_BY_PATH``), the rest through the CUDA-core
template.

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
