"""The port's CUDA kernels (paged attention over pools of q's dtype and
over int8 pools, flash attention, Mamba2 SSD) against their plain versions,
on the card, at head dims 64, 80 and 128; bf16 flash and the bf16 chunked
prefill at the shapes that reach their tensor-core kernels' one- and
two-warp-group blocks.

Marked ``cuda``: these skip without a GPU (the kernels have no CPU mode;
the CPU suite holds the plain versions against JAX in
``test_torch_kernels_ref.py``). No JAX here, so they run on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bhsd  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["pool", "int8"])
@pytest.mark.parametrize("widths", [(5, 3, 64, 16), (8, 4, 128, 8),
                                    (32, 1, 80, 16)],
                         ids=["smollm", "llama3", "zamba2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_on_card(dtype, widths, quant):
    """Each paged CUDA kernel against its plain version on the card at D
    64 / G 3 / page 16 (smollm, the main path), D 128 / G 4 / page 8
    (llama3-8b) and D 80 / G 1 (zamba2-2.7b), over a pool of q's dtype or
    an int8 pool with f32 scales (whose plain version is
    ``dequantize_pages`` + the f32 versions): f32 within 1e-3, bf16 within
    2e-2 after f32 accumulation, dead rows bit-exact zeros. The mixed kernel
    also runs the engine's fused step (decode rows, then one chunk on a
    shared table row with a dead suffix) with and without the engine's
    ``num_decode`` hint."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    tol = 1e-3 if dtype == "float32" else 2e-2
    kvh, group, d, page = widths
    g = torch.Generator(device="cuda").manual_seed(0)
    mp, npages = 8, 40
    kp = torch.randn(npages, page, kvh, d, generator=g, device="cuda")
    vp = torch.randn(npages, page, kvh, d, generator=g, device="cuda")
    if quant:
        (kp, ks), (vp, vs) = ref.quantize_kv(kp), ref.quantize_kv(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, sc = kp.to(dt), vp.to(dt), {}
    tables = torch.stack([torch.randperm(npages - 1, device="cuda")[:mp] + 1
                          for _ in range(6)]).int()
    lengths = torch.tensor([0, 1, page - 1, page, page + 1, mp * page],
                           dtype=torch.int32, device="cuda")
    q = torch.randn(6, kvh * group, d, generator=g, device="cuda").to(dt)
    for op, args in ((ops.paged_attention, (tables, lengths)),
                     (ops.paged_mixed_attention, (tables, lengths - 1))):
        out = op(q, kp, vp, *args, **sc)
        want = op(q, kp, vp, *args, **sc, impl="ref")
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=0)
        assert (out[0] == 0).all()
    c = 64
    qc = torch.randn(c, kvh * group, d, generator=g, device="cuda").to(dt)
    start = torch.tensor(9, dtype=torch.int32, device="cuda")
    valid = torch.tensor(50, dtype=torch.int32, device="cuda")
    out = ops.paged_prefill_attention(qc, kp, vp, tables[5], start, valid,
                                      **sc)
    want = ops.paged_prefill_attention(qc, kp, vp, tables[5], start, valid,
                                       impl="ref", **sc)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    assert (out[50:] == 0).all()
    # the fused step as the engine calls it: the 6 decode rows, then the
    # chunk's 64 rows on table row 5 (positions 9.., 14 dead past valid),
    # with the engine's num_decode hint and without it
    cpos = torch.arange(c, dtype=torch.int32, device="cuda")
    last_pos = torch.cat([lengths - 1, torch.where(cpos < 50, 9 + cpos, -1)])
    mtables = torch.cat([tables, tables[5:6].expand(c, mp)]).contiguous()
    qm = torch.cat([q, qc])
    want = ops.paged_mixed_attention(qm, kp, vp, mtables, last_pos,
                                     impl="ref", **sc)
    for hint in (6, None):
        out = ops.paged_mixed_attention(qm, kp, vp, mtables, last_pos,
                                        num_decode=hint, **sc)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=0, msg=f"num_decode {hint}")
        assert (out[last_pos < 0] == 0).all()


@pytest.mark.cuda
def test_split_decode_after_info_query():
    """The split decode kernel's shared memory grows with its split's page
    count. Querying the kernel (``paged_attention_decode_info``, phase 2
    of ``chip_smoke.py``) for one-page splits, then launching it with one
    split over a 44-entry table (an unhinted mixed step of 72 rows), must
    still launch, and match the plain version."""
    import ctypes

    from repro_torch.kernels import paged_attention as pk

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    info = (ctypes.c_int * 4)()
    assert pk._library().paged_attention_decode_info(64, 1, 0, 3, 1, info) == 0
    g = torch.Generator(device="cuda").manual_seed(4)
    kvh, group, d, page, mp, rows = 5, 3, 64, 16, 44, 72
    kp, vp = (torch.randn(rows * mp + 1, page, kvh, d, generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    tables = torch.randperm(rows * mp, generator=g, device="cuda").reshape(
        rows, mp).int() + 1
    last_pos = torch.randint(-1, mp * page, (rows,), generator=g,
                             device="cuda", dtype=torch.int32)
    q = torch.randn(rows, kvh * group, d, generator=g,
                    device="cuda").bfloat16()
    out = ops.paged_mixed_attention(q, kp, vp, tables, last_pos)
    want = ops.paged_mixed_attention(q, kp, vp, tables, last_pos, impl="ref")
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)
    assert (out[last_pos < 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_on_card(dtype):
    """The flash kernel against its plain version at smollm widths (15 q
    over 5 kv heads, D 64), at D 128 and at zamba2's D 80 (32 heads),
    causal and not: f32 within 1e-3, bf16 within 2e-2
    after f32 accumulation. Causal with Sq = Skv at ragged lengths (1, 100,
    300: partial q and K/V tiles), causal with Sq < Skv, and non-causal
    ragged; the wrapper is called directly since the op refuses lengths
    the reference does not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    tol = 1e-3 if dtype == "float32" else 2e-2
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, h, kvh, d, sq, skv, causal in (
            (2, 15, 5, 64, 1, 1, True), (2, 15, 5, 64, 100, 100, True),
            (1, 15, 5, 64, 300, 300, True), (2, 15, 5, 64, 64, 320, True),
            (2, 15, 5, 64, 37, 300, False), (1, 8, 2, 128, 130, 130, True),
            (2, 32, 32, 80, 100, 100, True), (1, 32, 32, 80, 37, 300, False)):
        q = torch.randn(b, h, sq, d, generator=g, device="cuda").to(dt)
        k = torch.randn(b, kvh, skv, d, generator=g, device="cuda").to(dt)
        v = torch.randn(b, kvh, skv, d, generator=g, device="cuda").to(dt)
        out = flash_attention_bhsd(q, k, v, causal=causal)
        want = ref.flash_attention_chunked(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, chunk_kv=skv).transpose(1, 2)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=0)
    # through the op, at a length the reference takes
    q = torch.randn(2, 256, 15, 64, generator=g, device="cuda").to(dt)
    k = torch.randn(2, 256, 5, 64, generator=g, device="cuda").to(dt)
    torch.testing.assert_close(
        ops.flash_attention(q, k, k).float(),
        ops.flash_attention(q, k, k, impl="ref").float(), atol=tol, rtol=0)


# (q heads, kv heads, head_dim): smollm-360m, zamba2-2.7b, llama3-8b
FLASH_WIDTHS = {"D64": (15, 5, 64), "D80": (32, 32, 80), "D128": (32, 8, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 512, 512, True), (8, 256, 256, True),
                                  (2, 64, 320, True), (2, 37, 300, False),
                                  (4, 1, 1, True)],
                         ids=["whole-prompt", "lockstep", "sq<skv",
                              "non-causal", "s1"])
@pytest.mark.parametrize("width", list(FLASH_WIDTHS))
def test_flash_bf16_tensor_core_kernel(width, case):
    """The bf16 flash kernel (tensor cores, cp.async K/V tiles) against the
    plain version at the engine shapes (B 1 x S 512, B 8 x S 256), causal
    Sq 64 < Skv 320, non-causal 37 x 300 and S 1, at D 64, 80 and 128:
    within 2e-2 after f32 accumulation. A q that is not 16-byte aligned is
    refused (the kernel's copies need it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, kvh, d = FLASH_WIDTHS[width]
    b, sq, skv, causal = case
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(b, h, sq, d, generator=g, device="cuda").bfloat16()
    k = torch.randn(b, kvh, skv, d, generator=g, device="cuda").bfloat16()
    v = torch.randn(b, kvh, skv, d, generator=g, device="cuda").bfloat16()
    out = flash_attention_bhsd(q, k, v, causal=causal)
    want = ref.flash_attention_chunked(
        q.float().transpose(1, 2), k.float().transpose(1, 2),
        v.float().transpose(1, 2), causal=causal,
        chunk_kv=skv).transpose(1, 2)
    torch.testing.assert_close(out.float(), want, atol=2e-2, rtol=0)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype,
                          device="cuda")[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(RuntimeError, match="error -2"):
        flash_attention_bhsd(shifted, k, v, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("widths", [(5, 3, 64, 16), (5, 3, 64, 8),
                                    (8, 4, 128, 8), (8, 4, 128, 16),
                                    (32, 1, 80, 16)],
                         ids=["D64-page16", "D64-page8", "D128-page8",
                              "D128-page16", "D80-page16"])
def test_paged_prefill_bf16_tensor_core_kernel(widths, quant):
    """The bf16 chunked-prefill kernel (tensor cores, 64-key tiles
    assembled from pages by cp.async) over bf16 pools and int8 pools with
    f32 scales, at pages 8 and 16 and D 64, 80 and 128, against the plain
    version: a chunk straddling a page with valid < C, a full chunk from
    position 0, an all-padding chunk (exact zeros), and prefixes that are
    not a multiple of 64 (so a key tile is not a whole number of live
    pages), within 2e-2; padded rows are exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kvh, group, d, page = widths
    g = torch.Generator(device="cuda").manual_seed(2)
    mp, npages, c = 704 // page, 400, 64
    kp = torch.randn(npages, page, kvh, d, generator=g, device="cuda")
    vp = torch.randn(npages, page, kvh, d, generator=g, device="cuda")
    if quant:
        (kp, ks), (vp, vs) = ref.quantize_kv(kp), ref.quantize_kv(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, sc = kp.bfloat16(), vp.bfloat16(), {}
    table = (torch.randperm(npages - 1, generator=g, device="cuda")[:mp]
             + 1).int()
    q = torch.randn(c, kvh * group, d, generator=g, device="cuda").bfloat16()
    for start, valid in ((23, 41), (0, c), (300, 0), (100, c), (37, 50),
                         (130, 17), (575, c)):
        st = torch.tensor(start, dtype=torch.int32, device="cuda")
        va = torch.tensor(valid, dtype=torch.int32, device="cuda")
        out = ops.paged_prefill_attention(q, kp, vp, table, st, va, **sc)
        want = ops.paged_prefill_attention(q, kp, vp, table, st, va,
                                           impl="ref", **sc)
        torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                                   rtol=0, msg=f"start {start} valid {valid}")
        assert (out[valid:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_prefill_bf16_long_chunk(quant):
    """A 768-row chunk at smollm widths (180 blocks of 64 flattened rows,
    more than the card's SMs) takes the bf16 prefill kernel's one-warp-
    group blocks, where the engine's 64-row chunks take two groups: the
    same bound against the plain version, padded rows exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kvh, group, d, page, c = 5, 3, 64, 16, 768
    g = torch.Generator(device="cuda").manual_seed(3)
    mp, npages = 1024 // page, 400
    kp = torch.randn(npages, page, kvh, d, generator=g, device="cuda")
    vp = torch.randn(npages, page, kvh, d, generator=g, device="cuda")
    if quant:
        (kp, ks), (vp, vs) = ref.quantize_kv(kp), ref.quantize_kv(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, sc = kp.bfloat16(), vp.bfloat16(), {}
    table = (torch.randperm(npages - 1, generator=g, device="cuda")[:mp]
             + 1).int()
    q = torch.randn(c, kvh * group, d, generator=g, device="cuda").bfloat16()
    st = torch.tensor(100, dtype=torch.int32, device="cuda")
    va = torch.tensor(700, dtype=torch.int32, device="cuda")
    out = ops.paged_prefill_attention(q, kp, vp, table, st, va, **sc)
    want = ops.paged_prefill_attention(q, kp, vp, table, st, va, impl="ref",
                                       **sc)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)
    assert (out[700:] == 0).all()


def _ssd_inputs(g, b, s, h, p, n, dt_):
    """The JAX package's SSD test distribution (tests/test_kernels.py):
    x ~ N(0, 1), dt in [0.1, 1), A in (-1.1, -0.1], B/C ~ N(0, 1/N)."""
    x = torch.randn(b, s, h, p, generator=g, device="cuda").to(dt_)
    dt = 0.1 + 0.9 * torch.rand(b, s, h, generator=g, device="cuda")
    A = -torch.rand(h, generator=g, device="cuda") - 0.1
    Bm = (torch.randn(b, s, n, generator=g, device="cuda") / n ** 0.5).to(dt_)
    Cm = (torch.randn(b, s, n, generator=g, device="cuda") / n ** 0.5).to(dt_)
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernels_on_card(dtype):
    """Both SSD kernels against their plain versions at mamba2-1.3b widths
    (H 64, P 64, N 128): f32 within 1e-3, bf16 within 5e-2 (atol and
    rtol, the JAX package's SSD bf16 bound). Scan cases: a chunk with a
    dt = 0 tail (valid < C) from a non-zero init_state, S spanning
    several of the kernel's 64-token sub-chunks with a ragged end, and the
    engine's pattern: 7 chained 64-token calls, each from the state the
    last returned, against one plain call over the 448 tokens (rounding
    must not compound through the carried state). Decode: idle slots keep
    their state bit for bit, in place and out of place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt_ = getattr(torch, dtype)
    tol = 1e-3 if dtype == "float32" else 5e-2
    g = torch.Generator(device="cuda").manual_seed(0)
    h, p, n = 64, 64, 128
    for b, s, valid, with_init in ((1, 64, 41, True), (2, 200, 200, False)):
        x, dt, A, Bm, Cm = _ssd_inputs(g, b, s, h, p, n, dt_)
        dt[:, valid:] = 0.0
        init = (torch.randn(b, h, p, n, generator=g, device="cuda")
                if with_init else None)
        y, fs = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=init, chunk=256)
        yr, fsr = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=init, chunk=256,
                               impl="ref")
        torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(fs, fsr, atol=tol, rtol=tol)
    x, dt, A, Bm, Cm = _ssd_inputs(g, 1, 7 * 64, h, p, n, dt_)
    init = torch.randn(1, h, p, n, generator=g, device="cuda")
    yr, fsr = ops.ssd_scan(x, dt, A, Bm, Cm, init_state=init, impl="ref")
    fs, ys = init, []
    for k in range(7):
        sl = slice(64 * k, 64 * (k + 1))
        y, fs = ops.ssd_scan(x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl],
                             init_state=fs, chunk=64)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1).float(), yr.float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(fs, fsr, atol=tol, rtol=tol)
    b = 8
    state = torch.randn(b, h, p, n, generator=g, device="cuda")
    x, dt, A, Bm, Cm = _ssd_inputs(g, b, 1, h, p, n, dt_)
    x, dt, Bm, Cm = x[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0]
    active = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0], dtype=torch.int32,
                          device="cuda")
    yr, sr = ops.ssd_decode_step(state.clone(), x, dt, A, Bm, Cm,
                                 active=active, impl="ref")
    before = state.clone()
    y, s_out = ops.ssd_decode_step(state, x, dt, A, Bm, Cm, active=active)
    assert s_out.data_ptr() == state.data_ptr()
    idle = active == 0
    assert torch.equal(state[idle], before[idle])
    torch.testing.assert_close(state, sr, atol=tol, rtol=tol)
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
