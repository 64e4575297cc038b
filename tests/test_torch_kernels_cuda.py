"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these skip without a GPU (the kernels have no CPU mode;
the CPU suite holds the plain versions against JAX in
``test_torch_kernels_ref.py``). No JAX here, so they run on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_on_card(dtype):
    """Each CUDA kernel against its plain version on the card (main-path
    widths: KVH 5, G 3, D 64, page 16): f32 within 1e-3, bf16 within 2e-2
    after f32 accumulation, dead rows bit-exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    tol = 1e-3 if dtype == "float32" else 2e-2
    g = torch.Generator(device="cuda").manual_seed(0)
    kvh, group, d, page, mp, npages = 5, 3, 64, 16, 8, 40
    kp = torch.randn(npages, page, kvh, d, generator=g, device="cuda").to(dt)
    vp = torch.randn(npages, page, kvh, d, generator=g, device="cuda").to(dt)
    tables = torch.stack([torch.randperm(npages - 1, device="cuda")[:mp] + 1
                          for _ in range(6)]).int()
    lengths = torch.tensor([0, 1, 15, 16, 17, 128], dtype=torch.int32,
                           device="cuda")
    q = torch.randn(6, kvh * group, d, generator=g, device="cuda").to(dt)
    out = ops.paged_attention(q, kp, vp, tables, lengths)
    want = ops.paged_attention(q, kp, vp, tables, lengths, impl="ref")
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    assert (out[0] == 0).all()
    last_pos = lengths - 1
    out = ops.paged_mixed_attention(q, kp, vp, tables, last_pos)
    want = ops.paged_mixed_attention(q, kp, vp, tables, last_pos, impl="ref")
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    c = 64
    qc = torch.randn(c, kvh * group, d, generator=g, device="cuda").to(dt)
    start = torch.tensor(9, dtype=torch.int32, device="cuda")
    valid = torch.tensor(50, dtype=torch.int32, device="cuda")
    out = ops.paged_prefill_attention(qc, kp, vp, tables[5], start, valid)
    want = ops.paged_prefill_attention(qc, kp, vp, tables[5], start, valid,
                                       impl="ref")
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    assert (out[50:] == 0).all()
