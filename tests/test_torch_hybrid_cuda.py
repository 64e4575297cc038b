"""The hybrid (zamba2) SSM engine on the card: kernel streams equal plain
streams, and a bf16 run takes the tensor-core scan and chunk kernels.

zamba2-2.7b at full width (d_model 2560, 32 heads of D 80, 80 SSD heads of
P 64, N 64) cut to 12 layers (two groups of the shared block and six
Mamba2 layers), seeded random weights. Marked ``cuda``: these skip
without a GPU. No JAX here, so they run on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_hybrid_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import paged_attention as pk  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Request, SamplingParams, SSMEngine  # noqa: E402

LAYERS = 12
KW = dict(max_len=256, max_slots=4, prefill_chunk=64, page_size=16,
          device="cuda")


def _cfg(dtype):
    return dataclasses.replace(ARCHS["zamba2-2.7b"], dtype=dtype,
                               num_layers=LAYERS)


def _requests(cfg, n=3, new=8):
    rng = np.random.default_rng(0)
    return [Request(f"r{i}", rng.integers(1, cfg.vocab_size,
                                          int(rng.integers(60, 150))).tolist(),
                    sampling=SamplingParams(max_new_tokens=new))
            for i in range(n)]


def _streams(engine, reqs):
    return [r.tokens for r in engine.generate(reqs)]


@pytest.mark.cuda
def test_hybrid_kernel_streams_equal_plain_streams():
    """f32 with TF32 off: the hybrid engine's greedy streams through the
    kernels (paged decode and chunk, SSD scan and decode) equal those
    through the plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg("float32")
    params = build_model(cfg, device="cuda").init(seed=1)
    pk.reset_launches()
    sk.reset_launches()
    got = _streams(SSMEngine(cfg, params, **KW), _requests(cfg))
    assert pk.LAUNCHES["paged_attention_bkgd"] > 0
    assert pk.LAUNCHES["paged_prefill_attention_ckgd"] > 0
    assert sk.LAUNCHES["ssd_scan_bshp"] > 0
    assert sk.LAUNCHES["ssd_decode_step_bh"] > 0
    want = _streams(SSMEngine(cfg, params, attn_impl="ref", ssd_impl="ref",
                              **KW), _requests(cfg))
    assert got == want


@pytest.mark.cuda
def test_hybrid_bf16_takes_the_tensor_core_kernels():
    """bf16: every scan launch takes the tensor-core kernel
    (``LAUNCHES_BY_PATH``), and the device trace shows the tensor-core
    chunk kernel and the split decode kernel, never the CUDA-core
    templates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg("bfloat16")
    params = build_model(cfg, device="cuda").init(seed=0)
    engine = SSMEngine(cfg, params, **KW)
    sk.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        results = engine.generate(_requests(cfg, n=4))
        torch.cuda.synchronize()
    assert all(len(r.tokens) == 8 for r in results)
    assert sk.LAUNCHES_BY_PATH == {"mma": sk.LAUNCHES["ssd_scan_bshp"],
                                   "cuda_core": 0}
    assert sk.LAUNCHES["ssd_scan_bshp"] > 0
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA}
    for shown in ("paged_prefill_mma_kernel", "paged_decode_split_kernel",
                  "ssd_scan_mma_kernel", "ssd_decode_kernel"):
        assert any(shown in n for n in names), (shown, sorted(names)[:40])
    for barred in ("paged_prefill_f32_kernel", "ssd_scan_kernel"):
        assert not any(barred in n for n in names), barred
