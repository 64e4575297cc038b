"""The moe (dbrx-132b) and vlm (internvl2-26b) families served through the
kernels on the card, at full width and reduced depth, seeded random
weights: every request finishes by length, each kernel of the path
launches, and in f32 (TF32 off) the greedy streams through the kernels
equal those through the plain versions (``attn_impl="ref"``).

Marked ``cuda``: these skip without a GPU. No JAX here:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_vlm_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import paged_attention as pk  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine, Request,  # noqa: E402
                                 SamplingParams)

LAYERS = 2


def _requests(cfg, lens, new=8):
    rng = np.random.default_rng(0)
    return [Request(f"r{i}", rng.integers(1, cfg.vocab_size, n).tolist(),
                    sampling=SamplingParams(max_new_tokens=new))
            for i, n in enumerate(lens)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw,lens,kernels", [
    # whole-prompt prefill after 256 vision positions: buckets 16, 128 and
    # 512 (S 272 and 384, padded to 512 inside the attention, and 768)
    ("internvl2-26b", dict(max_len=800), (10, 100, 300),
     ("flash_attention_bhsd", "paged_attention_bkgd")),
    ("dbrx-132b", dict(max_len=512, prefill_chunk=64), (150, 70),
     ("paged_attention_bkgd", "paged_prefill_attention_ckgd",
      "paged_mixed_attention_rkgd")),
], ids=["internvl2", "dbrx"])
def test_serves_through_the_kernels(arch, kw, lens, kernels):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(ARCHS[arch], num_layers=LAYERS)
    kw = dict(kw, max_slots=3, page_size=16, device="cuda")
    cfg = dataclasses.replace(base, dtype="bfloat16")
    params = build_model(cfg, device="cuda").init(seed=0)
    pk.reset_launches()
    fk.reset_launches()
    out = ContinuousBatchingEngine(cfg, params, **kw).generate(
        _requests(cfg, lens))
    assert [r.finish_reason.value for r in out] == ["length"] * len(lens)
    launches = {**pk.LAUNCHES, **fk.LAUNCHES}
    assert all(launches[k] > 0 for k in kernels), launches
    del params
    cfg = dataclasses.replace(base, dtype="float32")
    params = build_model(cfg, device="cuda").init(seed=0)
    streams = {impl: [r.tokens for r in ContinuousBatchingEngine(
        cfg, params, attn_impl=impl, **kw).generate(_requests(cfg, lens))]
        for impl in ("auto", "ref")}
    assert streams["auto"] == streams["ref"]
