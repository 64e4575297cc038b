"""The port's whole-prompt serving paths against the JAX engines.

The lockstep ``GenerationEngine`` (left-padded micro-batches, dense KV
cache) and the paged ``ContinuousBatchingEngine`` with whole-prompt
prefill (``prefill_chunk=None``) serve the same requests on the same
weights in both packages (reduced smollm-360m, f32, the JAX parameters
carried across by ``params_from_jax``; the port on the CPU). Greedy and
seeded top-k/top-p streams must be byte-identical, with the same events in
the same engine steps (so the same batch composition). Also ports the JAX
package's lockstep checks: a padded batch never decodes past ``max_len``,
greedy rows stay greedy beside sampled rows, and both paged paths equal
lockstep run one request at a time.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import GenerationEngine as JLockstep  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine,
    FinishReason,
    GenerationEngine,
    Request,
    SamplingParams,
)


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS["smollm-360m"])
    jparams = jbuild(jcfg).init(jax.random.key(0))
    cfg = reduced(ARCHS["smollm-360m"])
    state = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, cfg, state


def _requests(seed, n=7, sampled_every=2):
    """(uid, prompt, sampling kwargs): prompts of 3-29 tokens, 3-10 new
    tokens, every ``sampled_every``-th request seeded top-k/top-p."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(1, 256, int(rng.integers(3, 30))).tolist()
        kw = dict(max_new_tokens=int(rng.integers(3, 11)), seed=20 + i)
        if sampled_every and i % sampled_every == 1:
            kw.update(temperature=0.8, top_k=20, top_p=0.9)
        out.append((f"r{i}", prompt, kw))
    return out


def _serve(engine, request_cls, sampling_cls, reqs):
    """Streams and the per-step event log (uid, kind, token, index)."""
    handles = [engine.submit(request_cls(uid, prompt,
                                         sampling=sampling_cls(**kw)))
               for uid, prompt, kw in reqs]
    steps = []
    while not engine.idle:
        steps.append([(e.uid, e.kind, e.token, e.index)
                      for e in engine.step()])
    return [(h.finish_reason.value, list(h.tokens)) for h in handles], steps


@pytest.mark.parametrize("sampled_every", [0, 2])
def test_lockstep_streams_match_jax(weights, sampled_every):
    jcfg, jparams, cfg, state = weights
    reqs = _requests(5 + sampled_every, sampled_every=sampled_every)
    kw = dict(max_len=48, max_batch=3)
    want, jsteps = _serve(JLockstep(jcfg, jparams, **kw), JRequest,
                          JSamplingParams, reqs)
    got, tsteps = _serve(GenerationEngine(cfg, state, device="cpu", **kw),
                         Request, SamplingParams, reqs)
    assert got == want
    assert tsteps == jsteps
    assert all(reason == "length" for reason, _ in got)


@pytest.mark.parametrize("step_mode", ["fused", "interleaved"])
def test_whole_prompt_streams_match_jax(weights, step_mode):
    jcfg, jparams, cfg, state = weights
    reqs = _requests(9)
    kw = dict(max_len=48, max_slots=3, page_size=8, prefill_chunk=None,
              step_mode=step_mode)
    jeng = JEngine(jcfg, jparams, **kw)
    teng = ContinuousBatchingEngine(cfg, state, device="cpu", **kw)
    assert not teng.prefix_sharing and teng.tiers is None  # as in JAX
    want, jsteps = _serve(jeng, JRequest, JSamplingParams, reqs)
    got, tsteps = _serve(teng, Request, SamplingParams, reqs)
    assert got == want
    assert tsteps == jsteps
    assert jeng.stats["spec_bundles"] == 0  # speculation off
    assert teng.stats == jeng.stats
    assert teng.stats["prefills"] == len(reqs)
    assert teng.stats["prefill_chunks"] == 0


def test_whole_prompt_int8_streams_match_jax(weights):
    """Whole-prompt prefill into an int8 pool: ``write_prefill_pages``
    quantizes the dense K/V as the JAX package does."""
    jcfg, jparams, cfg, state = weights
    reqs = _requests(6)
    kw = dict(max_len=48, max_slots=3, page_size=8, prefill_chunk=None,
              kv_quant="int8")
    teng = ContinuousBatchingEngine(cfg, state, device="cpu", **kw)
    want, jsteps = _serve(JEngine(jcfg, jparams, **kw), JRequest,
                          JSamplingParams, reqs)
    got, tsteps = _serve(teng, Request, SamplingParams, reqs)
    assert teng.cache.pages["k"].dtype == torch.int8
    assert got == want and tsteps == jsteps


def test_lockstep_batch_never_exceeds_max_len(weights):
    """Two requests that are individually valid but whose padded batch
    would decode past ``max_len`` (long prompt + long max_new) are split
    into separate micro-batches, so the overflow never clobbers the last
    cache position (``tests/test_engine_protocol.py``'s lockstep check)."""
    _, _, cfg, state = weights
    eng = GenerationEngine(cfg, state, max_len=48, max_batch=4, device="cpu")
    long_prompt = list(range(1, 31))
    solo = eng.generate([Request("solo", [4, 5, 6, 7], max_new_tokens=40)])[0]
    ha = eng.submit(Request("a", long_prompt, max_new_tokens=8))   # 30+8 ok
    hb = eng.submit(Request("b", [4, 5, 6, 7], max_new_tokens=40))  # 4+40 ok
    while not eng.idle:                       # together: 30+40 > 48 -> split
        eng.step()
    assert ha.finish_reason == FinishReason.LENGTH and len(ha.tokens) == 8
    assert hb.finish_reason == FinishReason.LENGTH
    assert hb.tokens == solo.tokens  # unclobbered: identical to solo run


def test_lockstep_per_request_temperature(weights):
    """Greedy rows stay greedy when batched with sampled rows
    (``tests/test_serving_paged.py``'s lockstep check)."""
    _, _, cfg, state = weights
    base = GenerationEngine(cfg, state, max_len=32, device="cpu")
    exact = base.generate([Request("g", [1, 2, 3], 6)])[0]
    mixed = base.generate([
        Request("g", [1, 2, 3], 6, temperature=0.0),
        Request("h", [1, 2, 3], 6, temperature=1.0),
    ])
    assert mixed[0].tokens == exact.tokens
    assert len(mixed[1].tokens) == 6


@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_paged_engine_matches_lockstep(weights, prefill_chunk):
    """Greedy decode through the paged engine, whole-prompt and chunked,
    equals the lockstep engine run one request at a time (the exact,
    no-padding baseline: ``tests/test_serving_paged.py``'s check)."""
    _, _, cfg, state = weights
    reqs = _requests(11, sampled_every=0)
    eng = ContinuousBatchingEngine(cfg, state, max_len=48, max_slots=3,
                                   page_size=8, prefill_chunk=prefill_chunk,
                                   device="cpu")
    out = eng.generate([Request(u, p, sampling=SamplingParams(**kw))
                        for u, p, kw in reqs])
    base = GenerationEngine(cfg, state, max_len=48, device="cpu")
    for (uid, prompt, kw), o in zip(reqs, out):
        exact = base.generate([Request(uid, prompt,
                                       sampling=SamplingParams(**kw))])[0]
        assert o.uid == uid
        assert o.tokens == exact.tokens, uid
        assert len(o.tokens) == kw["max_new_tokens"]
    assert eng.cache.pool.available + eng.cache.parked_count \
        == eng.cache.num_pages - 1


def test_lockstep_engine_defaults_to_cuda_and_refuses_other_families(weights):
    """The lockstep engine runs on ``cuda`` unless asked (and raises the
    port's typed error without a card); the ssm and hybrid families'
    dense-cache paths are ported and build; the encoder-decoder (whisper,
    ROADMAP A.11) serves a request, and so do the moe and vlm families
    (a vlm prompt after its zero vision embeddings)."""
    from repro_torch.models import build_model

    _, _, cfg, state = weights
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GenerationEngine(cfg, state)
    for arch in ("mamba2-1.3b", "zamba2-2.7b"):
        rcfg = reduced(ARCHS[arch])
        eng = GenerationEngine(
            rcfg, build_model(rcfg, device="cpu").init(seed=0), max_len=16,
            device="cpu")
        assert eng.model.cfg.family == rcfg.family
    for arch in ("dbrx-132b", "internvl2-26b"):
        rcfg = reduced(ARCHS[arch])
        eng = GenerationEngine(
            rcfg, build_model(rcfg, device="cpu").init(seed=0), max_len=16,
            device="cpu")
        handle = eng.submit(Request(arch, [5, 6, 7],
                                    sampling=SamplingParams(max_new_tokens=3)))
        while not eng.idle:
            eng.step()
        assert handle.finish_reason == FinishReason.LENGTH, arch
        assert len(handle.tokens) == 3
    wcfg = reduced(ARCHS["whisper-tiny"])
    eng = GenerationEngine(wcfg, build_model(wcfg, device="cpu").init(seed=0),
                           max_len=16, device="cpu")
    handle = eng.submit(Request("w0", [5, 6, 7],
                                sampling=SamplingParams(max_new_tokens=3)))
    while not eng.idle:
        eng.step()
    assert handle.finish_reason == FinishReason.LENGTH
    assert len(handle.tokens) == 3
