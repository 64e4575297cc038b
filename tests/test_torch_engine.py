"""The port's paged engine against the JAX engine, stream for stream.

Both ``ContinuousBatchingEngine``s serve the same requests on the same
weights (reduced smollm-360m, f32, the JAX parameters carried across by
``params_from_jax``; the port on the CPU). Greedy and seeded top-k/top-p
streams must be byte-identical, and every executor dispatch must have the
same composition (decode rows, chunk tokens) — in both step modes, with a
shared prompt prefix (prefix hits through the parked-page tier) and under a
pool small enough to preempt; with int8 pages (``kv_quant="int8"``) too.
The tiered engine (a pool small enough that parked pages are reclaimed and
spilled to host RAM and an ``ArtifactStore``) gives the JAX tiered engine's
streams and tier counters and the port's untiered streams, and a fresh
engine on the same store serves the rerun from persisted pages. Also runs
the port's serve driver end to end (paged chunked, paged whole-prompt,
lockstep, and int8 with the host and persisted tiers, twice on one
directory).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine,
    Request,
    SamplingParams,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS["smollm-360m"])
    jparams = jbuild(jcfg).init(jax.random.key(0))
    cfg = reduced(ARCHS["smollm-360m"])
    state = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, cfg, state


def _requests(kind):
    """(uid, prompt, sampling kwargs) per scenario."""
    rng = np.random.default_rng({"mixed": 0, "prefix": 1, "preempt": 2}[kind])
    sampled = dict(temperature=0.8, top_k=20, top_p=0.9)
    if kind == "preempt":  # tests/test_engine_protocol.py's pressure case
        return [(f"p{i}", [100 + i] + list(range(2, 15)),
                 dict(max_new_tokens=10, seed=i, **(sampled if i == 1 else {})))
                for i in range(3)]
    shared = rng.integers(1, 256, 24).tolist() if kind == "prefix" else []
    out = []
    for i in range(6):
        n = int(rng.integers(3, 30))
        prompt = shared + rng.integers(1, 256, n).tolist()
        kw = dict(max_new_tokens=int(rng.integers(4, 12)), seed=10 + i)
        if i % 2:
            kw.update(sampled)
        out.append((f"r{i}", prompt, kw))
    return out


ENGINE_KW = {
    "mixed": dict(max_len=64, max_slots=3, page_size=8, prefill_chunk=8),
    "prefix": dict(max_len=64, max_slots=3, page_size=8, prefill_chunk=8),
    "preempt": dict(max_len=40, max_slots=2, page_size=8, num_pages=6,
                    prefill_chunk=8),
}


def _record_dispatches(engine):
    """Log each executor call the engine makes (outermost only) with its
    row composition: ('step', decode rows, chunk tokens) | ('decode', active
    rows) | ('chunk', chunk tokens)."""
    log, depth = [], [0]
    ex = engine.executor

    def wrap(name, describe):
        fn = getattr(ex, name)

        def call(arg=None):
            if depth[0] == 0:
                log.append((name, *describe(arg)))
            depth[0] += 1
            try:
                return fn(arg)
            finally:
                depth[0] -= 1
        setattr(ex, name, call)

    wrap("step", lambda plan: (len(plan.decode_slots),
                               plan.chunk.valid if plan.chunk else 0))
    wrap("decode", lambda inputs: (None if inputs is None
                                   else int(inputs.active.sum()),))
    wrap("prefill_chunk", lambda work: (work.valid,))
    return log


def _serve(engine, request_cls, sampling_cls, reqs):
    log = _record_dispatches(engine)
    handles = [engine.submit(request_cls(uid, prompt,
                                         sampling=sampling_cls(**kw)))
               for uid, prompt, kw in reqs]
    while not engine.idle:
        engine.step()
    return ([(h.finish_reason.value, list(h.tokens)) for h in handles], log,
            engine.stats, engine.cache.stats)


@pytest.mark.parametrize("step_mode", ["fused", "interleaved"])
@pytest.mark.parametrize("kind", ["mixed", "prefix", "preempt"])
def test_streams_match_jax_engine(weights, kind, step_mode):
    jcfg, jparams, cfg, state = weights
    reqs = _requests(kind)
    kw = dict(ENGINE_KW[kind], step_mode=step_mode)
    want, jlog, jstats, jcache = _serve(JEngine(jcfg, jparams, **kw),
                                        JRequest, JSamplingParams, reqs)
    got, tlog, tstats, tcache = _serve(
        ContinuousBatchingEngine(cfg, state, device="cpu", **kw), Request,
        SamplingParams, reqs)
    assert got == want
    assert tlog == jlog
    assert jstats["spec_bundles"] == 0  # speculation off
    assert tstats == jstats
    assert tcache == jcache
    assert all(reason == "length" for reason, _ in got)
    if kind == "prefix":
        assert tcache["prefix_hits"] > 0
    if kind == "preempt":
        assert tstats["preemptions"] > 0
    if step_mode == "fused" and kind != "preempt":
        # all three routes ran: chunk-only, mixed, decode-only
        shapes = {(d > 0, c > 0) for name, d, c in tlog if name == "step"}
        assert {(False, True), (True, True), (True, False)} <= shapes


@pytest.mark.parametrize("step_mode", ["fused", "interleaved"])
@pytest.mark.parametrize("kind", ["prefix", "preempt"])
def test_int8_streams_match_jax_engine(weights, kind, step_mode):
    """int8 pages: the new rows are quantized as JAX quantizes them, the
    pool is read through ``dequantize_pages``, and the streams, dispatches
    and stats equal the JAX int8 engine's."""
    jcfg, jparams, cfg, state = weights
    reqs = _requests(kind)
    kw = dict(ENGINE_KW[kind], step_mode=step_mode, kv_quant="int8")
    jeng = JEngine(jcfg, jparams, **kw)
    want, jlog, jstats, jcache = _serve(jeng, JRequest, JSamplingParams, reqs)
    eng = ContinuousBatchingEngine(cfg, state, device="cpu", **kw)
    got, tlog, tstats, tcache = _serve(eng, Request, SamplingParams, reqs)
    assert eng.cache.pages["k"].dtype == torch.int8
    assert got == want
    assert tlog == jlog
    assert tstats == jstats and tcache == jcache
    if kind == "prefix":
        assert tcache["prefix_hits"] > 0


TIER_KW = dict(max_len=64, max_slots=2, page_size=8, num_pages=10,
               prefill_chunk=8)


def _int_counters(tiers):
    """The tier counters that count (the *_s ones are host seconds)."""
    return {k: v for k, v in tiers.counters.items() if not k.endswith("_s")}


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_tiered_engine_matches_jax_and_untiered(weights, tmp_path, kv_quant):
    jcfg, jparams, cfg, state = weights
    reqs = _requests("prefix")
    kw = dict(TIER_KW, kv_quant=kv_quant, host_pages=4)
    jeng = JEngine(jcfg, jparams, persist_dir=str(tmp_path / "jax"), **kw)
    want = _serve(jeng, JRequest, JSamplingParams, reqs)[0]
    eng = ContinuousBatchingEngine(cfg, state, device="cpu",
                                   persist_dir=str(tmp_path / "kv"), **kw)
    got = _serve(eng, Request, SamplingParams, reqs)[0]
    t = eng.cache.tiers
    assert t.counters["reclaimed_pages"] > 0 and t.counters["spilled_pages"] > 0
    assert got == want
    assert _int_counters(t) == _int_counters(jeng.cache.tiers)
    untiered = ContinuousBatchingEngine(
        cfg, state, device="cpu", kv_tiers=False,
        **dict(TIER_KW, kv_quant=kv_quant))
    assert _serve(untiered, Request, SamplingParams, reqs)[0] == got
    # restart: flush what is parked, then a fresh engine on the same store
    # reloads the shared prefix instead of prefilling it
    eng.cache.flush_tiers()
    again = ContinuousBatchingEngine(cfg, state, device="cpu",
                                     persist_dir=str(tmp_path / "kv"), **kw)
    assert _serve(again, Request, SamplingParams, reqs)[0] == got
    assert again.cache.tiers.counters["persist_hits"] > 0
    assert again.stats["prefill_chunks"] < eng.stats["prefill_chunks"]


def test_unported_options_raise(weights):
    _, _, cfg, state = weights
    # speculative decoding is ported (ROADMAP A.6): it builds an engine
    # that serves, with streams equal to spec off (a prompt holding most of
    # the reduced vocabulary, so the ngram proposer finds its suffixes)
    reqs = [Request("s", list(range(1, 200)), max_new_tokens=6)]
    eng = ContinuousBatchingEngine(cfg, state, device="cpu", max_len=256,
                                   page_size=8, speculative="ngram")
    out = eng.generate(reqs)[0]
    off = ContinuousBatchingEngine(cfg, state, device="cpu", max_len=256,
                                   page_size=8).generate(reqs)[0]
    assert out.tokens == off.tokens and len(out.tokens) == 6
    assert eng.stats["spec_bundles"] > 0
    with pytest.raises(ValueError, match="kv_quant"):
        ContinuousBatchingEngine(cfg, state, device="cpu", kv_quant="fp8")
    # int8 pages and the host tier are ported (ROADMAP A.5): each builds
    # an engine that serves
    for kw in (dict(kv_quant="int8"), dict(host_pages=4)):
        eng = ContinuousBatchingEngine(cfg, state, device="cpu", max_len=32,
                                       page_size=8, **kw)
        out = eng.generate([Request("q", [5, 6, 7], max_new_tokens=3)])[0]
        assert len(out.tokens) == 3
    assert eng.cache.tiers.host_pages == 4
    assert eng.cache.pages["k"].dtype == torch.float32
    # whole-prompt prefill is ported: None and the CLI's 0 both build an
    # unchunked engine (prefix sharing off, as in JAX) that serves
    for chunk in (None, 0):
        eng = ContinuousBatchingEngine(cfg, state, device="cpu", max_len=32,
                                       page_size=8, prefill_chunk=chunk)
        assert eng.prefill_chunk is None and not eng.prefix_sharing
        out = eng.generate([Request("w", [5, 6, 7], max_new_tokens=3)])[0]
        assert len(out.tokens) == 3 and eng.stats["prefills"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ContinuousBatchingEngine(cfg, state)  # device defaults to cuda
        # the page pool alone resolves its device the same way
        from repro_torch.serving import PagedKVCache
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PagedKVCache(num_layers=1, num_kv_heads=1, head_dim=8,
                         dtype=torch.float32, max_slots=1, max_context=8)


def test_serve_driver_reduced_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "8", "--max-new", "4",
         "--shared-prefix", "16", "--workdir", str(tmp_path / "run")],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "served 8/8" in out.stdout
    for extra, engine in ((["--engine", "lockstep"], "lockstep"),
                          (["--prefill-chunk", "0"], "paged")):
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
             "--device", "cpu", "--requests", "6", "--max-new", "3", *extra,
             "--workdir", str(tmp_path / engine)],
            capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
        assert run.returncode == 0, run.stderr[-2000:]
        assert "served 6/6" in run.stdout
        assert f"engine={engine}," in run.stdout
    # int8 pages with the host and persisted tiers: the second run on the
    # same directory serves the shared prefix from persisted pages
    for n in (1, 2):
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
             "--device", "cpu", "--requests", "6", "--max-new", "3",
             "--shared-prefix", "32", "--kv-quant", "int8", "--host-pages",
             "8", "--persist-dir", str(tmp_path / "kv"), "--workdir",
             str(tmp_path / f"tiers{n}")],
            capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
        assert run.returncode == 0, run.stderr[-2000:]
        assert "served 6/6" in run.stdout
        hits = re.search(r"tier_hits=dev\d+/host\d+/pv(\d+);", run.stdout)
        assert hits, run.stdout
        assert (int(hits.group(1)) > 0) == (n == 2), run.stdout
    # the supervised fleet is ported (ROADMAP A.9): two engine workers
    # serve every request
    fleet = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--fleet", "2",
         "--device", "cpu", "--reduced", "--requests", "6", "--max-new",
         "3", "--workdir", str(tmp_path / "run2")],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert fleet.returncode == 0, fleet.stderr[-2000:]
    assert "fleet served 6/6" in fleet.stdout
