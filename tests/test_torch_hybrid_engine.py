"""The port's hybrid (zamba2) SSMEngine against the JAX SSMEngine, and the
ssm/hybrid families through the lockstep engine against JAX's.

Both packages serve the same requests on the same weights (reduced
zamba2-2.7b and mamba2-1.3b, f32, the JAX parameters carried across by
``params_from_jax``; the port on the CPU). Hybrid ``SSMEngine`` streams,
greedy and seeded top-k/top-p, must be byte-identical to JAX's with an
ample page pool (with the same prefill chunks, decode steps and
preemptions) and with one small enough that decode-time page growth
preempts; the lockstep ``GenerationEngine`` streams of both families
equal JAX's.
The hybrid arms of ``tests/test_ssm_engine.py`` are ported (snapshot
preemption refused, pages reclaimed, page pressure preempts and recovers,
an unschedulable request rejected, the SSM engine equal to lockstep for
both families), and the serve driver runs zamba2 through the SSM engine
and mamba2 through lockstep.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving import GenerationEngine as JGenerationEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import SSMEngine as JSSMEngine  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    FinishReason,
    GenerationEngine,
    Request,
    SamplingParams,
    SSMEngine,
)

REPO = Path(__file__).resolve().parents[1]
# the pool sizes of the stream tests: ample (every slot at max_len), and
# small enough that decode-time page growth preempts
HYBRID_KW = dict(max_len=96, max_slots=3, page_size=8, prefill_chunk=16)
TIGHT_PAGES = 12


def _weights(arch):
    jcfg = jreduced(JARCHS[arch])
    jparams = jbuild(jcfg).init(jax.random.key(0))
    cfg = reduced(ARCHS[arch])
    return jcfg, jparams, cfg, params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def zamba2():
    return _weights("zamba2-2.7b")


@pytest.fixture(scope="module")
def mamba2():
    return _weights("mamba2-1.3b")


def drain(engine):
    while not engine.idle:
        engine.step()


def _mixed_requests(n=6, seed=0, lo=3, hi=41):
    """(uid, prompt, sampling kwargs): prompts of lo..hi tokens (up to
    three 16-token chunks), greedy and seeded top-k/top-p alternating."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(1, 256, int(rng.integers(lo, hi))).tolist()
        kw = dict(max_new_tokens=int(rng.integers(6, 14)), seed=10 + i)
        if i % 2:
            kw.update(temperature=0.8, top_k=20, top_p=0.9)
        out.append((f"r{i}", prompt, kw))
    return out


def _port(reqs):
    return [Request(u, list(p), sampling=SamplingParams(**kw))
            for u, p, kw in reqs]


def _jax(reqs):
    return [JRequest(u, list(p), sampling=JSamplingParams(**kw))
            for u, p, kw in reqs]


STATS = ("prefill_chunks", "decode_steps", "preemptions")


@pytest.fixture(scope="module")
def jax_hybrid(zamba2):
    """The JAX hybrid engine's streams and step counts on the mixed
    requests, with an ample pool."""
    jcfg, jparams, _, _ = zamba2
    jeng = JSSMEngine(jcfg, jparams, **HYBRID_KW)
    streams = {r.uid: r.tokens for r in jeng.generate(_jax(_mixed_requests()))}
    return streams, {k: jeng.stats[k] for k in STATS}


@pytest.mark.parametrize("num_pages", [None, TIGHT_PAGES],
                         ids=["ample", "page-pressure"])
def test_hybrid_streams_match_jax_engine(zamba2, jax_hybrid, num_pages):
    """Greedy and seeded streams equal JAX's: with an ample pool also the
    chunk, step and preemption counts; over the small pool decode-time
    page growth preempts (organically, youngest first), and the streams
    still equal JAX's unpreempted ones."""
    _, _, cfg, state = zamba2
    want, want_stats = jax_hybrid
    eng = SSMEngine(cfg, state, num_pages=num_pages, device="cpu",
                    **HYBRID_KW)
    got = eng.generate(_port(_mixed_requests()))
    assert {r.uid: r.tokens for r in got} == want
    assert all(r.finish_reason == FinishReason.LENGTH for r in got)
    if num_pages is None:
        assert {k: eng.stats[k] for k in STATS} == want_stats
        assert want_stats["preemptions"] == 0
    else:
        assert eng.stats["preemptions"] > 0
    assert eng.cache.pages["k"].shape[0] == cfg.num_layers // cfg.attn_every
    assert eng.cache.pool.available == eng.cache.num_pages - 1


def test_snapshot_preemption_rejected_on_hybrid(zamba2):
    _, _, cfg, state = zamba2
    eng = SSMEngine(cfg, state, max_len=64, max_slots=2, page_size=8,
                    device="cpu")
    eng.submit(Request("h", [1, 2, 3], max_new_tokens=8))
    while not eng._has_decodable():
        eng.step()
    with pytest.raises(ValueError, match="pure-SSM"):
        eng.preempt_youngest(snapshot=True)
    eng.abort_all()
    drain(eng)


def test_hybrid_serves_and_reclaims_pages(zamba2):
    _, _, cfg, state = zamba2
    eng = SSMEngine(cfg, state, max_len=64, max_slots=3, page_size=8,
                    device="cpu")
    hs = [eng.submit(Request(f"r{i}", [1 + i, 2, 3], max_new_tokens=5))
          for i in range(4)]
    drain(eng)
    assert all(h.finish_reason == FinishReason.LENGTH for h in hs)
    assert eng.cache.pool.available == eng.cache.num_pages - 1
    assert eng.cache.free_slot_count == 3


def test_hybrid_page_pressure_preempts_and_recovers(zamba2):
    """A pool too small for the full batch forces organic youngest-first
    preemption during decode; every stream still finishes byte-identical
    to an unpressured run."""
    _, _, cfg, state = zamba2
    kw = dict(max_len=64, max_slots=3, page_size=8, prefill_chunk=8,
              device="cpu")
    roomy = SSMEngine(cfg, state, **kw)
    reqs = [Request(f"r{i}", [10 + i] + list(range(2, 12)), max_new_tokens=8)
            for i in range(3)]
    oracle = {r.uid: roomy.generate([Request(r.uid, list(r.prompt),
                                             sampling=r.sampling)])[0]
              for r in reqs}
    tight = SSMEngine(cfg, state, num_pages=7, **kw)
    hs = [tight.submit(Request(r.uid, list(r.prompt), sampling=r.sampling))
          for r in reqs]
    drain(tight)
    assert tight.stats["preemptions"] > 0, "pool pressure never preempted"
    for h in hs:
        assert h.finish_reason == FinishReason.LENGTH
        assert h.tokens == oracle[h.uid].tokens, h.uid


def test_hybrid_rejects_unschedulable_request(zamba2):
    _, _, cfg, state = zamba2
    eng = SSMEngine(cfg, state, max_len=256, max_slots=2, page_size=8,
                    num_pages=4, device="cpu")
    h = eng.submit(Request("big", list(range(1, 100)), max_new_tokens=50))
    assert h.finish_reason == FinishReason.REJECTED
    assert "pages" in h.error


@pytest.mark.parametrize("arch", ["mamba2", "zamba2"])
def test_ssm_engine_matches_lockstep_greedy(arch, mamba2, zamba2):
    """Greedy streams are engine-invariant: the recurrent-state engine and
    the lockstep baseline produce identical tokens for the same prompts
    (same math, different batching)."""
    _, _, cfg, state = mamba2 if arch == "mamba2" else zamba2
    reqs = [Request(f"r{i}", [1 + i, 2, 3 + i], max_new_tokens=6)
            for i in range(3)]
    ssm = SSMEngine(cfg, state, max_len=64, max_slots=3, device="cpu")
    lock = GenerationEngine(cfg, state, max_len=64, max_batch=3,
                            device="cpu")
    a = ssm.generate([Request(r.uid, list(r.prompt), sampling=r.sampling)
                      for r in reqs])
    b = lock.generate([Request(r.uid, list(r.prompt), sampling=r.sampling)
                       for r in reqs])
    for ra, rb in zip(a, b):
        assert ra.tokens == rb.tokens, ra.uid


@pytest.mark.parametrize("arch", ["mamba2", "zamba2"])
def test_lockstep_streams_match_jax(arch, mamba2, zamba2):
    """Left-padded micro-batches of 3 (the pads run through the recurrence
    in both packages), greedy and seeded rows: every stream equals the
    JAX lockstep engine's."""
    jcfg, jparams, cfg, state = mamba2 if arch == "mamba2" else zamba2
    reqs = _mixed_requests(n=5, seed=1, lo=2, hi=20)
    kw = dict(max_len=48, max_batch=3)
    want = {r.uid: r.tokens
            for r in JGenerationEngine(jcfg, jparams, **kw).generate(_jax(reqs))}
    got = GenerationEngine(cfg, state, device="cpu", **kw).generate(_port(reqs))
    assert {r.uid: r.tokens for r in got} == want
    assert all(r.finish_reason == FinishReason.LENGTH for r in got)


def test_engines_default_to_cuda(zamba2, mamba2):
    """Without ``device`` the hybrid SSM engine and the ssm/hybrid lockstep
    engine run on the card, and raise without one: nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for _, _, cfg, state in (zamba2, mamba2):
        with pytest.raises(RuntimeError, match="CUDA"):
            GenerationEngine(cfg, state)
    with pytest.raises(RuntimeError, match="CUDA"):
        SSMEngine(zamba2[2], zamba2[3])


@pytest.mark.parametrize("args,engine", [
    (["--arch", "zamba2-2.7b"], "ssm"),
    (["--engine", "lockstep", "--arch", "mamba2-1.3b"], "lockstep"),
], ids=["zamba2-ssm", "mamba2-lockstep"])
def test_serve_cli(tmp_path, args, engine):
    """``python -m repro_torch.launch.serve ... --reduced --device cpu``
    serves every request through the engine named."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args,
         "--reduced", "--device", "cpu", "--requests", "6", "--max-new",
         "4", "--workdir", str(tmp_path / "serve")],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "served 6/6 requests" in out.stdout
    assert f"engine={engine}" in out.stdout
