"""Protocol conformance of the port's engines: the paged, the lockstep and
the SSM engine behind one contract.

The port of ``tests/test_engine_protocol.py`` for ``repro_torch``: every
test is parameterized over ``ContinuousBatchingEngine`` (paged, reduced
smollm-360m), ``GenerationEngine`` (lockstep micro-batches chunked into
steps, reduced smollm-360m) and ``SSMEngine`` (per-slot recurrent state,
reduced mamba2-1.3b) on the CPU, with the port's own seeded weights —
streaming delta ordering, cancellation mid-decode and while queued, stop
tokens, typed rejections, duplicate uids, seeded reproducibility across
batch composition, abort, the ``generate`` wrapper, and the paged engine's
preemption finish and seamless re-streaming. The lockstep engine's own
batch bound is checked in ``tests/test_torch_lockstep.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine,
    EngineCore,
    FinishReason,
    GenerationEngine,
    Request,
    SamplingParams,
    SSMEngine,
)


@pytest.fixture(scope="module")
def smollm():
    cfg = reduced(ARCHS["smollm-360m"])
    return cfg, build_model(cfg, device="cpu").init(seed=0)


@pytest.fixture(scope="module")
def mamba2():
    cfg = reduced(ARCHS["mamba2-1.3b"])
    return cfg, build_model(cfg, device="cpu").init(seed=0)


@pytest.fixture(params=["paged", "lockstep", "ssm"])
def make_engine(request, smollm, mamba2):
    kind = request.param
    cfg, params = mamba2 if kind == "ssm" else smollm

    def factory(**kw):
        if kind == "paged":
            return ContinuousBatchingEngine(
                cfg, params, max_len=kw.pop("max_len", 64),
                max_slots=kw.pop("slots", 3), page_size=8, device="cpu",
                **kw)
        if kind == "ssm":
            return SSMEngine(cfg, params, max_len=kw.pop("max_len", 64),
                             max_slots=kw.pop("slots", 3), device="cpu", **kw)
        return GenerationEngine(cfg, params, max_len=kw.pop("max_len", 64),
                                max_batch=kw.pop("slots", 3), device="cpu",
                                **kw)

    factory.kind = kind
    return factory


def drain(engine):
    events = []
    while not engine.idle:
        events.append(engine.step())
    return events


def test_implements_protocol(make_engine):
    assert isinstance(make_engine(), EngineCore)


def test_streaming_delta_ordering(make_engine):
    """Token deltas stream with consecutive indices, at least one delta
    arrives in an EARLIER step than the finish, and the delta stream
    reassembles exactly into the final result."""
    eng = make_engine()
    ha = eng.submit(Request("a", [1, 2, 3], max_new_tokens=5))
    hb = eng.submit(Request("b", [4, 5, 6, 7], max_new_tokens=3))
    step_batches = drain(eng)

    for h in (ha, hb):
        toks, finish_step, token_steps = [], None, []
        for sno, batch in enumerate(step_batches):
            for ev in batch:
                if ev.uid != h.uid:
                    continue
                if ev.kind == "token":
                    assert finish_step is None, "token after finish"
                    assert ev.index == len(toks)  # consecutive from 0
                    toks.append(ev.token)
                    token_steps.append(sno)
                elif ev.kind == "finish":
                    assert finish_step is None, "duplicate finish"
                    finish_step = sno
                    assert ev.finish_reason == FinishReason.LENGTH
        assert toks == h.tokens == h.result().tokens
        assert finish_step is not None
        # streaming: the first delta is observable before completion
        assert token_steps[0] < finish_step
        assert h.result().finish_reason == FinishReason.LENGTH
        assert h.ttft is not None and h.ttft > 0
        assert len(h.itl) == len(toks) - 1


def test_new_tokens_drains_incrementally(make_engine):
    eng = make_engine()
    h = eng.submit(Request("inc", [1, 2, 3], max_new_tokens=4))
    seen = []
    while not eng.idle:
        eng.step()
        seen.extend(h.new_tokens())
    assert seen == h.tokens and h.new_tokens() == []


def test_cancellation_mid_decode(make_engine):
    """Cancel after a few streamed tokens: typed ``cancelled`` finish, the
    already-streamed tokens survive on the handle, the engine keeps serving
    other requests, and (paged) every page returns to the pool."""
    eng = make_engine()
    victim = eng.submit(Request("victim", [1, 2, 3], max_new_tokens=40))
    other = eng.submit(Request("other", [4, 5, 6], max_new_tokens=6))
    while len(victim.tokens) < 2:
        eng.step()
    n = len(victim.tokens)
    assert victim.cancel() is True
    assert victim.done and victim.finish_reason == FinishReason.CANCELLED
    assert len(victim.tokens) == n  # streamed deltas are kept
    assert victim.cancel() is False  # idempotent: already finished
    events = [e for batch in drain(eng) for e in batch]
    assert any(e.uid == "victim" and e.kind == "finish" and
               e.finish_reason == FinishReason.CANCELLED for e in events)
    assert other.finish_reason == FinishReason.LENGTH
    assert len(other.tokens) == 6
    if hasattr(eng, "cache"):
        assert eng.cache.pool.available == eng.cache.num_pages - 1


def test_cancel_while_queued(make_engine):
    """A request cancelled before it was ever admitted finishes
    ``cancelled`` with zero tokens and never occupies the engine."""
    eng = make_engine()
    h = eng.submit(Request("q", [1, 2, 3], max_new_tokens=8))
    assert eng.cancel("q") is True
    assert h.finish_reason == FinishReason.CANCELLED and h.tokens == []
    events = [e for batch in drain(eng) for e in batch]
    assert [e.kind for e in events if e.uid == "q"] == ["finish"]
    assert eng.idle
    assert eng.cancel("nonexistent") is False


def test_stop_token_termination(make_engine):
    """A stop token terminates the stream at its first occurrence with
    ``FinishReason.STOP``; the stop token itself is not emitted."""
    eng = make_engine()
    base = eng.generate([Request("learn", [9, 8, 7], max_new_tokens=6)])[0]
    stop = base.tokens[-1]
    cut = base.tokens.index(stop)  # first occurrence wins
    h = eng.submit(Request("stopme", [9, 8, 7], sampling=SamplingParams(
        max_new_tokens=6, stop_tokens=(stop,))))
    drain(eng)
    assert h.finish_reason == FinishReason.STOP
    assert h.tokens == base.tokens[:cut]
    assert stop not in h.tokens


def test_rejection_surfaced_as_typed_finish(make_engine):
    """Invalid requests come back as handles already finished ``rejected``
    (submit never raises), the engine stays idle and keeps serving."""
    eng = make_engine()
    bad = [
        Request("empty", [], max_new_tokens=4),
        Request("zeronew", [1, 2], max_new_tokens=0),
        Request("toolong", list(range(1, 100)), max_new_tokens=8),
        Request("badtemp", [1, 2], sampling=SamplingParams(
            temperature=-1.0, max_new_tokens=4)),
        Request("badtopp", [1, 2], sampling=SamplingParams(
            top_p=0.0, max_new_tokens=4)),
    ]
    for r in bad:
        h = eng.submit(r)
        assert h.done and h.finish_reason == FinishReason.REJECTED, r.uid
        assert h.error
        assert h.result().finish_reason == FinishReason.REJECTED
    assert eng.idle  # rejected requests never queue
    assert eng.stats["rejected"] == len(bad)
    assert [u for u, _ in eng.drain_rejections()] == [r.uid for r in bad]
    # the deprecated raise-on-reject wrapper still raises
    with pytest.raises(ValueError, match="empty prompt"):
        eng.enqueue(Request("empty2", [], max_new_tokens=4))
    ok = eng.submit(Request("ok", [1, 2, 3], max_new_tokens=3))
    drain(eng)
    assert ok.finish_reason == FinishReason.LENGTH and len(ok.tokens) == 3


def test_duplicate_uid_rejected(make_engine):
    eng = make_engine()
    first = eng.submit(Request("dup", [1, 2, 3], max_new_tokens=8))
    again = eng.submit(Request("dup", [1, 2, 3], max_new_tokens=8))
    assert again.finish_reason == FinishReason.REJECTED
    assert "uid" in again.error
    drain(eng)
    assert first.finish_reason == FinishReason.LENGTH
    # after the first finished, the uid is free again
    fresh = eng.submit(Request("dup", [1, 2, 3], max_new_tokens=2))
    drain(eng)
    assert fresh.finish_reason == FinishReason.LENGTH


def test_seeded_sampling_batch_independent(make_engine):
    """A seeded request reproduces the same tokens regardless of batch
    composition — the RNG is keyed off (seed, token_index), never engine
    step counters."""
    eng = make_engine()
    sp = SamplingParams(temperature=1.0, seed=123, max_new_tokens=6,
                        top_k=50, top_p=0.9)
    alone = eng.generate([Request("s1", [3, 4, 5], sampling=sp)])[0]
    batched = eng.generate([
        Request("s2", [3, 4, 5], sampling=sp),
        Request("noise", [7, 7, 2], max_new_tokens=6,
                sampling=SamplingParams(temperature=1.0, seed=9,
                                        max_new_tokens=6)),
    ])[0]
    assert alone.tokens == batched.tokens


def test_abort_all(make_engine):
    eng = make_engine()
    hs = [eng.submit(Request(f"x{i}", [1, 2, 3 + i], max_new_tokens=40))
          for i in range(4)]
    eng.step()
    assert eng.abort_all() == 4
    drain(eng)
    assert all(h.finish_reason == FinishReason.CANCELLED for h in hs)
    assert eng.idle
    if hasattr(eng, "cache"):
        assert eng.cache.pool.available == eng.cache.num_pages - 1


def test_generate_wrapper_orders_results(make_engine):
    """The deprecated sync wrapper drains through the protocol and returns
    Results in submission order with typed finish reasons."""
    eng = make_engine()
    reqs = [Request(f"g{i}", [1 + i, 2, 3], max_new_tokens=2 + i)
            for i in range(4)]
    out = eng.generate(reqs)
    assert [r.uid for r in out] == [r.uid for r in reqs]
    for r, o in zip(reqs, out):
        assert len(o.tokens) == r.max_new_tokens
        assert o.finish_reason == FinishReason.LENGTH


def test_preempted_finish_reason(smollm):
    """Paged-only: under pool pressure with ``max_preemptions=0``, an
    evicted request finishes ``preempted`` instead of silently requeueing
    forever; survivors still finish exactly."""
    cfg, params = smollm
    eng = ContinuousBatchingEngine(cfg, params, max_len=40, max_slots=2,
                                   page_size=8, num_pages=6,
                                   max_preemptions=0, device="cpu")
    hs = [eng.submit(Request(f"p{i}", [100 + i] + list(range(2, 15)),
                             max_new_tokens=10))
          for i in range(3)]
    drain(eng)
    reasons = [h.finish_reason for h in hs]
    assert FinishReason.PREEMPTED in reasons
    assert FinishReason.LENGTH in reasons
    assert eng.stats["preemptions"] > 0
    preempted = next(h for h in hs if h.finish_reason == FinishReason.PREEMPTED)
    assert "preempted" in preempted.error
    assert (eng.cache.pool.available + eng.cache.parked_count
            == eng.cache.num_pages - 1)


def test_preemption_never_reemits_deltas(smollm):
    """Paged-only: with requeueing allowed, a preempted request's stream is
    seamless — indices stay consecutive, nothing is emitted twice, and the
    regenerated tokens extend (not replace) the streamed prefix."""
    cfg, params = smollm
    eng = ContinuousBatchingEngine(cfg, params, max_len=40, max_slots=2,
                                   page_size=8, num_pages=6, device="cpu")
    hs = [eng.submit(Request(f"p{i}", [100 + i] + list(range(2, 15)),
                             max_new_tokens=10))
          for i in range(3)]
    seen: dict[str, list[int]] = {h.uid: [] for h in hs}
    preempts = 0
    while not eng.idle:
        for ev in eng.step():
            if ev.kind == "token":
                assert ev.index == len(seen[ev.uid])  # no gap, no repeat
                seen[ev.uid].append(ev.token)
            elif ev.kind == "preempted":
                preempts += 1
    assert preempts > 0
    for h in hs:
        assert h.finish_reason == FinishReason.LENGTH
        assert seen[h.uid] == h.tokens and len(h.tokens) == 10
