"""Engine-invariant stress arms of the port's tiered and int8 paged engine
and of its SSM/hybrid engine, ported from ``tests/test_serving_stress.py``
(the tiers arm, the int8 arm, the two ssm arms and the hybrid arm) with the
port's own trace, driver and invariant helpers.

A randomized submit/cancel/shared-prefix trace runs through
``ContinuousBatchingEngine.step()`` on reduced smollm-360m (f32, the
port's own seeded weights, on the CPU) with a page pool small enough that
parked prefix pages get reclaimed and preemption fires. After every step
the page pool must satisfy the scheduler/tier invariants: refcounts equal
live block-table references; free, referenced and parked pages partition
the pool; parked pages keep their prefix-index entry and content key;
the prefix index maps only full frozen pages, bijectively; slot occupancy
equals the live sequence set. At drain every handle has a typed finish
and every stream is byte-identical to an unperturbed oracle run: with
every tier engaged (parked, host RAM, a persisted ``ArtifactStore``)
against a tiers-off run, and with int8 pages against an int8 oracle.

The SSM arms run the same trace through ``SSMEngine`` on reduced
mamba2-1.3b and zamba2-2.7b: after every step the live slots and the free
list (or, hybrid, the page cache's occupancy) partition the slots and
parked state snapshots belong only to evicted-but-live requests. Forced
discard and snapshot preemptions mid-trace, an engine restart mid-trace
(a fresh engine re-serving the in-flight requests) and, hybrid, organic
page-pressure preemption all leave every stream byte-identical to an
unperturbed replay.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine,
    FinishReason,
    Request,
    SamplingParams,
    SSMEngine,
)
from repro_torch.serving.kv_cache import NULL_PAGE  # noqa: E402

PAGE = 8
MAX_LEN = 64


@pytest.fixture(scope="module")
def smollm():
    cfg = reduced(ARCHS["smollm-360m"])
    return cfg, build_model(cfg, device="cpu").init(seed=0)


def _make_trace(seed: int, n: int = 14):
    """Requests with explicit sampling seeds, a shared 2-page prefix on half
    of them, mixed greedy/sampled rows, submissions in bursts of three per
    step and two cancels mid-flight."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 250, 2 * PAGE).tolist()
    reqs = []
    for i in range(n):
        body = rng.integers(1, 250, int(rng.integers(3, 15))).tolist()
        sampled = i % 5 == 4
        reqs.append(Request(
            f"s{i}", (prefix if i % 2 == 0 else []) + body,
            sampling=SamplingParams(
                temperature=0.7 if sampled else 0.0,
                top_k=8 if sampled else 0,
                max_new_tokens=int(rng.integers(3, 7)), seed=1000 + i)))
    actions: dict[int, list[tuple[str, str]]] = {}
    for i, r in enumerate(reqs):
        actions.setdefault(i // 3, []).append(("submit", r.uid))
    actions.setdefault(4, []).append(("cancel", reqs[2].uid))
    actions.setdefault(2, []).append(("cancel", reqs[5].uid))
    return reqs, actions


def _check_invariants(engine) -> None:
    cache, sched, pool = engine.cache, engine.scheduler, engine.cache.pool
    refs: dict[int, int] = {}
    for slot in range(cache.max_slots):
        for p in cache._slot_pages[slot]:
            assert p != NULL_PAGE
            refs[p] = refs.get(p, 0) + 1
    for page in range(1, cache.num_pages):
        assert int(pool.refcounts[page]) == refs.get(page, 0), page
    free, used = pool._free, set(refs)
    assert len(set(free)) == len(free), "double-freed page"
    assert NULL_PAGE not in free
    tiers = cache.tiers
    parked = set(tiers.parked) if tiers is not None else set()
    assert not set(free) & used and not parked & used and not set(free) & parked
    assert set(free) | used | parked == set(range(1, cache.num_pages)), \
        "leaked page"
    if tiers is not None:
        for p in parked:
            assert int(pool.refcounts[p]) == 0
            assert p in cache._page_key and p in cache._page_ck, p
        assert tiers.pending <= parked
        assert len(tiers.host) <= max(tiers.host_pages, 0)
    assert len(cache._page_key) == len(cache._prefix_index)
    for key, page in cache._prefix_index.items():
        assert len(key[1]) == cache.page_size, "partial page in the index"
        assert page in used or page in parked, "index maps a freed page"
        assert cache._page_key.get(page) == key
    for slot, seq in sched.slots.items():
        written = (seq.prefill_pos if seq.phase == "prefill"
                   else int(cache.lengths[slot]))
        for i, p in enumerate(cache._slot_pages[slot]):
            if p in cache._page_key:
                assert (i + 1) * cache.page_size <= written, (slot, p, i)
    live = set(sched.slots)
    assert live == {s for s in range(cache.max_slots)
                    if cache._slot_pages[s]}
    assert set(cache._free_slots) == set(range(cache.max_slots)) - live
    for s in cache._free_slots:
        assert int(cache.lengths[s]) == 0
        assert (cache.block_tables[s] == NULL_PAGE).all()


def _check_drained(cache) -> None:
    assert cache.pool.available + cache.parked_count == cache.num_pages - 1
    assert (cache.pool.refcounts[1:] == 0).all()
    parked = set(cache.tiers.parked) if cache.tiers is not None else set()
    assert set(cache._page_key) == parked


def _drive(engine, reqs, actions, check=_check_invariants):
    """Run the schedule through ``step()``, checking the invariants
    (``check``) and the events' well-formedness after every step."""
    by_uid = {r.uid: r for r in reqs}
    handles, finished, cancelled, last = {}, set(), set(), {}
    step = 0
    while True:
        for kind, uid in actions.get(step, []):
            if kind == "submit":
                handles[uid] = engine.submit(by_uid[uid])
            elif engine.cancel(uid):
                cancelled.add(uid)
        for ev in engine.step():
            assert ev.uid not in finished, f"{ev.uid}: event after finish"
            if ev.kind == "finish":
                assert isinstance(ev.finish_reason, FinishReason)
                finished.add(ev.uid)
            elif ev.kind == "token":
                assert ev.index > last.get(ev.uid, -1)
                last[ev.uid] = ev.index
                assert handles[ev.uid].tokens[ev.index] == ev.token
        check(engine)
        step += 1
        if all(s <= step for s in actions) and engine.idle:
            return handles, cancelled
        assert step < 600, "trace failed to drain"


def _replay(cfg, params, reqs, engine_cls=ContinuousBatchingEngine, **kw):
    """Unperturbed oracle run: the same requests, no cancels."""
    eng = engine_cls(cfg, params, max_len=MAX_LEN, device="cpu", **kw)
    handles = [eng.submit(Request(r.uid, list(r.prompt), sampling=r.sampling))
               for r in reqs]
    while not eng.idle:
        eng.step()
    return {h.uid: h.result() for h in handles}


def _assert_streams(handles, cancelled, oracle):
    for uid, h in handles.items():
        want = oracle[uid].tokens
        if uid in cancelled:
            assert h.finish_reason is FinishReason.CANCELLED
            assert h.tokens == want[:len(h.tokens)], uid
        else:
            assert h.finish_reason in (FinishReason.LENGTH, FinishReason.STOP)
            assert h.tokens == want, uid


KW = dict(max_slots=4, page_size=PAGE, num_pages=8, prefill_chunk=PAGE,
          prefix_sharing=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_tiered_engine_streams_match_untiered(smollm, seed, tmp_path):
    """Park/spill/reload/reclaim never change a stream: every tier engaged
    gives the streams of a tiers-off run of the same trace."""
    cfg, params = smollm
    reqs, actions = _make_trace(seed)
    engine = ContinuousBatchingEngine(
        cfg, params, max_len=MAX_LEN, host_pages=16,
        persist_dir=str(tmp_path / "kv"), seed=seed, device="cpu", **KW)
    handles, cancelled = _drive(engine, reqs, actions)
    t = engine.cache.tiers
    assert t.counters["reclaimed_pages"] > 0, "parked pages never reclaimed"
    assert t.counters["spilled_pages"] > 0, "spill path never exercised"
    _check_drained(engine.cache)
    _assert_streams(handles, cancelled, _replay(
        cfg, params, reqs, kv_tiers=False, seed=seed, **KW))


@pytest.mark.parametrize("seed", [0])
def test_quantized_engine_invariants_and_determinism(smollm, seed):
    """int8 pages: the invariants hold under the perturbed trace and the
    streams replay byte-identical to an unperturbed int8 oracle."""
    cfg, params = smollm
    reqs, actions = _make_trace(seed)
    kw = dict(KW, seed=seed, kv_quant="int8")
    engine = ContinuousBatchingEngine(cfg, params, max_len=MAX_LEN,
                                      device="cpu", **kw)
    handles, cancelled = _drive(engine, reqs, actions)
    assert engine.cache.pages["k"].dtype == torch.int8
    _check_drained(engine.cache)
    _assert_streams(handles, cancelled, _replay(cfg, params, reqs, **kw))


# ---------------------------------------------------------------------------
# SSM / hybrid recurrent-state engine arms
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba2():
    cfg = reduced(ARCHS["mamba2-1.3b"])
    return cfg, build_model(cfg, device="cpu").init(seed=0)


@pytest.fixture(scope="module")
def zamba2():
    cfg = reduced(ARCHS["zamba2-2.7b"])
    return cfg, build_model(cfg, device="cpu").init(seed=0)


def _check_ssm_invariants(engine) -> None:
    """Slot-bank bookkeeping: live sequences and the free list exactly
    partition the slot range (pure SSM) or match the cache's occupancy
    (hybrid), and parked state snapshots belong only to evicted-but-live
    requests — never to an occupant or a finished handle."""
    live = set(engine.slots)
    if engine.hybrid:
        cache = engine.cache
        assert live == {s for s in range(cache.max_slots)
                        if cache._slot_pages[s]}, "slot/page-map mismatch"
    else:
        free = engine._free
        assert len(set(free)) == len(free), "double-freed slot"
        assert not set(free) & live, "slot simultaneously free and live"
        assert set(free) | live == set(range(engine.max_slots)), "leaked slot"
    for slot, seq in engine.slots.items():
        assert len(seq.tokens) <= seq.request.sampling.max_new_tokens
        assert seq.request.uid not in engine._snapshots, (
            f"slot {slot}: occupant still has a parked snapshot")
    for uid in engine._snapshots:
        h = engine._handles.get(uid)
        assert h is not None and not h.done, (
            f"snapshot parked for finished/unknown request {uid}")


def _assert_prefix_streams(handles, cancelled, oracle):
    """As ``_assert_streams``, for traces whose finishes the arm checks
    itself: a cancelled stream is a prefix of the oracle's, every other
    one equals it."""
    for uid, h in handles.items():
        assert isinstance(h.finish_reason, FinishReason), uid
        want = oracle[uid].tokens
        if uid in cancelled:
            assert h.tokens == want[:len(h.tokens)], uid
        else:
            assert h.tokens == want, uid


@pytest.mark.parametrize("seed", [0, 1])
def test_ssm_engine_invariants_under_stress(mamba2, seed):
    """The randomized submit/cancel trace on the recurrent-state engine,
    with forced youngest-first preemptions injected mid-trace — alternating
    discard (re-prefill) and snapshot (state restored verbatim) eviction —
    and only 2 slots so the queue stays under pressure. Every surviving
    stream must be byte-identical to an unperturbed replay."""
    cfg, params = mamba2
    reqs, actions = _make_trace(seed, n=10)
    by_uid = {r.uid: r for r in reqs}
    engine = SSMEngine(cfg, params, max_len=MAX_LEN, max_slots=2,
                       prefill_chunk=PAGE, seed=seed, device="cpu")
    handles, cancelled = {}, set()
    preempt_at = {4: False, 7: True, 10: False, 13: True}  # step -> snapshot
    step = 0
    while True:
        for kind, uid in actions.get(step, []):
            if kind == "submit":
                handles[uid] = engine.submit(by_uid[uid])
            elif engine.cancel(uid):
                cancelled.add(uid)
        if step in preempt_at:
            engine.preempt_youngest(snapshot=preempt_at[step])
        engine.step()
        _check_ssm_invariants(engine)
        step += 1
        if all(s <= step for s in actions) and engine.idle:
            break
        assert step < 600, "trace failed to drain"
    assert engine.stats["preemptions"] > 0
    assert engine.stats["restores"] > 0, (
        "no snapshot preemption ever restored: move the snapshot steps")
    assert not engine._snapshots, "parked snapshot leaked past drain"
    assert len(engine._free) == engine.max_slots
    _assert_prefix_streams(handles, cancelled, _replay(
        cfg, params, reqs, SSMEngine, max_slots=2, prefill_chunk=PAGE,
        seed=seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_ssm_engine_restart_mid_trace(mamba2, seed):
    """Crash-replay arm: the engine dies mid-trace — recurrent state gone,
    handles stranded — and a fresh engine re-serves every in-flight
    request under its original sampling seed. The combined streams must be
    byte-identical to the unperturbed oracle, the pre-crash delivery an
    exact prefix of the regenerated stream."""
    cfg, params = mamba2
    reqs, actions = _make_trace(seed, n=10)
    by_uid = {r.uid: r for r in reqs}
    kw = dict(max_slots=3, prefill_chunk=PAGE, seed=seed)
    engine = SSMEngine(cfg, params, max_len=MAX_LEN, device="cpu", **kw)
    handles, cancelled = {}, set()
    step = 0
    while True:
        for kind, uid in actions.get(step, []):
            if kind == "submit":
                handles[uid] = engine.submit(by_uid[uid])
            elif engine.cancel(uid):
                cancelled.add(uid)
        engine.step()
        _check_ssm_invariants(engine)
        step += 1
        mid_stream = any(h.tokens for h in handles.values() if not h.done)
        if step >= 6 and all(s < step for s in actions) and mid_stream:
            break
        assert step < 600, "trace never reached a crashable state"

    delivered = {uid: list(h.tokens) for uid, h in handles.items()}
    pre_crash = {uid: h for uid, h in handles.items() if h.done}
    inflight = [uid for uid, h in handles.items() if not h.done]
    assert inflight, "crash step too late: nothing was in flight"
    assert any(delivered[u] for u in inflight), (
        "crash step too early: no mid-stream request to resume")
    del engine

    engine2 = SSMEngine(cfg, params, max_len=MAX_LEN, device="cpu", **kw)
    handles2 = {
        uid: engine2.submit(Request(uid, list(by_uid[uid].prompt),
                                    sampling=by_uid[uid].sampling))
        for uid in inflight
    }
    steps = 0
    while not engine2.idle:
        engine2.step()
        _check_ssm_invariants(engine2)
        steps += 1
        assert steps < 600, "restarted trace failed to drain"

    oracle = _replay(cfg, params, reqs, SSMEngine, **kw)
    _assert_prefix_streams(pre_crash, cancelled, oracle)
    for uid, h in handles2.items():
        assert h.finish_reason in (FinishReason.LENGTH, FinishReason.STOP), uid
        assert h.tokens == oracle[uid].tokens, uid
        pre = delivered[uid]
        assert h.tokens[:len(pre)] == pre, (
            f"{uid}: pre-crash delivery is not a prefix of the replay")


@pytest.mark.parametrize("seed", [0])
def test_hybrid_engine_invariants_under_stress(zamba2, seed):
    """Hybrid (Zamba2) arm: attention pages and recurrent state advance in
    the same step, with the page pool sized so decode-time growth runs it
    dry and ORGANIC youngest-first preemption fires. Streams must still be
    byte-identical to an unpressured replay."""
    cfg, params = zamba2
    reqs, actions = _make_trace(seed, n=10)
    engine = SSMEngine(cfg, params, max_len=MAX_LEN, max_slots=4,
                       page_size=PAGE, num_pages=8, prefill_chunk=PAGE,
                       seed=seed, device="cpu")
    handles, cancelled = _drive(engine, reqs, actions, _check_ssm_invariants)
    assert engine.stats["preemptions"] > 0, (
        "trace too gentle: hybrid page-pressure preemption never fired")
    assert engine.cache.pool.available == engine.cache.num_pages - 1
    _assert_prefix_streams(handles, cancelled, _replay(
        cfg, params, reqs, SSMEngine, max_slots=4, page_size=PAGE,
        prefill_chunk=PAGE, seed=seed))
