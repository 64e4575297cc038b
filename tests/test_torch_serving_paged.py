"""The port's page pool, block tables, copy-on-write and paged engine
surface: ports of ``tests/test_serving_paged.py``'s pool, bookkeeping,
prefix-sharing, copy-on-write, exhaustion, rejection, poison-message,
latency and bus-admission cases, at the reference's reduced sizes on the
CPU (smollm-360m reduced, f32, the port's seeded weights).

Where the reference swaps a new pool in (``set_pages``), the port writes
the pool in place through ``PagedKVCache.k_pages`` / ``v_pages``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import TopicBus  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 GenerationEngine, PagedKVCache, PagePool,
                                 Request)
from repro_torch.serving.kv_cache import NULL_PAGE  # noqa: E402


def assert_drained(cache):
    """Every page is either free or parked (zero-refcount prefix pages kept
    for reuse by the tier manager) once all sequences have released."""
    assert cache.pool.available + cache.parked_count == cache.num_pages - 1
    assert (cache.pool.refcounts[1:] == 0).all()


@pytest.fixture(scope="module")
def smollm():
    cfg = reduced(ARCHS["smollm-360m"])
    return cfg, build_model(cfg, device="cpu").init(seed=0)


# ---------------------------------------------------------------------------
# page pool
# ---------------------------------------------------------------------------


def test_page_pool_alloc_free_reuse():
    pool = PagePool(8)  # pages 1..7 usable, 0 reserved
    assert pool.available == 7
    a = pool.alloc(3)
    assert len(set(a)) == 3 and NULL_PAGE not in a
    b = pool.alloc(4)
    assert pool.available == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(1)
    pool.free(a)
    assert pool.available == 3
    c = pool.alloc(3)
    assert set(c) == set(a)  # freed pages are reused
    assert not set(c) & set(b)


def test_paged_cache_block_table_bookkeeping():
    cache = PagedKVCache(
        num_layers=1, num_kv_heads=1, head_dim=4, dtype=torch.float32,
        max_slots=2, max_context=32, page_size=8, device="cpu",
    )
    slot, cached = cache.admit(context_len=10)  # needs 2 pages
    assert cached == 0  # no prompt tokens given -> nothing shared
    pages = cache._slot_pages[slot]
    assert len(pages) == 2
    assert list(cache.block_tables[slot, :2]) == pages
    assert (cache.block_tables[slot, 2:] == NULL_PAGE).all()

    # appending through position 15 stays inside page 2; 16 allocates page 3
    for _ in range(6):
        cache.ensure_append_capacity(slot)
        cache.append(slot)
    assert len(cache._slot_pages[slot]) == 2
    cache.ensure_append_capacity(slot)
    assert len(cache._slot_pages[slot]) == 3

    avail = cache.pool.available
    cache.release(slot)
    assert cache.pool.available == avail + 3
    assert (cache.block_tables[slot] == NULL_PAGE).all()
    assert cache.lengths[slot] == 0


# ---------------------------------------------------------------------------
# the engine's request boundary
# ---------------------------------------------------------------------------


def test_engine_rejects_unschedulable_request(smollm):
    cfg, params = smollm
    eng = ContinuousBatchingEngine(cfg, params, max_len=40, max_slots=2,
                                   page_size=8, num_pages=4, device="cpu")
    with pytest.raises(ValueError, match="never be scheduled"):
        eng.enqueue(Request("never", list(range(1, 31)), max_new_tokens=10))
    with pytest.raises(ValueError, match="max_len"):
        eng.enqueue(Request("long", list(range(1, 40)), max_new_tokens=10))


def test_bus_poison_message_is_rejected_and_committed(smollm, tmp_path):
    """An unservable bus message must be committed (not redelivered forever)
    and recorded as a rejection, while later messages still serve."""
    cfg, params = smollm
    bus = TopicBus(tmp_path)
    bus.publish("requests", {"uid": "bad", "prompt": list(range(40)),
                             "max_new_tokens": 16})
    bus.publish("requests", {"uid": "good", "prompt": [1, 2, 3],
                             "max_new_tokens": 3})
    eng = ContinuousBatchingEngine(cfg, params, max_len=32, max_slots=2,
                                   page_size=8, device="cpu")
    n = eng.admit_from_bus(bus, "requests", "g0")
    assert n == 1
    assert bus.lag("requests", "g0") == 0  # poison message consumed
    assert eng.stats["rejected"] == 1
    (uid, err), = eng.drain_rejections()
    assert uid == "bad" and "max_len" in err
    served = []
    while not eng.idle:
        served.extend(ev.uid for ev in eng.step() if ev.kind == "finish")
    assert served == ["good"]


# ---------------------------------------------------------------------------
# prefix sharing / copy-on-write
# ---------------------------------------------------------------------------


def _small_cache(**kw):
    args = dict(num_layers=1, num_kv_heads=1, head_dim=4, dtype=torch.float32,
                max_slots=3, max_context=32, page_size=8, device="cpu")
    args.update(kw)
    return PagedKVCache(**args)


def test_match_prefix_capped_below_last_token():
    """A prompt equal to its cached prefix must still recompute >= 1 token
    (the engine needs its logits), so matching stops strictly before the
    last token even on a page boundary."""
    cache = _small_cache()
    toks = list(range(100, 116))  # exactly 2 full pages
    slot, cached = cache.admit(len(toks), toks)
    assert cached == 0
    cache.register_prefix(slot, toks, len(toks))
    # identical prompt: only page 0 is eligible (page 1 holds the last token)
    _, cached2 = cache.match_prefix(toks)
    assert cached2 == 8
    # a longer prompt extending the prefix can use both full pages
    _, cached3 = cache.match_prefix(toks + [1, 2, 3])
    assert cached3 == 16


def test_shared_prefix_pages_not_double_freed():
    """Two slots sharing prefix pages release independently; the shared
    page survives the first release and every refcount returns to zero."""
    cache = _small_cache()
    toks = list(range(1, 21))  # 20 tokens: 2 full pages + 1 partial
    a, cached_a = cache.admit(len(toks), toks)
    assert cached_a == 0 and len(cache._slot_pages[a]) == 3
    cache.register_prefix(a, toks, len(toks))

    b, cached_b = cache.admit(len(toks), toks)
    assert cached_b == 16  # both full pages shared
    shared = cache._slot_pages[b][:2]
    assert shared == cache._slot_pages[a][:2]
    assert all(cache.pool.refcounts[p] == 2 for p in shared)

    avail = cache.pool.available
    cache.release(a)
    # a's private tail page freed; the two shared pages survive for b
    assert cache.pool.available == avail + 1
    assert all(cache.pool.refcounts[p] == 1 for p in shared)
    # b can still resolve its prefix through the index
    assert cache.match_prefix(toks + [99])[1] == 16
    cache.release(b)
    assert cache.pool.available == cache.num_pages - 1
    assert (cache.pool.refcounts[1:] == 0).all()
    assert not cache._prefix_index  # freed pages leave the index


def test_fork_cow_copies_exactly_one_page():
    """A write after fork copies exactly the written page; the other pages
    stay shared and the source slot's data is untouched."""
    cache = _small_cache()
    toks = list(range(1, 13))  # 12 tokens: 1 full page + 1 partial
    a, _ = cache.admit(len(toks), toks)
    # fill the pool pages with recognizable data, written in place
    pool = cache.k_pages
    k = pool.clone()
    for i, p in enumerate(cache._slot_pages[a]):
        k[:, p] = float(i + 1)
    cache.k_pages = k
    assert cache.k_pages is pool and torch.equal(pool, k)
    assert cache.v_pages is cache.pages["v"]

    b = cache.fork(a)
    assert cache._slot_pages[b] == cache._slot_pages[a]
    assert int(cache.lengths[b]) == 12
    assert all(cache.pool.refcounts[p] == 2 for p in cache._slot_pages[a])

    avail = cache.pool.available
    changed = cache.ensure_append_capacity(b)  # next write: pos 12, page 1
    assert changed and cache.stats["cow_copies"] == 1
    assert cache.pool.available == avail - 1  # exactly one page allocated
    pa, pb = cache._slot_pages[a], cache._slot_pages[b]
    assert pb[0] == pa[0] and pb[1] != pa[1]  # full page shared, tail copied
    assert cache.pool.refcounts[pa[0]] == 2
    assert cache.pool.refcounts[pa[1]] == 1 and cache.pool.refcounts[pb[1]] == 1
    # the copy carried the tail page's contents
    np.testing.assert_array_equal(
        cache.k_pages[:, pb[1]].numpy(), cache.k_pages[:, pa[1]].numpy())
    assert float(cache.k_pages[0, pb[1]].max()) == 2.0
    # a's next append sees refcount 1 everywhere: no second copy
    assert not cache.ensure_append_capacity(a)
    assert cache.stats["cow_copies"] == 1

    cache.release(a)
    cache.release(b)
    assert cache.pool.available == cache.num_pages - 1
    assert (cache.pool.refcounts[1:] == 0).all()


def test_cow_append_fails_cleanly_when_pool_exhausted():
    """Pool exhaustion DURING a copy-on-write append: every free page is
    held by refcounted (unfreeable) sharers, so the COW copy has nowhere to
    land. ensure_append_capacity must raise (so the engine can preempt)
    WITHOUT corrupting state: no page leaked, the shared mapping and block
    table untouched, refcounts intact — and the append must succeed after
    pressure drops."""
    cache = _small_cache(num_pages=4)  # pages 1..3 usable
    toks = list(range(1, 13))  # 12 tokens: 1 full page + 1 partial
    a, _ = cache.admit(len(toks), toks)   # takes pages 1, 2
    b = cache.fork(a)                     # maps both COW (refcounts 2)
    (filler,) = cache.pool.alloc(1)       # page 3: pool now empty
    assert cache.pool.available == 0

    before_pages = list(cache._slot_pages[b])
    before_bt = cache.block_tables[b].copy()
    before_rc = cache.pool.refcounts.copy()
    # b's next write lands at position 12 inside shared page 2 -> COW needs
    # a fresh page, but every page is refcounted and unfreeable
    with pytest.raises(RuntimeError, match="exhausted"):
        cache.ensure_append_capacity(b)
    assert cache.stats["cow_copies"] == 0
    assert cache._slot_pages[b] == before_pages      # mapping unchanged
    np.testing.assert_array_equal(cache.block_tables[b], before_bt)
    np.testing.assert_array_equal(cache.pool.refcounts, before_rc)
    assert cache.pool.available == 0                 # nothing leaked

    # releasing unrelated pressure makes the SAME append succeed as a copy
    cache.pool.free([filler])
    assert cache.ensure_append_capacity(b) is True
    assert cache.stats["cow_copies"] == 1
    assert cache._slot_pages[b][1] != cache._slot_pages[a][1]
    cache.release(a)
    cache.release(b)
    assert cache.pool.available == cache.num_pages - 1


def test_cow_exhaustion_growth_page_also_raises():
    """The page-boundary growth branch hits the same exhaustion path: a
    slot at a page boundary with an empty pool raises instead of stealing a
    refcounted page, and the pool stays balanced."""
    cache = _small_cache(num_pages=3, page_size=8)  # pages 1..2 usable
    toks = list(range(1, 9))  # exactly one full page
    a, _ = cache.admit(len(toks), toks)
    b = cache.fork(a)          # page shared at refcount 2
    (filler,) = cache.pool.alloc(1)
    with pytest.raises(RuntimeError, match="exhausted"):
        cache.ensure_append_capacity(a)  # boundary: needs a NEW page
    assert cache.pool.refcounts[cache._slot_pages[a][0]] == 2
    cache.pool.free([filler])
    assert cache.ensure_append_capacity(a) is True   # growth succeeds now
    cache.release(a)
    cache.release(b)
    assert cache.pool.available == cache.num_pages - 1
    assert (cache.pool.refcounts[1:] == 0).all()


def test_engine_preempts_when_cow_append_cannot_allocate(smollm):
    """Engine-level: shared prefix pages make the pool LOOK full of
    unfreeable pages; when a decode append needs a page the scheduler must
    preempt the youngest sequence (whose release drops the shared
    refcounts) instead of crashing, and every request still finishes
    exactly."""
    cfg, params = smollm
    # 7 usable pages; two 17-token same-prefix prompts share 2 full pages:
    # 2 shared + 2 private tails + growth quickly exceeds the pool
    eng = ContinuousBatchingEngine(cfg, params, max_len=48, max_slots=3,
                                   page_size=8, num_pages=8,
                                   prefill_chunk=8, device="cpu")
    prefix = list(range(40, 56))  # 2 full pages
    reqs = [Request(f"c{i}", prefix + [60 + i], max_new_tokens=14)
            for i in range(3)]
    out = eng.generate(reqs)
    assert eng.cache.stats["prefix_hits"] >= 1  # sharing actually happened
    assert eng.stats["preemptions"] > 0         # pressure forced eviction
    base = GenerationEngine(cfg, params, max_len=48, device="cpu")
    for r, o in zip(reqs, out):
        exact = base.generate([Request(r.uid, r.prompt, r.max_new_tokens)])[0]
        assert o.tokens == exact.tokens, r.uid
    assert_drained(eng.cache)


# ---------------------------------------------------------------------------
# latency metrics, bus admission
# ---------------------------------------------------------------------------


def test_engine_records_latency_metrics(smollm):
    cfg, params = smollm
    eng = ContinuousBatchingEngine(cfg, params, max_len=64, max_slots=2,
                                   page_size=8, device="cpu")
    (res,) = eng.generate([Request("t", [1, 2, 3, 4], max_new_tokens=5)])
    assert res.ttft is not None and res.ttft > 0
    assert len(res.itl) == 4  # gaps between the 5 emitted tokens
    assert all(g > 0 for g in res.itl)


def test_engine_admits_from_bus(smollm, tmp_path):
    cfg, params = smollm
    bus = TopicBus(tmp_path)
    for i in range(5):
        bus.publish("requests", {
            "uid": f"b{i}", "prompt": [1 + i, 2, 3], "max_new_tokens": 4,
        })
    eng = ContinuousBatchingEngine(cfg, params, max_len=32, max_slots=2,
                                   page_size=8, device="cpu")
    served: dict[str, list[int]] = {}
    while bus.lag("requests", "g0") > 0 or not eng.idle:
        eng.admit_from_bus(bus, "requests", "g0",
                           max_msgs=eng.cache.free_slot_count)
        for ev in eng.step():
            if ev.kind == "token":  # streamed deltas rebuild the outputs
                served.setdefault(ev.uid, []).append(ev.token)
    assert sorted(served) == [f"b{i}" for i in range(5)]
    assert all(len(t) == 4 for t in served.values())
