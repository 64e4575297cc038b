"""The port's tiered KV cache (``repro_torch.serving.kv_tiers`` and the tier
plumbing of ``repro_torch.serving.kv_cache.PagedKVCache``), no model.

Ports of ``tests/test_kv_tiers.py`` against the port's own page cache on
the CPU: spill to host RAM and prefetch back restore the exact bytes of
every pool tensor, the host LRU cap, ``flush_tiers``, a persisted prefix
surviving a restart (a fresh cache and tier manager on the same
``ArtifactStore`` directory), prefetch that never starves its own
admission; and the int8 pool: >= 2x admissions at equal pool bytes, array
shapes and ``page_nbytes``, the quantized write-prefill round trip within
absmax / 254, and int8 pages and scales bit-exact through spill and
reload. Last, the spilled bytes equal the JAX package's on the same trace
for f32, bf16 and int8 pools: a spilled page keeps the pool's own width.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.serving import KVTierManager as JTierManager  # noqa: E402
from repro.serving import PagedKVCache as JPagedKVCache  # noqa: E402
from repro_torch.core.storage import ArtifactStore  # noqa: E402
from repro_torch.serving import KVTierManager, PagedKVCache  # noqa: E402
from repro_torch.serving.kv_cache import write_prefill_pages  # noqa: E402


def _cache(tiers=None, **kw):
    args = dict(num_layers=2, num_kv_heads=2, head_dim=4,
                dtype=torch.float32, max_slots=3, max_context=64,
                page_size=8, tiers=tiers, device="cpu")
    args.update(kw)
    return PagedKVCache(**args)


def _fill(cache, pages, seed=0):
    """Write recognizable per-page values into every pool tensor."""
    rng = np.random.default_rng(seed)
    for arr in cache.pages.values():
        for p in pages:
            vals = rng.normal(size=tuple(arr[:, p].shape)) * 40
            arr[:, p] = torch.from_numpy(vals).to(arr.dtype)


def _register(cache, toks):
    slot, _ = cache.admit(len(toks), toks)
    cache.register_prefix(slot, toks, len(toks))
    return slot, list(cache._slot_pages[slot][:len(toks) // cache.page_size])


def _assert_pages_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got[key], arr)


# ---------------------------------------------------------------------------
# host spill + prefetch, LRU cap, flush
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spill_to_host_and_prefetch_restores_bytes(dtype):
    """A parked page reclaimed into the host tier and prefetched back on a
    prefix hit restores the exact device bytes (all pool tensors)."""
    tiers = KVTierManager(host_pages=8)
    cache = _cache(tiers, num_pages=8, max_slots=2, dtype=dtype)
    toks = list(range(50, 75))
    slot, chain = _register(cache, toks)
    _fill(cache, chain, seed=3)
    want = {p: cache._read_page(p) for p in chain}
    cache.release(slot)

    # pressure: spills the chain to host RAM, frees the device pages
    slot2, _ = cache.admit(41, list(range(300, 341)))
    assert tiers.counters["spilled_pages"] == 3
    assert tiers.host_count == 3
    cache.release(slot2)

    # rerun: can_admit prefetches the chain back (pending); a step later
    # the pages are matchable and the admission maps them
    assert not cache.can_admit(len(toks), toks)
    assert tiers.counters["host_hits"] == 3
    assert tiers.counters["prefetched_pages"] == 3
    assert len(tiers.pending) == 3
    assert cache.match_prefix(toks)[1] == 0  # pending pages stay invisible
    cache.tick_tiers()
    assert cache.can_admit(len(toks), toks)
    slot3, cached = cache.admit(len(toks), toks)
    assert cached == 24
    for i, p in enumerate(cache._slot_pages[slot3][:3]):
        _assert_pages_equal(cache._read_page(p), want[chain[i]])
    assert tiers.host_count == 0  # a host hit promotes


def test_host_tier_lru_eviction_caps_entries():
    tiers = KVTierManager(host_pages=2)
    for i in range(4):
        tiers.spill(bytes([i]) * 32, {"k": np.full((2, 8), i, np.float32)})
    assert tiers.host_count == 2
    assert set(tiers.host) == {bytes([2]) * 32, bytes([3]) * 32}
    assert tiers.counters["spilled_pages"] == 4


def test_flush_tiers_parks_nothing_spills_everything():
    tiers = KVTierManager(host_pages=8)
    cache = _cache(tiers)
    slot, _ = _register(cache, list(range(80, 105)))
    cache.release(slot)
    assert len(tiers.parked) == 3
    assert cache.flush_tiers() == 3 and not tiers.parked
    assert tiers.host_count == 3
    assert cache.pool.available == cache.num_pages - 1


# ---------------------------------------------------------------------------
# persisted tier (ArtifactStore write-through, restart re-attach)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,quant", [(torch.float32, "none"),
                                         (torch.bfloat16, "none"),
                                         (torch.bfloat16, "int8")])
def test_persisted_prefix_survives_restart(tmp_path, dtype, quant):
    """Spill with a store attached writes through to the ArtifactStore; a
    FRESH cache and tier manager over the same directory resolve the
    prefix by content key and restore identical bytes (f32, bf16 as its
    16-bit pattern, int8 with f32 scales)."""
    tiers = KVTierManager(store=ArtifactStore(tmp_path / "kv"))
    cache = _cache(tiers, quant=quant, dtype=dtype)
    toks = list(range(60, 85))
    slot, chain = _register(cache, toks)
    _fill(cache, chain, seed=7)
    want = [cache._read_page(p) for p in chain]
    cache.release(slot)
    assert cache.flush_tiers() == 3
    assert tiers.persisted_count == 3

    tiers2 = KVTierManager(store=ArtifactStore(tmp_path / "kv"))
    assert tiers2.persisted_count == 3  # index re-loaded from disk
    cache2 = _cache(tiers2, quant=quant, dtype=dtype)
    assert not cache2.can_admit(len(toks), toks)  # prefetch from the store
    assert tiers2.counters["persist_hits"] == 3
    cache2.tick_tiers()
    slot2, cached = cache2.admit(len(toks), toks)
    assert cached == 24
    for i, p in enumerate(cache2._slot_pages[slot2][:3]):
        _assert_pages_equal(cache2._read_page(p), want[i])


def test_prefetch_never_starves_its_admission(tmp_path):
    """Prefetch stops while the free pool can still cover the rest of the
    prompt."""
    tiers = KVTierManager(store=ArtifactStore(tmp_path / "kv"))
    cache = _cache(tiers, num_pages=8, max_slots=2)  # 7 usable pages
    toks = list(range(150, 190))  # 40 tokens: exactly 5 full pages
    slot, _ = _register(cache, toks)
    cache.release(slot)
    assert cache.flush_tiers() == 5
    cache.can_admit(len(toks), toks)
    prefetched = tiers.counters["prefetched_pages"]
    assert cache.pool.available >= 5 - prefetched
    cache.tick_tiers()
    slot2, cached = cache.admit(len(toks), toks)
    assert cached == prefetched * cache.page_size
    cache.release(slot2)


# ---------------------------------------------------------------------------
# quantized pages
# ---------------------------------------------------------------------------


def test_int8_pages_double_admission_at_equal_pool_bytes():
    """At (about) equal pool bytes an int8 pool admits >= 2x the
    concurrent sequences of an f32 pool."""
    def build(quant, budget_bytes):
        kw = dict(num_layers=2, num_kv_heads=2, head_dim=8,
                  dtype=torch.float32, max_slots=64, max_context=64,
                  page_size=8, quant=quant, device="cpu")
        probe = PagedKVCache(num_pages=2, **kw)
        return PagedKVCache(
            num_pages=max(2, budget_bytes // probe.page_nbytes + 1), **kw)

    admitted = {}
    for quant in ("none", "int8"):
        cache = build(quant, 1 << 18)
        n = 0
        while cache.free_slot_count and cache.can_admit(32):
            cache.admit(32)
            n += 1
        admitted[quant] = n
    assert admitted["int8"] >= 2 * admitted["none"], admitted


def test_quantized_pool_array_shapes_and_page_bytes():
    fp, q = _cache(), _cache(quant="int8")
    jq = JPagedKVCache(num_layers=2, num_kv_heads=2, head_dim=4,
                       dtype=jnp.float32, max_slots=3, max_context=64,
                       page_size=8, quant="int8")
    assert set(q.pages) == {"k", "v", "k_scale", "v_scale"}
    assert q.pages["k"].dtype == torch.int8
    assert q.pages["k_scale"].dtype == torch.float32
    assert q.pages["k_scale"].shape == q.pages["k"].shape[:-1]
    # the port's pool carries one sink page past the JAX pool's pages
    assert q.pages["k"].shape[1] == jq.pages["k"].shape[1] + 1
    assert q.page_nbytes == jq.page_nbytes and fp.page_nbytes >= 2 * q.page_nbytes


def test_quantized_write_prefill_roundtrip_within_bound():
    """Dense prefill scattered into an int8 pool dequantizes back within
    absmax / 127 / 2 per (position, head) row; padded rows go to the
    sink."""
    rng = np.random.default_rng(11)
    cache = _cache(quant="int8")
    plen = 20
    slot, _ = cache.admit(plen)
    k = rng.normal(size=(2, 24, 2, 4)).astype(np.float32)  # 4 padded rows
    v = rng.normal(size=(2, 24, 2, 4)).astype(np.float32)
    write_prefill_pages(cache.pages, torch.from_numpy(k), torch.from_numpy(v),
                        cache.device_row(slot), plen)
    got_k, got_v = cache.gather_dense(slot)
    for got, want in ((got_k, k[:, :plen]), (got_v, v[:, :plen])):
        bound = np.abs(want).max(axis=-1, keepdims=True) / 127.0 / 2 + 1e-6
        assert (np.abs(got - want) <= bound).all()
    real = set(cache._slot_pages[slot])
    touched = {int(p) for p in torch.nonzero(
        cache.pages["k_scale"][0].sum(dim=(1, 2)))[:, 0]}
    assert touched == real | {cache.num_pages}  # the rest went to the sink


def test_parked_page_survives_quantized_spill_reload_exactly():
    """int8 pool: spill + prefetch restores the quantized bytes AND scales
    bit for bit (no requantization across tier moves)."""
    tiers = KVTierManager(host_pages=8)
    cache = _cache(tiers, quant="int8", num_pages=8, max_slots=2)
    toks = list(range(70, 95))
    slot, chain = _register(cache, toks)
    _fill(cache, chain, seed=13)
    want = {p: cache._read_page(p) for p in chain}
    assert want[chain[0]]["k"].dtype == np.int8
    cache.release(slot)
    slot2, _ = cache.admit(41, list(range(300, 341)))  # forces the spill
    cache.release(slot2)
    assert not cache.can_admit(len(toks), toks)
    cache.tick_tiers()
    slot3, cached = cache.admit(len(toks), toks)
    assert cached == 24
    for i, p in enumerate(cache._slot_pages[slot3][:3]):
        _assert_pages_equal(cache._read_page(p), want[chain[i]])


# ---------------------------------------------------------------------------
# spilled bytes: the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,quant", [("float32", "none"),
                                         ("bfloat16", "none"),
                                         ("bfloat16", "int8")])
def test_spill_bytes_equal_jax(dtype, quant):
    """The same admit/register/release/pressure trace through both
    packages' caches spills the same number of bytes: a bf16 page leaves
    as 16 bits per element and an int8 page as int8 plus f32 scales."""
    def run(make_cache, make_tiers):
        tiers = make_tiers(host_pages=8)
        cache = make_cache(tiers)
        toks = list(range(50, 75))
        slot, _ = cache.admit(len(toks), toks)
        cache.register_prefix(slot, toks, len(toks))
        cache.release(slot)
        cache.release(cache.admit(41, list(range(300, 341)))[0])
        assert tiers.counters["spilled_pages"] == 3
        return tiers.counters["spill_bytes"], next(iter(tiers.host.values()))

    kw = dict(num_layers=2, num_kv_heads=2, head_dim=8, max_slots=2,
              max_context=64, page_size=8, num_pages=8, quant=quant)
    got, got_page = run(
        lambda t: PagedKVCache(dtype=getattr(torch, dtype), tiers=t,
                               device="cpu", **kw), KVTierManager)
    want, want_page = run(
        lambda t: JPagedKVCache(dtype=jnp.dtype(dtype), tiers=t, **kw),
        JTierManager)
    assert got == want
    assert {k: a.nbytes for k, a in got_page.items()} == \
        {k: a.nbytes for k, a in want_page.items()}
