"""Block-table KV cache: refcounted pages with prefix sharing + copy-on-write.

The device side is a dict of page-pool tensors per model — ``pages["k"]`` /
``pages["v"]`` of shape (L, P + 1, page_size, KVH, Dh) on the engine's
device, and with ``quant="int8"`` int8 K/V plus f32 ``pages["k_scale"]`` /
``pages["v_scale"]`` of shape (L, P + 1, page_size, KVH) — plus per-step
int32 inputs (block tables and lengths), so every
step sees ONE shape no matter how many sequences are in flight or how long
each one is. The model writes K/V into these tensors in place. The host
side is a refcounted free-list allocator (:class:`PagePool`) and per-slot
bookkeeping (:class:`PagedKVCache`) that hands the engine ready-to-transfer
block tables; it is the JAX package's, line for line.

Page 0 is reserved as the **null page**: unused block-table entries and idle
decode slots point at it, so the kernels' gathers never go out of bounds.
Page P (one past ``num_pages``) is the **sink**: rows that must not write
(idle slots, dead rows, chunk padding) write there instead of being dropped
out of bounds as the JAX scatter does (``mode="drop"``) — a torch scatter
has no drop mode. No block table ever names the sink and nothing reads it.

Sharing model:

* Every page carries a **refcount**. A page is physically freed (returned to
  the free list) only when its refcount reaches zero, so two sequences can
  map the same physical page and release independently.
* A **prefix index** maps the token content of a chain of full pages to the
  physical page holding its K/V. Keys are hash-chained — (parent physical
  page, this page's token chunk), root = the null page — so lookup and
  registration are O(1) per page, and a page is only reused when the
  ENTIRE prefix matches (the parent id names the whole chain), not just
  that page's tokens.
  :meth:`PagedKVCache.admit` consults it to map shared full pages read-only;
  matches are capped below the prompt's last token (the engine always needs
  at least one position's logits, and recomputing it must never write into
  a shared page).
* **Copy-on-write**: :meth:`ensure_append_capacity` copies a page (device
  page-granular in-place ``copy_`` on the pool's stream) before a
  sequence writes into a page whose refcount is > 1. With admission-time
  sharing restricted to full pages this only triggers after :meth:`fork`,
  which maps *all* of a sequence's pages — including the partial tail —
  into a second slot.
* **Tiers** (:mod:`repro_torch.serving.kv_tiers`, optional): with a
  :class:`~repro_torch.serving.kv_tiers.KVTierManager` attached, a prefix-index
  page whose last reference drops is **parked** (refcount 0, device-resident,
  still matchable) instead of freed, and :meth:`reclaim_parked` — invoked
  from :meth:`can_admit` / the allocation path before admission fails or
  preemption fires — spills the LRU parked pages to host RAM / an
  ``ArtifactStore`` and returns them to the free list. A prefix-index walk
  past device residency asynchronously prefetches spilled pages back
  (:meth:`match_prefix` with ``prefetch=True``); the engine publishes the
  transfers one step later via :meth:`tick_tiers`. See the state-machine
  diagram in ``kv_tiers.py``.

Pages are registered into the prefix index by the engine *after* the prefill
chunk that fills them has been dispatched (dispatch order = execution order
on one device stream), so a concurrent admission can never read a shared
page before its contents exist.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels.ref import dequantize_pages, quantize_kv
from repro_torch.models.common import resolve_device
from repro_torch.serving.kv_tiers import KVTierManager, chain_key

NULL_PAGE = 0


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PagePool:
    """Refcounted LIFO free-list allocator over physical page ids [1, num_pages).

    ``alloc`` hands out pages with refcount 1; ``incref`` adds a sharer;
    ``decref`` returns the page to the free list when the count hits zero.

    Tiered caches add a third state between live and free: ``park`` drops a
    page to refcount 0 WITHOUT returning it to the free list (the page stays
    device-resident and matchable), ``revive`` claims a parked page back to
    refcount 1, and ``reclaim`` finally free-lists a parked page. The owner
    (:class:`PagedKVCache`) tracks WHICH pages are parked; the pool only
    enforces the refcount transitions.
    """

    def __init__(self, num_pages: int):
        assert num_pages >= 2, "need at least the null page + one real page"
        self.num_pages = num_pages
        # LIFO so recently-freed (cache-warm) pages are reused first
        self._free = list(range(num_pages - 1, 0, -1))
        self.refcounts = np.zeros((num_pages,), np.int32)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> list[int]:
        """Pop n pages (each refcount 1); RuntimeError when exhausted."""
        assert n > 0, n  # n=0 would slice the whole free list without popping
        if n > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: want {n}, have {len(self._free)}"
            )
        taken = self._free[-n:][::-1]
        del self._free[len(self._free) - n:]
        for p in taken:
            self.refcounts[p] = 1
        return taken

    def incref(self, page: int) -> None:
        assert page != NULL_PAGE and self.refcounts[page] > 0, page
        self.refcounts[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        assert page != NULL_PAGE, "cannot free the null page"
        assert self.refcounts[page] > 0, f"decref of free page {page}"
        self.refcounts[page] -= 1
        if self.refcounts[page] == 0:
            self._free.append(page)
            return True
        return False

    def free(self, pages: list[int]) -> None:
        for p in pages:
            self.decref(p)

    # -- parked-tier transitions (refcount 0, NOT on the free list) --------
    def park(self, page: int) -> None:
        assert page != NULL_PAGE and self.refcounts[page] == 1, page
        self.refcounts[page] = 0

    def revive(self, page: int) -> None:
        assert page != NULL_PAGE and self.refcounts[page] == 0, page
        self.refcounts[page] = 1

    def reclaim(self, page: int) -> None:
        assert self.refcounts[page] == 0, page
        self._free.append(page)


def _copy_page(pages: dict[str, torch.Tensor], src: int, dst: int) -> None:
    """Copy one physical page (all layers, every pool tensor) src -> dst,
    in place, on the pool's stream."""
    for arr in pages.values():
        arr[:, dst].copy_(arr[:, src])


def _read_block(arr: torch.Tensor, page: int) -> np.ndarray:
    """One physical page (all layers) as a host array of the pool's own
    width: int8 stays int8, f32 stays f32, and bf16, which numpy lacks,
    keeps its bits as int16. Always a copy (on the CPU the slice would
    alias the pool)."""
    block = arr[:, page]
    if arr.dtype == torch.bfloat16:
        block = block.view(torch.int16)
    return block.cpu().numpy().copy()


def _write_page(arr: torch.Tensor, page: int, data: np.ndarray) -> None:
    """Write one physical page (all layers) from a host block that
    :func:`_read_block` made, in place and bit for bit."""
    block = torch.from_numpy(np.ascontiguousarray(data))
    arr[:, page].copy_(block.view(arr.dtype))


class PagedKVCache:
    """Device page pool + host block tables for up to ``max_slots`` sequences.

    The executor owns the model steps; this class owns allocation state
    (slots, refcounts, the prefix index) and the device page tensors, which
    the steps update in place. ``quant="int8"`` stores K/V as int8 with one
    f32 scale per (page, position, kv head) — about half the bytes of a
    bf16 page at head_dim 64; the paged kernels fuse the dequantization.
    ``tiers`` attaches a :class:`~repro_torch.serving.kv_tiers.KVTierManager`
    (see module docstring).
    """

    def __init__(
        self,
        *,
        num_layers: int,
        num_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype,
        max_slots: int,
        max_context: int,
        page_size: int = 16,
        num_pages: int | None = None,
        quant: str = "none",
        tiers: KVTierManager | None = None,
        device="cuda",
    ):
        if quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
        self.page_size = page_size
        self.max_slots = max_slots
        self.max_pages_per_seq = cdiv(max_context, page_size)
        if num_pages is None:  # worst case: every slot at max context, + null
            num_pages = max_slots * self.max_pages_per_seq + 1
        self.num_pages = num_pages
        self.quant = quant
        self.tiers = tiers
        self.device = resolve_device(device)
        # + 1: the sink page (see module docstring)
        shape = (num_layers, num_pages + 1, page_size, num_kv_heads, head_dim)
        store = torch.int8 if quant == "int8" else dtype
        self.pages: dict[str, torch.Tensor] = {
            "k": torch.zeros(shape, dtype=store, device=self.device),
            "v": torch.zeros(shape, dtype=store, device=self.device),
        }
        if quant == "int8":
            for key in ("k_scale", "v_scale"):
                self.pages[key] = torch.zeros(shape[:-1], dtype=torch.float32,
                                              device=self.device)

        self.pool = PagePool(num_pages)
        self.block_tables = np.full(
            (max_slots, self.max_pages_per_seq), NULL_PAGE, np.int32
        )
        self.lengths = np.zeros((max_slots,), np.int32)
        self._slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
        self._free_slots = list(range(max_slots - 1, -1, -1))
        # prefix index: (parent physical page, token chunk) -> physical page
        self._prefix_index: dict[tuple, int] = {}
        self._page_key: dict[int, tuple] = {}  # reverse map for dereg on free
        # content key per indexed page (kv_tiers.chain_key): names the prefix
        # by token content, so it survives spill/reload and page-id reuse
        self._page_ck: dict[int, bytes] = {}
        self.stats = {"prefix_hits": 0, "prefix_tokens_reused": 0,
                      "cow_copies": 0}

    # ------------------------------------------------------------------
    # prefix index
    # ------------------------------------------------------------------
    def _prefix_limit(self, tokens) -> int:
        """Number of full pages eligible for sharing: capped strictly below
        the last token, so recomputing the sampling position never writes
        into a shared page (see module docstring)."""
        return max(0, (len(tokens) - 1) // self.page_size)

    def match_prefix(self, tokens, prefetch: bool = False) -> tuple[list[int], int]:
        """Longest chain of registered full pages matching ``tokens``.

        Keys are hash-chained, (parent physical page, this page's token
        chunk) — O(1) per level instead of rehashing the whole prefix —
        with NULL_PAGE as the chain root. A parent page id uniquely names
        its prefix because every sharer of a child page also holds the
        parent (prefix structure), so a parent entry can never be freed
        (and its id recycled) while a child entry survives.

        Tier semantics: prefetch-PENDING pages (host→device copy dispatched
        this step, published next step by :meth:`tick_tiers`) count as a
        miss, so an admission never maps a page whose transfer it cannot
        know has landed. With ``prefetch=True`` (the :meth:`can_admit`
        path only), a walk that runs past device residency looks the next
        chunks up by content key in the host/persisted tiers and dispatches
        their uploads — the triggering request then waits a step (deferred
        admission) without blocking anyone else.

        Returns (pages, matched_token_count). Aside from prefetch, read
        only: the caller (:meth:`admit`) takes the references.
        """
        ps = self.page_size
        tiers = self.tiers
        pages: list[int] = []
        parent = NULL_PAGE
        limit = self._prefix_limit(tokens)
        for i in range(limit):
            page = self._prefix_index.get(
                (parent, tuple(tokens[i * ps:(i + 1) * ps]))
            )
            if page is None or (tiers is not None and page in tiers.pending):
                break
            pages.append(page)
            parent = page
        if tiers is not None:
            for p in pages:  # matched parked pages move to the MRU end
                tiers.touch(p)
            if prefetch:
                self._prefetch_chain(pages, tokens, limit)
        return pages, len(pages) * ps

    def _prefetch_chain(self, matched: list[int], tokens, limit: int) -> None:
        """Extend a device-resident prefix from the host/persisted tiers.

        Each hit allocates a device page, dispatches the upload (async),
        registers the page in the prefix index and parks it PENDING. The
        walk stops at the first tier miss, at a page some other query is
        already prefetching, or when taking one more page would leave the
        pool unable to cover the rest of this prompt (prefetch must never
        starve the admission it serves)."""
        tiers = self.tiers
        ps = self.page_size
        i = len(matched)
        parent = matched[-1] if matched else NULL_PAGE
        parent_ck = self._page_ck.get(parent, b"")
        total = cdiv(len(tokens), ps)
        while i < limit:
            chunk = tuple(tokens[i * ps:(i + 1) * ps])
            if (parent, chunk) in self._prefix_index:
                break  # already resident (pending from an earlier query)
            if self.pool.available < total - i:
                break
            ck = chain_key(parent_ck, chunk)
            arrays = tiers.lookup(ck)
            if arrays is None:
                break
            t0 = time.perf_counter()
            (page,) = self.pool.alloc(1)
            self._upload_page(page, arrays)
            self.pool.park(page)
            key = (parent, chunk)
            self._prefix_index[key] = page
            self._page_key[page] = key
            self._page_ck[page] = ck
            tiers.park(page, ck)
            tiers.pending.add(page)
            tiers.counters["prefetched_pages"] += 1
            tiers.counters["prefetch_bytes"] += sum(
                a.nbytes for a in arrays.values()
            )
            tiers.counters["prefetch_s"] += time.perf_counter() - t0
            parent, parent_ck = page, ck
            i += 1

    def _next_is_pending(self, matched: list[int], tokens) -> bool:
        """True when the first chunk past the device match maps to a page
        whose prefetch is still pending — the caller should defer admission
        one step instead of re-prefilling a prefix that is already in flight."""
        if self.tiers is None:
            return False
        i = len(matched)
        if i >= self._prefix_limit(tokens):
            return False
        ps = self.page_size
        parent = matched[-1] if matched else NULL_PAGE
        page = self._prefix_index.get(
            (parent, tuple(tokens[i * ps:(i + 1) * ps]))
        )
        return page is not None and page in self.tiers.pending

    def register_prefix(self, slot: int, tokens, upto: int) -> None:
        """Publish ``slot``'s full pages covering ``tokens[:upto]`` into the
        prefix index. MUST only be called once the K/V for those positions
        has been dispatched (the index hands these pages to other slots).

        Keys chain through THIS slot's own pages (not a previously
        registered twin): the slot provably keeps its own parent alive, so
        child entries never dangle behind a freed/recycled parent id. If a
        twin chain registered first (concurrent identical prefills), ours
        becomes an unreachable side chain — a missed match, never a wrong
        one — and admission deferral makes that window rare."""
        ps = self.page_size
        parent = NULL_PAGE
        parent_ck = b""
        for i in range(min(upto, len(tokens)) // ps):
            chunk = tuple(tokens[i * ps:(i + 1) * ps])
            key = (parent, chunk)
            page = self._slot_pages[slot][i]
            if key not in self._prefix_index:
                self._prefix_index[key] = page
                self._page_key[page] = key
                if self.tiers is not None:
                    self._page_ck[page] = chain_key(parent_ck, chunk)
            parent = page
            if self.tiers is not None:
                parent_ck = chain_key(parent_ck, chunk)

    def _deregister(self, page: int) -> None:
        key = self._page_key.pop(page, None)
        if key is not None:
            del self._prefix_index[key]
        self._page_ck.pop(page, None)

    # ------------------------------------------------------------------
    # tiers: park / reclaim / prefetch plumbing
    # ------------------------------------------------------------------
    def _drop_ref(self, page: int) -> None:
        """Drop one reference; a prefix-index page whose LAST reference
        drops is parked (tiers on) instead of freed, so a later rerun of
        the same prompt still matches it."""
        if (self.tiers is not None and page in self._page_key
                and self.pool.refcounts[page] == 1):
            self.pool.park(page)
            self.tiers.park(page, self._page_ck[page])
        elif self.pool.decref(page):
            self._deregister(page)

    def _alloc(self, n: int) -> list[int]:
        """``pool.alloc`` that reclaims parked pages under pressure first."""
        if self.tiers is not None and self.pool.available < n:
            self.reclaim_parked(n - self.pool.available)
        return self.pool.alloc(n)

    def reclaim_parked(self, n: int, protect=()) -> int:
        """Spill and free at least ``n`` parked pages (LRU first); returns
        how many were actually freed (0 when the tier is off or empty).

        Freeing a page whose id is a prefix-index *parent* would let the id
        recycle under surviving child entries (an ABA wrong-match), and a
        child whose parent left the index is unreachable anyway — so each
        reclaim cascades over the page's index descendants. Descendants of
        a parked page are provably parked too (any live holder of a child
        also holds the parent), so the cascade never touches a live slot.
        Contents are spilled to the host/persisted tiers before the device
        page is reused; content keys keep the spilled chain matchable."""
        if self.tiers is None or n <= 0:
            return 0
        tiers = self.tiers
        protect = set(protect)
        freed = 0
        while freed < n:
            got = tiers.pop_lru(protect)
            if got is None:
                break
            batch = [got]
            i = 0
            while i < len(batch):  # gather index descendants (all parked)
                parent_page = batch[i][0]
                i += 1
                for child, key in list(self._page_key.items()):
                    if key[0] == parent_page:
                        assert child in tiers.parked, (child, key)
                        batch.append((child, tiers.unpark(child)))
            t0 = time.perf_counter()
            for page, ck in batch:
                if tiers.wants_spill:
                    tiers.spill(ck, self._read_page(page))
                self._deregister(page)
                self.pool.reclaim(page)
                freed += 1
            tiers.counters["spill_s"] += time.perf_counter() - t0
            tiers.counters["reclaimed_pages"] += len(batch)
        return freed

    def tick_tiers(self) -> None:
        """Publish pending prefetches; the engine calls this once per step."""
        if self.tiers is not None:
            self.tiers.tick()

    def flush_tiers(self) -> int:
        """Spill and free EVERY parked page (idle demotion, or persisting
        the prefix cache before a planned restart). Returns pages freed."""
        if self.tiers is None:
            return 0
        self.tiers.tick()
        return self.reclaim_parked(len(self.tiers.parked))

    @property
    def parked_count(self) -> int:
        return 0 if self.tiers is None else len(self.tiers.parked)

    def _read_page(self, page: int) -> dict[str, np.ndarray]:
        """One physical page's contents (all layers) as host arrays of the
        pool's own widths (:func:`_read_block`), so the spilled and
        persisted bytes are the JAX package's."""
        return {key: _read_block(arr, page) for key, arr in self.pages.items()}

    def _upload_page(self, page: int, arrays: dict[str, np.ndarray]) -> None:
        """Write one spilled page back into the pool."""
        for key, arr in self.pages.items():
            _write_page(arr, page, arrays[key])

    # ------------------------------------------------------------------
    # slots
    # ------------------------------------------------------------------
    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    def can_admit(self, context_len: int, tokens=None) -> bool:
        """Admission check — with tiers attached this is also where the
        pressure valve lives: parked pages are reclaimed BEFORE the check
        can fail, and a prompt whose spilled prefix is mid-prefetch waits
        (returns False) rather than re-prefilling it."""
        if not self._free_slots:
            return False
        need = cdiv(max(context_len, 1), self.page_size)
        matched: list[int] = []
        if tokens is not None:
            if self.tiers is not None:
                self.tiers.counters["prefix_queries"] += 1
            matched = self.match_prefix(tokens, prefetch=True)[0]
            need -= len(matched)
            if self._next_is_pending(matched, tokens):
                return False
        if self.pool.available < need:
            self.reclaim_parked(need - self.pool.available, protect=matched)
        return self.pool.available >= need

    def admit(self, context_len: int, tokens=None) -> tuple[int, int]:
        """Claim a slot and pages for an initial context of ``context_len``.

        When ``tokens`` (the prompt) is given, full pages already holding a
        matching prefix are mapped read-only (refcount bumped; parked pages
        are revived in place) instead of allocated. Returns
        (slot, cached_len) — the caller only needs to prefill positions
        >= cached_len.
        """
        assert context_len <= self.max_pages_per_seq * self.page_size, (
            context_len, self.max_pages_per_seq * self.page_size)
        shared: list[int] = []
        cached = 0
        if tokens is not None:
            shared, cached = self.match_prefix(tokens)
        slot = self._free_slots.pop()
        for p in shared:
            if self.tiers is not None and p in self.tiers.parked:
                self.tiers.unpark(p)
                self.pool.revive(p)
                self.tiers.counters["device_hits"] += 1
            else:
                self.pool.incref(p)
        fresh = cdiv(max(context_len, 1), self.page_size) - len(shared)
        try:
            pages = shared + (self._alloc(fresh) if fresh > 0 else [])
        except RuntimeError:
            for p in shared:  # revived parked pages re-park, sharers decref
                self._drop_ref(p)
            self._free_slots.append(slot)
            raise
        if shared:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += cached
        self._slot_pages[slot] = pages
        self.block_tables[slot] = NULL_PAGE
        self.block_tables[slot, : len(pages)] = pages
        self.lengths[slot] = context_len
        return slot, cached

    def fork(self, src_slot: int) -> int:
        """Map every page of ``src_slot`` (including the partial tail) into a
        fresh slot, copy-on-write. The clone starts at the same length; the
        first append into a still-shared page triggers exactly one copy."""
        assert self._slot_pages[src_slot], f"slot {src_slot} is empty"
        slot = self._free_slots.pop()
        pages = list(self._slot_pages[src_slot])
        for p in pages:
            self.pool.incref(p)
        self._slot_pages[slot] = pages
        self.block_tables[slot] = self.block_tables[src_slot]
        self.lengths[slot] = self.lengths[src_slot]
        return slot

    def ensure_append_capacity(self, slot: int, n: int = 1) -> bool:
        """Make sure positions ``lengths[slot] .. lengths[slot]+n-1`` are
        writable before a dispatch lands there: allocates a page at page
        boundaries (on-demand growth) and copy-on-writes a shared page
        anywhere else. ``n=1`` is the plain decode step; a speculative
        verify bundle passes ``n = k+1`` so every drafted position is
        writable BEFORE the single fused dispatch scatters them (rollback
        then only rewinds ``lengths`` — over-provisioned tail pages stay
        owned by the slot and are reused by the next append). Returns True
        when the block table changed; raises RuntimeError when the pool is
        exhausted (callers may preempt) — with tiers attached, parked pages
        are reclaimed first, so preemption is truly the last resort. On a
        mid-range RuntimeError the pages already granted remain recorded in
        the slot's table (no leak; the caller retries or preempts)."""
        changed = False
        length = int(self.lengths[slot])
        pages = self._slot_pages[slot]
        for pos in range(length, length + n):
            need = pos // self.page_size
            if need == len(pages):
                (new,) = self._alloc(1)
                pages.append(new)
                self.block_tables[slot, need] = new
                changed = True
                continue
            old = pages[need]
            if self.pool.refcounts[old] > 1:  # shared: copy before the write
                (new,) = self._alloc(1)
                _copy_page(self.pages, old, new)
                self.pool.decref(old)  # shared, so never frees here
                pages[need] = new
                self.block_tables[slot, need] = new
                self.stats["cow_copies"] += 1
                changed = True
        return changed

    def append(self, slot: int) -> None:
        """Record that the decode step wrote one token for this slot."""
        self.lengths[slot] += 1

    def release(self, slot: int) -> None:
        for p in self._slot_pages[slot]:
            self._drop_ref(p)
        self._slot_pages[slot] = []
        self.block_tables[slot] = NULL_PAGE
        self.lengths[slot] = 0
        self._free_slots.append(slot)

    # ------------------------------------------------------------------
    # device views
    # ------------------------------------------------------------------
    def device_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Device copies of (block_tables, lengths).

        MUST copy: ``torch.from_numpy`` aliases the host numpy buffer (and
        ``.to("cpu")`` keeps the alias), and these arrays are mutated in
        place between steps — an aliased buffer shows up as stale block
        tables / lengths.
        """
        return (torch.from_numpy(self.block_tables.copy()).to(self.device),
                torch.from_numpy(self.lengths.copy()).to(self.device))

    def device_row(self, slot: int) -> torch.Tensor:
        """Device copy of one slot's block-table row (same aliasing rule)."""
        return torch.from_numpy(self.block_tables[slot].copy()).to(self.device)

    @property
    def page_nbytes(self) -> int:
        """Device bytes per physical page across every pool tensor (K, V
        and the int8 pool's scales): the denominator of pages per byte."""
        return sum(arr[:, 0].numel() * arr.element_size()
                   for arr in self.pages.values())

    def gather_dense(self, slot: int) -> tuple[np.ndarray, np.ndarray]:
        """A slot's K/V as dense host (L, len, KVH, Dh) arrays (tests
        only); an int8 pool is dequantized, so callers compare f32."""
        if self.quant == "int8":
            k = dequantize_pages(self.pages["k"], self.pages["k_scale"])
            v = dequantize_pages(self.pages["v"], self.pages["v_scale"])
        else:
            k, v = self.pages["k"], self.pages["v"]
        n = int(self.lengths[slot])
        idx = torch.tensor(self._slot_pages[slot], device=k.device)
        out = []
        for arr in (k, v):
            dense = arr[:, idx].reshape(arr.shape[0], -1, *arr.shape[3:])
            out.append(dense[:, :n].float().cpu().numpy())
        return out[0], out[1]


def write_prefill_pages(
    pages: dict[str, torch.Tensor],  # the pool, written in place
    k_new: torch.Tensor,     # (L, S, KVH, Dh) dense prefill K (S may be padded)
    v_new: torch.Tensor,
    table_row: torch.Tensor,  # (MP,) int32 physical page per logical page
    valid_len,                # int or int scalar: positions < valid_len are real
) -> None:
    """Scatter one sequence's dense prefill K/V into its pages, in place.

    Padded positions (>= valid_len) go to the sink page, where the JAX
    version routes them out of bounds and drops them (``mode="drop"``);
    every real position's (page, offset) is unique. An int8 pool
    quantizes the dense K/V on the way in and writes the scales alongside
    (the padded rows' scales go to the sink too)."""
    sink = pages["k"].shape[1] - 1
    page = pages["k"].shape[2]
    pos = torch.arange(k_new.shape[1], device=k_new.device)
    logical = (pos // page).clamp_max(table_row.shape[0] - 1)
    phys = torch.where(pos < valid_len, table_row[logical].long(), sink)
    off = pos % page
    if "k_scale" in pages:
        k_new, k_sc = quantize_kv(k_new)
        v_new, v_sc = quantize_kv(v_new)
        pages["k_scale"][:, phys, off] = k_sc
        pages["v_scale"][:, phys, off] = v_sc
    pages["k"][:, phys, off] = k_new.to(pages["k"].dtype)
    pages["v"][:, phys, off] = v_new.to(pages["v"].dtype)
