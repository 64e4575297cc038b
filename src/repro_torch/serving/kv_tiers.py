"""Cache-tier manager behind :class:`~repro_torch.serving.kv_cache.PagedKVCache`.

The page-pool capacity wall (ROADMAP item 3) is an *admission* problem: every
engine queues behind HBM-resident KV pages, yet the dominant workload —
notebook pipelines rerun repeatedly for reproduction — re-presents the same
prompt prefixes over and over with idle gaps in between. This module keeps
those prefixes alive across releases and lets them overflow HBM entirely.

Page state machine (one page moves strictly through these states)::

        alloc            release (last ref,        reclaim under
          |               page in prefix index)     pressure
          v                      |                     |
        LIVE  ----------------> PARKED  ------------> HOST  ----> PERSISTED
     (refcount>0)          (refcount 0, still      (numpy copy,   (ArtifactStore,
          ^                 device-resident,        device page    content-addressed,
          |   prefix hit    in the prefix index,    freed)         survives restart)
          +---- revive -----    reclaim-under-           |              |
          |                     pressure LRU)            +-- prefetch --+
          +-------------- async prefetch ----------------+   (on prefix-index hit)

* **PARKED** — a zero-refcount page whose prefix-index entry survives; it
  costs nothing until the pool runs dry, at which point
  ``PagedKVCache.reclaim_parked`` (called from ``can_admit`` /
  ``ensure_append_capacity`` *before* admission fails or preemption fires)
  spills the LRU parked pages and returns them to the free list.
* **HOST** — spilled page contents as numpy buffers keyed by *content key*
  (a sha256 chain over (parent content key, token chunk) — the content
  analogue of the device prefix index's (parent page id, chunk) key, stable
  across physical page reuse and process restarts). Capped at
  ``host_pages`` entries, LRU-evicted.
* **PERSISTED** — optional write-through of every spill into a
  ``core.storage.ArtifactStore`` (the repo's PV analogue); the content-key →
  ref index lives next to the objects as ``kv_prefix_index.json`` so a fresh
  process re-attaches to yesterday's prefixes.

Prefetch is *asynchronous at the dispatch level*: on a prefix-index walk
that runs past device residency, ``PagedKVCache.match_prefix(prefetch=True)``
allocates device pages, enqueues the host→device copies (jax dispatch is
async — the transfer overlaps host work) and registers the pages as parked
**pending**. Pending pages are treated as a miss until the engine's next
step calls ``tick()``, so the admission that triggered the prefetch waits
one step without ever blocking the step itself.

This class is deliberately device-free: it owns policy (LRU order, the
pending set, tier capacities) and host/persisted bytes. All device work —
page reads/writes, allocation, refcounts — stays in ``PagedKVCache``.
"""

from __future__ import annotations

import hashlib
import json
from collections import OrderedDict

import numpy as np

from repro_torch.core.storage import ArtifactStore

_INDEX_NAME = "kv_prefix_index.json"


def chain_key(parent: bytes, chunk) -> bytes:
    """Content key of one full page: sha256 over (parent key, token chunk).

    Root pages chain from ``b""``. Unlike the device prefix index's
    (parent *page id*, chunk) key, this names the prefix by content only,
    so it survives physical page reuse, spill/reload and process restarts.
    """
    h = hashlib.sha256(parent)
    h.update(np.asarray(tuple(chunk), np.int64).tobytes())
    return h.digest()


class KVTierManager:
    """Parked-LRU + host-RAM + persisted tiers for prefix KV pages.

    ``parked`` maps device page id -> content key in LRU order (oldest
    first); ``host`` maps content key -> per-array numpy page blocks;
    ``persist_index`` maps hex content key -> per-array ArtifactStore refs.
    ``pending`` holds device page ids whose host→device prefetch was
    dispatched this step; :meth:`tick` publishes them.

    ``counters`` is purely additive (ints/floats only) so metrics trackers
    can snapshot/delta/merge it without knowing the key set.
    """

    def __init__(
        self,
        *,
        host_pages: int = 0,
        store: ArtifactStore | None = None,
        persist_tier: str = "node",
    ):
        self.host_pages = int(host_pages)
        self.store = store
        self.persist_tier = persist_tier
        self.parked: OrderedDict[int, bytes] = OrderedDict()
        self.pending: set[int] = set()
        self.host: OrderedDict[bytes, dict[str, np.ndarray]] = OrderedDict()
        self.persist_index: dict[str, dict[str, str]] = {}
        if store is not None:
            idx = store.root / _INDEX_NAME
            if idx.exists():
                self.persist_index = json.loads(idx.read_text())
        self.counters: dict[str, float] = {
            "prefix_queries": 0,
            "device_hits": 0,      # parked pages revived in place
            "host_hits": 0,        # pages prefetched back from host RAM
            "persist_hits": 0,     # pages prefetched back from the store
            "prefetched_pages": 0,
            "prefetch_bytes": 0,
            "prefetch_s": 0.0,
            "spilled_pages": 0,
            "spill_bytes": 0,
            "spill_s": 0.0,
            "reclaimed_pages": 0,  # parked pages returned to the free list
        }

    # ------------------------------------------------------------------
    # parked tier (device-resident, refcount 0)
    # ------------------------------------------------------------------
    def park(self, page: int, ck: bytes) -> None:
        assert page not in self.parked, page
        self.parked[page] = ck

    def unpark(self, page: int) -> bytes:
        self.pending.discard(page)
        return self.parked.pop(page)

    def touch(self, page: int) -> None:
        """Move a matched parked page to the MRU end (protects a prefix that
        is being re-queried from reclaim racing its own admission)."""
        if page in self.parked:
            self.parked.move_to_end(page)

    def pop_lru(self, skip: set[int]) -> tuple[int, bytes] | None:
        """Oldest parked page not in ``skip`` (and not prefetch-pending)."""
        for page, ck in self.parked.items():
            if page not in skip and page not in self.pending:
                del self.parked[page]
                return page, ck
        return None

    def tick(self) -> None:
        """Publish prefetched pages: the engine calls this once per step, so
        every transfer dispatched during the previous step's admission pass
        has a full dispatch round to land before anyone can match it."""
        self.pending.clear()

    # ------------------------------------------------------------------
    # host + persisted tiers (content-key addressed)
    # ------------------------------------------------------------------
    def spill(self, ck: bytes, arrays: dict[str, np.ndarray]) -> None:
        """Demote one page's contents out of HBM: write-through to the store
        (when configured) and into the host LRU (when capacity allows)."""
        nbytes = sum(a.nbytes for a in arrays.values())
        self.counters["spilled_pages"] += 1
        self.counters["spill_bytes"] += nbytes
        if self.store is not None:
            hx = ck.hex()
            if hx not in self.persist_index:
                self.persist_index[hx] = {
                    key: self.store.put(a, tier=self.persist_tier, name=f"kv.{key}")
                    for key, a in arrays.items()
                }
                self._save_index()
        if self.host_pages > 0:
            self.host[ck] = arrays
            self.host.move_to_end(ck)
            while len(self.host) > self.host_pages:
                # write-through above means evicted entries are already
                # persisted (or deliberately droppable): just forget them
                self.host.popitem(last=False)

    def lookup(self, ck: bytes) -> dict[str, np.ndarray] | None:
        """Fetch one page's contents from host RAM, else the store.

        A host hit *promotes*: the entry moves back to device (the caller
        uploads it), so it leaves the host LRU. Persisted entries are
        immutable and stay."""
        arrays = self.host.pop(ck, None)
        if arrays is not None:
            self.counters["host_hits"] += 1
            return arrays
        if self.store is not None:
            refs = self.persist_index.get(ck.hex())
            if refs is not None:
                self.counters["persist_hits"] += 1
                return {key: self.store.get(ref) for key, ref in refs.items()}
        return None

    def _save_index(self) -> None:
        (self.store.root / _INDEX_NAME).write_text(
            json.dumps(self.persist_index)
        )

    # ------------------------------------------------------------------
    @property
    def wants_spill(self) -> bool:
        """False when reclaimed contents have nowhere to go (device-parking
        only): the caller skips the device read entirely."""
        return self.host_pages > 0 or self.store is not None

    @property
    def parked_count(self) -> int:
        return len(self.parked)

    @property
    def host_count(self) -> int:
        return len(self.host)

    @property
    def persisted_count(self) -> int:
        return len(self.persist_index)
