"""Host-side scheduling policy for the paged serving engine.

This module is the POLICY half of the scheduler/executor split
(``docs/serving.md``): everything the continuous-batching engine decides on
the host — slot placement, chunked-prefill interleaving, prefix-sharing
deferral, preemption victim selection, page accounting and decode-batch
assembly — lives here as plain Python + numpy, with no jax import and no
device dispatch. The device half (:class:`repro_torch.serving.executor.
ModelExecutor`) consumes the work items this module produces
(:class:`PrefillChunk`, :class:`DecodeInputs`) and never makes decisions.

The split is what makes sharded serving tractable: ONE scheduler instance
drives the whole mesh. Because the executor shards the KV page pool along
the head dimension, block tables and page ids are identical on every shard,
so the prefix/refcount index stays a single host-side structure — no
replication, no cross-shard reconciliation (the ROADMAP's
replicate-vs-shard question resolves to "neither: shard only the tensor
dim the host never indexes by").

It is also what makes the policy unit-testable: every method here can be
driven against a :class:`~repro_torch.serving.kv_cache.PagedKVCache` without
compiling or dispatching a single model step (see
``tests/test_serving_sharded.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.serving.kv_cache import NULL_PAGE, PagedKVCache

__all__ = [
    "DecodeInputs",
    "PrefillChunk",
    "Scheduler",
    "Sequence",
    "SpecBundle",
    "StepPlan",
]


@dataclass
class Sequence:
    """One in-flight sequence (a slot's host-side state)."""

    request: object         # serving.api.Request
    handle: object          # serving.api.RequestHandle
    tokens: list[int]       # this ATTEMPT's tokens (feed decode; the handle
                            # owns the emitted stream, which survives
                            # preemption)
    order: int = 0          # admission sequence number (preemption picks
                            # youngest)
    phase: str = "decode"   # "prefill" until the whole prompt is cached
    prefill_pos: int = 0    # prompt positions already resident in pages


@dataclass
class PrefillChunk:
    """One chunk of prefill work for the executor: ``tokens`` is the padded
    fixed-size chunk, positions ``[start, start+valid)`` are real."""

    slot: int
    seq: Sequence
    tokens: np.ndarray
    start: int
    valid: int


@dataclass
class DecodeInputs:
    """One decode step's host-assembled batch (numpy; the executor mirrors
    it to the device only when the composition changed)."""

    tokens: np.ndarray        # (S, 1) int32 last token per slot
    temps: np.ndarray         # (S,) f32
    top_ks: np.ndarray        # (S,) int32
    top_ps: np.ndarray        # (S,) f32
    seeds: np.ndarray         # (S,) int32
    idx: np.ndarray           # (S,) int32 per-request token index
    active: np.ndarray        # (S,) int32 1 for decoding slots
    block_tables: np.ndarray  # (S, MP) int32; masked slots -> null page
    lengths: np.ndarray       # (S,) int32; masked slots -> 0
    greedy_only: bool = True


@dataclass
class SpecBundle:
    """One speculation bundle: chunk-style verify rows for ONE decoding
    slot. Row 0 feeds the last committed token (whose KV is not yet
    cached — exactly what a plain decode row would feed), rows 1..k feed
    the proposer's drafts; the executor scores all of them in one fused
    dispatch over the slot's own block table at positions
    ``start .. start+valid-1``. ``tokens`` is padded to the static bundle
    width (``spec_k + 1``) so the jitted verify step never recompiles."""

    slot: int
    seq: Sequence
    tokens: np.ndarray   # (W,) int32 padded [t_last, d_1 .. d_k]
    start: int           # cache length L before the bundle dispatched
    valid: int           # 1 + k live rows
    drafts: list[int]    # the k proposed tokens (unpadded)


@dataclass
class StepPlan:
    """Everything one fused engine step dispatches: the decode batch plus at
    most one token-budgeted prefill chunk, all with static padded shapes
    (``decode`` is always the full S-slot batch, ``chunk`` always C padded
    tokens), so the executor's fused function never recompiles.

    ``decode_slots`` captures the decoding slots at plan time — the engine
    harvests exactly these after the dispatch, so a sequence that becomes
    decodable mid-step (the chunk finishing its prompt) is never harvested
    from a dispatch it was not part of. ``decode`` is None when the device
    mirrors are already current (the steady-state zero-transfer path).
    ``step_tokens`` is the plan's token-budget spend: one per decode row
    plus the chunk's valid tokens plus each spec bundle's live rows.

    ``spec`` carries this step's speculation bundles (at most one per
    decoding slot): each is ONE work item the executor scores with one
    fused verify dispatch. Bundled slots are excluded from
    ``decode_slots`` and masked in the decode batch — their step happens
    through the bundle, never twice.
    """

    decode_slots: list[int]
    decode: DecodeInputs | None
    chunk: PrefillChunk | None
    step_tokens: int
    spec: list[SpecBundle] = None  # None == no speculation this step


class Scheduler:
    """Pure-host scheduler over a :class:`PagedKVCache`'s bookkeeping.

    Owns the slot map and every serving *decision*; owns NO jitted function
    and no device array. The engine translates its outputs into lifecycle
    events and executor calls.
    """

    def __init__(
        self,
        cache: PagedKVCache,
        *,
        prefill_chunk: int | None,
        chunked: bool,
        prefix_sharing: bool,
        extra_ctx: int = 0,
        token_budget: int | None = None,
    ):
        self.cache = cache
        self.prefill_chunk = prefill_chunk
        self.chunked = chunked
        self.prefix_sharing = prefix_sharing and chunked
        self.extra_ctx = extra_ctx  # non-token context (vlm frontend tokens)
        # Sarathi-style cap on tokens per fused step (decode rows + chunk
        # valid); None = uncapped. Only build_step_plan applies it — the
        # interleaved A/B path is unaffected.
        self.token_budget = token_budget
        self.slots: dict[int, Sequence] = {}
        self._admit_counter = 0
        # persistent decode-batch mirrors: build_decode_inputs refreshes
        # only the slots marked dirty since the last build, so host-side
        # per-step assembly stops scaling with max_slots
        n, mp = cache.block_tables.shape
        self._mir_tokens = np.zeros((n, 1), np.int32)
        self._mir_temps = np.zeros((n,), np.float32)
        self._mir_tks = np.zeros((n,), np.int32)
        self._mir_tps = np.ones((n,), np.float32)
        self._mir_seeds = np.zeros((n,), np.int32)
        self._mir_idx = np.zeros((n,), np.int32)
        self._mir_active = np.zeros((n,), np.int32)
        self._mir_bt = np.full((n, mp), NULL_PAGE, np.int32)
        self._mir_lens = np.zeros((n,), np.int32)
        self._dirty_slots: set[int] = set()
        self._all_dirty = True  # composition changed since last build

    @property
    def dirty(self) -> bool:
        """True when the decode batch must be (re)built before dispatching
        (composition changed: admission, begin/end of decode, eviction,
        block-table growth/COW). Length/token advances from decoded tokens
        do NOT dirty the batch — the executor's jitted step advances its
        device copies identically."""
        return self._all_dirty or bool(self._dirty_slots)

    def _mark(self, slot: int) -> None:
        self._dirty_slots.add(slot)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _pending_prefix_gain(self, tokens: list[int]) -> int:
        """Longest full-page prefix of ``tokens`` that an IN-FLIGHT prefill
        will publish to the prefix index but has not yet (its chunks haven't
        reached those pages). Admission waits for such a prefix instead of
        allocating private pages for content that is about to be shared —
        without this, a burst of same-prefix requests admitted in one step
        would get zero sharing."""
        ps = self.cache.page_size
        limit = self.cache._prefix_limit(tokens)
        best = 0
        for seq in self.slots.values():
            if seq.phase != "prefill":
                continue
            other = seq.request.prompt
            n = 0
            for i in range(min(limit, len(other) // ps)):
                if tokens[i * ps:(i + 1) * ps] != other[i * ps:(i + 1) * ps]:
                    break
                n += 1
            best = max(best, n * ps)
        return best

    def can_place(self, request) -> bool:
        """Whether the queue head should be admitted NOW — false when the
        cache lacks slots/pages for it, or when deferring would let it share
        a prefix an in-flight prefill is about to publish."""
        tokens = request.prompt if self.prefix_sharing else None
        if tokens is not None:
            matched = self.cache.match_prefix(tokens)[1]
            if self._pending_prefix_gain(tokens) > matched:
                return False  # a longer shared prefix lands within a few chunks
        return self.cache.can_admit(self.extra_ctx + len(request.prompt), tokens)

    def place(self, request, handle) -> tuple[int, Sequence, int]:
        """Claim a slot and pages for ``request``. Returns
        ``(slot, sequence, cached_len)``; chunked sequences start in the
        ``prefill`` phase at ``prefill_pos=cached_len`` (shared prefix pages
        already mapped), legacy whole-prompt sequences start decode-ready
        (the engine runs their prefill immediately)."""
        tokens = request.prompt if self.prefix_sharing else None
        slot, cached = self.cache.admit(
            self.extra_ctx + len(request.prompt), tokens
        )
        self._admit_counter += 1
        seq = Sequence(
            request, handle, [], order=self._admit_counter,
            phase="prefill" if self.chunked else "decode",
            prefill_pos=cached,
        )
        self.slots[slot] = seq
        self._mark(slot)
        return slot, seq, cached

    # ------------------------------------------------------------------
    # chunked prefill
    # ------------------------------------------------------------------
    def next_prefill(self, limit: int | None = None,
                     width: int | None = None) -> PrefillChunk | None:
        """The OLDEST in-flight prefill's next fixed-size chunk (the engine
        runs at most one per step so concurrent decodes stall for one
        chunk's latency at worst), or None when nothing is prefilling.
        ``limit`` caps the chunk's live tokens (the fused step's token
        budget); a zero limit defers the chunk entirely this step.
        ``width`` shrinks the chunk's STATIC buffer below
        ``prefill_chunk`` — under a token budget the live tokens can never
        exceed the budget, so padding the buffer past it would make every
        fused dispatch pay compute for rows the mask kills."""
        cands = [(q.order, s) for s, q in self.slots.items()
                 if q.phase == "prefill"]
        if not cands:
            return None
        _, slot = min(cands)
        seq = self.slots[slot]
        prompt = seq.request.prompt
        start = seq.prefill_pos
        c = self.prefill_chunk if width is None else min(
            self.prefill_chunk, max(1, width))
        valid = min(c, len(prompt) - start)
        if limit is not None:
            valid = min(valid, limit)
        if valid <= 0:
            return None  # budget exhausted by decode rows: defer one step
        toks = np.zeros((c,), np.int32)
        toks[:valid] = prompt[start:start + valid]
        return PrefillChunk(slot, seq, toks, start, valid)

    def complete_chunk(self, work: PrefillChunk) -> bool:
        """Record a dispatched chunk: advance the prefill cursor, publish
        the covered full pages to the prefix index (dispatch order is
        execution order, so a later admission can share them safely).
        Returns True when the prompt is now fully cached."""
        seq = work.seq
        prompt = seq.request.prompt
        seq.prefill_pos = work.start + work.valid
        if self.prefix_sharing:
            self.cache.register_prefix(work.slot, prompt, seq.prefill_pos)
        return seq.prefill_pos == len(prompt)

    def begin_decode(self, slot: int) -> None:
        """Prompt fully cached: the slot joins the decode batch."""
        self.slots[slot].phase = "decode"
        self._mark(slot)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def find(self, uid: str) -> int | None:
        for slot, seq in self.slots.items():
            if seq.request.uid == uid:
                return slot
        return None

    def release(self, slot: int) -> Sequence:
        """Free a finished/cancelled sequence's slot and pages."""
        seq = self.slots.pop(slot)
        self.cache.release(slot)
        self._mark(slot)
        return seq

    def has_decodable(self) -> bool:
        return any(q.phase == "decode" for q in self.slots.values())

    def decoding(self) -> list[tuple[int, Sequence]]:
        """(slot, seq) pairs currently in the decode phase, slot order."""
        return sorted(
            (s, q) for s, q in self.slots.items() if q.phase == "decode"
        )

    def evict_youngest(self) -> tuple[int, Sequence]:
        """Release the youngest sequence (any phase) and hand it back for
        the engine to requeue or finish ``preempted``."""
        slot = max(self.slots, key=lambda s: self.slots[s].order)
        return slot, self.release(slot)

    def ensure_decode_capacity(
        self, extra: dict[int, int] | None = None
    ) -> list[Sequence]:
        """Give every DECODING slot a writable page for its next position —
        growing at page boundaries, copying a shared (refcount > 1) page
        anywhere else — evicting the youngest sequences if the pool runs
        dry. ``extra[slot]`` requests that many positions BEYOND the next
        one: a speculative verify bundle scatters k+1 candidate positions
        in one dispatch, so every one of them must be writable up front
        (rollback then never has to un-allocate — it only rewinds the
        length, and over-provisioned tail pages stay owned by the slot).
        A lone sequence can always grow (submit rejects requests that
        exceed the whole pool, and the engine caps drafts at the request's
        validated max_new budget), so this terminates with at least one
        slot making progress. Returns the evicted sequences (pages already
        released) for the engine's preemption bookkeeping."""
        preempted: list[Sequence] = []
        order = sorted(
            (s for s, q in self.slots.items() if q.phase == "decode"),
            key=lambda s: self.slots[s].order,
        )
        for slot in order:
            n = 1 + (extra.get(slot, 0) if extra else 0)
            while slot in self.slots:
                try:
                    if self.cache.ensure_append_capacity(slot, n):
                        self._mark(slot)  # table grew or a page was COWed
                    break
                except RuntimeError:
                    # pages granted before the failure are already in the
                    # table; the retry (or eviction) sees them as owned
                    self._mark(slot)
                    preempted.append(self.evict_youngest()[1])
        return preempted

    # ------------------------------------------------------------------
    # decode-batch assembly
    # ------------------------------------------------------------------
    def append_decoded(self, slot: int, token: int) -> None:
        """Record one sampled token for a decoding slot (both step modes'
        harvest path): advance the cache length and the attempt's token
        list, and keep the persistent mirrors current WITHOUT dirtying the
        batch — the executor's jitted step advanced its device copies
        (token, length, sample index) identically, so no re-upload is
        needed."""
        seq = self.slots[slot]
        self.cache.append(slot)
        seq.tokens.append(token)
        self._mir_tokens[slot, 0] = token
        self._mir_idx[slot] = len(seq.tokens)
        self._mir_lens[slot] = self.cache.lengths[slot]

    def _refresh_slot(self, slot: int) -> None:
        """Bring one slot's mirror row up to date with host truth."""
        seq = self.slots.get(slot)
        if seq is None or seq.phase != "decode":
            # idle or prefilling: mask to the null page / length 0 so the
            # decode write lands in the sink and the (discarded) attention
            # output reads nothing
            self._mir_active[slot] = 0
            self._mir_bt[slot] = NULL_PAGE
            self._mir_lens[slot] = 0
            self._mir_tokens[slot, 0] = 0
            self._mir_temps[slot] = 0.0
            self._mir_tks[slot] = 0
            self._mir_tps[slot] = 1.0
            self._mir_seeds[slot] = 0
            self._mir_idx[slot] = 0
            return
        sp = seq.request.sampling
        self._mir_active[slot] = 1
        self._mir_bt[slot] = self.cache.block_tables[slot]
        self._mir_lens[slot] = self.cache.lengths[slot]
        self._mir_tokens[slot, 0] = seq.tokens[-1]
        self._mir_temps[slot] = sp.temperature
        self._mir_tks[slot] = sp.top_k
        self._mir_tps[slot] = sp.top_p
        self._mir_seeds[slot] = seq.handle.seed
        self._mir_idx[slot] = len(seq.tokens)

    def build_decode_inputs(self) -> DecodeInputs:
        """Assemble the fixed-width decode batch from the persistent
        mirrors, refreshing only the slots dirtied since the last build —
        host-side per-step overhead tracks the number of lifecycle events,
        not max_slots. Fresh copies on return — the cache tables mutate
        between steps and the executor transfers these asynchronously."""
        if self._all_dirty:
            for slot in range(self.cache.max_slots):
                self._refresh_slot(slot)
        else:
            for slot in self._dirty_slots:
                self._refresh_slot(slot)
        self._dirty_slots.clear()
        self._all_dirty = False
        act = self._mir_active.astype(bool)
        greedy = bool((self._mir_temps[act] <= 0.0).all())
        return DecodeInputs(
            self._mir_tokens.copy(), self._mir_temps.copy(),
            self._mir_tks.copy(), self._mir_tps.copy(),
            self._mir_seeds.copy(), self._mir_idx.copy(),
            self._mir_active.copy(), self._mir_bt.copy(),
            self._mir_lens.copy(), greedy_only=greedy,
        )

    # ------------------------------------------------------------------
    # speculation bundles
    # ------------------------------------------------------------------
    def build_spec_bundle(self, slot: int, drafts: list[int],
                          width: int) -> SpecBundle:
        """Package a proposer's drafts for one decoding slot as a verify
        work item: row 0 is the slot's last committed token (same feed as
        its plain decode row), rows 1..k the drafts, padded to the static
        ``width`` (= spec_k + 1). The caller must already have ensured
        append capacity for ``1 + len(drafts)`` positions."""
        seq = self.slots[slot]
        assert seq.phase == "decode" and seq.tokens, (slot, seq.phase)
        assert 0 < len(drafts) < width, (len(drafts), width)
        toks = np.zeros((width,), np.int32)
        toks[0] = seq.tokens[-1]
        toks[1:1 + len(drafts)] = drafts
        return SpecBundle(
            slot=slot, seq=seq, tokens=toks,
            start=int(self.cache.lengths[slot]),
            valid=1 + len(drafts), drafts=list(drafts),
        )

    def append_speculated(self, slot: int, token: int) -> None:
        """Record one accepted/bonus token from a verify bundle. Unlike
        :meth:`append_decoded` this does NOT advance the mirrors — the
        verify dispatch never touches the decode batch's device copies,
        so :meth:`commit_speculation` re-dirties the whole row instead."""
        self.slots[slot].tokens.append(token)

    def commit_speculation(self, slot: int, length: int) -> None:
        """Finalize a verify bundle for a slot that keeps decoding: set
        the cache length to the accepted prefix + the committed row
        (REWINDING the rejected tail — pages are append-only per slot, so
        rejected positions simply fall out of the attention mask and the
        next append overwrites them in place) and dirty the mirror row so
        the next decode batch re-uploads host truth."""
        assert length >= int(self.cache.lengths[slot]), (
            length, int(self.cache.lengths[slot]))  # never below the start
        self.cache.lengths[slot] = length
        self._mark(slot)

    # ------------------------------------------------------------------
    # fused step plan
    # ------------------------------------------------------------------
    def build_step_plan(self, spec: list[SpecBundle] | None = None
                        ) -> StepPlan:
        """Assemble ONE fused step: the full decode batch plus at most one
        prefill chunk, under the token budget (one token per decode row;
        the chunk's live tokens fill what remains — Sarathi-style, so an
        operator can trade TTFT for ITL tail). With no decode rows in
        flight the budget is waived (a chunk always makes progress; cold
        start cannot stall). ``decode`` is None on the steady-state path
        (device mirrors current); shapes are static either way.

        ``spec`` lists this step's speculation bundles: their slots leave
        ``decode_slots`` and are masked to the null page in the decode
        batch (their step happens through the verify dispatch instead —
        never twice), and their live rows count against ``step_tokens``.
        Masking mutates only the returned copies; the mirrors stay true
        and the slot is re-marked dirty for the next plain build."""
        spec = spec or []
        spec_slots = {b.slot for b in spec}
        decode_slots = [s for s, q in sorted(self.slots.items())
                        if q.phase == "decode" and s not in spec_slots]
        limit = width = None
        if self.token_budget is not None and decode_slots:
            # The chunk buffer is sized to what the budget can actually
            # spend AFTER the decode rows take their token each — not the
            # full budget — so a chunky step never carries buffer rows the
            # mask is guaranteed to kill. Widths vary with the decode
            # count, so the executor compiles at most max_slots chunk
            # shapes (once each, during warmup).
            limit = width = max(0, self.token_budget - len(decode_slots))
        chunk = (self.next_prefill(limit=limit, width=width)
                 if self.chunked else None)
        decode = None
        if decode_slots:
            if spec_slots:
                decode = self.build_decode_inputs()
                for s in spec_slots:
                    decode.active[s] = 0
                    decode.block_tables[s] = NULL_PAGE
                    decode.lengths[s] = 0
                    self._mark(s)  # device copy now diverges from mirror
                act = decode.active.astype(bool)
                decode.greedy_only = bool((decode.temps[act] <= 0.0).all())
            elif self.dirty:
                decode = self.build_decode_inputs()
        return StepPlan(
            decode_slots=decode_slots,
            decode=decode,
            chunk=chunk,
            step_tokens=(len(decode_slots) + (chunk.valid if chunk else 0)
                         + sum(b.valid for b in spec)),
            spec=spec,
        )

    # ------------------------------------------------------------------
    # gauges
    # ------------------------------------------------------------------
    def occupancy(self) -> tuple[int, int]:
        """(decoding slots, total slots) for the utilization gauges."""
        return (sum(1 for q in self.slots.values() if q.phase == "decode"),
                self.cache.max_slots)

    def page_utilization(self) -> tuple[int, int]:
        """(pages in use, usable pages) — excludes the reserved null page.
        Parked pages (zero-refcount prefix pages in the reclaim-under-
        pressure LRU) do not count as used: they are free capacity that
        happens to still hold reusable bytes."""
        usable = self.cache.num_pages - 1
        used = usable - self.cache.pool.available - self.cache.parked_count
        return used, usable
