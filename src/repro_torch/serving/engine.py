"""Generation engines: lockstep micro-batching and continuous batching.

Both implement the :class:`repro_torch.serving.api.EngineCore` protocol —
``submit() -> RequestHandle``, ``step() -> list[StreamEvent]``,
``cancel(uid)``, ``abort_all()`` — over the shared lifecycle machinery in
:class:`repro_torch.serving.api.EngineBase`.

``GenerationEngine`` is the lockstep baseline: one ``step()`` forms a
left-padded micro-batch and prefills it (``DecoderLM.prefill``: attention
through the flash kernel, Mamba layers through the SSD scan on the card),
each further call runs one decode step over the whole batch on a dense
cache (K/V, or recurrent state, or both for the hybrid family), and the
batch retires when every row has finished (rows that stop early are
masked, not evicted).

``ContinuousBatchingEngine`` is the hot path, built from two layers:

* a host-side :class:`repro_torch.serving.scheduler.Scheduler` — admission
  order, chunked-prefill interleaving, prefix-sharing deferral, preemption
  victim selection, page accounting and decode-batch assembly, all plain
  Python/numpy with no device dispatch (the JAX package's, unchanged);
* a device-side :class:`repro_torch.serving.executor.ModelExecutor` — one
  model step + sampling per engine step on the engine's device, through the
  hand-written paged-attention kernels on the card.

Sampling (per-request temperature / top-k / top-p / seed) is keyed off
``(seed, token_index)`` with JAX's own bit stream, so a request's tokens
equal the JAX engine's and survive preemption byte-for-byte.

Ported: both step modes (``fused``, ``interleaved``), chunked prefill,
whole-prompt prefill (``prefill_chunk=None`` or 0: one flash-kernel prefill
per admission, prefix sharing off), copy-on-write prefix sharing with the
tiered KV cache (parked pages, a host-RAM tier ``host_pages`` and a
persisted ``ArtifactStore`` tier ``persist_dir`` that outlives the
process), int8 pages (``kv_quant="int8"``, dequantized inside the paged
kernels), preemption and the admission policies. Speculative decoding
(ROADMAP A.6) is not ported yet and raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.storage import ArtifactStore
from repro_torch.models import build_model
from repro_torch.models.common import pick_tokens, resolve_device
from repro_torch.serving.api import (
    AdmissionPolicy,
    EngineBase,
    FinishReason,
    Request,
    RequestHandle,
    Result,
    StreamEvent,
    validate_request,
)
from repro_torch.serving.executor import ModelExecutor
from repro_torch.serving.kv_cache import PagedKVCache, cdiv
from repro_torch.serving.kv_tiers import KVTierManager
from repro_torch.serving.metrics import UtilizationMetrics
from repro_torch.serving.scheduler import Scheduler, Sequence

__all__ = ["ContinuousBatchingEngine", "GenerationEngine", "Request",
           "Result"]


@dataclass
class _Row:
    """One row of a lockstep micro-batch."""

    request: Request
    handle: RequestHandle
    done: bool = False


class GenerationEngine(EngineBase):
    """Lockstep micro-batching engine (protocol adapter over padded batches).

    ``step()`` semantics: with no batch in flight, pull up to ``max_batch``
    requests from the admission queue, left-pad to the longest prompt,
    prefill and sample each row's first token. Every further ``step()`` runs
    one decode step over the whole batch. Rows finish independently (length
    / stop / cancel) and are masked until the slowest row retires the batch
    — the classic lockstep cost the continuous batcher removes.

    Serves the dense, ssm and hybrid families. ``params`` is the model's
    state dict; ``device`` is where the model, the dense cache and every
    step live (``"cuda"`` unless the caller asks for ``"cpu"``).
    ``attn_impl``/``ssd_impl`` ``"ref"`` run the plain attention / SSD
    versions on the card too.
    """

    def __init__(self, cfg, params, *, max_len: int = 256, seed: int = 0,
                 max_batch: int = 8,
                 admission: AdmissionPolicy | None = None,
                 attn_impl: str | None = None, ssd_impl: str | None = None,
                 device="cuda"):
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder lockstep path is not "
                f"ported yet (ROADMAP A.11)")
        if cfg.family not in ("dense", "ssm", "hybrid"):
            raise NotImplementedError(
                f"{cfg.name} (family {cfg.family!r}): the moe and vlm "
                f"families are not ported yet (ROADMAP A.7)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, device=self.device,
                                 attn_impl=attn_impl or "auto",
                                 ssd_impl=ssd_impl or "auto")
        self.model.load_state_dict(params)
        self.params = self.model.state_dict()
        self.max_len = max_len
        self.max_batch = max_batch
        self._init_api(admission=admission, seed=seed)
        self.utilization = UtilizationMetrics()
        self._batch: list[_Row] | None = None
        self._bstate: dict | None = None

    # -- EngineBase hooks ----------------------------------------------
    def _validate(self, request: Request) -> None:
        validate_request(request, max_len=self.max_len)

    def _cancel_active(self, uid: str) -> bool:
        if self._batch is None:
            return False
        for row in self._batch:
            if row.handle.uid == uid and not row.done:
                row.done = True
                self._finish_handle(row.handle, FinishReason.CANCELLED)
                self._retire_if_done()
                return True
        return False

    def _retire_if_done(self) -> None:
        if self._batch is not None and all(r.done for r in self._batch):
            self._batch = None
            self._bstate = None

    # -- protocol -------------------------------------------------------
    @property
    def idle(self) -> bool:
        return not (len(self.admission) or self._batch or self._events)

    def capacity(self) -> int:
        if self._batch is not None:
            return 0
        return max(0, self.max_batch - len(self.admission))

    def step(self) -> list[StreamEvent]:
        now = time.perf_counter()
        self._expire_queue(now)
        if self._batch is None:
            # batch bound: rows are left-padded to the longest prompt and
            # decode until the slowest row finishes, so the batch occupies
            # max(plen) + max(max_new) cache positions — admit only while
            # that fits max_len (a lone request always does: validated)
            reqs: list[Request] = []
            plen = new = 0
            while len(reqs) < self.max_batch:
                cand = self.admission.peek(now)
                if cand is None:
                    break
                c_plen = max(plen, len(cand.prompt))
                c_new = max(new, cand.sampling.max_new_tokens)
                if reqs and c_plen + c_new > self.max_len:
                    break
                plen, new = c_plen, c_new
                reqs.append(self.admission.pop(now))
            if reqs:
                self._start_batch(reqs)
        else:
            st = self._bstate
            self.utilization.record(
                active=sum(not r.done for r in self._batch),
                slots=self.max_batch,
            )
            st["cache"], logits = self.model.decode_step(
                st["cache"], st["tok"][:, None])
            st["step"] += 1
            st["tok"] = self._sample(logits, st)
            self._harvest(st["tok"].cpu().numpy())
        self._retire_if_done()
        return self._drain_events()

    # -- internals ------------------------------------------------------
    def _sample(self, logits: torch.Tensor, st: dict) -> torch.Tensor:
        """The batch's next tokens, at token index ``st["step"]``."""
        idx = torch.full((logits.shape[0],), st["step"], dtype=torch.int32,
                         device=self.device)
        return pick_tokens(logits, st["temps"], st["tks"], st["tps"],
                           st["seeds"], idx, self.cfg.vocab_size,
                           st["greedy_only"])

    def _start_batch(self, reqs: list[Request]) -> None:
        b = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        cache, logits = self.model.prefill(
            {"tokens": torch.from_numpy(toks).to(self.device)}, self.max_len)
        rows = [_Row(r, self._handles[r.uid]) for r in reqs]
        sp = [r.sampling for r in reqs]

        def dev(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=self.device)

        st = {
            "cache": cache,
            "step": 0,
            "greedy_only": all(s.temperature <= 0.0 for s in sp),
            "temps": dev([s.temperature for s in sp], torch.float32),
            "tks": dev([s.top_k for s in sp], torch.int32),
            "tps": dev([s.top_p for s in sp], torch.float32),
            "seeds": dev([row.handle.seed for row in rows], torch.int32),
        }
        st["tok"] = self._sample(logits, st)
        self._batch, self._bstate = rows, st
        self._harvest(st["tok"].cpu().numpy())

    def _harvest(self, toks: np.ndarray) -> None:
        now = time.perf_counter()
        idx = self._bstate["step"]
        for i, row in enumerate(self._batch):
            if row.done:
                continue
            if self._deliver(row.handle, int(toks[i]), idx, now):
                row.done = True


class ContinuousBatchingEngine(EngineBase):
    """Paged-KV continuous batcher for the dense decoder.

    Protocol adapter over the scheduler/executor split: the
    :class:`Scheduler` decides (host-only), the :class:`ModelExecutor`
    computes (device-only, one dispatch per step over ``max_slots``
    fixed-width slots; idle or prefilling slots are masked), and this class
    translates between them and the lifecycle: handles, stream events,
    typed finishes, preemption-transparent requeueing.

    With prefix sharing on, a :class:`~repro_torch.serving.kv_tiers.KVTierManager`
    (``kv_tiers``; default follows ``prefix_sharing``) parks released
    prefix pages instead of freeing them, reclaiming them lazily under pool
    pressure; ``host_pages`` and ``persist_dir`` give reclaimed pages a
    host-RAM tier and an ``ArtifactStore`` tier to spill to, from which a
    later prefix hit prefetches them back (across restarts, for the
    store). ``kv_quant="int8"`` stores the pages as int8 with f32 scales.
    ``params`` is the model's state dict (``DecoderLM.init`` or
    :func:`repro_torch.models.params_from_jax`); ``device`` is where the
    model, the page pool and every step live (``"cuda"`` unless the caller
    asks for ``"cpu"``).
    """

    def __init__(
        self,
        cfg,
        params,
        *,
        max_len: int = 256,
        max_slots: int = 8,
        page_size: int = 16,
        num_pages: int | None = None,
        seed: int = 0,
        attn_impl: str | None = None,
        prefill_chunk: int | None = 64,
        prefix_sharing: bool = True,
        admission: AdmissionPolicy | None = None,
        max_preemptions: int | None = None,
        step_mode: str = "fused",
        token_budget: int | None = None,
        kv_quant: str = "none",
        kv_tiers: bool | None = None,
        host_pages: int = 0,
        persist_dir: str | None = None,
        speculative: str = "off",
        device="cuda",
    ):
        assert not cfg.is_encoder_decoder, "paged engine is decoder-only"
        if cfg.family in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"family {cfg.family!r}: continuous batching needs a paged "
                f"KV path; serve it with SSMEngine (recurrent state) or "
                f"GenerationEngine (lockstep)")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: only the dense paged path is ported "
                f"(moe/vlm: ROADMAP A.7)")
        if speculative != "off":
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP A.6)")
        if kv_quant not in ("none", "int8"):
            raise ValueError(
                f"kv_quant must be 'none' or 'int8', got {kv_quant!r}")
        if prefill_chunk == 0:  # CLI convention: 0 disables chunking
            prefill_chunk = None
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if step_mode not in ("fused", "interleaved"):
            raise ValueError(
                f"step_mode must be 'fused' or 'interleaved', got {step_mode!r}"
            )
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_len = max_len
        self.max_slots = max_slots
        self.max_preemptions = max_preemptions
        # whole-prompt prefill (prefill_chunk=None) runs one dispatch per
        # admission and has no chunk cursor to share prefixes at
        self._chunked = prefill_chunk is not None
        self.prefill_chunk = prefill_chunk
        self.prefix_sharing = prefix_sharing and self._chunked
        self.step_mode = step_mode
        self.token_budget = token_budget
        if kv_tiers is None:
            kv_tiers = self.prefix_sharing
        # host/persist tiers engage only when host_pages / persist_dir are set
        self.tiers = (
            KVTierManager(
                host_pages=host_pages,
                store=(ArtifactStore(persist_dir)
                       if persist_dir is not None else None),
            )
            if kv_tiers and self.prefix_sharing else None
        )
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers,
            num_kv_heads=cfg.eff_kv_heads,
            head_dim=cfg.head_dim,
            dtype=getattr(torch, cfg.dtype),
            max_slots=max_slots,
            max_context=max_len,
            page_size=page_size,
            num_pages=num_pages,
            quant=kv_quant,
            tiers=self.tiers,
            device=self.device,
        )
        self.scheduler = Scheduler(
            self.cache,
            prefill_chunk=prefill_chunk,
            chunked=self._chunked,
            prefix_sharing=self.prefix_sharing,
            token_budget=token_budget,
        )
        self.executor = ModelExecutor(
            cfg, params, self.cache, max_len=max_len, device=self.device,
            attn_impl=attn_impl,
        )
        self.model = self.executor.model
        self.params = self.executor.params
        self._init_api(admission=admission, seed=seed)
        self.utilization = UtilizationMetrics()
        self.stats.update({"decode_steps": 0, "prefills": 0,
                           "prefill_chunks": 0, "preemptions": 0})

    # ------------------------------------------------------------------
    # EngineBase hooks
    # ------------------------------------------------------------------
    def _validate(self, request: Request) -> None:
        validate_request(request, max_len=self.max_len)
        worst = cdiv(len(request.prompt) + request.sampling.max_new_tokens,
                     self.cache.page_size)
        if worst > self.cache.num_pages - 1:
            raise ValueError(
                f"request {request.uid}: needs {worst} KV pages, pool has "
                f"{self.cache.num_pages - 1} — it could never be scheduled"
            )

    def _release_slot(self, slot: int) -> Sequence:
        return self.scheduler.release(slot)

    def _cancel_active(self, uid: str) -> bool:
        slot = self.scheduler.find(uid)
        if slot is None:
            return False
        seq = self._release_slot(slot)
        self._finish_handle(seq.handle, FinishReason.CANCELLED)
        return True

    # ------------------------------------------------------------------
    # protocol surface
    # ------------------------------------------------------------------
    @property
    def idle(self) -> bool:
        return not (len(self.admission) or self.scheduler.slots
                    or self._events)

    def capacity(self) -> int:
        return max(0, self.cache.free_slot_count - len(self.admission))

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _first_token(self, slot: int, seq: Sequence, tok: int) -> None:
        """Prompt fully cached: deliver the sampled first token (attempt
        index 0 — after a preemption the handle de-duplicates it)."""
        now = time.perf_counter()
        seq.tokens.append(tok)
        self.scheduler.begin_decode(slot)
        self.stats["prefills"] += 1
        if self._deliver(seq.handle, tok, 0, now):
            # finish event lands in THIS step's batch
            self._release_slot(slot)

    def _admit(self) -> int:
        now = time.perf_counter()
        self._expire_queue(now)
        admitted = 0
        while True:
            req = self.admission.peek(now)
            if req is None or not self.scheduler.can_place(req):
                break
            self.admission.pop(now)
            handle = self._handles[req.uid]
            slot, seq, _ = self.scheduler.place(req, handle)
            admitted += 1
            if not self._chunked:
                # whole-prompt path: one executor dispatch per admission
                tok = self.executor.prefill_whole(req, handle.seed, slot)
                self._first_token(slot, seq, tok)
        return admitted

    def _prefill_step(self) -> bool:
        """Advance the oldest in-flight prefill by one fixed-size chunk
        (scheduler picks, executor dispatches)."""
        work = self.scheduler.next_prefill()
        if work is None:
            return False
        tok = self.executor.prefill_chunk(work)
        self.stats["prefill_chunks"] += 1
        if self.scheduler.complete_chunk(work):
            self._first_token(work.slot, work.seq, tok)
        return True

    def _handle_preempted(self, seq: Sequence) -> None:
        """Bookkeeping for a sequence the scheduler evicted under pool
        pressure: requeue transparently (already-streamed deltas are never
        re-emitted) or finish ``preempted`` past ``max_preemptions``."""
        self.stats["preemptions"] += 1
        h = seq.handle
        h.preemptions += 1
        if (self.max_preemptions is not None
                and h.preemptions > self.max_preemptions):
            self._finish_handle(
                h, FinishReason.PREEMPTED,
                error=f"request {h.uid}: preempted {h.preemptions} times "
                      f"(max_preemptions={self.max_preemptions})",
            )
        else:
            self._events.append(
                StreamEvent(h.uid, "preempted", t=time.perf_counter())
            )
            self.admission.requeue(seq.request, h.arrival)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def step(self) -> list[StreamEvent]:
        """Run one engine step and return the lifecycle events produced
        (token deltas, finishes, preemptions).

        ``step_mode="fused"`` (default): admit, build ONE token-budgeted
        :class:`~repro_torch.serving.scheduler.StepPlan` and dispatch it —
        every decode slot and (at most) one prefill chunk in a single
        executor call. ``step_mode="interleaved"`` runs one chunk dispatch,
        then one decode dispatch; both modes produce byte-identical
        streams."""
        if self.step_mode == "interleaved":
            return self._step_interleaved()
        return self._step_fused()

    def _record_batch(self, decode_rows: int, prefill_live: int,
                      rows: int, fused: bool) -> None:
        self.utilization.record_batch(
            decode_rows=decode_rows, prefill_rows=prefill_live,
            padded_rows=rows - decode_rows - prefill_live, fused=fused,
        )

    def _dispatch_plan(self, plan) -> np.ndarray | None:
        """Run one plan through the executor and do the chunk bookkeeping
        (cursor advance, prefix publication, first-token delivery). Returns
        the decode tokens for the engine harvest (None: no decode rows)."""
        chunk, n_dec = plan.chunk, len(plan.decode_slots)
        rows = n_dec and self.max_slots
        if chunk is not None:
            rows += len(chunk.tokens)
        self._record_batch(n_dec, chunk.valid if chunk else 0, rows,
                           fused=bool(chunk is not None and n_dec))
        toks, ctok = self.executor.step(plan)
        if chunk is not None:
            self.stats["prefill_chunks"] += 1
            if self.scheduler.complete_chunk(chunk):
                self._first_token(chunk.slot, chunk.seq, ctok)
        return toks

    def _record_tiers(self) -> None:
        if self.tiers is not None:
            t = self.tiers
            self.utilization.record_tiers(
                parked=t.parked_count, host=t.host_count,
                persisted=t.persisted_count, counters=t.counters,
            )

    def _step_fused(self) -> list[StreamEvent]:
        sched = self.scheduler
        # publish last step's prefetched pages BEFORE admission matches
        # against the prefix index (pending pages stay invisible one step)
        self.cache.tick_tiers()
        self._admit()
        # with no decode in flight there is no stall to bound, so drain
        # chunk-only plans back-to-back until a sequence becomes decodable
        # (cold start, post-burst refill)
        while not sched.has_decodable():
            plan = sched.build_step_plan()
            if plan.chunk is None:
                return self._drain_events()
            self._dispatch_plan(plan)
            self._admit()

        # every decode row needs a writable page BEFORE the plan captures
        # block tables (growth/COW dirties them; eviction can also claim
        # the slot a chunk would have targeted)
        for seq in sched.ensure_decode_capacity():
            self._handle_preempted(seq)
        if not sched.has_decodable():
            return self._drain_events()  # preemption can empty the decode set

        decoding, slots = sched.occupancy()
        used, total = sched.page_utilization()
        self.utilization.record(active=decoding, slots=slots,
                                pages_used=used, pages_total=total)
        self._record_tiers()
        plan = sched.build_step_plan()
        toks = None
        if plan.decode_slots or plan.chunk is not None:
            toks = self._dispatch_plan(plan)
        self.stats["decode_steps"] += 1
        now = time.perf_counter()
        # harvest exactly the slots the plan dispatched — the chunk slot
        # may have become decodable mid-step and is NOT in this batch
        for slot in plan.decode_slots:
            seq = sched.slots[slot]
            tok = int(toks[slot])
            sched.append_decoded(slot, tok)
            if self._deliver(seq.handle, tok, len(seq.tokens) - 1, now):
                self._release_slot(slot)
        self._record_tiers()  # post-release: captures end-of-life parking
        return self._drain_events()

    def _step_interleaved(self) -> list[StreamEvent]:
        """Pre-fusion step: one chunk dispatch interleaved with one decode
        dispatch (kept for A/B against the fused step)."""
        sched = self.scheduler
        self.cache.tick_tiers()
        self._admit()
        ran = self._prefill_step()
        # the one-chunk-per-step cap exists to bound decode stalls; with no
        # decode in flight there is nothing to stall, so drain chunks
        # back-to-back until a sequence becomes decodable
        while ran and not sched.has_decodable():
            self._admit()
            ran = self._prefill_step()
        if not sched.has_decodable():
            return self._drain_events()

        for seq in sched.ensure_decode_capacity():
            self._handle_preempted(seq)
        if not sched.has_decodable():
            return self._drain_events()  # preemption can empty the decode set

        decoding, slots = sched.occupancy()
        used, total = sched.page_utilization()
        self.utilization.record(active=decoding, slots=slots,
                                pages_used=used, pages_total=total)
        self._record_tiers()
        self._record_batch(decoding, 0, self.max_slots, fused=False)
        inputs = sched.build_decode_inputs() if sched.dirty else None
        toks = self.executor.decode(inputs)
        self.stats["decode_steps"] += 1
        now = time.perf_counter()
        for slot, seq in sched.decoding():
            tok = int(toks[slot])
            sched.append_decoded(slot, tok)
            if self._deliver(seq.handle, tok, len(seq.tokens) - 1, now):
                self._release_slot(slot)
        self._record_tiers()  # post-release: captures end-of-life parking
        return self._drain_events()
