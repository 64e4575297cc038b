"""Generation engines: lockstep micro-batching and continuous batching.

Both implement the :class:`repro_torch.serving.api.EngineCore` protocol —
``submit() -> RequestHandle``, ``step() -> list[StreamEvent]``,
``cancel(uid)``, ``abort_all()`` — over the shared lifecycle machinery in
:class:`repro_torch.serving.api.EngineBase`.

``GenerationEngine`` is the lockstep baseline: one ``step()`` forms a
left-padded micro-batch and prefills it (``DecoderLM.prefill``: attention
through the flash kernel, Mamba layers through the SSD scan on the card,
a vlm batch after zero vision embeddings; ``EncDecLM.prefill`` for the
encoder-decoder, on zero frames), each
further call runs one decode step over the whole batch on a dense cache
(K/V, or recurrent state, or both for the hybrid family; self and cross
K/V for the encoder-decoder), and the batch retires when every row has
finished (rows that stop early are masked, not evicted).

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

It serves the dense, moe and vlm families. Ported: both step modes
(``fused``, ``interleaved``), chunked prefill, whole-prompt prefill
(``prefill_chunk=None`` or 0, and always for vlm, whose prompts carry
vision embeddings: one flash-kernel prefill per admission, prefix sharing
off), copy-on-write prefix sharing with the
tiered KV cache (parked pages, a host-RAM tier ``host_pages`` and a
persisted ``ArtifactStore`` tier ``persist_dir`` that outlives the
process), int8 pages (``kv_quant="int8"``, dequantized inside the paged
kernels), preemption, the admission policies and speculative decoding
(``speculative="ngram"|"draft"``: a proposer drafts ``spec_k`` tokens per
decoding slot, one verify dispatch per bundle scores them through the
chunk kernel, and the rejected tail rolls back by a length rewind).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.storage import ArtifactStore
from repro_torch.models import build_model, frontend_len
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
from repro_torch.serving.executor import (ModelExecutor,
                                         resolve_serving_mesh,
                                         validate_serving_mesh)
from repro_torch.serving.kv_cache import PagedKVCache, cdiv
from repro_torch.serving.kv_tiers import KVTierManager
from repro_torch.serving.metrics import UtilizationMetrics
from repro_torch.serving.scheduler import Scheduler, Sequence
from repro_torch.serving.speculative import SPEC_MODES, build_proposer

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

    Serves every decoder family (dense, moe, vlm: the prompt after zero
    vision embeddings, which ``max_len`` must also hold; ssm, hybrid) and
    the encoder-decoder (whisper: the encoder reads zero frames of the
    padded prompt's length), as the JAX engine does. ``params`` is the
    model's state dict; ``device`` is where the model, the dense cache and
    every step live (``"cuda"`` unless the caller asks for ``"cpu"``).
    ``attn_impl``/``ssd_impl`` ``"ref"`` run the plain attention / SSD
    versions on the card too.
    """

    def __init__(self, cfg, params, *, max_len: int = 256, seed: int = 0,
                 max_batch: int = 8,
                 admission: AdmissionPolicy | None = None,
                 attn_impl: str | None = None, ssd_impl: str | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, params=params, device=self.device,
                                 attn_impl=attn_impl or "auto",
                                 ssd_impl=ssd_impl or "auto")
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
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        nf = frontend_len(self.cfg)
        if nf:
            batch["vision_embeds"] = torch.zeros(
                (b, nf, self.cfg.d_model),
                device=self.device, dtype=getattr(torch, self.cfg.dtype))
        if self.cfg.is_encoder_decoder:
            batch["frames"] = torch.zeros(
                (b, plen, self.cfg.d_model), device=self.device,
                dtype=getattr(torch, self.cfg.dtype))
        cache, logits = self.model.prefill(batch, self.max_len)
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
    """Paged-KV continuous batcher for the dense, moe and vlm decoders.

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
    ``speculative`` (``"off"``, ``"ngram"`` or ``"draft"``, with
    ``spec_k`` drafts a bundle; ``draft_config``/``draft_params`` name the
    draft model) turns on speculative decoding; streams are byte-identical
    to ``"off"`` for dense. For moe they may part, in both packages: a
    verify bundle is a chunk, which takes the capacity dispatch and can
    drop a token that a one-row decode step runs through every expert (the
    same holds between the two step modes). vlm has no chunk path: its
    prompts are prefilled whole and it refuses speculation.
    ``params`` is the model's state dict (``DecoderLM.init`` or
    :func:`repro_torch.models.params_from_jax`); ``device`` is where the
    model, the page pool and every step live (``"cuda"`` unless the caller
    asks for ``"cpu"``).

    Tensor parallelism: the engine runs on the default serving mesh
    (``executor.default_serving_mesh``: the one set by
    ``serving_mesh_scope`` / ``set_default_serving_mesh``, else
    ``pick_tp``'s over the local cards — one rank on one card or the CPU).
    At tp > 1 the page pool holds this rank's ``KVH / tp`` heads, the
    executor drives the followers, and :meth:`close` releases them. The
    KV tiers stay on rank 0 and hold whole pages (the executor gathers
    every rank's heads on a spill and scatters them on a reload); the
    draft model runs whole on rank 0, outside every executor call, so no
    collective runs in it.
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
        spec_k: int = 4,
        draft_config=None,
        draft_params=None,
        device="cuda",
    ):
        assert not cfg.is_encoder_decoder, "paged engine is decoder-only"
        if cfg.family in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"family {cfg.family!r}: continuous batching needs a paged "
                f"KV path; serve it with SSMEngine (recurrent state) or "
                f"GenerationEngine (lockstep)")
        assert cfg.family in ("dense", "moe", "vlm"), cfg.family
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
        self.nf = frontend_len(cfg)
        self.device = resolve_device(device)
        # the serving mesh, as the JAX engine builds it: the default one
        # (serving_mesh_scope / set_default_serving_mesh) or pick_tp's
        mesh, own_mesh = resolve_serving_mesh(cfg, self.device)
        tp = validate_serving_mesh(cfg, mesh)
        self.max_len = max_len
        self.max_slots = max_slots
        self.max_preemptions = max_preemptions
        # whole-prompt prefill (prefill_chunk=None) runs one dispatch per
        # admission and has no chunk cursor to share prefixes at; vlm
        # prompts carry vision embeds: no token chunking, no prefix trie
        self._chunked = (prefill_chunk is not None
                         and cfg.family in ("dense", "moe"))
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
            num_kv_heads=cfg.eff_kv_heads // tp,  # this rank's heads
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
            extra_ctx=self.nf,
            token_budget=token_budget,
        )
        self.executor = ModelExecutor(
            cfg, params, self.cache, max_len=max_len, device=self.device,
            attn_impl=attn_impl, mesh=mesh, own_mesh=own_mesh,
        )
        self.model = self.executor.model
        self.params = self.executor.params
        # speculative decoding: a proposer drafts spec_k tokens per
        # decoding slot; the executor verifies each bundle in one dispatch;
        # rejected tails roll back by rewinding the sequence length
        if speculative not in SPEC_MODES:
            raise ValueError(
                f"speculative must be one of {SPEC_MODES}, got {speculative!r}"
            )
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self.spec_mode = speculative
        self.spec_k = spec_k
        self.spec = None
        if speculative != "off":
            if cfg.family not in ("dense", "moe"):
                raise ValueError(
                    f"speculative decoding needs the paged chunk path; "
                    f"family {cfg.family!r} has none")
            if step_mode != "fused":
                raise ValueError(
                    "speculative decoding requires step_mode='fused'")
            self.spec = build_proposer(
                speculative, draft_config=draft_config,
                draft_params=draft_params, max_slots=max_slots,
                max_len=max_len, page_size=page_size, seed=seed,
                attn_impl=attn_impl, device=self.device,
            )
        self._init_api(admission=admission, seed=seed)
        self.utilization = UtilizationMetrics()
        self.stats.update({"decode_steps": 0, "prefills": 0,
                           "prefill_chunks": 0, "preemptions": 0,
                           "spec_bundles": 0})

    def close(self) -> None:
        """Release the executor on the mesh's followers (ending them when
        the mesh is the engine's own)."""
        self.executor.close()

    # ------------------------------------------------------------------
    # EngineBase hooks
    # ------------------------------------------------------------------
    def _validate(self, request: Request) -> None:
        validate_request(request, max_len=self.max_len, extra_ctx=self.nf)
        ctx = self.nf + len(request.prompt)
        worst = cdiv(ctx + request.sampling.max_new_tokens,
                     self.cache.page_size)
        if worst > self.cache.num_pages - 1:
            raise ValueError(
                f"request {request.uid}: needs {worst} KV pages, pool has "
                f"{self.cache.num_pages - 1} — it could never be scheduled"
            )

    def _release_slot(self, slot: int) -> Sequence:
        """Release a slot and retire any proposer state for its uid: every
        engine-side release funnels through here, so a finished or
        cancelled request never leaks a draft-cache slot."""
        seq = self.scheduler.release(slot)
        if self.spec is not None:
            self.spec.retire(seq.request.uid)
        return seq

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
        if self.spec is not None:
            self.spec.retire(seq.request.uid)
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

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------
    def _propose_bundles(self) -> dict[int, list[int]]:
        """Ask the proposer for drafts for every decoding slot. ``k`` is
        capped so a fully-accepted bundle can neither overshoot the
        request's validated page budget (context + k + 1 must stay within
        max_pages_per_seq) nor draft past max_new_tokens."""
        out: dict[int, list[int]] = {}
        cache = self.cache
        ctx_cap = cache.max_pages_per_seq * cache.page_size
        for slot, seq in self.scheduler.decoding():
            sp = seq.request.sampling
            if not sp.speculative:
                continue
            k = min(self.spec_k,
                    sp.max_new_tokens - len(seq.tokens) - 1,
                    ctx_cap - int(cache.lengths[slot]) - 1)
            if k < 1:
                continue
            history = list(seq.request.prompt) + seq.tokens
            drafts = self.spec.propose(seq.request.uid, history, k)
            if drafts:
                out[slot] = drafts[:k]
        return out

    def _harvest_bundle(self, bundle, now: float) -> None:
        """Dispatch one verify bundle and commit its outcome.

        The verify step sampled a token for every bundle row under the key
        sequential decode would have used, so acceptance is a host-side
        comparison: ``a`` = the length of the leading run where the sampled
        token equals the draft. Rows 0..a hold K/V of tokens the sampler
        itself produced: commit advances the cached length to ``start + a
        + 1`` and the rejected tail falls out by never being advanced past
        (append-only pages: nothing to free, nothing published).
        ``sampled[a]`` is the bonus/correction token, not cached yet, like
        a plain decode step's newest token. Emission goes through the same
        ``_deliver`` as plain decode, so a finish mid-bundle releases the
        slot and drops the unemitted remainder."""
        sched = self.scheduler
        toks = self.executor.verify(bundle)
        k = len(bundle.drafts)
        a = 0
        while a < k and int(toks[a]) == bundle.drafts[a]:
            a += 1
        sched.commit_speculation(bundle.slot, bundle.start + a + 1)
        self.stats["spec_bundles"] += 1
        self.utilization.record_spec(proposed=k, accepted=a,
                                     rollbacks=k - a)
        seq = bundle.seq
        for j in range(a + 1):
            tok = int(toks[j])
            sched.append_speculated(bundle.slot, tok)
            if self._deliver(seq.handle, tok, len(seq.tokens) - 1, now):
                self._release_slot(bundle.slot)
                break

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
        # the slot a chunk would have targeted); speculating slots pre-grow
        # their k extra positions, so the verify dispatch never faults
        proposals = (self._propose_bundles()
                     if self.spec is not None else {})
        extra = ({s: len(d) for s, d in proposals.items()}
                 if proposals else None)
        for seq in sched.ensure_decode_capacity(extra=extra):
            self._handle_preempted(seq)
        if not sched.has_decodable():
            return self._drain_events()  # preemption can empty the decode set

        decoding, slots = sched.occupancy()
        used, total = sched.page_utilization()
        self.utilization.record(active=decoding, slots=slots,
                                pages_used=used, pages_total=total)
        self._record_tiers()
        # eviction may have dropped a proposal's sequence: bundle only
        # slots that still hold the decoding sequence drafted for
        bundles = [
            sched.build_spec_bundle(s, d, self.spec_k + 1)
            for s, d in sorted(proposals.items())
            if sched.slots.get(s) is not None
            and sched.slots[s].phase == "decode"
        ]
        plan = sched.build_step_plan(spec=bundles)
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
        # bundled slots step through their verify dispatch instead
        for bundle in plan.spec or ():
            self._harvest_bundle(bundle, now)
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
