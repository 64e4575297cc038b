"""SSM/hybrid continuous-batching engine: per-slot recurrent state.

Mamba2 serving is the page-pool design turned inside out: a sequence's
whole history is a CONSTANT-SIZE recurrent state (the ``init_mamba_cache``
tree — f32 SSD state ``(H, P, N)`` plus three conv tails), so instead of a
:class:`~repro_torch.serving.kv_cache.PagedKVCache` the engine owns a
:class:`SlotStateBank` — that tree stacked over layers and batched over
slots, on the engine's device. Admission binds a request to a bank slot;
chunked prefill runs the prompt through ``ops.ssd_scan`` (carrying the
state chunk to chunk, padded tail positions neutralized by dt = 0); decode
is one model step over every slot per engine step, through
``ops.ssd_decode_step``, which advances the bank in place and leaves idle
slots untouched. The decode batch lives on the device packed into ``di``
(S, MP+6) int32 and ``df`` (S, 2) f32 and is advanced there, as in
:class:`~repro_torch.serving.executor.ModelExecutor`, so the steady-state
loop transfers nothing to the device.

Fault tolerance is where constant-size state pays: :meth:`SSMEngine
.preempt_youngest` evicts the youngest decoding sequence either by
discarding its state (default — the requeued request re-prefills and the
``(seed, token_index)``-keyed sampler regenerates a byte-identical stream,
already-emitted deltas de-duplicated by the handle) or with
``snapshot=True`` by parking a host copy of the slot's state, restored
verbatim at re-admission so the sequence resumes decoding without
re-prefill.

The hybrid (Zamba2) case routes the shared attention block through a
:class:`~repro_torch.serving.kv_cache.PagedKVCache` sized for ``num_layers
// attn_every`` layers (pages of the model's dtype; no int8 pages, tiers
or prefix sharing, as in the JAX engine) and every Mamba layer through
the state bank in the SAME step; attention page exhaustion preempts
youngest-first exactly like the paged engine, and snapshot preemption is
refused (a hybrid slot's pages are released with it).

The port of ``repro/serving/ssm_engine.py`` at tp=1.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models import build_model
from repro_torch.models.common import pick_tokens
from repro_torch.models.lm import resolve_device
from repro_torch.models.ssm import init_mamba_cache
from repro_torch.serving.kv_cache import NULL_PAGE, PagedKVCache, cdiv
from repro_torch.serving.api import (
    EngineBase,
    FinishReason,
    Request,
    StreamEvent,
    validate_request,
)
from repro_torch.serving.metrics import UtilizationMetrics
from repro_torch.serving.scheduler import DecodeInputs, Sequence

__all__ = ["SSMEngine", "SlotStateBank"]


class SlotStateBank:
    """The per-slot recurrent-state bank: ``init_mamba_cache`` stacked over
    layers (leading axis L) and batched over slots (second axis S), as
    tensors on ``device`` (the card unless the caller asks otherwise).

    The model's decode step advances the bank in place; a prefill chunk's
    result is written back into its slot. Host-side slot bookkeeping (which
    slot belongs to which request) lives in the engine; the bank only knows
    shapes, snapshots and restores."""

    def __init__(self, cfg, max_slots: int, dtype: torch.dtype,
                 device="cuda") -> None:
        device = resolve_device(device)
        mc = init_mamba_cache(cfg, max_slots, dtype, device="meta")
        self.state: dict[str, torch.Tensor] = {
            k: torch.zeros((cfg.num_layers,) + tuple(v.shape), dtype=v.dtype,
                           device=device)
            for k, v in mc.items()
        }
        self.max_slots = max_slots

    def slot(self, slot: int) -> dict[str, torch.Tensor]:
        """Views of one slot's state, slot axis kept singleton
        ((L, 1, ...) leaves)."""
        return {k: v[:, slot:slot + 1] for k, v in self.state.items()}

    def zero(self, slot: int) -> None:
        for v in self.state.values():
            v[:, slot].zero_()

    def put(self, slot: int, new: dict[str, torch.Tensor]) -> None:
        for k, v in self.state.items():
            v[:, slot:slot + 1].copy_(new[k])

    def snapshot(self, slot: int) -> dict[str, torch.Tensor]:
        """A host COPY of one slot's full state — (L, ...) leaves with the
        slot axis dropped. Never a view: on a CPU bank ``.cpu()`` would
        alias, and a parked snapshot must not change when the slot is
        reused."""
        return {k: v[:, slot].to("cpu", copy=True)
                for k, v in self.state.items()}

    def restore(self, slot: int, snap: dict[str, torch.Tensor]) -> None:
        """Write a host snapshot back into a (newly allocated) slot."""
        for k, v in self.state.items():
            v[:, slot].copy_(snap[k])


class SSMExecutor:
    """Compute half of the SSM engine: the model on its device, the decode
    step + sampling over every slot (plus the shared attention pool's
    read/write in the hybrid case), the chunked-prefill step, and the
    packed device mirrors of the decode batch — the JAX executor's
    packing: ``di`` (S, MP+6) int32 = [block-table row (MP = 0 for pure
    SSM) | lens, active, tokens, top_ks, seeds, idx], ``df`` (S, 2) f32 =
    [temps, top_ps]. ``lens`` drives attention in the hybrid case only but
    is advanced uniformly, so both layouts share one packing."""

    _DI_COLS = 6

    def __init__(self, cfg, params, bank: SlotStateBank,
                 cache: PagedKVCache | None = None, *, device="cuda",
                 attn_impl: str | None = None, ssd_impl: str | None = None):
        self.cfg = cfg
        self.model = build_model(cfg, device=device,
                                 attn_impl=attn_impl or "auto",
                                 ssd_impl=ssd_impl or "auto")
        self.model.load_state_dict(params)
        self.device = self.model.device
        self.params = self.model.state_dict()
        self.bank = bank
        self.cache = cache
        self._greedy_only = True
        self._di: torch.Tensor | None = None
        self._df: torch.Tensor | None = None

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never an alias)."""
        return torch.from_numpy(arr.copy()).to(self.device)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def refresh(self, inputs: DecodeInputs) -> None:
        """Mirror a freshly assembled decode batch to the device (two
        transfers: packed int32 + packed f32)."""
        self._greedy_only = inputs.greedy_only
        bt = inputs.block_tables
        s, mp = bt.shape
        di = np.empty((s, mp + self._DI_COLS), np.int32)
        di[:, :mp] = bt
        di[:, mp] = inputs.lengths
        di[:, mp + 1] = inputs.active
        di[:, mp + 2] = inputs.tokens[:, 0]
        di[:, mp + 3] = inputs.top_ks
        di[:, mp + 4] = inputs.seeds
        di[:, mp + 5] = inputs.idx
        self._di = self._to_device(di)
        self._df = self._to_device(
            np.stack([inputs.temps, inputs.top_ps], axis=1).astype(np.float32))

    def decode(self, inputs: DecodeInputs | None = None) -> np.ndarray:
        """Run one decode step; ``None`` reuses the device-advanced batch
        from last step. Returns the sampled token per slot, (S,) int32 on
        the host."""
        if inputs is not None:
            self.refresh(inputs)
        di, df = self._di, self._df
        mp = di.shape[1] - self._DI_COLS
        lens, active = di[:, mp].contiguous(), di[:, mp + 1].contiguous()
        tokens = di[:, mp + 2:mp + 3]
        if self.cache is None:
            logits = self.model.decode_step_ssm(self.bank.state, tokens,
                                                active)
        else:
            logits = self.model.decode_step_hybrid(
                self.cache.pages, self.bank.state, di[:, :mp].contiguous(),
                lens, tokens, active)
        toks = pick_tokens(logits, df[:, 0], di[:, mp + 3], df[:, 1],
                           di[:, mp + 4], di[:, mp + 5], self.cfg.vocab_size,
                           self._greedy_only)
        di[:, mp] += active
        di[:, mp + 2] = toks
        di[:, mp + 5] += active
        return toks.cpu().numpy()

    # ------------------------------------------------------------------
    # chunked prefill
    # ------------------------------------------------------------------
    def prefill_chunk(self, slot: int, seq: Sequence, tokens: np.ndarray,
                      start: int, valid: int) -> int:
        """One padded chunk for ``slot``: the slot's state (zeroed first
        when ``start == 0``, so a recycled slot never leaks its previous
        occupant — a host decision, no sync), the SSD scan continuation
        (and, hybrid, the chunk's K/V scattered into the slot's pages and
        attended), the advanced state written back, and the chunk's
        sampled token (the request's first token on the prompt's final
        chunk). One transfer: ``ci`` = [block-table row (hybrid) | padded
        tokens | top_k, seed]."""
        sp = seq.request.sampling
        c = tokens.shape[0]
        row = (self.cache.block_tables[slot] if self.cache is not None
               else np.zeros(0, np.int32))
        m = row.shape[0]
        ci = np.empty(m + c + 2, np.int32)
        ci[:m] = row
        ci[m:m + c] = tokens
        ci[m + c:] = (sp.top_k, seq.handle.seed)
        ci = self._to_device(ci)
        cf = self._to_device(np.array([sp.temperature, sp.top_p], np.float32))
        if start == 0:
            self.bank.zero(slot)
        if self.cache is None:
            new, logits = self.model.prefill_chunk_ssm(
                self.bank.slot(slot), ci[:c], valid)
        else:
            new, logits = self.model.prefill_chunk_hybrid(
                self.cache.pages, self.bank.slot(slot), ci[:m],
                ci[m:m + c], start, valid)
        self.bank.put(slot, new)
        # the JAX chunk sampler's arguments: temps, top_ks, top_ps, seeds,
        # and token index 0
        tok = pick_tokens(
            logits[None], cf[0:1], ci[m + c:m + c + 1], cf[1:2],
            ci[m + c + 1:m + c + 2],
            torch.zeros((1,), dtype=torch.int32, device=self.device),
            self.cfg.vocab_size, sp.temperature <= 0)
        return int(tok[0])


class SSMEngine(EngineBase):
    """Continuous-batching :class:`~repro_torch.serving.api.EngineCore` for
    the ``ssm`` (Mamba2) and ``hybrid`` (Zamba2) families.

    Same protocol surface and streaming semantics as
    :class:`~repro_torch.serving.engine.ContinuousBatchingEngine` —
    continuous admission, chunked prefill interleaved with decode,
    transparent preemption, ``(seed, token_index)``-keyed sampling — over a
    :class:`SlotStateBank` instead of (pure SSM) or alongside (hybrid) a
    paged KV pool. Pure-SSM engines deliberately have NO ``cache``
    attribute: there are no pages, per-request memory is constant, and
    admission is bounded by slots alone. ``page_size``/``num_pages`` size
    the hybrid's pool (``num_pages`` None: every slot at ``max_len``).
    ``params`` is the model's state dict; ``device`` is where the model,
    the bank, the pool and every step live (``"cuda"`` unless the caller
    asks for ``"cpu"``); ``attn_impl``/``ssd_impl`` ``"ref"`` run the
    plain versions on the card too."""

    def __init__(self, cfg, params, *, max_len: int = 256,
                 max_slots: int = 8, prefill_chunk: int | None = 32,
                 page_size: int = 16, num_pages: int | None = None,
                 admission=None, seed: int = 0,
                 max_preemptions: int | None = None,
                 attn_impl: str | None = None, ssd_impl: str | None = None,
                 device="cuda"):
        assert not cfg.is_encoder_decoder, "SSM engine is decoder-only"
        assert cfg.family in ("ssm", "hybrid"), (
            f"SSMEngine serves recurrent-state families; family "
            f"{cfg.family!r} should use the paged or lockstep engine")
        self.cfg = cfg
        self.max_len = max_len
        self.max_slots = max_slots
        self.max_preemptions = max_preemptions
        if prefill_chunk == 0:  # CLI convention: 0 disables chunking
            prefill_chunk = None
        if prefill_chunk is None:
            # the state bank has no whole-prompt path; one max_len-sized
            # chunk is semantically identical (dt=0 padding is exact)
            prefill_chunk = max_len
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self.device = resolve_device(device)
        self.hybrid = cfg.family == "hybrid"
        if self.hybrid:
            self.cache = PagedKVCache(
                num_layers=cfg.num_layers // cfg.attn_every,
                num_kv_heads=cfg.eff_kv_heads, head_dim=cfg.head_dim,
                dtype=getattr(torch, cfg.dtype), max_slots=max_slots,
                max_context=max_len, page_size=page_size,
                num_pages=num_pages, device=self.device)
        else:
            self._free = list(range(max_slots - 1, -1, -1))  # pop() -> slot 0 first
        self.bank = SlotStateBank(cfg, max_slots, getattr(torch, cfg.dtype),
                                  device=self.device)
        self.executor = SSMExecutor(
            cfg, params, self.bank, self.cache if self.hybrid else None,
            device=self.device, attn_impl=attn_impl, ssd_impl=ssd_impl)
        self.model = self.executor.model
        self.params = self.executor.params
        self.slots: dict[int, Sequence] = {}
        self._order = 0
        # uid -> (host state snapshot, attempt token list) parked by
        # preempt_youngest(snapshot=True)
        self._snapshots: dict[str, tuple] = {}
        self._dirty = True
        self._init_api(admission=admission, seed=seed)
        self.utilization = UtilizationMetrics()
        self.stats.update({"decode_steps": 0, "prefills": 0,
                           "prefill_chunks": 0, "preemptions": 0,
                           "restores": 0})

    # ------------------------------------------------------------------
    # EngineBase hooks
    # ------------------------------------------------------------------
    def _validate(self, request: Request) -> None:
        validate_request(request, max_len=self.max_len)
        if self.hybrid:
            worst = cdiv(len(request.prompt) + request.sampling.max_new_tokens,
                         self.cache.page_size)
            if worst > self.cache.num_pages - 1:
                raise ValueError(
                    f"request {request.uid}: needs {worst} KV pages, pool "
                    f"has {self.cache.num_pages - 1} — it could never be "
                    f"scheduled")

    def _find(self, uid: str) -> int | None:
        for slot, seq in self.slots.items():
            if seq.request.uid == uid:
                return slot
        return None

    def _cancel_active(self, uid: str) -> bool:
        slot = self._find(uid)
        if slot is None:
            return False
        seq = self._release(slot)
        self._finish_handle(seq.handle, FinishReason.CANCELLED)
        return True

    def _finish_handle(self, h, reason, error=None, now=None):
        self._snapshots.pop(h.uid, None)  # parked state must not leak
        super()._finish_handle(h, reason, error=error, now=now)

    # ------------------------------------------------------------------
    # protocol surface
    # ------------------------------------------------------------------
    @property
    def idle(self) -> bool:
        return not (len(self.admission) or self.slots or self._events)

    def capacity(self) -> int:
        free = (self.cache.free_slot_count if self.hybrid
                else len(self._free))
        return max(0, free - len(self.admission))

    # ------------------------------------------------------------------
    # admission + release
    # ------------------------------------------------------------------
    def _release(self, slot: int) -> Sequence:
        seq = self.slots.pop(slot)
        if self.hybrid:
            self.cache.release(slot)
        else:
            self._free.append(slot)
        self._dirty = True
        return seq

    def _admit(self) -> int:
        now = time.perf_counter()
        self._expire_queue(now)
        admitted = 0
        while True:
            req = self.admission.peek(now)
            if req is None:
                break
            if self.hybrid:
                if not self.cache.can_admit(len(req.prompt)):
                    break
                slot, _ = self.cache.admit(len(req.prompt))
            else:
                if not self._free:
                    break
                slot = self._free.pop()
            self.admission.pop(now)
            handle = self._handles[req.uid]
            self._order += 1
            seq = Sequence(req, handle, [], order=self._order,
                           phase="prefill", prefill_pos=0)
            self.slots[slot] = seq
            admitted += 1
            parked = self._snapshots.pop(req.uid, None)
            if parked is not None:
                # snapshot-preempted: resume decoding where it left off —
                # the bank gets the parked state verbatim alongside the
                # attempt's own token list, whose last entry is the
                # sampled-but-not-yet-fed pending token
                snap, attempt_tokens = parked
                self.bank.restore(slot, snap)
                seq.tokens = list(attempt_tokens)
                seq.phase = "decode"
                seq.prefill_pos = len(req.prompt)
                self._dirty = True
                self.stats["restores"] += 1
        return admitted

    def _first_token(self, slot: int, seq: Sequence, tok: int) -> None:
        """Prompt fully scanned into the slot state: deliver the sampled
        first token (attempt index 0 — after a preemption the handle
        de-duplicates it)."""
        now = time.perf_counter()
        seq.tokens.append(tok)
        seq.phase = "decode"
        self._dirty = True
        self.stats["prefills"] += 1
        if self._deliver(seq.handle, tok, 0, now):
            self._release(slot)

    # ------------------------------------------------------------------
    # preemption + snapshot/restore
    # ------------------------------------------------------------------
    def preempt_youngest(self, *, snapshot: bool = False) -> str | None:
        """Evict the youngest decoding sequence; returns its uid (None when
        nothing is decoding).

        Default: discard the slot's state and requeue the request — it
        re-prefills on re-admission and the ``(seed, token_index)``-keyed
        sampler regenerates a byte-identical stream (emitted deltas are
        de-duplicated). ``snapshot=True`` (pure SSM only; a hybrid slot
        raises) parks a host copy of the slot's constant-size state
        instead; re-admission restores it and decoding resumes without
        re-prefill."""
        decoding = [(seq.order, slot) for slot, seq in self.slots.items()
                    if seq.phase == "decode"]
        if not decoding:
            return None
        _, slot = max(decoding)
        return self._preempt_slot(slot, snapshot=snapshot)

    def _preempt_slot(self, slot: int, snapshot: bool = False) -> str:
        seq = self.slots[slot]
        uid = seq.request.uid
        if snapshot:
            if self.hybrid:
                raise ValueError(
                    "snapshot preemption is pure-SSM only: a hybrid slot's "
                    "attention pages are released on preemption, so the "
                    "sequence must re-prefill (snapshot=False)")
            if seq.phase == "decode" and seq.tokens:
                self._snapshots[uid] = (self.bank.snapshot(slot),
                                        list(seq.tokens))
        self._release(slot)
        self.stats["preemptions"] += 1
        h = seq.handle
        h.preemptions += 1
        if (self.max_preemptions is not None
                and h.preemptions > self.max_preemptions):
            self._finish_handle(
                h, FinishReason.PREEMPTED,
                error=f"request {uid}: preempted {h.preemptions} times "
                      f"(max_preemptions={self.max_preemptions})",
            )
        else:
            self._events.append(
                StreamEvent(uid, "preempted", t=time.perf_counter())
            )
            self.admission.requeue(seq.request, h.arrival)
        return uid

    def _ensure_decode_pages(self) -> None:
        """Hybrid only: grow every decoding slot's attention page chain
        before the step; pool exhaustion preempts youngest-first (the
        victim may be the requesting slot itself)."""
        for slot in sorted(s for s, q in self.slots.items()
                           if q.phase == "decode"):
            while slot in self.slots and self.slots[slot].phase == "decode":
                try:
                    if self.cache.ensure_append_capacity(slot):
                        self._dirty = True
                    break
                except RuntimeError:
                    decoding = [(q.order, s) for s, q in self.slots.items()
                                if q.phase == "decode"]
                    _, victim = max(decoding)
                    self._preempt_slot(victim)
                    if victim == slot:
                        break

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def _has_decodable(self) -> bool:
        return any(seq.phase == "decode" for seq in self.slots.values())

    def step(self) -> list[StreamEvent]:
        """Interleaved step: admit, advance the oldest in-flight prefill by
        one chunk, then run one decode step over every decoding slot. Cold
        start (nothing decodable yet) drains prefill chunks back to back so
        the first token is never gated on an empty decode batch."""
        self._admit()
        while not self._has_decodable():
            if not self._prefill_step():
                return self._drain_events()
            self._admit()
        self._prefill_step()
        self._decode_once()
        return self._drain_events()

    def _prefill_step(self) -> bool:
        cand = [(q.order, s) for s, q in self.slots.items()
                if q.phase == "prefill"]
        if not cand:
            return False
        _, slot = min(cand)
        seq = self.slots[slot]
        prompt = seq.request.prompt
        c = self.prefill_chunk
        start = seq.prefill_pos
        valid = min(c, len(prompt) - start)
        tokens = np.zeros(c, np.int32)
        tokens[:valid] = prompt[start:start + valid]
        tok = self.executor.prefill_chunk(slot, seq, tokens, start, valid)
        self.stats["prefill_chunks"] += 1
        self.utilization.record_batch(decode_rows=0, prefill_rows=valid,
                                      padded_rows=c - valid, fused=False)
        seq.prefill_pos += valid
        if seq.prefill_pos >= len(prompt):
            self._first_token(slot, seq, tok)
        return True

    def _decode_inputs(self) -> DecodeInputs:
        s = self.max_slots
        mp = self.cache.block_tables.shape[1] if self.hybrid else 0
        bt = np.full((s, mp), NULL_PAGE, np.int32)
        lengths = np.zeros(s, np.int32)
        active = np.zeros(s, np.int32)
        tokens = np.zeros((s, 1), np.int32)
        top_ks = np.zeros(s, np.int32)
        seeds = np.zeros(s, np.int32)
        idx = np.zeros(s, np.int32)
        temps = np.zeros(s, np.float32)
        top_ps = np.ones(s, np.float32)
        greedy = True
        for slot, seq in self.slots.items():
            if seq.phase != "decode":
                continue
            sp = seq.request.sampling
            if self.hybrid:
                bt[slot] = self.cache.block_tables[slot]
                lengths[slot] = self.cache.lengths[slot]
            active[slot] = 1
            tokens[slot, 0] = seq.tokens[-1]
            top_ks[slot] = sp.top_k
            seeds[slot] = seq.handle.seed
            idx[slot] = len(seq.tokens)
            temps[slot] = sp.temperature
            top_ps[slot] = sp.top_p
            if sp.temperature > 0:
                greedy = False
        return DecodeInputs(
            tokens=tokens, temps=temps, top_ks=top_ks, top_ps=top_ps,
            seeds=seeds, idx=idx, active=active, block_tables=bt,
            lengths=lengths, greedy_only=greedy,
        )

    def _decode_once(self) -> None:
        if self.hybrid:
            self._ensure_decode_pages()
        decoding = sorted(s for s, q in self.slots.items()
                          if q.phase == "decode")
        if not decoding:
            return
        if self._dirty:
            self.executor.refresh(self._decode_inputs())
            self._dirty = False
        toks = self.executor.decode()
        self.stats["decode_steps"] += 1
        self.utilization.record(
            active=len(decoding), slots=self.max_slots,
            pages_used=(self.cache.num_pages - 1 - self.cache.pool.available
                        if self.hybrid else None),
            pages_total=self.cache.num_pages - 1 if self.hybrid else None)
        self.utilization.record_batch(
            decode_rows=len(decoding), prefill_rows=0,
            padded_rows=self.max_slots - len(decoding), fused=False,
        )
        now = time.perf_counter()
        for slot in decoding:
            seq = self.slots[slot]
            tok = int(toks[slot])
            seq.tokens.append(tok)
            if self.hybrid:
                self.cache.append(slot)
            if self._deliver(seq.handle, tok, len(seq.tokens) - 1, now):
                self._release(slot)
