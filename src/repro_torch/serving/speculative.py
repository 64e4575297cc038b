"""Speculative decoding over the paged engine: proposers + bundle policy.

Decode is one token per dispatch, so in the low-batch interactive regime
(the notebook-rerun workload the paper targets) per-step dispatch overhead
dominates and tokens/sec sits far below the roofline. Speculation breaks
the serial chain: a cheap *proposer* drafts ``k`` candidate tokens, the
target model scores all of them in ONE fused dispatch (``models/lm.py::
verify_step_paged`` — exactly a k+1-token prefill chunk over the slot's
own block table), and the engine keeps the longest prefix that agrees
with what the ``(seed, token_index)``-keyed sampler would have produced
one token at a time. Pages are append-only per sequence, so rejecting the
tail is a pure host-side length rewind — no page is freed, published, or
parked on the rejected range.

Two proposers live behind one duck-typed interface (``propose(uid,
history, k)`` / ``retire(uid)``):

* :class:`NgramProposer` — self-speculation with no second model: match
  the last n tokens of the request's own prompt+output history against
  the earlier history and propose the continuation of the most recent
  match. Free to run and surprisingly strong on the rerun workload, where
  outputs quote their own prompts and loops abound.
* :class:`DraftModelProposer` — a small draft model (e.g. smollm drafting
  for llama3-8b-reduced) decoding greedily ``k`` steps ahead. It owns a
  separate :class:`~repro_torch.serving.kv_cache.PagedKVCache` on the
  engine's device with its own block tables, so the target pool's
  COW/refcounting is untouched; draft KV follows the same
  append-only/rewind discipline as the target (divergence rewinds to the
  common prefix, never copies) and is written in place by the draft's
  paged entry points (the paged kernels on the card).

The engine only ever asks "what comes next for this history" — proposers
never see pages, slots, or the scheduler, which is what keeps the
acceptance/rollback proof local to ``engine.py``.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.models import build_model
from repro_torch.serving.executor import RankShards
from repro_torch.serving.kv_cache import PagedKVCache

__all__ = [
    "SpeculativeProposer",
    "NgramProposer",
    "DraftModelProposer",
    "build_proposer",
]

SPEC_MODES = ("off", "ngram", "draft")


@runtime_checkable
class SpeculativeProposer(Protocol):
    """What the engine needs from a proposer — nothing engine-shaped."""

    def propose(self, uid: str, history: list[int], k: int) -> list[int]:
        """Up to ``k`` drafted continuations of ``history`` (prompt +
        emitted tokens). An empty list means "no idea": the engine falls
        back to the plain decode row for that step."""
        ...

    def retire(self, uid: str) -> None:
        """The request finished/was evicted: drop any per-uid state."""
        ...


class NgramProposer:
    """Prompt/self-speculation: propose the continuation of the most
    recent earlier occurrence of the history's n-token suffix.

    Longest match wins (``n`` down to 1), most recent occurrence wins
    within a match length — recency tracks the local repetition structure
    (code loops, quoted prompts) better than first occurrence. Stateless
    across calls, so ``retire`` is a no-op and preemption/replay cannot
    desynchronize it."""

    def __init__(self, n: int = 3):
        assert n >= 1, n
        self.n = n

    def propose(self, uid: str, history: list[int], k: int) -> list[int]:
        # iterate the lookup on history+drafts: a match near the end of
        # history (short cycles — THE high-acceptance regime) yields a
        # short continuation, and re-matching extends it to the full k
        drafts: list[int] = []
        while len(drafts) < k:
            cont = self._match(history + drafts, k - len(drafts))
            if not cont:
                break
            drafts.extend(cont)
        return drafts

    def _match(self, h: list[int], k: int) -> list[int]:
        ln = len(h)
        if k <= 0 or ln < 2:
            return []
        for m in range(min(self.n, ln - 1), 0, -1):
            pat = h[ln - m:]
            for j in range(ln - m - 1, -1, -1):
                if h[j:j + m] == pat:
                    cont = h[j + m:j + m + k]
                    if cont:
                        return list(cont)
                    break  # suffix-adjacent match: shorter m may still hit
        return []

    def retire(self, uid: str) -> None:  # stateless
        return None


class DraftModelProposer:
    """Greedy k-step lookahead with a small draft model on its OWN paged
    cache.

    Per request the proposer keeps ``(slot, cached)``: a draft-cache slot
    and the token list whose KV that slot holds (position i caches
    ``cached[i]``). Each ``propose`` rewinds to the longest common prefix
    of ``cached`` and the true history (rejected drafts fall away for
    free — append-only pages, same rewind rule as the target), catches up
    on new history via chunked prefill, then decodes ``k`` tokens
    greedily (one host sync per drafted token, for its argmax). The draft
    pool is sized like the target's but entirely separate: different
    layer count/head shape anyway, and isolation is what keeps the
    target's COW/refcount proof untouched by speculation.

    ``params`` is the draft model's state dict; without it the draft's
    weights are drawn from a ``torch.Generator`` seeded with ``seed``
    (``DecoderLM.init``). ``device`` is the engine's.

    At tp > 1 the draft stays whole on rank 0 (the reference builds it
    unsharded too): ``params`` is the draft's own full state dict, never a
    rank's slices, and :meth:`propose` runs in the engine's thread outside
    every executor call, where no ``tensor_parallel`` context is active,
    so the model's reductions are identities and no collective fires.
    """

    def __init__(self, cfg, params=None, *, max_slots: int = 8,
                 max_len: int = 256, page_size: int = 16, seed: int = 0,
                 chunk: int = 32, attn_impl: str | None = None,
                 device="cuda"):
        if isinstance(params, RankShards) or (
                params is not None and any(isinstance(k, int) for k in params)):
            raise ValueError("the draft model runs whole: pass its own full "
                             "state dict, not a rank's slices")
        self.cfg = cfg
        self.model = build_model(cfg, params=params, device=device,
                                 attn_impl=attn_impl or "auto")
        if params is None:
            params = self.model.init(seed=seed)
        self.device = self.model.device
        self.params = self.model.state_dict()
        self.max_len = max_len
        self.chunk = chunk
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers,
            num_kv_heads=cfg.eff_kv_heads,
            head_dim=cfg.head_dim,
            dtype=getattr(torch, cfg.dtype),
            max_slots=max_slots,
            max_context=max_len,
            page_size=page_size,
            device=self.device,
        )
        self._state: dict[str, dict] = {}  # uid -> {"slot", "cached"}

    def _tensor(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    # -- internals ----------------------------------------------------
    def _rewind(self, st: dict, history: list[int], target: int) -> int:
        """Rewind the slot to the longest common prefix of what its pages
        hold and what the history now demands (<= target positions)."""
        cached = st["cached"]
        cp = 0
        m = min(len(cached), target)
        while cp < m and cached[cp] == history[cp]:
            cp += 1
        del cached[cp:]
        self.cache.lengths[st["slot"]] = cp
        return cp

    def _catch_up(self, st: dict, history: list[int], target: int) -> None:
        """Chunk-prefill history[cp:target] into the slot's pages (their
        capacity already ensured)."""
        slot, cached = st["slot"], st["cached"]
        pos = len(cached)
        if pos >= target:
            return
        row = self._tensor(self.cache.block_tables[slot])
        while pos < target:
            step = min(self.chunk, target - pos)
            buf = np.zeros(self.chunk, np.int32)
            buf[:step] = history[pos:pos + step]
            self.model.prefill_chunk(self.cache.pages, row, self._tensor(buf),
                                     pos, step)
            pos += step
        cached.extend(history[len(cached):target])
        self.cache.lengths[slot] = target

    # -- proposer interface -------------------------------------------
    def propose(self, uid: str, history: list[int], k: int) -> list[int]:
        target = len(history) - 1  # positions cached before drafting
        k = min(k, self.max_len - len(history))
        if k <= 0 or target < 1:
            return []
        st = self._state.get(uid)
        if st is None:
            if self.cache.free_slot_count == 0 and self._state:
                # engine retires uids on finish/evict; this is a backstop
                self.retire(next(iter(self._state)))
            if self.cache.free_slot_count == 0:
                return []
            try:
                slot, _ = self.cache.admit(target)
            except RuntimeError:
                return []
            self.cache.lengths[slot] = 0  # admit reserves; nothing cached
            st = self._state[uid] = {"slot": slot, "cached": []}
        slot = st["slot"]
        cp = self._rewind(st, history, target)
        try:
            # the catch-up and the k drafted positions, from the rewound
            # length: the same pages the two-step growth would grant
            self.cache.ensure_append_capacity(slot, target - cp + k)
        except RuntimeError:
            return []  # draft pool full: skip speculation this step
        self._catch_up(st, history, target)
        bt = self._tensor(self.cache.block_tables[slot:slot + 1])
        drafts: list[int] = []
        last = history[-1]
        cur = target
        for _ in range(k):
            logits = self.model.decode_step_paged(
                self.cache.pages, bt, self._tensor([cur]),
                self._tensor([[last]]))
            st["cached"].append(last)
            cur += 1
            last = int(logits[0, :self.cfg.vocab_size].argmax().item())
            drafts.append(last)
        self.cache.lengths[slot] = cur
        return drafts

    def retire(self, uid: str) -> None:
        st = self._state.pop(uid, None)
        if st is not None:
            self.cache.release(st["slot"])


def build_proposer(mode: str, *, draft_config=None, draft_params=None,
                   ngram_n: int = 3, max_slots: int = 8, max_len: int = 256,
                   page_size: int = 16, seed: int = 0,
                   attn_impl: str | None = None, device="cuda"):
    """Resolve an engine ``speculative=`` kwarg into a proposer instance.

    ``draft_config`` may be a ModelConfig or an arch name (resolved via
    ``repro_torch.configs.get_arch``, ``-reduced`` suffix honored); fresh
    seed-derived params are initialized when ``draft_params`` is None —
    fine for benchmarks, real deployments pass trained draft weights."""
    if mode == "ngram":
        return NgramProposer(n=ngram_n)
    if mode == "draft":
        if draft_config is None:
            raise ValueError("speculative='draft' needs draft_config")
        if isinstance(draft_config, str):
            from repro_torch.configs import get_arch

            draft_config = get_arch(draft_config)
        return DraftModelProposer(
            draft_config, draft_params, max_slots=max_slots,
            max_len=max_len, page_size=page_size, seed=seed,
            attn_impl=attn_impl, device=device,
        )
    raise ValueError(
        f"speculative must be one of {SPEC_MODES}, got {mode!r}"
    )
