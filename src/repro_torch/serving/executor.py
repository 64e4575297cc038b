"""Device-side model executor for the paged serving engine.

This is the COMPUTE half of the scheduler/executor split: it owns the model
on its device and runs one fused model step + sampling per engine step,
eagerly (no CUDA graphs yet). ``step`` routes each
:class:`~repro_torch.serving.scheduler.StepPlan` down one of three
dispatches, each ending in its own paged-attention kernel on the card:

* decode-only (steady state)        -> ``decode_step_paged``  -> decode kernel
* chunk-only (cold start, refill)   -> ``prefill_chunk``      -> prefill kernel
* decode + chunk (fused)            -> ``mixed_step_paged``   -> mixed kernel

Without chunking (``prefill_chunk=None``), ``prefill_whole`` prefills each
admitted prompt in one executor call instead: ``DecoderLM.prefill`` over the
prompt padded to a power-of-two bucket (through the flash kernel), the
dense K/V scattered into the sequence's pages (quantized, scales alongside,
for an int8 pool: ``write_prefill_pages`` takes the whole pool dict), and
the first token sampled.

The decode batch lives on the device PACKED into one int32 tensor ``di``
(S, MP+6) and one f32 tensor ``df`` (S, 2), refreshed only when the
scheduler reports a composition change; each step advances them on the
device (lengths and sample indices stepped, sampled tokens written back), so
the steady-state loop transfers nothing to the device.

Tensor parallelism is not ported yet (ROADMAP A.10): the executor runs on
one device, and ``mesh``/``tp > 1`` raise.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import build_model
from repro_torch.models.common import pick_tokens
from repro_torch.serving.kv_cache import write_prefill_pages
from repro_torch.serving.scheduler import DecodeInputs, PrefillChunk, StepPlan

__all__ = ["ModelExecutor"]


class ModelExecutor:
    """Owns the model, the device mirrors of the decode batch, and the
    three step dispatches. Stateless with respect to scheduling: it
    executes :class:`~repro_torch.serving.scheduler.PrefillChunk` /
    :class:`~repro_torch.serving.scheduler.DecodeInputs` work items."""

    def __init__(self, cfg, params, cache, *, max_len: int, device="cuda",
                 attn_impl: str | None = None, mesh=None, tp: int = 1):
        if mesh is not None or tp != 1:
            raise NotImplementedError(
                "tensor-parallel serving is not ported yet (ROADMAP A.10); "
                "the executor runs at tp=1")
        self.cfg = cfg
        self.model = build_model(cfg, device=device,
                                 attn_impl=attn_impl or "auto")
        self.model.load_state_dict(params)
        self.device = self.model.device
        self.params = self.model.state_dict()
        self.cache = cache
        self.max_len = max_len
        self.tp = 1
        # device mirrors of the last decode batch (see module docstring)
        self._greedy_only = True
        self._di: torch.Tensor | None = None
        self._df: torch.Tensor | None = None

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never an alias: ``.to('cpu')`` of a
        ``from_numpy`` tensor would keep sharing the numpy buffer)."""
        return torch.from_numpy(arr.copy()).to(self.device)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    # Packed decode batch ``di`` (S, MP+6) int32: block table row, then
    # _DI_COLS columns [lens, active, tokens, top_ks, seeds, idx]; ``df``
    # (S, 2) f32: [temps, top_ps].
    _DI_COLS = 6

    def _advance(self, toks: torch.Tensor) -> None:
        """Step the packed batch on the device after a decode-bearing step:
        lengths and sample indices advance on active rows, the sampled
        tokens become next step's inputs."""
        di = self._di
        mp = di.shape[1] - self._DI_COLS
        active = di[:, mp + 1]
        di[:, mp] += active
        di[:, mp + 2] = toks
        di[:, mp + 5] += active

    def refresh(self, inputs: DecodeInputs) -> None:
        """Mirror a freshly assembled decode batch to the device (two
        transfers: the packed int32 batch and the packed f32 sampling
        params)."""
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

    def _decode_columns(self):
        di, mp = self._di, self._di.shape[1] - self._DI_COLS
        return (di[:, :mp].contiguous(), di[:, mp].contiguous(),
                di[:, mp + 1], mp)

    def decode(self, inputs: DecodeInputs | None = None) -> np.ndarray:
        """Run one decode step. ``inputs`` refreshes the device mirrors
        (admission/eviction/page growth); None reuses last step's device
        state. Returns the sampled token per slot, (S,) int32 on the host."""
        if inputs is not None:
            self.refresh(inputs)
        bt, lens, _, mp = self._decode_columns()
        di, df = self._di, self._df
        logits = self.model.decode_step_paged(
            self.cache.pages, bt, lens, di[:, mp + 2:mp + 3])
        toks = pick_tokens(logits, df[:, 0], di[:, mp + 3], df[:, 1],
                           di[:, mp + 4], di[:, mp + 5], self.cfg.vocab_size,
                           self._greedy_only)
        self._advance(toks)
        return toks.cpu().numpy()

    # ------------------------------------------------------------------
    # fused mixed step (decode batch + one prefill chunk, one dispatch)
    # ------------------------------------------------------------------
    def _pack_chunk(self, chunk) -> tuple[torch.Tensor, torch.Tensor]:
        """Pack one prefill chunk's host state into two transfers:
        ``ci`` (MP+C+4,) int32 = [block-table row | padded tokens | start,
        valid, top_k, seed] and ``cf`` (2,) f32 = [temperature, top_p]."""
        sp = chunk.seq.request.sampling
        row = self.cache.block_tables[chunk.slot]
        mp, c = row.shape[0], chunk.tokens.shape[0]
        ci = np.empty(mp + c + 4, np.int32)
        ci[:mp] = row
        ci[mp:mp + c] = chunk.tokens
        ci[mp + c:] = (chunk.start, chunk.valid, sp.top_k,
                       chunk.seq.handle.seed)
        cf = np.array([sp.temperature, sp.top_p], np.float32)
        return self._to_device(ci), self._to_device(cf)

    def _mixed(self, chunk: PrefillChunk, greedy_only: bool):
        """ONE model step for every decode slot AND one prefill chunk:
        S + C single-token rows. Decode rows keep their exact decode
        semantics (same device-mirror feedback); the chunk contributes C
        rows sharing its slot's block-table row and one extra sampled
        token at index 0, meaningful only on the prompt's final chunk."""
        ci, cf = self._pack_chunk(chunk)
        bt, lens, active, mp = self._decode_columns()
        di, df = self._di, self._df
        s = di.shape[0]
        c = ci.shape[0] - mp - 4
        crow, ctoks = ci[:mp], ci[mp:mp + c]
        cstart, cvalid = ci[mp + c], ci[mp + c + 1]
        # rows [0,S): decode slots at position = length (-1 when idle);
        # rows [S,S+C): the chunk at start+i (-1 past valid)
        cidx = torch.arange(c, dtype=torch.int32, device=self.device)
        positions = torch.cat([
            torch.where(active == 1, lens, -1),
            torch.where(cidx < cvalid, cstart + cidx, -1),
        ])
        tables = torch.cat([bt, crow[None, :].expand(c, mp)])
        logits = self.model.mixed_step_paged(
            self.cache.pages, tables, positions,
            torch.cat([di[:, mp + 2:mp + 3], ctoks[:, None]]),
            num_decode=s, chunk_valid=cvalid,
        )  # (S+1, Vp): decode rows + the chunk's row
        zero = torch.zeros((1,), dtype=torch.int32, device=self.device)
        toks = pick_tokens(
            logits,
            torch.cat([df[:, 0], cf[0:1]]),
            torch.cat([di[:, mp + 3], ci[mp + c + 2:mp + c + 3]]),
            torch.cat([df[:, 1], cf[1:2]]),
            torch.cat([di[:, mp + 4], ci[mp + c + 3:mp + c + 4]]),
            torch.cat([di[:, mp + 5], zero]),
            self.cfg.vocab_size,
            greedy_only,
        )
        self._advance(toks[:s])
        return toks

    def step(self, plan: StepPlan) -> tuple[np.ndarray | None, int | None]:
        """Execute one step plan. Returns ``(decode_toks, chunk_tok)``:
        the sampled token per slot ((S,) int32 on the host, None when the
        plan had no decode rows) and the chunk's sampled first token (None
        when the plan had no chunk; meaningful only on a final chunk).

        Degenerate plans route to the specialized dispatches — chunk-only
        runs the chunk kernel without S dead decode rows, decode-only runs
        the decode step with its zero-transfer device mirrors."""
        chunk = plan.chunk
        if not plan.decode_slots:
            ctok = self.prefill_chunk(chunk) if chunk is not None else None
            return None, ctok
        if chunk is None:
            return self.decode(plan.decode), None
        if plan.decode is not None:
            self.refresh(plan.decode)
        sp = chunk.seq.request.sampling
        toks = self._mixed(chunk, self._greedy_only and sp.temperature <= 0.0)
        host = toks.cpu().numpy()
        return host[:-1], int(host[-1])

    # ------------------------------------------------------------------
    # chunked prefill
    # ------------------------------------------------------------------
    def prefill_chunk(self, work: PrefillChunk) -> int:
        """Dispatch one chunk (model step + page writes + sample); returns
        the sampled first token (meaningful only when this was the prompt's
        final chunk)."""
        ci, cf = self._pack_chunk(work)
        mp = self.cache.block_tables.shape[1]
        c = ci.shape[0] - mp - 4
        logits = self.model.prefill_chunk(
            self.cache.pages, ci[:mp], ci[mp:mp + c], ci[mp + c],
            ci[mp + c + 1])
        tok = pick_tokens(
            logits[None], cf[0:1], ci[mp + c + 2:mp + c + 3], cf[1:2],
            ci[mp + c + 3:mp + c + 4],
            torch.zeros((1,), dtype=torch.int32, device=self.device),
            self.cfg.vocab_size,
            work.seq.request.sampling.temperature <= 0.0)
        return int(tok[0])

    # ------------------------------------------------------------------
    # whole-prompt prefill (prefill_chunk=None)
    # ------------------------------------------------------------------
    def _bucket(self, plen: int) -> int:
        """The prompt's padded length: the next power of two from 16,
        capped at ``max_len`` (so prompts over max_len / 2 all share the
        max_len bucket)."""
        b = 16
        while b < plen:
            b *= 2
        return min(b, max(self.max_len, 1))

    def prefill_whole(self, request, seed: int, slot: int) -> int:
        """Prefill a whole prompt into its pages and return the first
        token: prefill, page scatter and first-token sample in one call,
        with the logits taken at the last real position."""
        plen = len(request.prompt)
        bucket = self._bucket(plen)
        sp = request.sampling
        row = self.cache.block_tables[slot]
        mp = row.shape[0]
        # one transfer: [block-table row | padded tokens | top_k, seed]
        ci = np.zeros(mp + bucket + 2, np.int32)
        ci[:mp] = row
        ci[mp:mp + plen] = request.prompt
        ci[mp + bucket:] = (sp.top_k, seed)
        ci = self._to_device(ci)
        cf = self._to_device(np.array([sp.temperature, sp.top_p], np.float32))
        cache, logits = self.model.prefill(
            {"tokens": ci[None, mp:mp + bucket]}, bucket,
            logits_index=plen - 1)
        write_prefill_pages(self.cache.pages, cache["k"][:, 0],
                            cache["v"][:, 0], ci[:mp], plen)
        tok = pick_tokens(
            logits, cf[0:1], ci[mp + bucket:mp + bucket + 1], cf[1:2],
            ci[mp + bucket + 1:],
            torch.zeros((1,), dtype=torch.int32, device=self.device),
            self.cfg.vocab_size, sp.temperature <= 0.0)
        return int(tok[0])
