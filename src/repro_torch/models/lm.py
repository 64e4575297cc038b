"""Decoder-only LM, dense, ssm and hybrid families, with the serving entry
points.

One ``nn.Module`` holding the same stacked ``(L, ...)`` parameters as
``repro/models/lm.py`` (names ``embed``, ``final_norm``, ``layers.ln1``,
``layers.attn.wq`` ... for dense, ``layers.ln``, ``layers.mamba.w_z`` ...
for ssm and hybrid, plus the hybrid's unstacked ``shared.{ln1, attn, ln2,
mlp}`` block), on an explicit device. The hybrid (Zamba2) stack is
``L // attn_every`` groups, each the shared attention + MLP block (the
same weights every time, its own KV layer each time) followed by
``attn_every`` Mamba2 layers. The entry points serve the engines, each a
Python loop over the layers:

  * dense, ssm and hybrid, dense per-sequence cache (the lockstep engine,
    and the whole-prompt admission of the paged engine): ``init_cache``,
    ``prefill`` (a whole padded batch of prompts; attention through the
    flash kernel, K/V padded to ``max_len``; Mamba layers through
    ``mamba_block``, the scan from a zero state) and ``decode_step`` (one
    token per row, the cache written in place);
  * dense (paged KV pool, written in place):
    ``decode_step_paged`` (one token per in-flight slot), ``prefill_chunk``
    (one fixed-size prompt chunk of one sequence), ``mixed_step_paged``
    (decode rows + one chunk in one pass);
  * ssm (per-slot recurrent state bank): ``decode_step_ssm`` (one token per
    slot, the bank advanced in place) and ``prefill_chunk_ssm`` (one chunk
    of one sequence from its carried state);
  * hybrid (a ``L // attn_every``-layer paged pool beside the state bank):
    ``decode_step_hybrid`` and ``prefill_chunk_hybrid``.

Each returns f32 logits. Vocab is padded to a multiple of 256, as in the
JAX package.

Not ported yet: training (``loss_fn``, A.11), ``verify_step_paged``
(A.6), and the moe and vlm families (A.7).
"""

from __future__ import annotations

import zlib
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamSpec, flatten_tree, resolve_device,
                                       rms_norm, swiglu)

VOCAB_PAD_MULTIPLE = 256

_NOT_PORTED = {
    "moe": "ROADMAP A.7 (moe family)",
    "vlm": "ROADMAP A.7 (vlm path)",
    "audio": "ROADMAP A.11 (encoder-decoder)",
}


def mlp_param_specs(cfg: ModelConfig, stacked: int | None = None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    pre = (stacked,) if stacked else ()
    pax = ("stack",) if stacked else ()
    return {
        "w_gate": ParamSpec(pre + (d, f), pax + ("embed", "ff")),
        "w_up": ParamSpec(pre + (d, f), pax + ("embed", "ff")),
        "w_down": ParamSpec(pre + (f, d), pax + ("ff", "embed")),
    }


def padded_vocab(cfg: ModelConfig) -> int:
    v = cfg.vocab_size
    return ((v + VOCAB_PAD_MULTIPLE - 1) // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def _register(module: nn.Module, specs: dict, default_dtype: str,
              device: torch.device) -> None:
    for key, val in specs.items():
        if isinstance(val, ParamSpec):
            dt = getattr(torch, val.dtype or default_dtype)
            module.register_parameter(key, nn.Parameter(
                torch.empty(val.shape, dtype=dt, device=device),
                requires_grad=False))
        else:
            child = nn.Module()
            _register(child, val, default_dtype, device)
            module.add_module(key, child)


class DecoderLM(nn.Module):
    """Dense, ssm or hybrid decoder-only LM; the port's counterpart of
    ``repro``'s ``DecoderLM`` for the dense-cache, paged and
    recurrent-state serving paths."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 attn_impl: str = "auto", ssd_impl: str = "auto"):
        super().__init__()
        assert not cfg.is_encoder_decoder
        if cfg.family not in ("dense", "ssm", "hybrid"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: "
                f"{_NOT_PORTED.get(cfg.family, 'ROADMAP A')}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.ssd_impl = ssd_impl
        self.device = resolve_device(device)
        _register(self, self.param_specs(), cfg.dtype, self.device)
        self._layer_views: list[dict] | None = None
        self._shared_view: dict | None = None
        self._unembed_cache: tuple | None = None

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        L, D = cfg.num_layers, cfg.d_model
        vp = padded_vocab(cfg)
        specs: dict[str, Any] = {
            "embed": ParamSpec((vp, D), ("vocab", None), init="embed", scale=0.02),
            "final_norm": ParamSpec((D,), (None,), init="ones"),
        }
        if not cfg.tie_embeddings:
            specs["unembed"] = ParamSpec((D, vp), (None, "vocab"))
        if cfg.family in ("ssm", "hybrid"):
            specs["layers"] = {
                "ln": ParamSpec((L, D), ("stack", None), init="ones"),
                "mamba": ssm_mod.mamba_param_specs(cfg, stacked=L),
            }
            if cfg.family == "hybrid":
                specs["shared"] = {
                    "ln1": ParamSpec((D,), (None,), init="ones"),
                    "attn": attn.attn_param_specs(cfg),
                    "ln2": ParamSpec((D,), (None,), init="ones"),
                    "mlp": mlp_param_specs(cfg),
                }
            return specs
        specs["layers"] = {
            "ln1": ParamSpec((L, D), ("stack", None), init="ones"),
            "attn": attn.attn_param_specs(cfg, stacked=L),
            "ln2": ParamSpec((L, D), ("stack", None), init="ones"),
            "mlp": mlp_param_specs(cfg, stacked=L),
        }
        return specs

    @torch.no_grad()
    def init(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Fill every parameter with seeded random values (drawn on the
        model's device from a ``torch.Generator`` per parameter, seeded
        from ``seed`` and the parameter's name, so adding a parameter never
        reshuffles the others) and return the state dict. The init rules
        and scales are the JAX package's; the random streams are not."""
        gen = torch.Generator(device=self.device)
        for name, spec in flatten_tree(self.param_specs()).items():
            p = self.get_parameter(name)
            if spec.init == "zeros":
                p.zero_()
                continue
            if spec.init == "ones":
                p.fill_(1.0)
                continue
            if spec.init == "embed":
                scale = spec.scale if spec.scale is not None else 1.0
            else:
                fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
                scale = (spec.scale if spec.scale is not None
                         else 1.0 / np.sqrt(fan_in))
            gen.manual_seed((seed << 32) + zlib.crc32(name.encode()))
            p.copy_(torch.randn(spec.shape, generator=gen, device=self.device,
                                dtype=torch.float32) * scale)
        return self.state_dict()

    def _layers(self) -> list[dict]:
        """Per-layer views of the stacked parameters, nested like the JAX
        tree (``{"ln1", "attn": {...}, "ln2", "mlp": {...}}``, or
        ``{"ln", "mamba": {...}}`` for ssm and hybrid)."""
        if self._layer_views is None:
            self._layer_views = [_views(self.layers, lambda p, l=l: p[l])
                                 for l in range(self.cfg.num_layers)]
        return self._layer_views

    def _stack(self):
        """The layer stack in order, one ``(kind, i, params)`` per block:
        ``("attn", KV layer i, attention + MLP block)`` or ``("mamba",
        layer i, Mamba layer)``. dense: attention layer l; ssm: Mamba layer
        l; hybrid: for each of the ``L // attn_every`` groups g, the shared
        block (``{"ln1", "attn", "ln2", "mlp"}``, the same weights every
        time) on KV layer g, then Mamba layers ``g * attn_every`` onward."""
        cfg, layers = self.cfg, self._layers()
        if cfg.family != "hybrid":
            kind = "attn" if cfg.family == "dense" else "mamba"
            yield from ((kind, l, pl) for l, pl in enumerate(layers))
            return
        if self._shared_view is None:
            self._shared_view = _views(self.shared, lambda p: p)
        every = cfg.attn_every
        for g in range(cfg.num_layers // every):
            yield "attn", g, self._shared_view
            for l in range(g * every, (g + 1) * every):
                yield "mamba", l, layers[l]

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        """(N, S, D) -> (N, S, Vp) f32 logits. The product runs in f32 on
        the weight's values (bf16 operands into f32 logits, like the JAX
        unembed's ``preferred_element_type=f32``): a bf16 matmul would round
        the logits. The f32 copy of a bf16 weight is made once and kept
        until the weight changes."""
        w = self.embed if self.cfg.tie_embeddings else self.unembed
        key = (w.data_ptr(), w._version)
        if self._unembed_cache is None or self._unembed_cache[0] != key:
            wf = w.detach().float()
            self._unembed_cache = (key, wf.t() if self.cfg.tie_embeddings else wf)
        return x.float() @ self._unembed_cache[1]

    def _block(self, pl: dict, x: torch.Tensor, attend) -> torch.Tensor:
        cfg = self.cfg
        x = x + attend(pl["attn"], rms_norm(x, pl["ln1"], cfg.norm_eps))
        h = rms_norm(x, pl["ln2"], cfg.norm_eps)
        mlp = pl["mlp"]
        return x + swiglu(h, mlp["w_gate"], mlp["w_up"], mlp["w_down"])

    def _as_scalar(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.int32, device=self.device)

    def _mamba(self, pl: dict, x: torch.Tensor, step):
        """One Mamba layer: ``x + step(mamba params, rms_norm(x))``;
        ``step`` returns (h, its new cache), handed back beside x."""
        h, new = step(pl["mamba"], rms_norm(x, pl["ln"], self.cfg.norm_eps))
        return x + h, new

    def _mamba_decode(self, pl: dict, x: torch.Tensor, cl: dict,
                      active: torch.Tensor | None) -> torch.Tensor:
        """One Mamba layer's decode step on the layer's cache ``cl`` (the
        SSD state advanced in place, the conv tails written back in place).
        ``active`` gates the writeback per row, as the JAX ``_mask_state``
        gates its bank: the SSD kernel gates its own state rows, the conv
        tails go through the same mask. None advances every row (the
        lockstep cache)."""
        x, new = self._mamba(pl, x, lambda p, h: ssm_mod.mamba_decode(
            p, h, cl, self.cfg, ssd_impl=self.ssd_impl, active=active))
        keep = None if active is None else active.to(torch.bool)[:, None, None]
        for k in ("conv_x", "conv_b", "conv_c"):
            cl[k].copy_(new[k] if keep is None
                        else torch.where(keep, new[k], cl[k]))
        return x

    def _logits_at(self, x: torch.Tensor, logits_index) -> torch.Tensor:
        """(B, S, D) -> (B, Vp) f32 logits of one position: the last when
        ``logits_index`` is None, else that index (an int or an int scalar
        tensor; negative wraps and out-of-range clamps, like the JAX
        ``dynamic_slice``)."""
        s = x.shape[1]
        if logits_index is None:
            x = x[:, -1:]
        else:
            row = self._as_scalar(logits_index)
            row = torch.where(row < 0, row + s, row).clamp(0, s - 1)
            x = x.index_select(1, row.reshape(1).long())
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._unembed(x)[:, 0]

    # ------------------------------------------------------------------
    # dense cache (lockstep engine, whole-prompt prefill)
    # ------------------------------------------------------------------
    def cache_struct(self, batch: int, max_len: int) -> dict:
        """Shapes and dtypes of the dense cache, ``pos`` an int32 scalar
        (positions written so far, shared by every row) in each:

        * dense: k/v (L, B, max_len, KVH, Dh) in the model's dtype;
        * ssm: ``mamba``, the ``init_mamba_cache`` tree stacked over L
          (f32 SSD state (L, B, H, P, N), conv tails in the model's dtype);
        * hybrid: ``mamba`` as ssm, plus ``shared_k``/``shared_v`` (g, B,
          max_len, KVH, Dh), one layer per attention occurrence."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        pos = ((), torch.int32)
        if cfg.family == "dense":
            kv = ((cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                   cfg.head_dim), dt)
            return {"k": kv, "v": kv, "pos": pos}
        mc = ssm_mod.init_mamba_cache(cfg, batch, dt, device="meta")
        struct = {"mamba": {k: ((cfg.num_layers,) + tuple(v.shape), v.dtype)
                            for k, v in mc.items()}}
        if cfg.family == "hybrid":
            kv = ((cfg.num_layers // cfg.attn_every, batch, max_len,
                   cfg.num_kv_heads, cfg.head_dim), dt)
            struct.update(shared_k=kv, shared_v=kv)
        struct["pos"] = pos
        return struct

    def init_cache(self, batch: int, max_len: int) -> dict:
        def zeros(struct):
            if isinstance(struct, dict):
                return {k: zeros(v) for k, v in struct.items()}
            shape, dt = struct
            return torch.zeros(shape, dtype=dt, device=self.device)

        return zeros(self.cache_struct(batch, max_len))

    def _kv_layer(self, cache: dict, i: int) -> dict:
        """Attention occurrence i's K/V in the dense cache (views)."""
        pre = "shared_" if self.cfg.family == "hybrid" else ""
        return {"k": cache[pre + "k"][i], "v": cache[pre + "v"][i]}

    def _attend_prompt(self, p: dict, h: torch.Tensor, cl: dict,
                       positions: torch.Tensor) -> torch.Tensor:
        """Self-attention over the whole prompt, its K/V written into the
        cache layer ``cl`` at ``[:S]``."""
        out, (k, v) = attn.self_attention_with_cache_write(
            p, h, self.cfg, positions=positions, attn_impl=self.attn_impl)
        s = h.shape[1]
        cl["k"][:, :s] = k
        cl["v"][:, :s] = v
        return out

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int, *, logits_index=None):
        """Full-sequence forward; returns (cache, one position's logits).

        batch: ``{"tokens": (B, S) int}`` on the model's device, all rows at
        positions ``0..S-1`` (the lockstep engine left-pads with token 0
        and masks nothing: real tokens attend the pads, and the pads run
        through the Mamba recurrence, as in the JAX package). The cache is
        :meth:`init_cache`'s: K/V written at ``[:S]`` and zero past it (S
        <= max_len), the Mamba layers' state and conv tails after position
        S, ``pos`` = S. Returns logits (B, Vp) f32 of position
        ``logits_index`` (an int or an int scalar tensor; negative wraps
        and out-of-range clamps, like the JAX ``dynamic_slice``), or of the
        last position when None.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        if s > max_len:
            raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
        cache = self.init_cache(b, max_len)
        positions = torch.arange(s, device=self.device)
        x = self.embed[tokens.long()]  # (B,S,D)

        for kind, i, pl in self._stack():
            if kind == "attn":
                cl = self._kv_layer(cache, i)
                x = self._block(pl, x, lambda p, h: self._attend_prompt(
                    p, h, cl, positions))
            else:
                x, mc = self._mamba(pl, x, lambda p, h: ssm_mod.mamba_block(
                    p, h, cfg, ssd_impl=self.ssd_impl, return_cache=True))
                for k, v in mc.items():
                    cache["mamba"][k][i] = v
        cache["pos"].fill_(s)
        return cache, self._logits_at(x, logits_index)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens):
        """tokens (B, 1) -> (cache, logits (B, Vp) f32). Every attention
        layer writes its K/V at ``cache["pos"]`` (clamped into the cache)
        IN PLACE and attends positions ``<= pos``; every Mamba layer
        advances its state and conv tails in place, every row; ``pos`` then
        advances by one. The JAX step returns a new cache (its engine
        donates the old one)."""
        cfg = self.cfg
        pos = cache["pos"]
        x = self.embed[tokens.long()]  # (B,1,D)

        for kind, i, pl in self._stack():
            if kind == "attn":
                cl = self._kv_layer(cache, i)
                x = self._block(pl, x, lambda p, h: attn.decode_self_attention(
                    p, h, cl, pos, cfg)[0])
            else:
                x = self._mamba_decode(
                    pl, x, {k: v[i] for k, v in cache["mamba"].items()}, None)
        pos.add_(1)
        return cache, self._logits_at(x, None)

    # ------------------------------------------------------------------
    # paged decode (continuous batching)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_step_paged(self, pages, block_tables, lengths, tokens):
        """One token per in-flight slot against the paged KV pool.

        pages: {"k": (L,P+1,page,KVH,Dh), "v": ...} — the shared page pool
        (with its sink page), written in place; an int8 pool also carries
        ``k_scale``/``v_scale`` (L,P+1,page,KVH) f32. block_tables (S, MP) int32,
        lengths (S,) int32 (tokens already cached per slot; idle slots are
        0), tokens (S, 1) int. Returns logits (S, Vp) f32.
        """
        return self._decode_pool(pages, None, block_tables, lengths, tokens,
                                 None)

    def _decode_pool(self, pages, state, block_tables, lengths, tokens,
                     active):
        """One token per slot through the stack: attention blocks on the
        paged pool (``pages``, ``block_tables``, ``lengths``), Mamba layers
        on the state bank (``state``, writeback gated by ``active``), both
        IN PLACE. Returns logits (S, Vp) f32."""
        cfg = self.cfg
        x = self.embed[tokens.long()]  # (S,1,D)
        for kind, i, pl in self._stack():
            if kind == "attn":
                cl = {key: arr[i] for key, arr in pages.items()}
                x = self._block(pl, x, lambda p, h: attn.decode_self_attention_paged(
                    p, h, cl, block_tables, lengths, cfg,
                    attn_impl=self.attn_impl))
            else:
                x = self._mamba_decode(pl, x, {k: v[i] for k, v in state.items()},
                                       active)
        return self._logits_at(x, None)

    @torch.no_grad()
    def mixed_step_paged(self, pages, block_tables, positions, tokens, *,
                         num_decode: int, chunk_valid):
        """Fused mixed step: ``num_decode`` decode rows plus one prefill
        chunk's rows in ONE forward pass over the paged KV pool.

        tokens (R, 1) with R = num_decode + C; block_tables (R, MP) int32
        (chunk rows repeat the chunk slot's row); positions (R,) int32, -1
        for dead rows. ``chunk_valid`` (int32 scalar) selects the chunk's
        sampling row ``num_decode + max(chunk_valid - 1, 0)``. Returns
        logits (num_decode + 1, Vp) f32: one row per decode slot plus the
        chunk's row (meaningful on the prompt's final chunk only).
        """
        cfg = self.cfg
        x = self.embed[tokens.long()]  # (R,1,D)
        for l, pl in enumerate(self._layers()):
            cl = {key: arr[l] for key, arr in pages.items()}
            x = self._block(pl, x, lambda p, h: attn.mixed_step_attention_paged(
                p, h, cl, block_tables, positions, cfg,
                attn_impl=self.attn_impl, num_decode=num_decode))
        row = num_decode + (self._as_scalar(chunk_valid) - 1).clamp_min(0)
        xc = x.index_select(0, row.reshape(1).long())
        x = torch.cat([x[:num_decode], xc], dim=0)  # (S+1, 1, D)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self._unembed(x)[:, 0]

    # ------------------------------------------------------------------
    # chunked prefill (continuous batching)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill_chunk(self, pages, block_table, tokens, start, valid):
        """One fixed-size prefill chunk of ONE sequence, written into its
        existing page set.

        block_table (MP,) int32; tokens (C,) int; start / valid int32
        scalars (positions already resident; real tokens in this padded
        chunk). Returns logits (Vp,) f32 of chunk position ``valid - 1`` —
        meaningful on the prompt's final chunk.
        """
        cfg = self.cfg
        start, valid = self._as_scalar(start), self._as_scalar(valid)
        x = self.embed[tokens.long()][None]  # (1,C,D)
        for l, pl in enumerate(self._layers()):
            cl = {key: arr[l] for key, arr in pages.items()}
            x = self._block(pl, x, lambda p, h: attn.prefill_chunk_attention_paged(
                p, h, cl, block_table, start, valid, cfg,
                attn_impl=self.attn_impl))
        # negative index wraps like JAX's dynamic slice: valid 0 -> row C-1
        row = torch.remainder(valid - 1, x.shape[1])
        x = x.index_select(1, row.reshape(1).long())
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self._unembed(x)[0, 0]

    # ------------------------------------------------------------------
    # recurrent-state serving (SSM / hybrid continuous batching)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_step_ssm(self, state, tokens, active):
        """One token per in-flight slot against the per-slot state bank.

        state: the ``init_mamba_cache`` tree stacked over layers and
        batched over slots — ssm (L,S,HN,PN,N) f32 plus conv tails — and
        advanced IN PLACE (the JAX step donates it and returns the new
        bank). tokens (S, 1) int is each slot's last token; active (S,)
        int32 on the model's device masks idle slots, whose state is left
        untouched (their rows still run; the SSD kernel gates its own
        writeback, the conv tails are written through the same mask, as
        the JAX ``_mask_state``). Returns logits (S, Vp) f32."""
        assert self.cfg.family == "ssm", self.cfg.family
        return self._decode_pool(None, state, None, None, tokens, active)

    def _prefill_chunk_bank(self, pages, state_slot, block_table, tokens,
                            start: int, valid: int):
        """One chunk of one sequence through the stack: attention blocks on
        its pages (in place), Mamba layers from the slot's carried state
        (not modified). Returns (new_state_slot, logits (Vp,) f32 at chunk
        position ``max(valid - 1, 0)``: clamped, as the JAX
        ``prefill_chunk_ssm`` and ``prefill_chunk_hybrid`` do; the dense
        ``prefill_chunk`` wraps)."""
        cfg = self.cfg
        valid = int(valid)
        start_t, valid_t = self._as_scalar(start), self._as_scalar(valid)
        x = self.embed[tokens.long()][None]  # (1,C,D)
        new_state = {k: [] for k in state_slot}
        for kind, i, pl in self._stack():
            if kind == "attn":
                cl = {key: arr[i] for key, arr in pages.items()}
                x = self._block(pl, x, lambda p, h: attn.prefill_chunk_attention_paged(
                    p, h, cl, block_table, start_t, valid_t, cfg,
                    attn_impl=self.attn_impl))
            else:
                cl = {k: v[i] for k, v in state_slot.items()}
                x, new = self._mamba(pl, x, lambda p, h: ssm_mod.mamba_prefill_chunk(
                    p, h, cl, cfg, valid=valid, ssd_impl=self.ssd_impl))
                for k, v in new.items():
                    new_state[k].append(v)
        row = max(valid - 1, 0)
        x = rms_norm(x[:, row:row + 1], self.final_norm, cfg.norm_eps)
        return ({k: torch.stack(v) for k, v in new_state.items()},
                self._unembed(x)[0, 0])

    @torch.no_grad()
    def prefill_chunk_ssm(self, state_slot, tokens, valid: int):
        """One fixed-size prefill chunk of ONE sequence through the SSD
        scan, continuing from the slot's carried state.

        state_slot: one slot's state with the slot axis kept singleton —
        ssm (L,1,HN,PN,N) f32 plus conv tails; it is not modified. tokens
        (C,) int; valid (host int) is the number of real tokens in this
        possibly-padded chunk. Returns (new_state_slot, logits (Vp,) f32)
        with logits at chunk position ``max(valid - 1, 0)`` — meaningful on
        the prompt's final chunk."""
        assert self.cfg.family == "ssm", self.cfg.family
        return self._prefill_chunk_bank(None, state_slot, None, tokens, 0,
                                        valid)

    @torch.no_grad()
    def decode_step_hybrid(self, pages, state, block_tables, lengths,
                           tokens, active):
        """Hybrid (Zamba2) paged decode: the shared attention block reads
        and writes the g-layer paged KV pool (g = L // attn_every) while
        every Mamba layer steps the per-slot state bank — one pass, both
        written IN PLACE.

        pages: {"k": (g,P+1,page,KVH,Dh), "v": ...} (with its sink page);
        state: the stacked bank (slot axis second), as
        :meth:`decode_step_ssm`'s; block_tables (S, MP) int32 / lengths
        (S,) int32 index the pool as in :meth:`decode_step_paged` (idle
        slots: the null page and length 0, so their K/V rows go to the
        sink); tokens (S, 1) int; active (S,) int32 gates the bank's
        writeback. Returns logits (S, Vp) f32."""
        assert self.cfg.family == "hybrid", self.cfg.family
        return self._decode_pool(pages, state, block_tables, lengths, tokens,
                                 active)

    @torch.no_grad()
    def prefill_chunk_hybrid(self, pages, state_slot, block_table, tokens,
                             start: int, valid: int):
        """Hybrid chunked prefill of ONE sequence: the shared block's chunk
        rows scatter into the sequence's pages (positions ``start ..
        start + valid - 1``; padded rows go to the sink) and attend its
        cached prefix, IN PLACE, while the Mamba layers continue from the
        slot's carried state.

        pages: the g-layer pool; state_slot: one slot's state, slot axis
        kept singleton, not modified; block_table (MP,) int32; tokens (C,)
        int; start / valid host ints. Returns (new_state_slot, logits (Vp,)
        f32) with logits at chunk position ``max(valid - 1, 0)``, clamped
        as in :meth:`prefill_chunk_ssm`."""
        assert self.cfg.family == "hybrid", self.cfg.family
        return self._prefill_chunk_bank(pages, state_slot, block_table,
                                        tokens, start, valid)


def _views(mod: nn.Module, pick) -> dict:
    """The module's parameters as a nested dict (the JAX tree's layout),
    each leaf ``pick(param)`` (one layer's slice of a stacked parameter,
    or the parameter itself)."""
    out = {k: pick(p) for k, p in mod.named_parameters(recurse=False)}
    for k, child in mod.named_children():
        out[k] = _views(child, pick)
    return out
