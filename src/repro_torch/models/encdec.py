"""Encoder-decoder LM (the Whisper backbone), trained and served by the
lockstep engine.

The port of ``repro/models/encdec.py``, with its stated deviations from
Whisper: sinusoidal (not learned) positions on both stacks, so the
parameters do not depend on the sequence length; RMSNorm for LayerNorm +
bias, as in the rest of the zoo; and the conv front end stubbed: a batch
carries precomputed ``frames`` (B, Senc, d_model) for the encoder.

One ``nn.Module`` (:class:`repro_torch.models.lm.LMBase`) holding the JAX
tree's parameters: ``embed``, ``unembed`` (untied), ``enc_norm``,
``final_norm``, ``encoder.{ln1, attn, ln2, mlp}`` and ``decoder.{ln1,
attn, ln_x, xattn, ln2, mlp}``, each stacked ``(L, ...)``.

* Training: ``loss_fn(params, batch)`` on a parameter tree (the train
  state's), under autograd; every attention goes through
  ``ops.flash_attention`` (on the card the kernel's forward inside its
  autograd Function): the encoder's self-attention and the decoder's cross
  attention not causal, the decoder's self-attention causal. The stacks run
  without recompute, as the JAX module scans them.
* Serving (the lockstep engine): ``init_cache``, ``prefill(batch,
  max_len)`` (encode the frames, run the decoder over the prompt through
  the flash kernel, write its self K/V and the cross K/V into the cache,
  zero past them) and ``decode_step(cache, tokens)`` (one token a row: self
  K/V written at ``pos`` in place, cross attention over the cached encoder
  K/V masked past ``enc_len``, both by ``decode_attention_raw``). Each
  returns f32 logits of the padded vocabulary.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import ParamSpec, rms_norm, swiglu
from repro_torch.models.lm import (LMBase, chunked_cross_entropy,
                                   mlp_param_specs, padded_vocab, unstack)


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S,) int positions -> (S, d) f32: sines then cosines of
    ``positions * 10000^(-i / (d / 2))``."""
    half = d // 2
    log_base = torch.log(torch.tensor(10000.0, device=positions.device))
    freqs = torch.exp(-log_base * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecLM(LMBase):
    """The port's counterpart of ``repro``'s ``EncDecLM``, on an explicit
    device (``"cuda"`` unless the caller asks for ``"cpu"``)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 attn_impl: str = "auto", ssd_impl: str = "auto"):
        assert cfg.is_encoder_decoder
        super().__init__(cfg, device, attn_impl, ssd_impl)

    def param_specs(self) -> dict:
        cfg = self.cfg
        L, D = cfg.num_layers, cfg.d_model
        vp = padded_vocab(cfg)

        def norm():
            return ParamSpec((L, D), ("stack", None), init="ones")

        enc_layer = {"ln1": norm(), "attn": attn.attn_param_specs(cfg, stacked=L),
                     "ln2": norm(), "mlp": mlp_param_specs(cfg, stacked=L)}
        dec_layer = {"ln1": norm(), "attn": attn.attn_param_specs(cfg, stacked=L),
                     "ln_x": norm(),
                     "xattn": attn.attn_param_specs(cfg, stacked=L),
                     "ln2": norm(), "mlp": mlp_param_specs(cfg, stacked=L)}
        return {
            "embed": ParamSpec((vp, D), ("vocab", None), init="embed", scale=0.02),
            "unembed": ParamSpec((D, vp), (None, "vocab")),
            "enc_norm": ParamSpec((D,), (None,), init="ones"),
            "final_norm": ParamSpec((D,), (None,), init="ones"),
            "encoder": enc_layer,
            "decoder": dec_layer,
        }

    # ------------------------------------------------------------------
    # the stacks, on a parameter tree (per-layer lists of slices)
    # ------------------------------------------------------------------
    def _mlp(self, pl: dict, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, pl["ln2"], self.cfg.norm_eps)
        m = pl["mlp"]
        return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"])

    def _encode(self, layers: list[dict], enc_norm: torch.Tensor,
                frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        pos = sinusoidal(torch.arange(frames.shape[1], device=frames.device),
                         cfg.d_model)
        x = frames.to(dt) + pos[None].to(dt)
        for pl in layers:
            h = rms_norm(x, pl["ln1"], cfg.norm_eps)
            x = x + attn.self_attention(pl["attn"], h, cfg, causal=False,
                                        rope=False, attn_impl=self.attn_impl)
            x = self._mlp(pl, x)
        return rms_norm(x, enc_norm, cfg.norm_eps)

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, Senc, D) precomputed embeddings -> encoder states
        (B, Senc, D), normed."""
        return self._encode(unstack(params["encoder"], self.cfg.num_layers),
                            params["enc_norm"], frames)

    def _decode_stack_train(self, params: dict, x: torch.Tensor,
                            enc: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        for pl in unstack(params["decoder"], cfg.num_layers):
            h = rms_norm(x, pl["ln1"], cfg.norm_eps)
            x = x + attn.self_attention(pl["attn"], h, cfg, causal=True,
                                        rope=False, attn_impl=self.attn_impl)
            h = rms_norm(x, pl["ln_x"], cfg.norm_eps)
            kv = attn.cross_attention_kv(pl["xattn"], enc)
            x = x + attn.cross_attention(pl["xattn"], h, kv, cfg,
                                         attn_impl=self.attn_impl)
            x = self._mlp(pl, x)
        return x

    def _embed_tokens(self, embed: torch.Tensor,
                      tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens.long(), embed)
        pos = sinusoidal(torch.arange(tokens.shape[1], device=x.device),
                         self.cfg.d_model)
        return x + pos[None].to(x.dtype)

    def loss_fn(self, params: dict, batch: dict):
        """Training forward + chunked CE: ``(loss, {"ce", "aux"})``, f32
        scalars (``aux`` zero). batch: ``{"tokens", "targets"}`` (B, S) int
        and ``frames`` (B, Senc, D), on the parameters' device."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"])
        x = self._embed_tokens(params["embed"], batch["tokens"])
        x = self._decode_stack_train(params, x, enc)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        ce = chunked_cross_entropy(x, params["unembed"], batch["targets"],
                                   cfg.vocab_size)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=ce.device)}

    # ------------------------------------------------------------------
    # serving: decoder self K/V + the encoder's cross K/V
    # ------------------------------------------------------------------
    def cache_struct(self, batch: int, max_len: int) -> dict:
        """Shapes and dtypes of the cache: self K/V ``k``/``v`` and cross
        K/V ``xk``/``xv`` (L, B, max_len, KVH, Dh) in the model's dtype;
        ``pos`` (positions written) and ``enc_len`` (the encoder's true,
        unpadded length) int32 scalars."""
        cfg = self.cfg
        kv = ((cfg.num_layers, batch, max_len, cfg.num_kv_heads,
               cfg.head_dim), getattr(torch, cfg.dtype))
        scalar = ((), torch.int32)
        return {"k": kv, "v": kv, "xk": kv, "xv": kv, "pos": scalar,
                "enc_len": scalar}

    def cache_axes(self) -> dict:
        """The cache's logical axes, leaf for leaf (the JAX model's)."""
        kv = ("stack", "cache_batch", "cache_seq", "kv_heads", "head_dim")
        return {"k": kv, "v": kv, "xk": kv, "xv": kv, "pos": None,
                "enc_len": None}

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        """Encode ``batch["frames"]`` (B, Senc, D) and run the decoder over
        ``batch["tokens"]`` (B, S) (positions ``0..S-1``, the lockstep
        engine's left padding attended as in the JAX package). Returns
        (cache, logits (B, Vp) f32 of the last position): self K/V at
        ``[:S]`` and cross K/V at ``[:Senc]``, zero past them (S, Senc <=
        max_len), ``pos`` = S, ``enc_len`` = Senc."""
        cfg = self.cfg
        tokens, frames = batch["tokens"], batch["frames"]
        b, s = tokens.shape
        senc = frames.shape[1]
        if max(s, senc) > max_len:
            raise ValueError(f"prompt length {s} or encoder length {senc} "
                             f"exceeds max_len {max_len}")
        cache = self.init_cache(b, max_len)
        enc = self._encode(self._per_layer("encoder"), self.enc_norm, frames)
        x = self._embed_tokens(self.embed, tokens)
        for l, pl in enumerate(self._per_layer("decoder")):
            h = rms_norm(x, pl["ln1"], cfg.norm_eps)
            h, (k, v) = attn.self_attention_with_cache_write(
                pl["attn"], h, cfg, attn_impl=self.attn_impl, rope=False)
            cache["k"][l, :, :s] = k
            cache["v"][l, :, :s] = v
            x = x + h
            h = rms_norm(x, pl["ln_x"], cfg.norm_eps)
            xk, xv = attn.cross_attention_kv(pl["xattn"], enc)
            cache["xk"][l, :, :senc] = xk
            cache["xv"][l, :, :senc] = xv
            x = x + attn.cross_attention(pl["xattn"], h, (xk, xv), cfg,
                                         attn_impl=self.attn_impl)
            x = self._mlp(pl, x)
        cache["pos"].fill_(s)
        cache["enc_len"].fill_(senc)
        return cache, self._logits_at(x, None)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens):
        """tokens (B, 1) -> (cache, logits (B, Vp) f32): the token at
        position ``cache["pos"]`` (its sinusoidal position), its self K/V
        written there IN PLACE (clamped into the cache) and attending
        positions ``<= pos``, its cross attention over the cached encoder
        K/V masked past ``enc_len``; ``pos`` then advances by one."""
        cfg = self.cfg
        pos = cache["pos"]
        x = self.embed[tokens.long()]  # (B,1,D)
        x = x + sinusoidal(pos.reshape(1), cfg.d_model)[None].to(x.dtype)
        for l, pl in enumerate(self._per_layer("decoder")):
            h = rms_norm(x, pl["ln1"], cfg.norm_eps)
            x = x + attn.decode_self_attention(
                pl["attn"], h, {"k": cache["k"][l], "v": cache["v"][l]}, pos,
                cfg, rope=False)[0]
            h = rms_norm(x, pl["ln_x"], cfg.norm_eps)
            x = x + attn.decode_cross_attention(
                pl["xattn"], h, (cache["xk"][l], cache["xv"][l]), cfg,
                enc_len=cache["enc_len"])
            x = self._mlp(pl, x)
        pos.add_(1)
        return cache, self._logits_at(x, None)
