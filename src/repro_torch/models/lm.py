"""Decoder-only LM, every decoder family (dense, moe, vlm, ssm, hybrid),
with the serving entry points.

One ``nn.Module`` holding the same stacked ``(L, ...)`` parameters as
``repro/models/lm.py`` (names ``embed``, ``final_norm``, ``layers.ln1``,
``layers.attn.wq`` ... for dense, ``layers.moe.{router, w_gate, w_up,
w_down}`` in place of ``layers.mlp`` for moe, ``vision_proj`` beside the
dense tree for vlm, ``layers.ln``, ``layers.mamba.w_z`` ... for ssm and
hybrid, plus the hybrid's unstacked ``shared.{ln1, attn, ln2, mlp}``
block), on an explicit device. The hybrid (Zamba2) stack is
``L // attn_every`` groups, each the shared attention + MLP block (the
same weights every time, its own KV layer each time) followed by
``attn_every`` Mamba2 layers. The moe family's block is attention then
``models/moe.py``'s ``moe_block``; the vlm family's is the dense one,
after projected vision embeddings (``batch["vision_embeds"]``, the stub
frontend's) are prepended to the token embeddings. The entry points serve
the engines, each a Python loop over the layers:

  * dense, moe, vlm, ssm and hybrid, dense per-sequence cache (the
    lockstep engine, and the whole-prompt admission of the paged engine):
    ``init_cache``, ``prefill`` (a whole padded batch of prompts, vision
    positions first for vlm; attention through the flash kernel, K/V
    padded to ``max_len``; Mamba layers through ``mamba_block``, the scan
    from a zero state) and ``decode_step`` (one token per row, the cache
    written in place);
  * dense, moe and vlm (paged KV pool, written in place):
    ``decode_step_paged`` (one token per in-flight slot), and for dense
    and moe ``prefill_chunk`` (one fixed-size prompt chunk of one
    sequence), ``mixed_step_paged`` (decode rows + one chunk in one pass),
    ``verify_step_paged`` (a speculation bundle of one sequence through
    the chunk path, every row unembedded);
  * ssm (per-slot recurrent state bank): ``decode_step_ssm`` (one token per
    slot, the bank advanced in place) and ``prefill_chunk_ssm`` (one chunk
    of one sequence from its carried state);
  * hybrid (a ``L // attn_every``-layer paged pool beside the state bank):
    ``decode_step_hybrid`` and ``prefill_chunk_hybrid``.

Each returns f32 logits. Vocab is padded to a multiple of 256, as in the
JAX package.

Training (every decoder family): ``loss_fn(params, batch)`` and
``backbone_train(params, x)`` are functions of a parameter TREE (nested
like the JAX one, ``params["layers"]["attn"]["wq"]``, e.g. the train
state's, see ``train/step.py``), not of the module's own parameters, and
run under autograd: attention and the SSD scan go through ``kernels.ops``
(on the card the flash and scan kernels' forwards, each inside a
``torch.autograd.Function``), the loss is :func:`chunked_cross_entropy`
(plus 0.01 times the summed router aux loss for moe; the vision positions
sliced off for vlm), and ``cfg.remat_policy`` maps onto
``torch.utils.checkpoint`` (:func:`scan_layers`; the hybrid stack's unit
is one group, the shared block and its ``attn_every`` Mamba layers, as in
the JAX package).

:class:`LMBase` holds what this model and the encoder-decoder
(``models/encdec.py``) share: the parameters declared by
``param_specs()``, seeded init, loading, per-layer views and the f32
unembedding.
"""

from __future__ import annotations

import zlib
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamSpec, flatten_tree, resolve_device,
                                       rms_norm, swiglu, tree_map)
from repro_torch.parallel.collectives import all_gather_logits

VOCAB_PAD_MULTIPLE = 256
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")


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


def chunked_cross_entropy(
    x: torch.Tensor,        # (B, S, D) final hidden states
    w_out: torch.Tensor,    # (D, Vp)
    targets: torch.Tensor,  # (B, S) int
    real_vocab: int,
    chunk: int = 1024,
) -> torch.Tensor:
    """Mean next-token CE without keeping (B, S, Vp) logits for backward.

    Walks sequence chunks; each chunk runs under ``torch.utils.checkpoint``
    (the JAX package's ``jax.checkpoint``), so backward recomputes its
    logits instead of saving them. The logits are f32 products of the
    operands' values (bf16 operands into f32 logits, as the JAX einsum's
    ``preferred_element_type=f32``); padded-vocab columns are set to -1e30.
    """
    b, s, d = x.shape
    vp = w_out.shape[-1]
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    vocab_mask = (torch.arange(vp, device=x.device) < real_vocab
                  if real_vocab != vp else None)

    def one(x_chunk, t_chunk):
        logits = x_chunk.float() @ w_out.float()
        if vocab_mask is not None:
            logits = torch.where(vocab_mask, logits,
                                 torch.full_like(logits, -1e30))
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, t_chunk.long()[..., None])[..., 0]
        return (lse - tgt).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s, chunk):
        total = total + checkpoint(one, x[:, c:c + chunk],
                                   targets[:, c:c + chunk],
                                   use_reentrant=False)
    return total / (b * s)


def _remat(fn, policy: str):
    """``fn`` under ``cfg.remat_policy``. ``"none"``: as it is. Every
    policy that saves less than everything runs ``fn`` under
    ``torch.utils.checkpoint`` (its inputs saved, the rest recomputed in
    backward): ``"nothing"`` (the JAX default) and ``"full"`` exactly so;
    ``"dots"`` and ``"names"``, which in JAX also keep the matmul outputs
    or the tagged block outputs, recompute those too, since the port has
    no selective policy: more compute, less memory, the same values. The
    loss and gradients do not depend on the policy."""
    if policy == "none":
        return fn
    if policy in ("nothing", "full", "dots", "names"):
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    raise ValueError(f"unknown remat policy {policy!r}")


def scan_layers(body, x: torch.Tensor, layers: list, policy: str):
    """Run ``x = body(x, layer)`` over the layer stack under ``policy``.

    ``"groupG"`` (e.g. ``"group8"``, ``"group8names"``): sqrt-L
    checkpointing as in the JAX package: blocks of G layers (G lowered to a
    divisor of L), each block checkpointed as a unit so only the block
    inputs are kept, and each layer inside checkpointed as well so the
    block's backward holds one layer's internals at a time. Any other
    policy: each layer through :func:`_remat`."""
    if policy.startswith("group"):
        spec = policy[len("group"):]
        inner_policy = "names" if spec.endswith("names") else "nothing"
        spec = spec.removesuffix("names")
        g = int(spec or 8)
        n_layers = len(layers)
        if n_layers % g != 0:
            g = next(d for d in range(g, 0, -1) if n_layers % d == 0)
        inner = _remat(body, inner_policy)

        def group_body(x, group):
            for pl in group:
                x = inner(x, pl)
            return x

        outer = _remat(group_body, "nothing")
        for i in range(0, n_layers, g):
            x = outer(x, layers[i:i + g])
        return x
    step = _remat(body, policy)
    for pl in layers:
        x = step(x, pl)
    return x


def unstack(tree: dict, n: int) -> list[dict]:
    """A tree of stacked ``(n, ...)`` leaves as n trees of one slice each:
    one unbind a leaf, whose backward stacks the n gradients in one op."""
    per_layer = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t, l=l: t[l], per_layer) for l in range(n)]


def _zeros(struct, device) -> dict:
    """A tree of (shape, dtype) leaves as zero tensors on ``device``."""
    if isinstance(struct, dict):
        return {k: _zeros(v, device) for k, v in struct.items()}
    shape, dt = struct
    return torch.zeros(shape, dtype=dt, device=device)


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


class LMBase(nn.Module):
    """A model whose parameters ``param_specs()`` declares, registered on
    an explicit device (frozen: training works on a parameter tree, see
    ``train/step.py``), with seeded init, loading, per-layer views of the
    stacked parameters, and the f32 unembedding of the final states
    through ``unembed`` (or the tied ``embed`` where there is none)."""

    def __init__(self, cfg: ModelConfig, device, attn_impl: str,
                 ssd_impl: str):
        super().__init__()
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.ssd_impl = ssd_impl
        self.device = resolve_device(device)
        _register(self, self.param_specs(), cfg.dtype, self.device)
        self._view_cache: dict = {}
        self._unembed_cache: tuple | None = None

    def param_specs(self) -> dict:
        raise NotImplementedError

    def abstract(self) -> dict:
        """The parameter tree as ``meta`` tensors of its shapes and dtypes
        (no allocation; the JAX model's ``ShapeDtypeStruct`` tree)."""
        return tree_map(lambda s: torch.empty(
            s.shape, dtype=getattr(torch, s.dtype or self.cfg.dtype),
            device="meta"), self.param_specs())

    def axes(self) -> dict:
        """The parameter tree's logical axes, leaf for leaf."""
        return tree_map(lambda s: s.axes, self.param_specs())

    def cache_struct(self, batch: int, max_len: int) -> dict:
        raise NotImplementedError

    def init_cache(self, batch: int, max_len: int) -> dict:
        """The dense cache of :meth:`cache_struct`, zeros on the model's
        device."""
        return _zeros(self.cache_struct(batch, max_len), self.device)

    def abstract_cache(self, batch: int, max_len: int) -> dict:
        """The dense cache as ``meta`` tensors (no allocation)."""
        return _zeros(self.cache_struct(batch, max_len), "meta")

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
            # scaled in place: one f32 temporary of the leaf, not two (a
            # 48-layer internvl2-26b's MLP leaf is 19 GB in f32)
            p.copy_(torch.randn(spec.shape, generator=gen, device=self.device,
                                dtype=torch.float32).mul_(scale))
        return self.state_dict()

    def load_params(self, params: dict) -> None:
        """Load a state dict: each tensor, moved to the model's device in
        its parameter's dtype, becomes the parameter (``assign``). A tensor
        already there in that dtype is not copied: engines built from one
        state dict (fleet workers, a draft model on its target's weights)
        share the weights, which serving only reads."""
        own = self.state_dict()
        if all(tuple(v.shape) == tuple(own[k].shape)
               for k, v in params.items() if k in own):
            self.load_state_dict({k: v.to(self.device, own[k].dtype)
                                  for k, v in params.items()}, assign=True)
        else:
            self._load_shards(params, own)
        self._view_cache = {}
        self._unembed_cache = None

    def _load_shards(self, params: dict, own: dict) -> None:
        """Load a tensor-parallel rank's state dict: a leaf may be a slice of
        its declared shape (each dim equal or an exact divisor of it, the
        serving executor's ``Sharding.shard``), and becomes the parameter
        at its own shape. The forward passes read head, ff and vocab counts
        off the weights' shapes."""
        missing, extra = set(own) - set(params), set(params) - set(own)
        if missing or extra:
            raise KeyError(f"state dict: missing {sorted(missing)}, "
                           f"unexpected {sorted(extra)}")
        for k, v in params.items():
            full = tuple(own[k].shape)
            if v.dim() != len(full) or any(
                    f % d for d, f in zip(v.shape, full)):
                raise ValueError(f"{k}: shape {tuple(v.shape)} is no shard "
                                 f"of {full}")
            mod_name, _, leaf = k.rpartition(".")
            mod = self.get_submodule(mod_name) if mod_name else self
            mod._parameters[leaf] = nn.Parameter(
                v.to(self.device, own[k].dtype), requires_grad=False)

    def _per_layer(self, name: str) -> list[dict]:
        """Per-layer views of the stacked parameters under ``name``, nested
        like the JAX tree (kept until the next :meth:`load_params`)."""
        views = self._view_cache.get(name)
        if views is None:
            mod = self.get_submodule(name)
            views = self._view_cache[name] = [
                _views(mod, lambda p, l=l: p[l])
                for l in range(self.cfg.num_layers)]
        return views

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        """(N, S, D) -> (N, S, Vp) f32 logits. The product runs in f32 on
        the weight's values (bf16 operands into f32 logits, like the JAX
        unembed's ``preferred_element_type=f32``): a bf16 matmul would round
        the logits. The f32 copy of a bf16 weight is made once and kept
        until the weight changes.

        Every entry point unembeds here (the JAX package's ten unembedding
        sites, ``all_gather_logits`` at each): under a serving executor's
        ``tensor_parallel`` context with an untied, vocab-sharded
        ``unembed`` the rank's column slice of the logits is gathered into
        the full padded vocab; otherwise the gather is the identity."""
        return all_gather_logits(x.float() @ self.unembed_f32())

    def unembed_f32(self) -> torch.Tensor:
        """The (D, Vp) f32 copy of the unembedding that :meth:`_unembed`
        multiplies by, made on first use and kept beside the weights (the
        dry run counts it as resident state)."""
        tied = not hasattr(self, "unembed")
        w = self.embed if tied else self.unembed
        key = (w.data_ptr(), w._version)
        if self._unembed_cache is None or self._unembed_cache[0] != key:
            wf = w.detach().float()
            self._unembed_cache = (key, wf.t() if tied else wf)
        return self._unembed_cache[1]

    def _as_scalar(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.int32, device=self.device)

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


class DecoderLM(LMBase):
    """Dense, moe, vlm, ssm or hybrid decoder-only LM; the port's
    counterpart of ``repro``'s ``DecoderLM`` for the dense-cache, paged and
    recurrent-state serving paths, and for training."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 attn_impl: str = "auto", ssd_impl: str = "auto"):
        assert not cfg.is_encoder_decoder
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown decoder family {cfg.family!r}")
        super().__init__(cfg, device, attn_impl, ssd_impl)

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
        if cfg.family == "vlm":
            specs["vision_proj"] = ParamSpec((D, D), ("embed", None))
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
        }
        if cfg.family == "moe":
            specs["layers"]["moe"] = moe_mod.moe_param_specs(cfg, stacked=L)
        else:
            specs["layers"]["mlp"] = mlp_param_specs(cfg, stacked=L)
        return specs

    def _own_params(self) -> dict:
        """The module's embedding parameters as :meth:`embed_inputs` takes
        them."""
        own = {"embed": self.embed}
        if self.cfg.family == "vlm":
            own["vision_proj"] = self.vision_proj
        return own

    def _layers(self) -> list[dict]:
        """Per-layer views of the stacked parameters, nested like the JAX
        tree (``{"ln1", "attn": {...}, "ln2", "mlp": {...}}``, ``"moe"``
        in place of ``"mlp"`` for moe, or ``{"ln", "mamba": {...}}`` for
        ssm and hybrid)."""
        return self._per_layer("layers")

    def _stack(self):
        """The layer stack in order, one ``(kind, i, params)`` per block:
        ``("attn", KV layer i, attention + MLP/MoE block)`` or ``("mamba",
        layer i, Mamba layer)``. dense, moe, vlm: attention layer l; ssm:
        Mamba layer l; hybrid: for each of the ``L // attn_every`` groups g, the shared
        block (``{"ln1", "attn", "ln2", "mlp"}``, the same weights every
        time) on KV layer g, then Mamba layers ``g * attn_every`` onward."""
        cfg, layers = self.cfg, self._layers()
        if cfg.family != "hybrid":
            kind = "mamba" if cfg.family == "ssm" else "attn"
            yield from ((kind, l, pl) for l, pl in enumerate(layers))
            return
        shared = self._view_cache.get("shared")
        if shared is None:
            shared = self._view_cache["shared"] = _views(self.shared,
                                                         lambda p: p)
        every = cfg.attn_every
        for g in range(cfg.num_layers // every):
            yield "attn", g, shared
            for l in range(g * every, (g + 1) * every):
                yield "mamba", l, layers[l]

    def _block(self, pl: dict, x: torch.Tensor, attend) -> torch.Tensor:
        return self._block_aux(pl, x, attend)[0]

    def _block_aux(self, pl: dict, x: torch.Tensor, attend):
        """One attention block: ``(x + attention + MLP or MoE, the MoE's
        aux loss or None)``."""
        cfg = self.cfg
        x = x + attend(pl["attn"], rms_norm(x, pl["ln1"], cfg.norm_eps))
        h = rms_norm(x, pl["ln2"], cfg.norm_eps)
        if "moe" in pl:
            h, aux = moe_mod.moe_block(pl["moe"], h, cfg)
            return x + h, aux
        mlp = pl["mlp"]
        return x + swiglu(h, mlp["w_gate"], mlp["w_up"], mlp["w_down"]), None

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

    # ------------------------------------------------------------------
    # training, on a parameter tree
    # ------------------------------------------------------------------
    def embed_inputs(self, params: dict, batch: dict) -> torch.Tensor:
        """(B, S) tokens -> (B, S, D) embeddings; vlm: the vision
        embeddings (B, F, D), cast to the parameters' dtype and projected
        by ``vision_proj``, prepended -> (B, F + S, D)."""
        x = F.embedding(batch["tokens"].long(), params["embed"])
        if self.cfg.family == "vlm":
            vis = batch["vision_embeds"].to(x.dtype)
            vis = torch.einsum("bfd,de->bfe", vis, params["vision_proj"])
            x = torch.cat([vis, x], dim=1)
        return x

    def backbone_train(self, params: dict, x: torch.Tensor):
        """x (B, S, D) embedded tokens -> (hidden states (B, S, D), aux
        loss f32 scalar) through the stack of ``params["layers"]``, each
        layer's parameters that layer's slice of the stacked leaves, under
        ``cfg.remat_policy``: dense and vlm, attention + MLP blocks; moe,
        attention + MoE blocks (the aux loss summed over the layers); ssm,
        ``x + mamba_block(rms_norm(x))`` a layer; hybrid, ``L //
        attn_every`` groups, each the shared block (``params["shared"]``,
        the same weights every time) then ``attn_every`` Mamba layers, a
        group the remat unit (a ``group*`` policy is ``"nothing"`` there,
        as in the JAX package)."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)
        layers = unstack(params["layers"], cfg.num_layers)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def attend(p, h):
            return attn.self_attention(p, h, cfg, positions=positions,
                                       attn_impl=self.attn_impl)

        def block(carry, pl):
            x, aux = carry
            x, a = self._block_aux(pl, x, attend)
            return x, aux if a is None else aux + a

        def mamba(x, pl):
            return self._mamba(pl, x, lambda p, h: (ssm_mod.mamba_block(
                p, h, cfg, ssd_impl=self.ssd_impl), None))[0]

        if cfg.family == "ssm":
            return scan_layers(mamba, x, layers, cfg.remat_policy), aux
        if cfg.family != "hybrid":
            return scan_layers(block, (x, aux), layers, cfg.remat_policy)

        def group(x, group_layers):
            x = self._block(params["shared"], x, attend)
            for pl in group_layers:
                x = mamba(x, pl)
            return x

        policy = cfg.remat_policy
        step = _remat(group, "nothing" if policy.startswith("group")
                      else policy)
        every = cfg.attn_every
        for g in range(cfg.num_layers // every):
            x = step(x, layers[g * every:(g + 1) * every])
        return x, aux

    def loss_fn(self, params: dict, batch: dict):
        """Training forward + chunked CE: ``(loss, {"ce", "aux"})``, f32
        scalars; the loss is ``ce + 0.01 * aux`` for moe, ``ce`` otherwise.
        batch: ``{"tokens", "targets"}`` (B, S) int on the parameters'
        device, and for vlm ``"vision_embeds"`` (B, F, D), whose F
        positions are dropped before the loss."""
        cfg = self.cfg
        x = self.embed_inputs(params, batch)
        x, aux = self.backbone_train(params, x)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if cfg.family == "vlm":
            x = x[:, batch["vision_embeds"].shape[1]:]
        w_out = (params["embed"].t() if cfg.tie_embeddings
                 else params["unembed"])
        ce = chunked_cross_entropy(x, w_out, batch["targets"],
                                   cfg.vocab_size)
        loss = ce + 0.01 * aux if cfg.family == "moe" else ce
        return loss, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------------
    # dense cache (lockstep engine, whole-prompt prefill)
    # ------------------------------------------------------------------
    def cache_struct(self, batch: int, max_len: int) -> dict:
        """Shapes and dtypes of the dense cache, ``pos`` an int32 scalar
        (positions written so far, shared by every row) in each:

        * dense, moe, vlm: k/v (L, B, max_len, KVH, Dh) in the model's
          dtype;
        * ssm: ``mamba``, the ``init_mamba_cache`` tree stacked over L
          (f32 SSD state (L, B, H, P, N), conv tails in the model's dtype);
        * hybrid: ``mamba`` as ssm, plus ``shared_k``/``shared_v`` (g, B,
          max_len, KVH, Dh), one layer per attention occurrence.

        The head counts (KVH, H) and ``d_inner`` are the weights': a
        tensor-parallel rank's slices give its share of the cache."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        pos = ((), torch.int32)
        if cfg.family in ("dense", "moe", "vlm"):
            kvh = self.layers.attn.wk.shape[-2]
            kv = ((cfg.num_layers, batch, max_len, kvh, cfg.head_dim), dt)
            return {"k": kv, "v": kv, "pos": pos}
        mc = ssm_mod.init_mamba_cache(cfg, batch, dt, device="meta")
        mamba = self.layers.mamba
        local = {"ssm": (batch, mamba.a_log.shape[-1], cfg.ssm_head_dim,
                         cfg.ssm_state),
                 "conv_x": (batch, cfg.conv_width - 1,
                            mamba.conv_x.shape[-1])}
        struct = {"mamba": {
            k: ((cfg.num_layers,) + local.get(k, tuple(v.shape)), v.dtype)
            for k, v in mc.items()}}
        if cfg.family == "hybrid":
            kv = ((cfg.num_layers // cfg.attn_every, batch, max_len,
                   self.shared.attn.wk.shape[-2], cfg.head_dim), dt)
            struct.update(shared_k=kv, shared_v=kv)
        struct["pos"] = pos
        return struct

    def cache_axes(self) -> dict:
        """The dense cache's logical axes, leaf for leaf (the JAX
        model's)."""
        kv = ("stack", "cache_batch", "cache_seq", "kv_heads", "head_dim")
        if self.cfg.family in ("dense", "moe", "vlm"):
            return {"k": kv, "v": kv, "pos": None}
        mam = {k: ("stack",) + tuple(v)
               for k, v in ssm_mod.MAMBA_CACHE_AXES.items()}
        if self.cfg.family == "ssm":
            return {"mamba": mam, "pos": None}
        return {"mamba": mam, "shared_k": kv, "shared_v": kv, "pos": None}

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
        through the Mamba recurrence, as in the JAX package); vlm also
        ``"vision_embeds"`` (B, F, D), projected and prepended, so the
        sequence is F + S long and S below counts it. The cache is
        :meth:`init_cache`'s: K/V written at ``[:S]`` and zero past it (S
        <= max_len), the Mamba layers' state and conv tails after position
        S, ``pos`` = S. Returns logits (B, Vp) f32 of position
        ``logits_index`` (an int or an int scalar tensor; negative wraps
        and out-of-range clamps, like the JAX ``dynamic_slice``), or of the
        last position when None.
        """
        cfg = self.cfg
        x = self.embed_inputs(self._own_params(), batch)  # (B,S,D)
        b, s = x.shape[:2]
        if s > max_len:
            raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
        cache = self.init_cache(b, max_len)
        positions = torch.arange(s, device=self.device)

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
        valid = self._as_scalar(valid)
        x = self._chunk_stack(pages, block_table, tokens, start, valid)
        # negative index wraps like JAX's dynamic slice: valid 0 -> row C-1
        row = torch.remainder(valid - 1, x.shape[1])
        x = x.index_select(1, row.reshape(1).long())
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._unembed(x)[0, 0]

    def _chunk_stack(self, pages, block_table, tokens, start, valid):
        """C chunk rows of one sequence through every layer: each layer
        scatters the rows' K/V into the sequence's pages (in place; rows
        past ``valid`` into the sink) and attends them over the cached
        prefix, causal. Returns the last hidden states (1, C, D)."""
        cfg = self.cfg
        start, valid = self._as_scalar(start), self._as_scalar(valid)
        x = self.embed[tokens.long()][None]  # (1,C,D)
        for l, pl in enumerate(self._layers()):
            cl = {key: arr[l] for key, arr in pages.items()}
            x = self._block(pl, x, lambda p, h: attn.prefill_chunk_attention_paged(
                p, h, cl, block_table, start, valid, cfg,
                attn_impl=self.attn_impl))
        return x

    # ------------------------------------------------------------------
    # speculative verify (continuous batching)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def verify_step_paged(self, pages, block_table, tokens, start, valid):
        """Score a speculation bundle: C chunk rows of ONE sequence (the
        last committed token, then k drafted tokens, padded to the bundle
        width) scattered into its pages and attended exactly as a prefill
        chunk (the chunk kernel on the card), with every row unembedded.

        block_table (MP,) int32; tokens (C,) int ``[t_last, d_1 .. d_k]``;
        start (int32 scalar) is the cached length L (t_last's K/V lands at
        L, draft i at L + i); valid (int32 scalar) is 1 + k (rows past it
        write into the sink and return garbage the caller ignores).
        Returns logits (C, Vp) f32: row i scores token index ``idx0 + i``
        given the history plus drafts ``d_1 .. d_i``, as a sequential
        decode loop would."""
        x = self._chunk_stack(pages, block_table, tokens, start, valid)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._unembed(x)[0]

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
