"""Mixture-of-Experts block: top-k routing, per-example capacity dispatch.

The port of ``repro/models/moe.py`` at tensor-parallel degree 1 (its
``psum_tp`` and sharding constraints are identities there). Every expert's
SwiGLU runs as a batched matmul over the expert axis (cuBLAS on the card);
no hand-written kernel is involved, as none is in the JAX package.

* ``route``: the router product in x's dtype, then softmax, top-k and the
  renormalised gates in f32; the top-k breaks ties toward the lower
  expert index, as ``jax.lax.top_k`` does (a stable descending sort), and
  the Switch load-balancing loss counts each token's first choice.
* ``_moe_block_chunk``, S == 1 (every decode row, and every row of the
  fused mixed step, which passes its rows as (R, 1, D)): each row through
  ALL experts, combined by one-hot gates; no token is dropped.
* S > 1 (prefill, prefill chunks, verify bundles, training): tokens are
  dispatched per example into (E, capacity) buffers in token order; an
  assignment past its expert's capacity is dropped, as the JAX
  ``.at[].add(mode="drop")`` drops it: here it lands in a sink row past
  the capacity that is sliced off. Padded rows take capacity slots like
  real ones, as in the reference.
* ``moe_block`` splits sequences longer than ``MOE_SEQ_CHUNK`` into chunks
  and averages their aux losses.

Everything is out of place, so the block runs under autograd.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec
from repro_torch.parallel.collectives import psum_tp


def moe_param_specs(cfg: ModelConfig, stacked: int | None = None) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    pre = (stacked,) if stacked else ()
    pax = ("stack",) if stacked else ()
    return {
        "router": ParamSpec(pre + (d, e), pax + ("embed", None)),
        "w_gate": ParamSpec(pre + (e, d, f), pax + ("experts", "embed", "ff")),
        "w_up": ParamSpec(pre + (e, d, f), pax + ("experts", "embed", "ff")),
        "w_down": ParamSpec(pre + (e, f, d), pax + ("experts", "ff", "embed")),
    }


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    c = math.ceil(seq_len * cfg.experts_per_token * cfg.capacity_factor
                  / cfg.num_experts)
    return max(cfg.experts_per_token, min(c, seq_len))


def route(p, x: torch.Tensor, cfg: ModelConfig):
    """Router logits -> (gates (B,S,k) f32, idx (B,S,k) int64, aux f32)."""
    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, idx = srt[..., :k], order[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load balancing loss
    e = cfg.num_experts
    frac_tokens = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * (frac_tokens * frac_probs).sum()
    return gates, idx, aux


def _expert_ffn(p, x_exp: torch.Tensor) -> torch.Tensor:
    """x_exp (B, E, C, D) -> (B, E, C, D); SwiGLU per expert, the SiLU in
    f32."""
    g = torch.einsum("becd,edf->becf", x_exp, p["w_gate"])
    u = torch.einsum("becd,edf->becf", x_exp, p["w_up"])
    h = F.silu(g.float()).to(x_exp.dtype) * u
    return psum_tp(torch.einsum("becf,efd->becd", h, p["w_down"]))


MOE_SEQ_CHUNK = 4096  # dispatch-buffer bound: B x k x chunk x cf x D


def moe_block(p, x: torch.Tensor, cfg: ModelConfig):
    """x (B,S,D) -> (y, aux_loss). Sequences longer than MOE_SEQ_CHUNK are
    dispatched chunk by chunk (S a multiple of it); aux is their mean."""
    b, s, d = x.shape
    if s > MOE_SEQ_CHUNK:
        assert s % MOE_SEQ_CHUNK == 0, (s, MOE_SEQ_CHUNK)
        ys, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, s, MOE_SEQ_CHUNK):
            y_chunk, a = _moe_block_chunk(p, x[:, c:c + MOE_SEQ_CHUNK], cfg)
            ys.append(y_chunk)
            aux = aux + a
        return torch.cat(ys, dim=1), aux / (s // MOE_SEQ_CHUNK)
    return _moe_block_chunk(p, x, cfg)


def _moe_block_chunk(p, x: torch.Tensor, cfg: ModelConfig):
    b, s, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    gates, idx, aux = route(p, x, cfg)

    if s == 1:
        # decode: every row through every expert, dense one-hot combine
        onehot = (F.one_hot(idx, e).float() * gates[..., None]).sum(2)
        ye = _expert_ffn(p, x[:, None].expand(b, e, 1, d))  # (B,E,1,D)
        y = torch.einsum("beqd,bqe->bqd", ye.float(), onehot)
        return y.to(x.dtype), aux

    cap = capacity(cfg, s)
    # position of each (s, k) assignment within its expert's buffer, in
    # token order per example
    flat = F.one_hot(idx, e).reshape(b, s * k, e)
    pos = ((flat.cumsum(1) - 1) * flat).sum(-1).reshape(b, s, k)
    keep = pos < cap

    # dispatch: (B, E, cap + 1, D) with a sink row per expert for the drops
    slot = (idx * (cap + 1) + torch.where(keep, pos, cap)).reshape(b, s * k)
    xs = x.repeat_interleave(k, dim=1)  # (B, S*k, D), each token k times
    buf = x.new_zeros((b, e * (cap + 1), d))
    buf = buf.scatter_add(1, slot[..., None].expand(b, s * k, d), xs)
    x_exp = buf.view(b, e, cap + 1, d)[:, :, :cap]

    y_exp = _expert_ffn(p, x_exp).reshape(b, e * cap, d)

    # combine: gather back (dropped assignments read row 0, weight 0)
    src = (idx * cap + torch.where(keep, pos, 0)).reshape(b, s * k)
    got = y_exp.gather(1, src[..., None].expand(b, s * k, d))
    w = (gates * keep).float()[..., None]
    y = (got.reshape(b, s, k, d).float() * w).sum(2)
    return y.to(x.dtype), aux
