"""Mamba2 (SSD) block for serving: in_proj -> causal depthwise conv -> SSD
scan -> gated norm -> out_proj, one decode token or one prefill chunk at a
time against a carried cache, or a whole sequence from a zero state.

The port of ``repro/models/ssm.py`` at tensor-parallel degree 1 (its
``psum_tp``/``pmean_tp`` are identities there). The depthwise conv stays
split into x / B / C streams as in the JAX package. ``mamba_block`` is the
whole-sequence forward (the lockstep engine's prefill; training the ssm and
hybrid families, with the SSD scan under autograd, waits for ROADMAP A.11:
only the dense family trains so far). The projections are plain matmuls;
the SSD recurrence goes through ``ops.ssd_scan`` / ``ops.ssd_decode_step``
(the CUDA kernels on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import ParamSpec, resolve_device


def mamba_param_specs(cfg: ModelConfig, stacked: int | None = None) -> dict:
    d, din, n, h, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.conv_width)
    pre = (stacked,) if stacked else ()
    pax = ("stack",) if stacked else ()
    return {
        "w_z": ParamSpec(pre + (d, din), pax + ("embed", "ff")),
        "w_x": ParamSpec(pre + (d, din), pax + ("embed", "ff")),
        "w_b": ParamSpec(pre + (d, n), pax + ("embed", None)),
        "w_c": ParamSpec(pre + (d, n), pax + ("embed", None)),
        "w_dt": ParamSpec(pre + (d, h), pax + ("embed", "ssm_heads")),
        "conv_x": ParamSpec(pre + (w, din), pax + (None, "ff"), scale=0.5),
        "conv_b": ParamSpec(pre + (w, n), pax + (None, None), scale=0.5),
        "conv_c": ParamSpec(pre + (w, n), pax + (None, None), scale=0.5),
        "a_log": ParamSpec(pre + (h,), pax + ("ssm_heads",), init="ones"),
        "d_skip": ParamSpec(pre + (h,), pax + ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec(pre + (h,), pax + ("ssm_heads",), init="zeros"),
        "norm": ParamSpec(pre + (din,), pax + ("ff",), init="ones"),
        "w_out": ParamSpec(pre + (din, d), pax + ("ff", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: torch.Tensor | None = None, valid: int | None = None):
    """Depthwise causal conv. x (B,S,C), w (W,C), tail (B,W-1,C) carry-in.

    Returns (y (B,S,C), new_tail (B,W-1,C)). The W taps are summed in order
    in x's dtype, as the JAX package does. ``valid`` (host int) marks how
    many leading positions of ``x`` are real tokens: the carried tail then
    ends at position ``valid`` instead of S, so a partially filled prefill
    chunk hands the next chunk the right conv window."""
    width = w.shape[0]
    s = x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)  # (B, S+W-1, C)
    y = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(width))
    if width > 1:
        # tokens occupy xp[:, W-1 : W-1+valid]; the (W-1)-wide window ending
        # at the last valid token starts at xp[:, valid]
        v = s if valid is None else valid
        new_tail = xp[:, v:v + width - 1, :]
    else:
        new_tail = tail
    return y.to(x.dtype), new_tail


def _silu_as(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


def _gated_norm(p, gated: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMS norm over d_inner in f32, returned in ``gated``'s dtype."""
    dt = gated.dtype
    g32 = gated.float()
    var = g32.square().mean(dim=-1, keepdim=True)
    g32 = g32 * torch.rsqrt(var + cfg.norm_eps)
    return (g32 * p["norm"].float()).to(dt)


def _pre_ssd(p, x, cfg: ModelConfig, conv_tails=None, valid=None):
    """Shared projection + conv path. Returns SSD inputs and conv tails."""
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    bm = x @ p["w_b"]
    cm = x @ p["w_c"]
    dt = x @ p["w_dt"]
    tails_in = conv_tails or {"x": None, "b": None, "c": None}
    xs, tx = _causal_conv(xs, p["conv_x"], tails_in["x"], valid)
    bm, tb = _causal_conv(bm, p["conv_b"], tails_in["b"], valid)
    cm, tc = _causal_conv(cm, p["conv_c"], tails_in["c"], valid)
    xs, bm, cm = _silu_as(xs), _silu_as(bm), _silu_as(cm)
    # softplus as JAX writes it: logaddexp(x, 0)
    dpre = dt.float() + p["dt_bias"].float()
    dt = torch.logaddexp(dpre, torch.zeros_like(dpre))
    return z, xs, bm, cm, dt, {"x": tx, "b": tb, "c": tc}


def _post_ssd(p, y, xs_heads, z, cfg: ModelConfig):
    """D-skip, gated RMS norm, out projection. y/xs_heads (B,S,H,P)."""
    b, s, h, pdim = y.shape
    d_skip = p["d_skip"].float()
    y = y.float() + d_skip[None, None, :, None] * xs_heads.float()
    y = y.reshape(b, s, h * pdim)
    gated = y * F.silu(z.float())
    gated = _gated_norm(p, gated.to(z.dtype), cfg)
    return gated @ p["w_out"]


def _a(p) -> torch.Tensor:
    return -torch.exp(p["a_log"].float())


def mamba_block(p, x, cfg: ModelConfig, *, ssd_impl: str = "auto",
                return_cache: bool = False):
    """Full-sequence Mamba2 block from a zero state. x (B,S,D) -> y
    (B,S,D), and with ``return_cache`` also the cache the sequence leaves
    behind: the scan's final f32 state and the conv tails ending at
    position S (every position counts, padding included, as in the JAX
    package)."""
    b, s, _ = x.shape
    pn = cfg.ssm_head_dim
    z, xs, bm, cm, dt, tails = _pre_ssd(p, x, cfg)
    xs_h = xs.reshape(b, s, xs.shape[-1] // pn, pn)
    y, state = ops.ssd_scan(xs_h, dt, _a(p), bm, cm, chunk=cfg.ssm_chunk,
                            impl=ssd_impl)
    out = _post_ssd(p, y, xs_h, z, cfg)
    if return_cache:
        return out, {"ssm": state, "conv_x": tails["x"],
                     "conv_b": tails["b"], "conv_c": tails["c"]}
    return out


def mamba_decode(p, x, cache, cfg: ModelConfig, *, ssd_impl: str = "auto",
                 active: torch.Tensor | None = None):
    """One-token Mamba2 step. x (B,1,D); cache {ssm, conv_x, conv_b, conv_c}.

    Returns (out (B,1,D), new_cache). The SSD state ``cache["ssm"]`` is
    advanced IN PLACE (``new_cache["ssm"]`` is the same tensor), with rows
    whose ``active`` entry is 0 left untouched; the conv tails come back
    as new tensors for the caller to gate."""
    b = x.shape[0]
    pn = cfg.ssm_head_dim
    tails = {"x": cache["conv_x"], "b": cache["conv_b"], "c": cache["conv_c"]}
    z, xs, bm, cm, dt, tails = _pre_ssd(p, x, cfg, conv_tails=tails)
    xs_h = xs.reshape(b, 1, xs.shape[-1] // pn, pn)
    y_t, state = ops.ssd_decode_step(
        cache["ssm"], xs_h[:, 0], dt[:, 0], _a(p), bm[:, 0], cm[:, 0],
        impl=ssd_impl, active=active)
    out = _post_ssd(p, y_t[:, None], xs_h, z, cfg)
    return out, {"ssm": state, "conv_x": tails["x"], "conv_b": tails["b"],
                 "conv_c": tails["c"]}


def mamba_prefill_chunk(p, x, cache, cfg: ModelConfig, *, valid: int,
                        ssd_impl: str = "auto"):
    """Chunked-prefill Mamba2 block: continue from a carried cache.

    x (B,C,D) is one fixed-size prompt chunk, of which only the first
    ``valid`` positions (host int) are real tokens. The SSD scan starts from
    ``cache["ssm"]`` and the conv streams from the carried tails; padded
    positions get dt = 0 after the softplus — exp(0·a) = 1 decay and 0·x
    update make them exact identities on the recurrence — so the returned
    cache (new tensors; the input cache is not modified) is the state
    after the last valid token."""
    b, c, _ = x.shape
    pn = cfg.ssm_head_dim
    tails = {"x": cache["conv_x"], "b": cache["conv_b"], "c": cache["conv_c"]}
    z, xs, bm, cm, dt, tails = _pre_ssd(p, x, cfg, conv_tails=tails,
                                        valid=valid)
    mask = (torch.arange(c, device=x.device) < valid).to(dt.dtype)
    dt = dt * mask[None, :, None]
    xs_h = xs.reshape(b, c, xs.shape[-1] // pn, pn)
    y, state = ops.ssd_scan(xs_h, dt, _a(p), bm, cm, chunk=cfg.ssm_chunk,
                            impl=ssd_impl, init_state=cache["ssm"])
    out = _post_ssd(p, y, xs_h, z, cfg)
    return out, {"ssm": state, "conv_x": tails["x"], "conv_b": tails["b"],
                 "conv_c": tails["c"]}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device="cuda") -> dict[str, torch.Tensor]:
    """Zero cache for ``batch`` sequences on ``device``: f32 SSD state
    (B, H, P, N) and the three conv tails (B, W-1, C) in the model's
    dtype."""
    device = resolve_device(device)
    hn, pn = cfg.ssm_heads, cfg.ssm_head_dim
    n, w = cfg.ssm_state, cfg.conv_width
    shapes = {
        "ssm": ((batch, hn, pn, n), torch.float32),
        "conv_x": ((batch, w - 1, cfg.d_inner), dtype),
        "conv_b": ((batch, w - 1, n), dtype),
        "conv_c": ((batch, w - 1, n), dtype),
    }
    return {k: torch.zeros(s, dtype=d, device=device)
            for k, (s, d) in shapes.items()}
