"""Public attention and Mamba2 SSD ops: the hand-written CUDA kernel for
CUDA tensors, the plain PyTorch version for CPU tensors.

Ops: ``flash_attention`` (dense whole-sequence attention: whole-prompt
prefill), ``paged_attention`` (single-token decode over the serving page
pool),
``paged_prefill_attention`` (chunked prefill), ``paged_mixed_attention``
(decode rows + one prefill chunk, one dispatch per engine step),
``ssd_scan`` / ``ssd_decode_step`` (Mamba2).

``impl``:
  * "auto" — where the tensors lie decides: a CUDA tensor launches the
    kernel of :mod:`repro_torch.kernels.flash_attention`,
    :mod:`repro_torch.kernels.paged_attention` or
    :mod:`repro_torch.kernels.ssd_scan` (which raises on
    anything it does not take; there is no fallback), a CPU tensor runs
    :mod:`repro_torch.kernels.ref`.
  * "ref"  — the plain version on any device (tests, ``chip_smoke.py``'s
    kernel-against-plain comparison, ``--attn-impl/--ssd-impl ref``).

A ``meta`` tensor (the dry run's shape-only step, ``analysis/cost.py``)
takes the kernel's route with "auto": the plain version stands in for the
kernel through ``analysis.cost.kernel_region``, which counts it as the
kernel (its inputs and outputs once), and training goes through the same
autograd Functions as on the card.

Gradients: on a CUDA tensor with grad mode on, ``flash_attention`` runs
the kernel inside :class:`FlashAttentionFunction`, whose backward is the
hand-written backward kernel (``csrc/flash_backward.cu``), and
``ssd_scan`` inside :class:`SSDScanFunction`, whose backward recomputes
the plain scan under autograd and returns its vector-Jacobian product
(the JAX package trains through its plain chunked versions; it has no
backward kernel to port). The other ops serve inference only.

Contract: :mod:`repro_torch.kernels.ref` is the ground truth; on the card
each kernel matches it within the bounds ``chip_smoke.py`` states (1e-3 in
f32, as ``repro/kernels/ops.py`` states for the Pallas kernels).

int8 pages: the three paged ops take ``k_scale``/``v_scale`` (f32, one
scale per (page, position, kv head)) with int8 pools. The kernel fuses the
dequantization into its page loads; the plain path runs
``ref.dequantize_pages`` and then the unchanged f32 versions, as the JAX
ops do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.analysis.cost import kernel_region
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                 flash_attention_bwd)
from repro_torch.kernels.paged_attention import (
    paged_attention_bkgd,
    paged_mixed_attention_rkgd,
    paged_prefill_attention_ckgd,
)
from repro_torch.kernels.ssd_scan import ssd_decode_step_bh, ssd_scan_bshp

IMPLS = ("auto", "ref")


def _route(t: torch.Tensor, impl: str, op: str) -> str:
    """"plain" (CPU tensors, or ``impl="ref"``), "kernel" (CUDA tensors)
    or "meta" (meta tensors: the plain version as the kernel's stand-in)."""
    if impl not in IMPLS:
        raise ValueError(f"{op}: unknown impl {impl!r} (have {IMPLS})")
    if impl == "ref" or t.device.type == "cpu":
        return "plain"
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{op}: no kernel for device {t.device}")
    return "kernel" if t.device.type == "cuda" else "meta"


def _plain(route: str, kernel: str, fn, *args):
    """``fn(*args)``, a plain version; on meta tensors standing in for the
    hand-written ``kernel`` (``analysis.cost.kernel_region``: counted as
    the kernel, its inputs whole)."""
    if route == "meta":
        return kernel_region(kernel, fn, *args)
    return fn(*args)


def _paged_route(q: torch.Tensor, impl: str, k_pages: torch.Tensor, k_scale,
                 v_scale, op: str) -> str:
    """``_route`` after checking the scales: both or neither, and exactly
    when the pages are int8."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{op}: k_scale and v_scale come in pairs")
    if (k_scale is not None) != (k_pages.dtype == torch.int8):
        raise ValueError(
            f"{op}: scales go with int8 pages and only with them (pages "
            f"{k_pages.dtype}, scales {'given' if k_scale is not None else 'none'})")
    return _route(q, impl, op)


def _dequantized(k_pages, v_pages, k_scale, v_scale):
    """The pool the plain versions read: f32 pages for an int8 pool."""
    if k_scale is None:
        return k_pages, v_pages
    return (ref.dequantize_pages(k_pages, k_scale),
            ref.dequantize_pages(v_pages, v_scale))


def _grouped(q: torch.Tensor, kvh: int) -> torch.Tensor:
    n, h, d = q.shape
    assert kvh and h % kvh == 0, (
        f"q heads ({h}) must be a multiple of kv heads ({kvh})")
    return q.reshape(n, kvh, h // kvh, d)


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with a given forward and a given backward.

    ``apply(q, k, v, causal, scale, forward, backward)`` on the op's
    (B, S, H, D) layouts: ``forward(q, k, v, causal, scale)`` returns
    ``(out, lse, saved)`` and runs with grad mode off; the Function
    returns ``out`` and keeps ``saved`` (the tensors ``backward`` reads
    for q, k, v and out, in whatever layout the pair agrees on) and lse,
    the rows' logsumexp. ``backward(*saved, lse, grad_out, causal,
    scale)`` returns the gradients of q, k and v. On the card the pair is
    :func:`_flash_kernel_fwd` and :func:`_flash_kernel_bwd`, the two
    hand-written kernels; taking them as arguments lets a CPU test run the
    Function with the plain versions standing in (:func:`flash_plain`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, forward, backward):
        out, lse, saved = forward(q, k, v, causal, scale)
        ctx.save_for_backward(*saved, lse)
        ctx.args = (causal, scale, backward)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        causal, scale, backward = ctx.args
        dq, dk, dv = backward(*ctx.saved_tensors, grad_out, causal, scale)
        return dq, dk, dv, None, None, None, None


def _bhsd(*ts):
    """(B, S, H, D) -> contiguous (B, H, S, D) copies, the kernels' layout."""
    return tuple(t.transpose(1, 2).contiguous() for t in ts)


def _t(*ts):
    return tuple(t.transpose(1, 2) for t in ts)


def _flash_kernel(q, k, v, causal, scale, kernel=flash_attention_bhsd):
    """The flash kernel on the op's (B, S, H, D) layouts (no statistics:
    the serving paths)."""
    return kernel(*_bhsd(q, k, v), causal=causal, scale=scale).transpose(1, 2)


def _flash_kernel_fwd(q, k, v, causal, scale, kernel=flash_attention_bhsd):
    """The flash kernel as :class:`FlashAttentionFunction`'s forward:
    ``(out, lse, saved)``, ``saved`` the kernel-layout copies of q, k and v
    and its output."""
    qt, kt, vt = _bhsd(q, k, v)
    out, lse = kernel(qt, kt, vt, causal=causal, scale=scale,
                      return_lse=True)
    return out.transpose(1, 2), lse, (qt, kt, vt, out)


def _flash_kernel_bwd(qt, kt, vt, out, lse, grad_out, causal, scale,
                      kernel=flash_attention_bwd):
    """The backward kernel on :func:`_flash_kernel_fwd`'s saved tensors:
    dO copied to the kernel's layout, the gradients handed back on the
    op's layouts (views)."""
    return _t(*kernel(qt, kt, vt, out, *_bhsd(grad_out), lse, causal=causal,
                      scale=scale))


# the K/V block of the flash op's length contract (its ``block_kv``)
FLASH_BLOCK_KV = 256


def flash_plain(block_kv: int = FLASH_BLOCK_KV):
    """The plain (forward, backward) pair of :class:`FlashAttentionFunction`
    on the op's layouts: ``ref.flash_attention_lse`` and
    ``ref.flash_attention_bwd`` over K/V blocks of ``block_kv``."""
    def forward(q, k, v, causal, scale):
        out, lse = ref.flash_attention_lse(q, k, v, causal=causal,
                                           scale=scale, chunk_kv=block_kv)
        return out, lse, (q, k, v, out)

    def backward(q, k, v, out, lse, grad_out, causal, scale):
        return ref.flash_attention_bwd(q, k, v, out, grad_out, lse,
                                       causal=causal, scale=scale,
                                       block_kv=block_kv)
    return forward, backward


def _flash_bhsd_plain(q, k, v, *, causal, scale, return_lse=False):
    """The plain version at the flash kernel's (B, H, S, D) layouts: the
    whole score matrix (the chunked version's FLOPs in a few ops; a
    kernel region counts neither's internal bytes); with ``return_lse``
    the chunked version over one K/V block, and its statistics."""
    if return_lse:
        out, lse = ref.flash_attention_lse(*_t(q, k, v), causal=causal,
                                           scale=scale, chunk_kv=k.shape[2])
        return out.transpose(1, 2), lse
    return ref.flash_attention_ref(*_t(q, k, v), causal=causal,
                                   scale=scale).transpose(1, 2)


def _flash_bwd_bhsd_plain(q, k, v, o, do, lse, *, causal, scale):
    """The plain backward at the kernel's layouts, one K/V block."""
    return _t(*ref.flash_attention_bwd(*_t(q, k, v, o, do), lse,
                                       causal=causal, scale=scale,
                                       block_kv=k.shape[2]))


def _region(name, fn):
    return lambda *a, **kw: kernel_region(name, fn, *a, **kw)


def _flash_stand_in(q, k, v, causal, scale):
    """``_flash_kernel`` on meta tensors: its layout copies, and the plain
    version in a kernel region for the kernel."""
    return _flash_kernel(q, k, v, causal, scale, kernel=_region(
        "flash_attention_bhsd", _flash_bhsd_plain))


def _flash_fwd_stand_in(q, k, v, causal, scale):
    """``_flash_kernel_fwd`` on meta tensors (the region's outputs: out and
    lse)."""
    return _flash_kernel_fwd(q, k, v, causal, scale, kernel=_region(
        "flash_attention_bhsd", _flash_bhsd_plain))


def _flash_bwd_stand_in(*args):
    """``_flash_kernel_bwd`` on meta tensors: the plain backward in a
    kernel region (q, k, v, out, dO and lse in, dq, dk and dv out)."""
    return _flash_kernel_bwd(*args, kernel=_region("flash_attention_bwd",
                                                   _flash_bwd_bhsd_plain))


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    impl: str = "auto",
    block_kv: int = FLASH_BLOCK_KV,
) -> torch.Tensor:
    """Multi-head / grouped-query attention. Returns (B, Sq, H, D).

    Keeps the JAX op's length contract: its reference scans K/V in blocks
    of ``min(block_kv, Skv)`` and refuses an Skv that is not a multiple of
    that block (``repro/kernels/ref.py`` ``flash_attention_chunked``, and
    the Pallas kernel likewise), so this op raises ``ValueError`` for the
    same inputs on every path and both packages serve the same lengths.
    The kernel itself masks ragged tiles (call
    :func:`repro_torch.kernels.flash_attention.flash_attention_bhsd`
    directly for those).

    On a CUDA tensor, with grad mode on and q, k or v requiring grad, the
    kernel runs inside :class:`FlashAttentionFunction` (gradients by the
    backward kernel); on the CPU the plain version is differentiable as
    it is."""
    skv = k.shape[1]
    chunk = min(block_kv, skv)
    if chunk and skv % chunk:
        raise ValueError(
            f"flash_attention: Skv={skv} is not a multiple of "
            f"min(block_kv={block_kv}, Skv): the reference scans K/V in "
            f"blocks of {chunk} and refuses this length")
    route = _route(q, impl, "flash_attention")
    if route == "plain":
        return ref.flash_attention_chunked(q, k, v, causal=causal,
                                           scale=scale, chunk_kv=block_kv)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        pair = ((_flash_kernel_fwd, _flash_kernel_bwd) if route == "kernel"
                else (_flash_fwd_stand_in, _flash_bwd_stand_in))
        return FlashAttentionFunction.apply(q, k, v, causal, scale, *pair)
    forward = _flash_kernel if route == "kernel" else _flash_stand_in
    return forward(q, k, v, causal, scale)


def paged_attention(
    q: torch.Tensor,             # (B, H, D) one query token per sequence
    k_pages: torch.Tensor,       # (P, page, KVH, D) shared page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, MP) int32
    lengths: torch.Tensor,       # (B,) int32 valid positions per sequence
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Single-token decode attention over a paged KV cache. Returns
    (B, H, D); idle slots (length 0) return zeros, never NaN."""
    route = _paged_route(q, impl, k_pages, k_scale, v_scale,
                         "paged_attention")
    if route != "kernel":
        return _plain(
            route, "paged_attention_bkgd",
            lambda q, kp, vp, ks, vs, bt, ln: ref.paged_attention_ref(
                q, *_dequantized(kp, vp, ks, vs), bt, ln, scale=scale),
            q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths)
    out = paged_attention_bkgd(
        _grouped(q, k_pages.shape[2]), k_pages, v_pages, block_tables,
        lengths, k_scale=k_scale, v_scale=v_scale, scale=scale)
    return out.reshape(q.shape)


def paged_prefill_attention(
    q: torch.Tensor,            # (C, H, D) one prefill chunk of ONE sequence
    k_pages: torch.Tensor,      # (P, page, KVH, D) shared page pool
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (MP,) int32 the sequence's block-table row
    start: torch.Tensor,        # int32 scalar: positions already cached
    valid: torch.Tensor,        # int32 scalar: real tokens in this chunk
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Chunked-prefill attention over a paged KV cache. Returns (C, H, D).
    The chunk's own K/V must already be in the pages; query i attends
    positions ``<= start + i``, padded queries (``i >= valid``) give zeros."""
    route = _paged_route(q, impl, k_pages, k_scale, v_scale,
                         "paged_prefill_attention")
    if route != "kernel":
        return _plain(
            route, "paged_prefill_attention_ckgd",
            lambda q, kp, vp, ks, vs, bt, st, va:
                ref.paged_prefill_attention_ref(
                    q, *_dequantized(kp, vp, ks, vs), bt, st, va,
                    scale=scale),
            q, k_pages, v_pages, k_scale, v_scale, block_table, start, valid)
    out = paged_prefill_attention_ckgd(
        _grouped(q, k_pages.shape[2]), k_pages, v_pages, block_table,
        start, valid, k_scale=k_scale, v_scale=v_scale, scale=scale)
    return out.reshape(q.shape)


def paged_mixed_attention(
    q: torch.Tensor,             # (R, H, D) one query row per batch row
    k_pages: torch.Tensor,       # (P, page, KVH, D) shared page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (R, MP) int32, one block-table row per row
    last_pos: torch.Tensor,      # (R,) int32 last attendable position, -1 = dead
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
    impl: str = "auto",
    num_decode: int | None = None,
) -> torch.Tensor:
    """Fused mixed-step attention over a paged KV cache. Returns (R, H, D);
    dead rows (``last_pos = -1``) return exact zeros.

    ``num_decode`` is an optional structure hint, the caller's promise:
    rows ``[num_decode, R)`` form one prefill chunk (one shared block-table
    row, contiguous live positions, dead suffix). The plain version then
    gathers the chunk's K/V once (:func:`ref.paged_mixed_attention_split_ref`);
    with bf16 q the kernel runs the decode rows through the split decode
    kernel and the chunk rows through the tensor-core chunk kernel, which
    reads the chunk's pages once per kv head. Without it (or with f32 q)
    every row goes through the split decode kernel on its own table row."""
    route = _paged_route(q, impl, k_pages, k_scale, v_scale,
                         "paged_mixed_attention")
    if route != "kernel":
        def plain(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                  last_pos):
            k_pages, v_pages = _dequantized(k_pages, v_pages, k_scale,
                                            v_scale)
            if num_decode is None or not 0 < num_decode < q.shape[0]:
                return ref.paged_mixed_attention_ref(
                    q, k_pages, v_pages, block_tables, last_pos, scale=scale)
            return ref.paged_mixed_attention_split_ref(
                q, k_pages, v_pages, block_tables, last_pos, num_decode,
                scale=scale)

        return _plain(route, "paged_mixed_attention_rkgd", plain, q, k_pages,
                      v_pages, k_scale, v_scale, block_tables, last_pos)
    out = paged_mixed_attention_rkgd(
        _grouped(q, k_pages.shape[2]), k_pages, v_pages, block_tables,
        last_pos, k_scale=k_scale, v_scale=v_scale, scale=scale,
        num_decode=num_decode)
    return out.reshape(q.shape)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------


def _ssd_plain(x, dt, A, Bm, Cm, init_state, chunk):
    """The plain scan as the JAX op runs it on the CPU: the tail padded with
    dt = 0 positions to a multiple of ``min(chunk, S)``, then
    ``ref.ssd_chunked``; differentiable as it is."""
    s = x.shape[1]
    chunk_eff = min(chunk, s)
    pad = (chunk_eff - s % chunk_eff) % chunk_eff
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    y, fs = ref.ssd_chunked(x, dt, A, Bm, Cm, init_state, chunk=chunk_eff)
    return (y[:, :s] if pad else y), fs


def _ssd_kernel(x, dt, A, Bm, Cm, init_state, chunk, kernel=ssd_scan_bshp):
    """The scan kernel on the op's inputs (it walks its own 64-token
    sub-chunks and ignores ``chunk``)."""
    if init_state is not None:
        init_state = init_state.float().contiguous()
    return kernel(
        x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
        Bm.to(x.dtype).contiguous(), Cm.to(x.dtype).contiguous(), init_state)


def _ssd_stand_in(x, dt, A, Bm, Cm, init_state, chunk):
    """``_ssd_kernel`` on meta tensors: its casts and copies, and the plain
    scan in a kernel region for the kernel."""
    return _ssd_kernel(x, dt, A, Bm, Cm, init_state, chunk, kernel=lambda *a:
                       kernel_region("ssd_scan_bshp", _ssd_plain, *a, chunk))


class SSDScanFunction(torch.autograd.Function):
    """The SSD scan with a given forward and the plain version's gradient.

    ``apply(x, dt, A, Bm, Cm, init_state, chunk, forward)``: the outputs
    are ``forward(x, dt, A, Bm, Cm, init_state, chunk)`` (y and the final
    state, run with grad mode off: on the card, :func:`_ssd_kernel`);
    backward recomputes the plain scan (:func:`_ssd_plain`: the padding to
    ``min(chunk, S)`` and ``ref.ssd_chunked``) under autograd from the
    saved inputs and returns its vector-Jacobian product for both outputs
    for x, dt, A, Bm, Cm and ``init_state`` (None when it is None), each
    in its own dtype. An output without an upstream gradient counts as
    zeros and is left out of the recompute's backward (training drops the
    final state). Taking the forward as an argument lets a CPU test run
    the Function with the plain version standing in for the kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk, forward):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk = chunk
        return forward(x, dt, A, Bm, Cm, init_state, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        saved = ctx.saved_tensors
        wanted = [i for i, t in enumerate(saved)
                  if t is not None and ctx.needs_input_grad[i]]
        inputs = [t if t is None else t.detach().requires_grad_(i in wanted)
                  for i, t in enumerate(saved)]
        with torch.enable_grad():
            outs = [(o, g) for o, g in zip(_ssd_plain(*inputs, ctx.chunk),
                                           (grad_y, grad_state))
                    if g is not None]
            grads = torch.autograd.grad(
                [o for o, _ in outs], [inputs[i] for i in wanted],
                [g for _, g in outs], allow_unused=True)
        out = [None] * len(saved)
        for i, g in zip(wanted, grads):
            out[i] = torch.zeros_like(inputs[i]) if g is None else g
        return (*out, None, None)


def ssd_scan(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,   # (H,)
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 256,
    impl: str = "auto",
    init_state: torch.Tensor | None = None,  # (B, H, P, N) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B,S,H,P), final_state (B,H,P,N) f32).

    S need not divide ``chunk``: the tail is padded with dt=0 positions,
    which are exact identities on the recurrence (decay exp(0·a)=1, update
    dt·x=0), and the padded outputs are sliced off. ``init_state``
    continues a scan from a carried state (chunked prefill). The plain
    version pads here and runs ``ref.ssd_chunked`` at ``min(chunk, S)``,
    as the JAX op runs it on the CPU. On the card the kernel ignores
    ``chunk``: it walks 64-token sub-chunks (the result does not depend
    on the chunk length up to rounding), zero-fills its own ragged last
    one the same way, and loads ``init_state`` as its carried state. bf16
    with P and N multiples of 16 and N <= 256 runs on tensor cores (bf16
    operands, f32 sums, the carried state f32 throughout); other shapes
    and f32 run the CUDA-core kernel in f32 (``kernels/ssd_scan.py``).

    On a CUDA tensor, with grad mode on and any input requiring grad, the
    kernel runs inside :class:`SSDScanFunction` (gradients by the plain
    version's autograd); on the CPU the plain version is differentiable
    as it is."""
    route = _route(x, impl, "ssd_scan")
    if route == "plain":
        return _ssd_plain(x, dt, A, Bm, Cm, init_state, chunk)
    forward = _ssd_kernel if route == "kernel" else _ssd_stand_in
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init_state)):
        return SSDScanFunction.apply(x, dt, A, Bm, Cm, init_state, chunk,
                                     forward)
    return forward(x, dt, A, Bm, Cm, init_state, chunk)


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N) f32
    x_t: torch.Tensor,    # (B, H, P)
    dt_t: torch.Tensor,   # (B, H)
    A: torch.Tensor,      # (H,)
    B_t: torch.Tensor,    # (B, N)
    C_t: torch.Tensor,    # (B, N)
    *,
    impl: str = "auto",
    active: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence, advancing ``state`` (f32) IN PLACE.
    Returns (y (B,H,P), ``state``). The JAX op returns a new state and its
    engine donates the bank; here the bank is updated where it lies, so
    the kernel writes only the rows that change. (``ref.ssd_decode_step``
    is the out-of-place plain form.)

    ``active`` (B,) int gates the state writeback per row: a row with 0
    keeps its old state untouched (its y still comes from the advanced
    state), as the JAX engine's ``_mask_state`` gates its bank."""
    route = _route(state, impl, "ssd_decode_step")
    if route != "kernel":
        def plain(state, x_t, dt_t, A, B_t, C_t, active):
            y, new = ref.ssd_decode_step(state, x_t, dt_t, A, B_t, C_t)
            if active is not None:
                keep = active.to(torch.bool).reshape(-1, 1, 1, 1)
                new = torch.where(keep, new, state)
            state.copy_(new)
            return y, state

        return _plain(route, "ssd_decode_step_bh", plain, state, x_t, dt_t,
                      A, B_t, C_t, active)
    return ssd_decode_step_bh(
        state, x_t.contiguous(), dt_t.float().contiguous(),
        A.float().contiguous(), B_t.to(x_t.dtype).contiguous(),
        C_t.to(x_t.dtype).contiguous(),
        active=None if active is None else active.to(torch.int32).contiguous())
