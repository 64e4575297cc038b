"""Explicit collectives on ``torch.distributed``: tensor-parallel serving +
gradients.

The port of ``repro/parallel/collectives.py``. There, model code runs
inside ``jax.shard_map`` and these functions lower to XLA collectives;
here every rank of a mesh is its own process (``parallel/group.py``) and
they call the rank's process group:

* **Tensor-parallel serving reductions.** The serving executors
  (``serving/executor.py``, ``serving/ssm_engine.py``) run each step on
  every rank of a ``("model",)`` mesh with attention heads, MLP ff, SSM
  heads and (untied) unembed columns sharded Megatron-style. Model code
  marks the reduction points with :func:`psum_tp` (row-parallel output
  projections: attention ``wo``, MLP ``w_down``, the MoE expert down
  projection, Mamba's ``w_out``), :func:`pmean_tp` (the Mamba gated norm
  over the sharded ``d_inner``) and :func:`all_gather_logits`
  (column-parallel unembed -> full-vocab logits for sampling). All three
  are IDENTITY outside a :func:`tensor_parallel` context, so the same
  model code runs unsharded (training, lockstep engine, one-rank serving)
  without change.
* **Error-feedback int8-compressed gradient all-reduce**
  (1-bit-Adam-family trick, here at 8 bits).

    g_compressed = quantize_int8(g + error_carry)
    all-reduce(g_compressed)            # 4x fewer wire bytes than fp32
    error_carry = (g + error_carry) - dequant(g_compressed)

The error carry makes the quantization *unbiased over time* — the residual
of step t is re-injected at t+1, so long-run drift vanishes (standard error
feedback / EF-SGD result).

Staging: a group on the gloo backend (ranks that share one card, or CPU
ranks) reduces host tensors, so a CUDA tensor is copied to the host, reduced
and copied back; bf16/f16 partial sums are reduced in f32 and rounded once.
Every rank receives the same reduced values.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

# ---------------------------------------------------------------------------
# tensor-parallel context (serving executors)
# ---------------------------------------------------------------------------

_TP = threading.local()


@contextmanager
def tensor_parallel(comm, *, vocab_sharded: bool = False):
    """Declare that the enclosed model code runs on one rank of ``comm``
    (a :class:`repro_torch.parallel.group.Comm`: this rank's process group
    over the mesh's ``"model"`` axis) with Megatron-style weight sharding
    (heads/kv_heads/ff/ssm_heads -> ``"model"``; unembed columns too when
    ``vocab_sharded``). :func:`psum_tp` / :func:`pmean_tp` /
    :func:`all_gather_logits` become real collectives inside this context
    and stay identity outside it.

    ``comm=None`` (or a one-rank comm) is an explicit no-op, so one-rank
    serving shares the code path. Thread-local, so concurrent serving
    workers with different meshes don't interfere."""
    if comm is not None and comm.size == 1:
        comm = None
    prev = (getattr(_TP, "comm", None), getattr(_TP, "vocab", False))
    _TP.comm, _TP.vocab = comm, vocab_sharded and comm is not None
    try:
        yield
    finally:
        _TP.comm, _TP.vocab = prev


def tp_axis() -> str | None:
    """Mesh axis of the ambient :func:`tensor_parallel` context (or None)."""
    return "model" if getattr(_TP, "comm", None) is not None else None


def _tp_comm():
    """The ambient context's :class:`~repro_torch.parallel.group.Comm`, or
    None outside one."""
    return getattr(_TP, "comm", None)


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _all_reduce(x: torch.Tensor, comm, op: str) -> torch.Tensor:
    """``x`` reduced over ``comm`` (a new tensor on x's device, in x's
    dtype; the reduction in f32 for 16-bit floats)."""
    staged = x.to(comm.staging_device(x), _sum_dtype(x.dtype)).contiguous()
    if staged.data_ptr() == x.data_ptr():
        staged = staged.clone()  # never reduce the caller's tensor in place
    comm.all_reduce(staged, op)
    return staged.to(x.device, x.dtype)


def psum_tp(x: torch.Tensor) -> torch.Tensor:
    """Sum partial products over the tensor-parallel axis.

    Model code calls this exactly where a row-parallel matmul leaves a
    partial sum on each shard (attention output projection, MLP down
    projection, MoE expert down projection, Mamba's out projection).
    Identity outside a :func:`tensor_parallel` context."""
    comm = _tp_comm()
    return x if comm is None else _all_reduce(x, comm, "sum")


def pmean_tp(x: torch.Tensor) -> torch.Tensor:
    """Mean over the tensor-parallel axis.

    Normalization layers whose reduction axis is sharded (the Mamba gated
    RMSNorm runs over the ff-sharded ``d_inner`` dim) need the *global*
    mean of squares; since every shard holds an equal-size slice, the
    global mean is exactly the mean of the shard-local means. Identity
    outside a :func:`tensor_parallel` context."""
    comm = _tp_comm()
    if comm is None:
        return x
    return _all_reduce(x, comm, "sum") / comm.size


def all_gather_logits(x: torch.Tensor) -> torch.Tensor:
    """Reassemble full-vocab logits from a column-parallel unembed.

    Sampling (greedy argmax / top-k / top-p) needs the whole vocab row, so
    the shard-local logits slice is gathered along the last axis, rank
    order. Identity outside a :func:`tensor_parallel` context and when the
    vocab dim is replicated (tied embeddings keep the embedding table —
    and thus the logits — replicated; gathering replicated logits would
    wrongly tile them)."""
    comm = _tp_comm()
    if comm is None or not getattr(_TP, "vocab", False):
        return x
    staged = x.to(comm.staging_device(x)).contiguous()
    parts = comm.all_gather(staged)
    return torch.cat(parts, dim=-1).to(x.device)


# ---------------------------------------------------------------------------
# int8-compressed all-reduce with error feedback (data-parallel gradients)
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = x.abs().max()
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, comm) -> torch.Tensor:
    """int8-compressed psum over ``comm`` (a Comm, or a Mesh for its
    rank's Comm; None: a one-rank axis):
    quantize locally, sum int32, dequant.

    Wire bytes: 1 byte/elt for the payload (+1 scalar) vs 4 for fp32 (the
    int8 values travel in an int32 buffer here, as the JAX package's
    ``psum`` of int32 does). Scales are max-combined so dequantization is
    conservative (no overflow: the int32 accumulator holds up to 2^23
    shards of int8 exactly)."""
    comm = getattr(comm, "comm", comm)  # a Mesh: this rank's Comm
    _, scale = quantize_int8(x)
    if comm is not None:
        scale = _all_reduce(scale.reshape(1), comm, "max")[0]
    # requantize against the shared scale so the integer sum is coherent
    q2 = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
    if comm is not None:
        q2 = _all_reduce(q2, comm, "sum")
    return q2.to(torch.float32) * scale


def make_compressed_grad_allreduce(mesh, axis: str = "data"):
    """Returns ef_allreduce(grads, error_carry) -> (mean_grads, new_carry).

    ``mesh``: a :class:`~repro_torch.parallel.group.Mesh` with ``axis``.
    ``grads`` is ``(n_local, N)``: the flat gradients of the data shards
    this process holds, one row each (the JAX function's per-shard view).
    On a one-process mesh every shard is a row of one tensor and the
    reduction runs over the rows; on a mesh of processes each rank passes
    its own row and the reduction runs over the group. ``error_carry``
    has ``grads``' shape; the mean comes back whole on every rank. The
    function is picklable (every rank of a group can be handed it)."""
    return _EFAllReduce(mesh, mesh.shape[axis])


class _EFAllReduce:
    """The error-feedback all-reduce of :func:`make_compressed_grad_allreduce`.

    Every shard quantizes against the scale shared by all shards (their
    max, as :func:`compressed_psum` does), and its carry is the residual
    of exactly what it sent. The JAX package's carry is the residual of a
    quantization against the shard's own scale, which is what it sent only
    when one shard holds the largest magnitude; with two shards that
    leaves a bias the carry never repays (ROADMAP C.12). With one shard
    the two are the same arithmetic."""

    def __init__(self, mesh, n: int):
        self.mesh, self.n = mesh, n

    def __call__(self, grad_shards: torch.Tensor, error_carry: torch.Tensor):
        comm = self.mesh.comm
        corrected = grad_shards.to(torch.float32) + error_carry
        scale = torch.stack([quantize_int8(r)[1] for r in corrected]).max()
        if comm is not None:
            scale = _all_reduce(scale.reshape(1), comm, "max")[0]
        q = torch.clamp(torch.round(corrected / scale), -127, 127)
        total = q.to(torch.int32).sum(0)
        if comm is not None:
            total = _all_reduce(total, comm, "sum")
        mean = total.to(torch.float32) * scale / float(self.n)
        return mean.to(grad_shards.dtype), corrected - q * scale


def flatten_grads(grads: dict) -> tuple[torch.Tensor, list]:
    """A nested-dict gradient tree -> (one flat f32 vector, the meta that
    :func:`unflatten_grads` needs), leaves in sorted-key order."""
    from repro_torch.models.common import flatten_tree

    flat = flatten_tree(grads)
    names = sorted(flat)
    vec = torch.cat([flat[k].reshape(-1).to(torch.float32) for k in names])
    return vec, [(k, tuple(flat[k].shape), flat[k].dtype) for k in names]


def unflatten_grads(flat: torch.Tensor, meta: list) -> dict:
    from repro_torch.models.common import unflatten_tree

    out, off = {}, 0
    for name, shape, dtype in meta:
        n = 1
        for d in shape:
            n *= d
        out[name] = flat[off:off + n].reshape(shape).to(dtype)
        off += n
    return unflatten_tree(out)
