"""Logical-axis sharding (MaxText-style rules), on meshes of ranks.

The port of ``repro/parallel/axes.py``. Model code declares tensors with
*logical* axis names ("batch", "embed", "heads", ...) in its
``param_specs()``; a rule table maps logical names to mesh axes. The same
declarations therefore serve one device and a mesh of ranks — only the
rules and the mesh change.

A :class:`Sharding` (the counterpart of ``NamedSharding``) is a mesh plus a
:class:`PartitionSpec`: which mesh axis, if any, splits each tensor dim.
Each rank holds its own slice, on its own device (:meth:`Sharding.shard`);
there is no global array object, so placing a tensor means cutting this
rank's slice out of the full tensor.

Design notes
------------
* ``sharding_context`` is a thread-local context manager. ``constrain`` is
  a compiler hint in the JAX package (``with_sharding_constraint``); eager
  PyTorch has no compiler to hint, so here it is the documented identity,
  kept so the names line up, and no model code calls it.
* Rules map a logical name to a mesh axis, a tuple of mesh axes (a logical
  dim sharded over several physical axes, e.g. batch over (pod, data)), or
  ``None`` (replicated).
* Unknown logical names are replicated — a deliberate fail-soft so new model
  code works before its rule is tuned.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Mapping, Sequence

import torch

# The production rule table (the JAX package's, unchanged).
# batch        -> fully data-parallel over both pod and data axes
# embed        -> FSDP (ZeRO-3): weight dims sharded over the data axes
# heads/ff/... -> tensor parallel over the model axis
# experts      -> expert parallel over the model axis
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": ("pod", "data"),      # FSDP shard dim of weights
    "embed_tp": "model",           # activation d_model dim when TP-sharding acts
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "experts": "model",
    "expert_capacity": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    "stack": None,                 # scan-stacked layer dim, never sharded
    "cache_batch": ("pod", "data"),
    "cache_seq": "model",
}


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated), a mesh axis name, or a tuple of
    mesh axis names (``jax.sharding.PartitionSpec``'s meaning)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Sharding:
    """``spec`` over ``mesh``: the counterpart of ``NamedSharding``.

    :meth:`shard` gives a rank its slice of a full tensor, placed on that
    rank's device. A dim split over mesh axes is cut into equal contiguous
    blocks, the first axis named being the slowest (the row-major order of
    the mesh's ranks), so the concatenation of the ranks' slices in rank
    order is the full tensor."""

    def __init__(self, mesh, spec: PartitionSpec | Sequence = ()):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    def __repr__(self) -> str:
        return f"Sharding({self.spec!r} over {self.mesh!r})"

    def _axes(self, i: int) -> tuple[str, ...]:
        entry = self.spec[i] if i < len(self.spec) else None
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def _coords(self, rank: int) -> dict[str, int]:
        coords, rem = {}, rank
        for name in reversed(self.mesh.axis_names):
            size = self.mesh.shape[name]
            coords[name] = rem % size
            rem //= size
        return coords

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of each rank's slice of a tensor of ``shape``."""
        out = []
        for i, d in enumerate(shape):
            parts = 1
            for a in self._axes(i):
                parts *= self.mesh.shape[a]
            if d % parts:
                raise ValueError(f"dim {i} of {tuple(shape)} ({d}) does not "
                                 f"split into {parts} under {self.spec!r}")
            out.append(d // parts)
        return tuple(out)

    def slice_of(self, x: torch.Tensor, rank: int | None = None
                 ) -> torch.Tensor:
        """Rank ``rank``'s slice of the full tensor ``x`` (this process's
        rank by default), a view where ``x`` lies."""
        rank = self.mesh.rank if rank is None else rank
        coords = self._coords(rank)
        local = self.shard_shape(x.shape)
        for i, n in enumerate(local):
            axes = self._axes(i)
            if not axes:
                continue
            block = 0
            for a in axes:
                block = block * self.mesh.shape[a] + coords[a]
            x = x.narrow(i, block * n, n)
        return x

    def shard(self, x: torch.Tensor, rank: int | None = None) -> torch.Tensor:
        """Rank ``rank``'s slice of ``x`` on that rank's device, in x's
        dtype (a copy unless it already lies there whole)."""
        rank = self.mesh.rank if rank is None else rank
        return self.slice_of(x, rank).to(self.mesh.device_of(rank))


    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full tensor from this rank's slice ``x``: the ranks' slices
        gathered over the mesh's group (one split dim over a 1-D mesh);
        ``x`` itself when no dim is split or the mesh has one rank."""
        dims = [i for i in range(x.dim()) if self._axes(i)]
        if not dims or self.mesh.size == 1:
            return x
        if len(dims) > 1 or len(self.mesh.axis_names) > 1:
            raise NotImplementedError(
                f"gather of {self.spec!r} over {self.mesh!r}: one split dim "
                f"over a 1-D mesh")
        comm = self.mesh.comm
        parts = comm.all_gather(x.to(comm.staging_device(x)).contiguous())
        return torch.cat(parts, dim=dims[0]).to(x.device)


_CTX = threading.local()


def _get(name: str, default=None):
    return getattr(_CTX, name, default)


@contextmanager
def sharding_context(mesh, rules: Mapping[str, Any] | None = None):
    """Activate (mesh, rules) for ``constrain`` / ``logical_to_spec``."""
    prev_mesh, prev_rules = _get("mesh"), _get("rules")
    _CTX.mesh = mesh
    _CTX.rules = dict(rules) if rules is not None else dict(DEFAULT_RULES)
    try:
        yield
    finally:
        _CTX.mesh = prev_mesh
        _CTX.rules = prev_rules


def current_mesh():
    return _get("mesh")


def current_rules() -> dict[str, Any]:
    r = _get("rules")
    return dict(r) if r is not None else dict(DEFAULT_RULES)


def logical_to_spec(
    logical_axes: Sequence[str | None],
    rules: Mapping[str, Any] | None = None,
    mesh=None,
    dim_sizes: Sequence[int] | None = None,
) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec.

    * Drops mesh axes that do not exist on ``mesh`` (so the same rules work
      for a 2D mesh, a 3D mesh, and a one-rank test mesh).
    * Never assigns one mesh axis to two tensor dims.
    * If ``dim_sizes`` is given, drops mesh axes that do not divide the dim
      evenly (e.g. kv_heads=8 cannot shard over model=16 -> replicated).
      For multi-axis entries it keeps the longest divisible prefix, so
      batch=32 over ("pod","data")=(2,16) shards fully while batch=1 falls
      back to replicated instead of erroring.
    """
    rules = rules if rules is not None else (_get("rules") or DEFAULT_RULES)
    mesh = mesh if mesh is not None else _get("mesh")
    mesh_axes = set(mesh.axis_names) if mesh is not None else None
    axis_size = dict(mesh.shape) if mesh is not None else {}
    used: set[str] = set()
    out = []
    for i, name in enumerate(logical_axes):
        entry = rules.get(name) if name is not None else None
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(
            a for a in axes
            if (mesh_axes is None or a in mesh_axes) and a not in used
        )
        if dim_sizes is not None and mesh is not None and axes:
            dim = dim_sizes[i]
            kept: list[str] = []
            prod = 1
            for a in axes:
                if dim % (prod * axis_size[a]) == 0:
                    kept.append(a)
                    prod *= axis_size[a]
                else:
                    break
            axes = tuple(kept)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return P(*out)


def constrain(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """The identity: the JAX package's ``with_sharding_constraint`` hint has
    no eager counterpart (each rank already holds exactly its slice)."""
    return x


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def make_shardings(
    axes_tree: Any,
    mesh,
    rules: Mapping[str, Any] | None = None,
    shapes_tree: Any = None,
):
    """Map a tree (nested dicts) of logical-axes tuples — or of
    :class:`~repro_torch.models.common.ParamSpec` — to a tree of
    :class:`Sharding`.

    ``shapes_tree`` (same structure, leaves = shape tuples or tensors)
    enables divisibility-aware dropping."""
    rules = rules if rules is not None else DEFAULT_RULES

    def one(axes, shape=None):
        axes = getattr(axes, "axes", axes)  # a ParamSpec's logical axes
        if axes is None:
            return Sharding(mesh, P())
        dims = getattr(shape, "shape", shape)
        return Sharding(mesh, logical_to_spec(axes, rules=rules, mesh=mesh,
                                              dim_sizes=dims))

    if shapes_tree is None:
        return _map(one, axes_tree)
    return _map(one, axes_tree, shapes_tree)
