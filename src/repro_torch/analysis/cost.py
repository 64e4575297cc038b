"""The cost of one step, counted by running it on ``meta`` tensors.

The counterpart of ``repro/analysis/hlo.py``. The JAX package compiles a
step and parses its HLO; the port runs eagerly and has no HLO, so
:func:`count_step` runs one step on tensors of the ``meta`` device (shapes
and dtypes, no data, no allocation) under three counters:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``'s rules, its
  registry applied to each op in the same dispatch mode as the other two
  counters (matmuls, batched matmuls and convolutions at 2*M*N*K, the
  counterpart of the analyzer's dot FLOPs). A Python loop runs every
  iteration, so no trip count needs correcting;
* **HBM bytes**: every ATen op's input and output bytes, each input read
  once and each output written once: the eager, unfused traffic, the
  counterpart of ``memory_xla_s``. A broadcast (stride-0) dim of an
  input is read once; view ops move nothing; a gather
  (``embedding``, ``index_select``, ``gather``, ``index``) reads the rows
  it returns, not the table; an indexed write (``index_copy_``,
  ``index_put_``, ``scatter``) the rows it writes, not the buffer (the
  analyzer's gather and dynamic-update-slice rules); ``copy_`` does not
  read its destination, ``fill_``/``zero_`` read nothing;
* **peak live bytes**: the bytes of the storages the step allocates,
  tracked from the op that made each to its release (a weakref finaliser
  on the storage), and their maximum. Storages that existed before the
  step (its arguments) are not counted: the peak is what the step needs
  beyond its arguments.

**Kernel regions.** ``kernels/ops.py`` runs the plain version that stands
in for a hand-written kernel on meta tensors through :func:`kernel_region`.
Inside a region the FLOPs and unfused bytes count as usual, but
``hbm_bytes_kernelized`` charges only the region's inputs and outputs,
once, and the peak counts only the outputs it allocated: what the kernel
itself moves and holds (the counterpart of the analyzer's "innermost scan
charged as a fused kernel", ``repro/analysis/hlo.py:427-466``). The
backward of ``FlashAttentionFunction`` is a kernel too
(``flash_attention_bwd``: q, k, v, the output, dO and the rows' logsumexp
in, dq, dk and dv out); only ``SSDScanFunction``'s backward is still the
plain version's recompute under autograd on the card, so it is counted in
full.

Collectives are not counted here: a step on one process issues none.
``launch/builders.py`` adds them analytically from the sharding
(:attr:`StepCost.collective_bytes`).
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten

# ops that read only the rows they return: 2 x output + the index
_GATHERS = {aten.embedding, aten.index_select, aten.gather, aten.index}
# ops that write rows into a buffer in place: 2 x the rows + the index
_SCATTERS = {aten.index_copy_, aten.index_copy, aten.index_put_,
             aten.index_put, aten.scatter_, aten.scatter, aten.index_add_,
             aten.index_add, aten.scatter_add_, aten.scatter_add}
# ops that write their output without reading it
_WRITES_ONLY = {aten.fill_, aten.zero_, aten.zeros, aten.zeros_like,
                aten.ones, aten.ones_like, aten.full, aten.full_like,
                aten.arange, aten.scalar_tensor}
# ops that allocate without touching memory, or alias their input
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh,
         aten.lift_fresh_copy}


@dataclass
class StepCost:
    """One step's counts (the fields of ``repro``'s ``HloCost`` that
    ``roofline_terms`` reads, plus the peak)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    hbm_bytes_kernelized: float = 0.0
    collective_bytes: dict[str, float] = field(default_factory=dict)
    collective_count: int = 0
    # the most bytes the step's own storages held at once (kernel regions:
    # their outputs only), and those still held when it returned
    peak_bytes: float = 0.0
    output_bytes: float = 0.0
    # kernel regions entered, and the FLOPs counted inside them, by kernel
    regions: dict[str, int] = field(default_factory=dict)
    region_flops_by: dict[str, float] = field(default_factory=dict)
    ops: int = 0
    # the storages (``_key``) some op other than a view read: which
    # arguments the step uses
    read: set[int] = field(default_factory=set, repr=False)

    @property
    def region_flops(self) -> float:
        """The FLOPs counted inside every kernel region."""
        return sum(self.region_flops_by.values())

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree) -> list[torch.Tensor]:
    """The distinct tensors of nested lists, tuples and dicts, in order
    (iterative: a recursive closure would be a reference cycle holding
    the tensors until the garbage collector ran)."""
    seen, out, stack = set(), [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _key(t: torch.Tensor) -> int:
    """The address of a tensor's storage (its C++ object, unique while it
    lives; the Python object may be made later, at another address)."""
    return t.untyped_storage()._cdata


def _nbytes(ts) -> int:
    """Bytes of the memory the tensors span: a broadcast (stride-0) dim
    reads its elements once, not once per repeat."""
    return sum(math.prod(n for n, st in zip(t.shape, t.stride()) if st)
               * t.element_size() for t in ts)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _op_bytes(func, ins: list[torch.Tensor], outs: list[torch.Tensor]
              ) -> int:
    packet = func.overloadpacket
    if packet in _FREE or _is_view(func):
        return 0
    if packet in _WRITES_ONLY:
        return _nbytes(outs)
    index = [t for t in ins if not (t.is_floating_point() or t.is_complex())]
    if packet in _GATHERS:
        return 2 * _nbytes(outs) + _nbytes(index)
    if packet in _SCATTERS:
        rows = [t for t in ins[1:] if t.is_floating_point()]
        return 2 * _nbytes(rows) + _nbytes(index)
    if packet is aten.copy_:
        return _nbytes(ins[1:]) + _nbytes(outs)
    return _nbytes(ins) + _nbytes(outs)


# the counter of the running count_step (one at a time); the autograd
# engine may run backward on a thread of its own, so this is not
# thread-local
_ACTIVE: list["_Counter"] = []


class _Counter(TorchDispatchMode):
    """FLOPs, unfused and kernelized bytes, live and peak bytes, ops."""

    def __init__(self):
        super().__init__()
        self.flop_rules = FlopCounterMode(display=False).flop_registry
        self.cost = StepCost()
        self.live = 0
        self.tracked: dict[int, tuple[weakref.ref, int]] = {}
        self.depth = 0  # kernel regions open
        self.region_names: list[str] = []  # the open regions' kernels

    def _track(self, st) -> None:
        key = st._cdata
        if key in self.tracked:
            return
        n = st.nbytes()

        def release(_ref, key=key, n=n):
            if self.tracked.pop(key, None) is not None:
                self.live -= n

        self.tracked[key] = (weakref.ref(st, release), n)
        self.live += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)

    def _track_new(self, ins, outs) -> None:
        """Track each output storage that is none of the inputs'."""
        old = {_key(t) for t in ins}
        for t in outs:
            if _key(t) not in old:
                self._track(t.untyped_storage())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = self.flop_rules.get(func.overloadpacket)
        if rule is not None:
            flops = rule(*args, **kwargs, out_val=out)
            self.cost.flops += flops
            if self.depth:
                by = self.cost.region_flops_by
                name = self.region_names[0]
                by[name] = by.get(name, 0.0) + flops
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not _is_view(func):
            self.cost.read.update(_key(t) for t in ins)
        b = _op_bytes(func, ins, outs)
        self.cost.hbm_bytes += b
        self.cost.ops += 1
        if self.depth == 0:
            self.cost.hbm_bytes_kernelized += b
            self._track_new(ins, outs)
        return out

    def region(self, name: str, fn, args, kwargs):
        ins = _tensors((args, kwargs))
        self.depth += 1
        self.region_names.append(name)
        try:
            out = fn(*args, **kwargs)
        finally:
            self.depth -= 1
            self.region_names.pop()
        if self.depth == 0:
            outs = _tensors(out)
            self.cost.hbm_bytes_kernelized += _nbytes(ins) + _nbytes(outs)
            self._track_new(ins, outs)
        self.cost.regions[name] = self.cost.regions.get(name, 0) + 1
        return out


def kernel_region(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, the plain version standing in for the
    hand-written kernel ``name``: inside a :func:`count_step`, counted as
    that kernel (its inputs read and outputs written once, only the
    outputs held); otherwise just the call."""
    if not _ACTIVE:
        return fn(*args, **kwargs)
    return _ACTIVE[-1].region(name, fn, args, kwargs)


def _check_storage_identity() -> None:
    t = torch.empty(1, device="meta")
    if t.untyped_storage() is not t.untyped_storage():
        raise RuntimeError(
            f"torch {torch.__version__} gives a new storage object per "
            f"call: the peak tracker needs one object per storage")


def count_step(fn, *args, **kwargs) -> StepCost:
    """Run ``fn(*args, **kwargs)`` once (on meta tensors: it allocates
    nothing) under the FLOP, byte and live-byte counters; returns its
    :class:`StepCost`. ``output_bytes`` is what the step's own storages
    still held when it returned (its outputs); the outputs are dropped
    then."""
    if _ACTIVE:
        raise RuntimeError("count_step does not nest")
    _check_storage_identity()
    counter = _Counter()
    _ACTIVE.append(counter)
    try:
        with counter:
            out = fn(*args, **kwargs)
        counter.cost.output_bytes = counter.live
        del out
    finally:
        _ACTIVE.pop()
    return counter.cost
