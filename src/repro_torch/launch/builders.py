"""Cell builders: (architecture x shape x mesh) -> a step on meta tensors.

The port of ``repro/launch/builders.py``. Where the JAX package lowers the
step a cell runs (``jax.jit(...).lower``), :func:`lower_cell` builds it on
the ``meta`` device: the model, the step function the trainer or an engine
calls and its arguments as meta tensors, and the mesh's shardings of those
arguments. Nothing is allocated and no process is spawned: the mesh's ranks
are never started. :func:`count_cell` then counts the step
(``analysis/cost.py``) and states it per rank:

* **arguments** (state + batch for train, params + batch for prefill,
  params + cache + tokens for decode): each rank's shard of each leaf the
  step reads, exact, from :func:`~repro_torch.parallel.make_shardings`
  and :meth:`Sharding.shard_shape` under ``parallel/axes.py::DEFAULT_RULES``
  (the JAX package's, ``cache_seq -> model`` included). A leaf the step
  never reads (a prefill's targets, whisper's encoder in decode,
  ``vision_proj`` in decode) is left out, as ``jax.jit`` prunes unused
  arguments;
* **FLOPs and HBM bytes**: the whole step at the GLOBAL batch, divided by
  the rank count: an ideal split (the record says so in ``meta``). A train
  step of ``ga`` microbatches is counted in the parts the trainer runs
  (``train/step.py::make_train_parts``): one microbatch's forward and
  backward, counted once and multiplied by ``ga``; the accumulators and the
  optimizer update, once;
* **peak bytes**: the step with microbatches of the PER-RANK batch and
  the model at full width (no tensor-parallel split of activations,
  gradients or temporaries): an upper bound;
* **resident bytes**: what a serving step keeps beside the parameters, the
  f32 copy of the unembedding (``LMBase.unembed_f32``), per rank;
* **collectives** (analytic; none run): operand bytes per rank, as the
  JAX analyzer counts them (an all-gather's input shard, a reduce-scatter's
  full operand), by kind and mesh axis (:func:`collective_terms`). ``act``
  is one microbatch's (rows, S, D) activation on a rank in the model's
  dtype, ``stat`` its (rows, S) f32 statistics:

  - data axes, FSDP: a weight leaf sharded over them (``embed -> (pod,
    data)``) is all-gathered before use: once per step in prefill and
    decode; in training twice per microbatch (forward, and the backward's
    recompute under ``torch.utils.checkpoint``), and its gradient
    reduce-scattered once per microbatch at its gathered size in the
    parameter's dtype (the microbatch's gradient; the ``accum_dtype``
    accumulation is local). A leaf replicated over the data-parallel ranks
    has its gradient all-reduced once per microbatch instead;
  - model axis (over more than 1 rank, with some weight sharded over it):
    the port's own ``psum_tp`` sites, each an all-reduce of ``act``: two a
    dense, moe or vlm layer (attention ``wo``, the MLP/MoE ``w_down``),
    one a Mamba layer (``w_out``) plus its gated norm's ``pmean_tp`` of a
    ``stat``, two a hybrid group's shared block. Training runs them in the
    forward, again in the recompute except the one that closes each
    checkpointed unit (a layer; a hybrid group), whose output no backward
    reads (``torch.utils.checkpoint`` stops there), and once more in the
    backward for the gradient of each block's input, summed over the
    block's projections first (Megatron's plan); a Mamba norm's statistic
    in all three. A vocab-sharded embedding sums its rows over the shards
    (one ``act`` a pass). Training adds, for a vocab-sharded unembedding,
    the gradient of its input (one ``act``) and the cross-entropy's
    statistics over the shards, five ``stat`` at S tokens: the max, the
    sum of exponentials and the target's logit in the forward, the max
    and the sum again in the chunk's recompute. A serving step gathers one
    position's f32 logits over the shards (``all_gather_logits``).
    Whisper's sites (decoder three a layer: self, cross and MLP; encoder
    two) are taken as three passes in training.

  Held against JAX's compiled step (``tests/test_torch_analysis.py``): on
  the dense family every term equals its counterpart in the HLO, operand
  for operand, but one: XLA all-reduces the gradient of each projection's
  input apart (q, k, v; gate, up), 3 ``act`` a layer more than the sum
  reduced once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.analysis.cost import StepCost, _key, count_step
from repro_torch.configs.base import ModelConfig, ShapeConfig, cell_supported
from repro_torch.models.api import (BATCH_AXES, build_model, cache_len,
                                    frontend_len, input_specs)
from repro_torch.models.common import (flatten_tree, tree_leaves,
                                       unflatten_tree)
from repro_torch.parallel import DEFAULT_RULES, make_shardings
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import (abstract_train_state, make_train_parts,
                                    make_train_step, train_state_axes)


@dataclass
class CellPlan:
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any
    kind: str
    model: Any
    step: Any          # the step function ...
    args: tuple        # ... and its arguments, at the global batch
    shardings: Any     # the mesh's shardings of ``args``' leaves
    params: dict       # the parameter tree (meta tensors) ...
    params_sh: dict    # ... and its shardings
    rules: dict
    meta: dict
    parts: tuple = ()  # train: ``make_train_parts``' (init, micro, update)


def default_ga(shape: ShapeConfig, cfg: ModelConfig | None = None) -> int:
    """Microbatch count heuristic: large-d models need smaller microbatches
    (activation bytes/token scale with d_model); floor at 16 sequences."""
    if shape.kind != "train":
        return 1
    per_micro = 16 if (cfg is not None and cfg.d_model >= 6144) else 32
    return max(1, min(16, shape.global_batch // per_micro))


def batch_shardings(specs: dict, mesh, rules=None) -> dict:
    axes = {k: BATCH_AXES[k] for k in specs}
    return make_shardings(axes, mesh, rules=rules, shapes_tree=specs)


def _pairs(tree, shardings) -> list[tuple[torch.Tensor, Any]]:
    """(leaf, its sharding) of a tree and its sharding tree, matched by
    name (a module's parameter order need not be its spec's)."""
    if not isinstance(tree, dict):
        return [(tree, shardings)]
    flat_sh = flatten_tree(shardings)
    return [(t, flat_sh[k]) for k, t in flatten_tree(tree).items()]


def rank_bytes(t: torch.Tensor, sh) -> int:
    """One rank's bytes of a tensor under its sharding."""
    return math.prod(sh.shard_shape(t.shape)) * t.element_size()


def _global_bytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size()
               for t in flatten_tree(tree).values())


def _module_params(model) -> dict:
    """The serving entry points' parameters (the module's own, as meta
    tensors), nested like ``model.abstract()``."""
    return unflatten_tree(dict(model.named_parameters()))


def lower_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    *,
    rules: dict | None = None,
    ga: int | None = None,
) -> CellPlan:
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape.name}: {reason}")
    rules = dict(rules or DEFAULT_RULES)
    opt_cfg = AdamWConfig(moment_dtype="bfloat16")
    ga = ga if ga is not None else default_ga(shape, cfg)
    # the microbatch must not drop below the data-parallel width, or batch
    # sharding silently degrades (divisibility fallback) and per-rank
    # activations blow up by the lost factor
    batch_rule = rules.get("batch") or ()
    batch_axes = batch_rule if isinstance(batch_rule, tuple) else (batch_rule,)
    dp = 1
    for a in batch_axes:
        dp *= mesh.shape.get(a, 1)
    if shape.kind == "train":
        ga = max(1, min(ga, shape.global_batch // max(dp, 1)))
    model = build_model(cfg, device="meta")
    meta: dict = {"ga": ga, "rules": {k: str(v) for k, v in rules.items()}}
    parts: tuple = ()

    if shape.kind == "train":
        state = abstract_train_state(model, opt_cfg)
        state_sh = make_shardings(train_state_axes(model), mesh, rules=rules,
                                  shapes_tree=state)
        bspecs = input_specs(cfg, shape)
        bsh = batch_shardings(bspecs, mesh, rules)
        # bf16 accumulation, as the JAX cell: halves the gradient buffer;
        # the update math is f32
        step = make_train_step(model, opt_cfg, ga=ga, accum_dtype="bfloat16")
        parts = make_train_parts(model, opt_cfg, ga=ga,
                                 accum_dtype="bfloat16")
        args, shardings = (state, bspecs), (state_sh, bsh)
        params, params_sh = state["params"], state_sh["params"]
        meta["state_bytes_global"] = _global_bytes(state)
    elif shape.kind == "prefill":
        params = _module_params(model)
        params_sh = make_shardings(model.axes(), mesh, rules=rules,
                                   shapes_tree=params)
        bspecs = input_specs(cfg, shape)
        bsh = batch_shardings(bspecs, mesh, rules)
        clen = cache_len(cfg, shape.seq_len)
        step = model.prefill
        args, shardings = (bspecs, clen), (params_sh, bsh)
    else:  # decode
        params = _module_params(model)
        params_sh = make_shardings(model.axes(), mesh, rules=rules,
                                   shapes_tree=params)
        specs = input_specs(cfg, shape)
        cache, tokens = specs["cache"], specs["tokens"]
        cache_sh = make_shardings(model.cache_axes(), mesh, rules=rules,
                                  shapes_tree=cache)
        tok_sh = make_shardings({"tokens": BATCH_AXES["tokens"]}, mesh,
                                rules=rules,
                                shapes_tree={"tokens": tokens})["tokens"]
        step = model.decode_step
        args, shardings = (cache, tokens), (params_sh, cache_sh, tok_sh)
        meta["cache_bytes_global"] = _global_bytes(cache)

    return CellPlan(cfg=cfg, shape=shape, mesh=mesh, kind=shape.kind,
                    model=model, step=step, args=args, shardings=shardings,
                    params=params, params_sh=params_sh, rules=rules,
                    meta=meta, parts=parts)


def _arguments(plan: CellPlan) -> list[tuple[torch.Tensor, Any]]:
    """The step's argument leaves with their shardings, in a fixed order:
    state + batch (train), params + batch (prefill), params + cache +
    tokens (decode)."""
    if plan.kind == "train":
        trees = list(zip(plan.args, plan.shardings))
    else:
        trees = [(plan.params, plan.params_sh)] + list(zip(
            plan.args[:1] if plan.kind == "prefill" else plan.args,
            plan.shardings[1:]))
    return [p for tree, shs in trees for p in _pairs(tree, shs)]


def used_arguments(plan: CellPlan, cost: StepCost) -> list[bool]:
    """Per argument leaf (:func:`_arguments`' order), whether the step its
    count ``cost`` ran (:func:`count_cell`, at the global microbatch)
    read it. A serving step reads the unembedding through its f32 copy,
    made before the count: counted as read."""
    read = set(cost.read)
    if plan.kind != "train":
        read.add(_key(plan.params[_unembed_name(plan)]))
    return [_key(t) in read for t, _ in _arguments(plan)]


def argument_bytes(plan: CellPlan, used: list[bool]) -> int:
    """One rank's bytes of the step's arguments that it reads (``used``,
    from :func:`used_arguments` on this cell, on any mesh)."""
    return sum(rank_bytes(t, sh)
               for (t, sh), u in zip(_arguments(plan), used) if u)


def _micro(batch: dict, rows: int) -> dict:
    """The first ``rows`` rows of a batch of meta tensors."""
    return {k: v[:rows] for k, v in batch.items()}


def _resize(plan: CellPlan, rows: int) -> tuple:
    """The step's arguments at ``rows`` sequences (the batch's rows, or a
    decode cache of that many rows)."""
    if rows == plan.shape.global_batch:
        return plan.args
    if plan.kind == "train":
        return plan.args[0], _micro(plan.args[1], rows)
    if plan.kind == "prefill":
        return _micro(plan.args[0], rows), plan.args[1]
    cache, tokens = plan.args
    clen = cache_len(plan.cfg, plan.shape.seq_len)
    return plan.model.abstract_cache(rows, clen), tokens[:rows]


def rank_batch(plan: CellPlan) -> int:
    """Sequences of one microbatch on one rank: the global microbatch over
    the data-parallel ranks that split it (none where they do not divide
    it, as the sharding falls back to replication)."""
    shape = (plan.shape.global_batch // plan.meta["ga"], 1)
    sh = make_shardings({"tokens": BATCH_AXES["tokens"]}, plan.mesh,
                        rules=plan.rules, shapes_tree={"tokens": shape})
    return sh["tokens"].shard_shape(shape)[0]


def count_cell(plan: CellPlan, rows: int) -> StepCost:
    """Count the cell's whole step with microbatches of ``rows`` sequences.
    A train step of ``ga`` > 1 microbatches is counted in its parts
    (``make_train_parts``): the accumulators and the update once, one
    microbatch ``ga`` times; its peak is the accumulators' bytes plus the
    larger of the microbatch's and the update's peaks. A serving step's f32
    unembedding copy is made first, outside the count: it is resident
    state, not the step's."""
    if plan.kind != "train":
        plan.model.unembed_f32()
        return count_step(plan.step, *_resize(plan, rows))
    ga = plan.meta["ga"]
    state, batch = _resize(plan, rows)
    if ga == 1:
        return count_step(plan.step, state, batch)
    init, micro, update = plan.parts
    acc = init(state["params"])  # meta tensors: nothing is allocated
    counted = ((count_step(init, state["params"]), 1),
               (count_step(micro, state["params"], batch, acc), ga),
               (count_step(update, state, acc), 1))
    out = StepCost()
    for c, n in counted:
        out.flops += n * c.flops
        out.hbm_bytes += n * c.hbm_bytes
        out.hbm_bytes_kernelized += n * c.hbm_bytes_kernelized
        out.ops += n * c.ops
        for k, v in c.regions.items():
            out.regions[k] = out.regions.get(k, 0) + n * v
        for k, v in c.region_flops_by.items():
            out.region_flops_by[k] = out.region_flops_by.get(k, 0.0) + n * v
        out.read |= c.read
    acc_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(acc[0]) + tree_leaves(acc[1]))
    out.peak_bytes = acc_bytes + max(c.peak_bytes for c, _ in counted[1:])
    out.output_bytes = counted[2][0].output_bytes
    return out


def resident_bytes(plan: CellPlan) -> int:
    """One rank's bytes of the f32 unembedding copy a serving step keeps
    (none in training, whose loss multiplies by the weight itself)."""
    if plan.kind == "train":
        return 0
    name = _unembed_name(plan)
    return math.prod(plan.params_sh[name].shard_shape(
        plan.params[name].shape)) * 4


def _unembed_name(plan: CellPlan) -> str:
    """The parameter ``LMBase.unembed_f32`` copies: the tied embedding
    where there is no ``unembed``."""
    return "unembed" if "unembed" in plan.params else "embed"


def _axes(entry) -> tuple:
    """The mesh axes of one entry of a partition spec."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _vocab_on_model(plan: CellPlan, name: str) -> bool:
    """Whether the vocab dim of the embedding or unembedding ``name``
    (``embed`` (Vp, D), ``unembed`` (D, Vp)) is sharded over a model axis
    of more than one rank."""
    spec = tuple(plan.params_sh[name].spec)
    spec += (None,) * (2 - len(spec))
    entry = spec[0] if name == "embed" else spec[-1]
    return plan.mesh.shape.get("model", 1) > 1 and "model" in _axes(entry)


def _block_sites(cfg: ModelConfig, kind: str):
    """The ``psum_tp``/``pmean_tp`` sites of one pass over the layers, as
    (act, stat) counts: the forward, the recompute and the backward (module
    docstring)."""
    n = cfg.num_layers
    if cfg.is_encoder_decoder:  # decoder 3 a layer, encoder 2
        fwd = ((3 + 2 * (kind != "decode")) * n, 0)
        return fwd, fwd, fwd
    if cfg.family == "ssm":
        return (n, n), (0, n), (n, n)
    if cfg.family == "hybrid":
        g = n // cfg.attn_every
        return (2 * g + n, n), (g + n, n), (2 * g + n, n)
    return (2 * n, 0), (n, 0), (2 * n, 0)


def collective_terms(plan: CellPlan, rows: int
                     ) -> list[tuple[str, str, str, float, int]]:
    """The collectives one rank issues in one step, by the formula of the
    module docstring, as (kind, mesh axis, what, bytes, count) terms;
    ``rows`` is the per-rank microbatch."""
    cfg, mesh, kind = plan.cfg, plan.mesh, plan.kind
    train = kind == "train"
    ga = plan.meta["ga"] if train else 1
    data_axes = [a for a in ("pod", "data") if a in mesh.shape]
    dp = math.prod(mesh.shape[a] for a in data_axes)
    terms: list[tuple[str, str, str, float, int]] = []

    def add(k, axis, what, nbytes, n):
        if nbytes:
            terms.append((k, axis, what, float(nbytes), n))

    tp_sharded = False
    for w, sh in _pairs(plan.params, plan.params_sh):
        axes = [a for e in sh.spec for a in _axes(e)]
        tp_sharded |= "model" in axes and mesh.shape.get("model", 1) > 1
        local = math.prod(sh.shard_shape(w.shape)) * w.element_size()
        fsdp = math.prod(mesh.shape[a] for a in axes if a in data_axes)
        gathers = 2 * ga if train else 1  # train: forward and recompute
        if fsdp > 1:
            add("all-gather", "data", "weights (FSDP)", gathers * local,
                gathers)
        if train and fsdp > 1:
            add("reduce-scatter", "data", "gradients", ga * local * fsdp, ga)
        elif train and dp > 1:
            add("all-reduce", "data", "gradients", ga * local, ga)
    if not tp_sharded:
        return terms
    seq = 1 if kind == "decode" else plan.shape.seq_len + frontend_len(cfg)
    act = rows * seq * cfg.d_model * getattr(torch, cfg.dtype).itemsize
    stat = rows * seq * 4
    passes = zip(("forward", "recompute", "backward"),
                 _block_sites(cfg, kind)[:3 if train else 1])
    for what, (acts, stats) in passes:
        add("all-reduce", "model", f"block sites ({what})",
            ga * (acts * act + stats * stat), ga * (acts + stats))
    if _vocab_on_model(plan, "embed"):
        add("all-reduce", "model", "embedding rows", ga * act, ga)
    unembed = _unembed_name(plan)
    if not _vocab_on_model(plan, unembed):
        return terms
    if train:
        add("all-reduce", "model", "unembedding input gradient", ga * act,
            ga)
        add("all-reduce", "model", "cross-entropy statistics",
            ga * 5 * rows * plan.shape.seq_len * 4, 5 * ga)
    else:
        vp = plan.params[unembed].shape[0 if unembed == "embed" else -1]
        add("all-gather", "model", "logits",
            rows * vp // mesh.shape["model"] * 4, 1)
    return terms


def collectives(plan: CellPlan, rows: int) -> tuple[dict[str, float], int]:
    """(bytes by kind, count) one rank issues in one step
    (:func:`collective_terms` summed by kind)."""
    out: dict[str, float] = {}
    count = 0
    for kind, _, _, nbytes, n in collective_terms(plan, rows):
        out[kind] = out.get(kind, 0.0) + nbytes
        count += n
    return out, count
