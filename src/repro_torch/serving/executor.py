"""Device-side model executor for the paged serving engine.

This is the COMPUTE half of the scheduler/executor split: it owns the model
on its device and runs one fused model step + sampling per engine step,
eagerly (no CUDA graphs yet). ``step`` routes each
:class:`~repro_torch.serving.scheduler.StepPlan` down one of three
dispatches, each ending in its own paged-attention kernel on the card:

* decode-only (steady state)        -> ``decode_step_paged``  -> decode kernel
* chunk-only (cold start, refill)   -> ``prefill_chunk``      -> prefill kernel
* decode + chunk (fused)            -> ``mixed_step_paged``   -> mixed kernel

and ``verify`` scores one speculation bundle (the last committed token + k
drafts of one sequence) in one more dispatch: ``verify_step_paged`` -> the
prefill kernel, every row sampled with its own ``(seed, index)`` key.

Without chunking (``prefill_chunk=None``, and always for vlm),
``prefill_whole`` prefills each admitted prompt in one executor call
instead: ``DecoderLM.prefill`` over the prompt padded to a power-of-two
bucket (through the flash kernel; a vlm prompt after its
``num_frontend_tokens`` zero vision embeddings, which count toward the
context), the dense K/V scattered into the sequence's pages (quantized,
scales alongside, for an int8 pool: ``write_prefill_pages`` takes the
whole pool dict), and the first token sampled.

The dense, moe and vlm families run here; moe's decode and fused mixed
rows take the reference's dense all-experts path and its chunks and verify
bundles the capacity dispatch (``models/moe.py``), so its streams in the
two step modes may part where a chunk drops a token, as JAX's do.

The decode batch lives on the device PACKED into one int32 tensor ``di``
(S, MP+6) and one f32 tensor ``df`` (S, 2), refreshed only when the
scheduler reports a composition change; each step advances them on the
device (lengths and sample indices stepped, sampled tokens written back), so
the steady-state loop transfers nothing to the device.

Tensor parallelism (the JAX package's ``shard_map`` executor): the
executor runs on a 1-D ``("model",)`` mesh of ranks (``parallel/group.py``),
Megatron-style:

* attention q/kv heads, MLP ff, SSM heads and (untied) unembed columns are
  sharded over ``"model"``; each rank holds its slice of the weights
  (``Sharding.shard``) and the model code reduces with ``psum_tp`` /
  ``pmean_tp`` and gathers the vocab-sharded logits with
  ``all_gather_logits`` (identities outside a ``tensor_parallel``
  context); the token embedding stays whole on every rank;
* each rank's page pool holds its ``KVH / tp`` heads (``PAGE_SPEC``; int8
  scales shard the same head dim, ``SCALE_SPEC``), so page ids and block
  tables mean the same on every rank and the block tables, refcounts and
  the prefix index stay single host-side structures on rank 0;
* rank 0 (the caller's process) packs each call's host arrays and sends
  them, with the pool operations queued since the last call (the
  copy-on-write page copies), to the followers in ONE message
  (``RankGroup.broadcast``); every rank then runs the same step on its
  shard and samples from the same full logits with the same ``(seed,
  index)`` keys, so the packed ``di``/``df`` mirrors advance identically
  everywhere. Rank 0's tokens are the result: the scheduler never sees the
  mesh;
* the KV tiers live on rank 0 only and see whole pages: a spill reads a
  list of pages from every rank in one round trip (the followers first
  apply the queued pool operations, so a page copied on write and spilled
  before the next call reads fresh) and concatenates the ranks' heads; a
  reload writes rank 0's heads at once and queues the whole page for the
  followers (``write_page``), each of which takes its own heads before
  the next call.

The mesh is chosen as in the JAX package: the largest count of local cards
that divides the model's effective kv heads, q heads, ff width (SSM heads
and ``d_inner``; the padded vocab when the unembedding is untied) —
``pick_tp`` — so one card, or the CPU, is tp 1, which runs today's code
and starts no process. Pass ``mesh=`` explicitly, or set a process default
with :func:`set_default_serving_mesh` / :func:`serving_mesh_scope` (what
``launch/serve.py --mesh`` uses); the public engine signatures stay
mesh-free. A mesh the executor made itself is its own and closes with
it; a mesh the caller passed or set stays open for the next engine.
"""

from __future__ import annotations

import itertools
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import build_model, frontend_len
from repro_torch.models.common import (flatten_tree, pick_tokens,
                                       resolve_device)
from repro_torch.models.lm import DecoderLM, padded_vocab
from repro_torch.parallel.axes import P, Sharding, logical_to_spec
from repro_torch.parallel.collectives import tensor_parallel
from repro_torch.parallel.group import Mesh
from repro_torch.serving.kv_cache import (PagedKVCache, _copy_page,
                                          _read_block, _write_page,
                                          write_prefill_pages)
from repro_torch.serving.scheduler import (DecodeInputs, PrefillChunk,
                                          SpecBundle, StepPlan)

__all__ = [
    "ModelExecutor",
    "PAGE_SPEC",
    "SCALE_SPEC",
    "default_serving_mesh",
    "pick_tp",
    "place_serving_params",
    "serving_mesh_scope",
    "set_default_serving_mesh",
    "validate_serving_mesh",
]

# (L, P, page, KVH, Dh): only the head dim is sharded, so page ids and
# block-table entries mean the same thing on every rank
PAGE_SPEC = P(None, None, None, "model", None)
# int8 pools carry per-page-per-head scale arrays (L, P, page, KVH) — same
# head sharding, no Dh axis
SCALE_SPEC = P(None, None, None, "model")

_DEFAULT_MESH: Mesh | None = None


def set_default_serving_mesh(mesh: Mesh | None) -> None:
    """Process-wide default mesh for engines built without an explicit one
    (``launch/serve.py --mesh``). ``None`` restores auto-selection."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


@contextmanager
def serving_mesh_scope(mesh: Mesh | None):
    """Temporarily pin the default serving mesh (tests: force a one-rank
    mesh next to the sharded one and compare outputs)."""
    global _DEFAULT_MESH
    prev = _DEFAULT_MESH
    _DEFAULT_MESH = mesh
    try:
        yield
    finally:
        _DEFAULT_MESH = prev


def _tp_dims(cfg) -> list[int]:
    """Tensor dims the mesh size must divide for this config."""
    # pure-SSM configs carry default head fields no layer ever uses —
    # only constrain on attention dims when attention layers exist
    dims = [] if cfg.family == "ssm" else [cfg.eff_kv_heads, cfg.eff_heads]
    if cfg.ssm_state:
        # SSM/hybrid: d_inner is ff-sharded and the state bank shards on
        # ssm_heads; keep both so pure-SSM configs never vacuously admit
        # any mesh size
        dims += [cfg.ssm_heads, cfg.d_inner]
    if cfg.d_ff:
        dims.append(cfg.d_ff)
    if not cfg.tie_embeddings:
        dims.append(padded_vocab(cfg))
    return [d for d in dims if d]


def pick_tp(cfg, num_devices: int | None = None) -> int:
    """Largest tensor-parallel degree <= the device count (the local
    cards by default) that divides every sharded dim (kv heads bound it in
    practice: pages shard along heads)."""
    n = num_devices if num_devices is not None else torch.cuda.device_count()
    dims = _tp_dims(cfg)
    tp = max(1, n)
    while tp > 1 and any(d % tp for d in dims):
        tp -= 1
    return tp


def resolve_serving_mesh(cfg, device="cuda") -> tuple[Mesh, bool]:
    """``(mesh, owned)``: the default mesh if one is set (the caller's,
    ``owned`` False), else a new one (``owned`` True): over the first
    ``pick_tp(cfg)`` local cards for a CUDA ``device``, one rank on
    ``device`` otherwise."""
    if _DEFAULT_MESH is not None:
        return _DEFAULT_MESH, False
    device = torch.device(device)
    tp = pick_tp(cfg) if device.type == "cuda" else 1
    if tp > 1:
        return make_serving_mesh(tp), True
    return make_serving_mesh(1, devices=[device]), True


def default_serving_mesh(cfg, device="cuda") -> Mesh:
    return resolve_serving_mesh(cfg, device)[0]


def _mesh_tp(mesh: Mesh) -> int:
    return mesh.shape["model"]


def validate_serving_mesh(cfg, mesh: Mesh) -> int:
    """Check ``mesh`` can shard ``cfg`` (every TP dim divisible); returns
    the TP degree. Drivers call this ONCE up front so a bad explicit
    ``--mesh N`` fails fast in the main thread instead of crashing every
    worker as it builds its engine."""
    tp = _mesh_tp(mesh)
    bad = [d for d in _tp_dims(cfg) if d % tp]
    if bad:
        raise ValueError(
            f"serving mesh size {tp} does not divide sharded dims {bad} of "
            f"{cfg.name} (kv_heads={cfg.eff_kv_heads}, "
            f"heads={cfg.eff_heads}, d_ff={cfg.d_ff})"
        )
    return tp


def serving_shardings(cfg, mesh: Mesh, vocab_sharded: bool) -> dict:
    """{state-dict name: :class:`Sharding`} under the serving TP rules."""
    rules = {
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "ssm_heads": "model",
        "vocab": "model" if vocab_sharded else None,
    }
    specs = flatten_tree(DecoderLM(cfg, device="meta").param_specs())
    out = {name: Sharding(mesh, logical_to_spec(spec.axes, rules=rules,
                                                mesh=mesh))
           for name, spec in specs.items()}
    # the token-embedding table is looked up by GLOBAL token id, so it
    # must stay whole even when the (untied) unembedding shards its vocab
    # columns
    out["embed"] = Sharding(mesh, P())
    return out


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` are one card (the default index is 0)."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class RankShards(dict):
    """One rank's slices of a state dict (``{name: tensor}``), marked with
    the mesh and rank they belong to, so an executor on that rank takes
    them as they are."""

    def __init__(self, shards: dict, mesh_id: str, rank: int):
        super().__init__(shards)
        self.mesh_id, self.rank = mesh_id, rank


def _rank_shards(cfg, params: dict, mesh: Mesh, rank: int) -> RankShards:
    """Rank ``rank``'s slices of a full state dict: on its device when it is
    this process's rank, else as shared-memory CPU tensors of their own
    (what a follower's ``build`` message carries)."""
    shardings = serving_shardings(cfg, mesh, not cfg.tie_embeddings)
    if rank == mesh.rank:
        cut = {k: shardings[k].shard(v).contiguous()
               for k, v in params.items()}
    else:
        cut = {}
        for k, v in params.items():
            t = shardings[k].slice_of(v, rank)
            t = t.to("cpu") if t.device.type != "cpu" else t.clone()
            cut[k] = t.contiguous().share_memory_()
    return RankShards(cut, mesh.id, rank)


def place_serving_params(cfg, params: dict, mesh: Mesh | None = None
                         ) -> dict[int, dict]:
    """Cut a state dict into every rank's slices ONCE, up front (engines
    built from the result share them): ``{rank: RankShards}``, rank 0's
    on its device, the followers' as shared-memory CPU tensors; at tp 1,
    ``{0: params}``."""
    mesh = mesh if mesh is not None else default_serving_mesh(cfg)
    tp = validate_serving_mesh(cfg, mesh)
    if tp == 1:
        return {0: params}
    return {r: _rank_shards(cfg, params, mesh, r) for r in range(tp)}


class ShardedExecutor:
    """What the paged and SSM executors share for tensor parallelism: the
    mesh, this rank's weights, the followers' build, the one-message call
    (:meth:`_run`), the queued pool operations (``_ops``) and
    :meth:`close`."""

    _xids = itertools.count()

    def _init_mesh(self, cfg, device, mesh: Mesh | None, own_mesh: bool):
        if mesh is None:
            mesh, own_mesh = resolve_serving_mesh(cfg, device)
        self.mesh = mesh
        self.own_mesh = own_mesh
        self.tp = validate_serving_mesh(cfg, mesh)
        device = resolve_device(device)
        if not _same_device(mesh.device, device):
            raise ValueError(f"executor on {device}, but rank {mesh.rank} of "
                             f"{mesh!r} runs on {mesh.device}")
        self.vocab_sharded = (not cfg.tie_embeddings) and self.tp > 1
        self.leader = self.tp > 1 and mesh.rank == 0
        # pool / bank operations since the last call, for the followers
        self._ops: list[tuple] = []
        self._xid: str | None = None
        self.closed = False
        # per follower rank, read when the executor closes: its kernel
        # launches and its shard shapes (rank_info)
        self.follower_launches: dict[int, dict[str, int]] = {}
        self.follower_info: dict[int, dict] = {}
        self.stats = {"calls": 0, "broadcast_bytes": 0}

    def _local_params(self, params: dict) -> dict:
        """This rank's weights: the full ``params`` at tp 1, else this
        rank's slices (cut here unless ``params`` already holds them)."""
        if set(params) == set(range(self.tp)):  # place_serving_params'
            params = params[self.mesh.rank]
        if self.tp == 1:
            return params
        if isinstance(params, RankShards):
            if (params.mesh_id, params.rank) != (self.mesh.id, self.mesh.rank):
                raise ValueError("weights cut for another rank or mesh")
            return params
        return _rank_shards(self.cfg, params, self.mesh, self.mesh.rank)

    def _start_followers(self, params: dict, factory, kwargs: dict) -> None:
        """Rank 0: have every follower build its executor over its weight
        slices (``factory(mesh=..., params=..., **kwargs)``)."""
        if not self.leader:
            return
        shards = params if set(params) == set(range(self.tp)) else {
            r: _rank_shards(self.cfg, params, self.mesh, r)
            for r in range(1, self.tp)}
        self._xid = f"x{next(self._xids)}"
        self.mesh.group.build(self._xid, factory, {
            r: dict(kwargs, params=shards[r]) for r in range(1, self.tp)})

    def _send(self, kind: str, method: str, args: tuple) -> None:
        """Under the group's lock: one message to every follower, carrying
        the pool operations queued since the last one (in order) and
        ``method(*args)``; its bytes count in ``broadcast_bytes``."""
        ops = list(self._ops)
        self._ops.clear()
        self.stats["broadcast_bytes"] += self.mesh.group.broadcast(
            (kind, self._xid, ops, method, args))

    def _run(self, method: str, *args):
        """One executor call on every rank: rank 0 sends ``(queued pool
        operations, method, args)`` to the followers in one message, then
        runs ``method(*args)`` itself under the tensor-parallel context.
        ``args`` are host values (numpy arrays, numbers). At tp 1: the plain
        call."""
        if self.closed:
            raise RuntimeError("executor is closed")
        if not self.leader:
            return getattr(self, method)(*args)
        group = self.mesh.group
        with group.lock:
            self.stats["calls"] += 1
            self._send("call", method, args)
            try:
                with tensor_parallel(group.comm,
                                     vocab_sharded=self.vocab_sharded):
                    return getattr(self, method)(*args)
            except Exception:
                group.fail_if_dead()
                raise

    def run_call(self, ops: list, method: str, args: tuple) -> None:
        """A follower's side of :meth:`_run`: replay rank 0's pool
        operations in order, then the same step on this rank's shard."""
        self._replay(ops)
        with tensor_parallel(self.mesh.comm, vocab_sharded=self.vocab_sharded):
            getattr(self, method)(*args)

    def run_query(self, ops: list, method: str, args: tuple):
        """A follower's side of :meth:`on_every_rank`: replay rank 0's pool
        operations in order, then ``method(*args)`` (no collective)."""
        self._replay(ops)
        return getattr(self, method)(*args)

    def on_every_rank(self, method: str, *args) -> list:
        """``method(*args)`` on this executor and on its counterpart on
        every follower, results in rank order, in one round trip; the
        followers first apply the queued pool operations. State reads: the
        tiers' whole pages (:meth:`read_pages`), and for tests and tools
        :meth:`rank_info` and :meth:`page_contents`."""
        if not self.leader:
            return [getattr(self, method)(*args)]
        if self.closed:
            raise RuntimeError("executor is closed")
        mine = getattr(self, method)(*args)
        group = self.mesh.group
        with group.lock:
            self._send("query", method, args)
            theirs = group.gather()
        return [mine] + [theirs[r][1] for r in sorted(theirs)]

    def page_contents(self, pages: list[int]) -> dict[str, torch.Tensor]:
        """Host copies of physical ``pages`` of this rank's pool (all
        layers, this rank's heads)."""
        idx = torch.tensor(pages, device=self.device)
        return {k: v.index_select(1, idx).cpu()
                for k, v in self.cache.pages.items()}

    def rank_info(self) -> dict:
        """This rank's shard shapes: the page pool, the state bank (SSM),
        and every weight."""
        info = {"params": {k: tuple(v.shape) for k, v in self.params.items()}}
        if getattr(self, "cache", None) is not None:
            info["pages"] = {k: tuple(v.shape)
                             for k, v in self.cache.pages.items()}
        if getattr(self, "bank", None) is not None:
            info["bank"] = {k: tuple(v.shape)
                            for k, v in self.bank.state.items()}
        return info

    # ------------------------------------------------------------------
    # whole pages for the KV tiers (rank 0 owns them; tp > 1)
    # ------------------------------------------------------------------
    def read_pages(self, pages: list[int]) -> list[dict[str, np.ndarray]]:
        """This rank's heads of physical ``pages``: host blocks of the
        pool's own widths, (L, page, KVH / tp, Dh) and int8 scales (L,
        page, KVH / tp)."""
        return [{k: _read_block(arr, p) for k, arr in self.cache.pages.items()}
                for p in pages]

    def _gather_pages(self, pages: list[int]) -> list[dict[str, np.ndarray]]:
        """Whole pages: every rank's :meth:`read_pages` in one round trip,
        concatenated in rank order on the head axis (axis 2 of every
        block), as a tp-1 pool would hold them."""
        ranks = self.on_every_rank("read_pages", pages)
        return [{k: np.concatenate([r[i][k] for r in ranks], axis=2)
                 for k in ranks[0][i]} for i in range(len(pages))]

    def write_page(self, page: int, arrays: dict[str, np.ndarray]) -> None:
        """Write this rank's heads of a whole page (every rank's heads on
        axis 2 of each block) into physical ``page``, bit for bit."""
        rank = self.mesh.rank
        for k, arr in self.cache.pages.items():
            n = arr.shape[3]
            _write_page(arr, page, arrays[k][:, :, rank * n:(rank + 1) * n])

    def _scatter_page(self, page: int, arrays: dict[str, np.ndarray]) -> None:
        """A reload: rank 0's heads now, the followers' when they replay
        the queued ``write_page`` before the next call."""
        self.write_page(page, arrays)
        self._ops.append(("write_page", page, arrays))

    def _replay(self, ops: list) -> None:
        for op in ops:
            if op[0] == "copy_page":
                _copy_page(self.cache.pages, op[1], op[2])
            elif op[0] == "write_page":
                self.write_page(op[1], op[2])
            else:
                raise ValueError(f"unknown pool operation {op[0]!r}")

    def close(self) -> None:
        """Release this executor on every follower (their launch counts land
        in ``follower_launches``), and end the followers when the mesh is
        this executor's own. Idempotent; a no-op at tp 1."""
        if self.closed:
            return
        self.closed = True
        if self.leader and self._xid is not None and self.mesh.started:
            try:
                for r, (counts, info) in self.mesh.group.drop(
                        self._xid).items():
                    self.follower_launches[r] = counts
                    self.follower_info[r] = info
            finally:
                if self.own_mesh:
                    self.mesh.close()
        elif self.own_mesh:
            self.mesh.close()


def _follower_executor(*, mesh: Mesh, cfg, params, cache_kw: dict,
                       max_len: int, attn_impl: str | None):
    """A follower's :class:`ModelExecutor`: its own page pool (``KVH/tp``
    heads, no tiers) and its weight slices, on its device."""
    cache = PagedKVCache(**cache_kw, device=mesh.device)
    return ModelExecutor(cfg, params, cache, max_len=max_len,
                         device=mesh.device, attn_impl=attn_impl, mesh=mesh)


class ModelExecutor(ShardedExecutor):
    """Owns the model (this rank's weights), the device mirrors of the
    decode batch, and the step dispatches. Stateless with respect to
    scheduling: it executes
    :class:`~repro_torch.serving.scheduler.PrefillChunk` /
    :class:`~repro_torch.serving.scheduler.DecodeInputs` work items.

    Each public call packs its host arrays and runs through
    :meth:`_run` (every rank of the mesh, one message to the followers);
    the underscored method it names is the device side. ``cache`` holds
    ``KVH / tp`` heads. ``params`` is the full state dict (or
    :func:`place_serving_params`' cut of it); at tp > 1 the executor keeps
    this rank's slices and ships the followers theirs."""

    def __init__(self, cfg, params, cache, *, max_len: int, device="cuda",
                 attn_impl: str | None = None, mesh: Mesh | None = None,
                 own_mesh: bool = False):
        self.cfg = cfg
        self._init_mesh(cfg, device, mesh, own_mesh)
        kvh = cache.pages["k"].shape[3]
        if kvh * self.tp != cfg.eff_kv_heads:
            raise ValueError(f"page pool of {kvh} kv heads for tp {self.tp} "
                             f"of {cfg.eff_kv_heads}")
        self.model = build_model(cfg, params=self._local_params(params),
                                 device=device, attn_impl=attn_impl or "auto")
        self.device = self.model.device
        self.params = self.model.state_dict()
        self.cache = cache
        self.max_len = max_len
        # vlm: the vision positions ahead of every prompt
        self.nf = frontend_len(cfg)
        # device mirrors of the last decode batch (see module docstring)
        self._greedy_only = True
        self._di: torch.Tensor | None = None
        self._df: torch.Tensor | None = None
        if self.leader:
            cache.replay = self._ops
            cache.gather_pages = self._gather_pages
            cache.scatter_page = self._scatter_page
            self._start_followers(params, _follower_executor, dict(
                cfg=cfg, max_len=max_len, attn_impl=attn_impl,
                cache_kw=dict(
                    num_layers=cache.pages["k"].shape[0], num_kv_heads=kvh,
                    head_dim=cache.pages["k"].shape[4],
                    dtype=getattr(torch, cfg.dtype),
                    max_slots=cache.max_slots,
                    max_context=cache.max_pages_per_seq * cache.page_size,
                    page_size=cache.page_size, num_pages=cache.num_pages,
                    quant=cache.quant)))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never an alias: ``.to('cpu')`` of a
        ``from_numpy`` tensor would keep sharing the numpy buffer)."""
        return torch.from_numpy(arr.copy()).to(self.device)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    # Packed decode batch ``di`` (S, MP+6) int32: block table row, then
    # _DI_COLS columns [lens, active, tokens, top_ks, seeds, idx]; ``df``
    # (S, 2) f32: [temps, top_ps].
    _DI_COLS = 6

    def _advance(self, toks: torch.Tensor) -> None:
        """Step the packed batch on the device after a decode-bearing step:
        lengths and sample indices advance on active rows, the sampled
        tokens become next step's inputs."""
        di = self._di
        mp = di.shape[1] - self._DI_COLS
        active = di[:, mp + 1]
        di[:, mp] += active
        di[:, mp + 2] = toks
        di[:, mp + 5] += active

    def _pack_decode(self, inputs: DecodeInputs) -> tuple:
        """A freshly assembled decode batch as host arrays: ``(di, df,
        greedy_only)``."""
        bt = inputs.block_tables
        s, mp = bt.shape
        di = np.empty((s, mp + self._DI_COLS), np.int32)
        di[:, :mp] = bt
        di[:, mp] = inputs.lengths
        di[:, mp + 1] = inputs.active
        di[:, mp + 2] = inputs.tokens[:, 0]
        di[:, mp + 3] = inputs.top_ks
        di[:, mp + 4] = inputs.seeds
        di[:, mp + 5] = inputs.idx
        df = np.stack([inputs.temps, inputs.top_ps], axis=1).astype(np.float32)
        return di, df, inputs.greedy_only

    def refresh(self, inputs: DecodeInputs) -> None:
        """Mirror a freshly assembled decode batch to the device (two
        transfers: the packed int32 batch and the packed f32 sampling
        params)."""
        self._run("_refresh", *self._pack_decode(inputs))

    def _refresh(self, di: np.ndarray, df: np.ndarray,
                 greedy_only: bool) -> None:
        self._greedy_only = greedy_only
        self._di = self._to_device(di)
        self._df = self._to_device(df)

    def _decode_columns(self):
        di, mp = self._di, self._di.shape[1] - self._DI_COLS
        return (di[:, :mp].contiguous(), di[:, mp].contiguous(),
                di[:, mp + 1], mp)

    def decode(self, inputs: DecodeInputs | None = None) -> np.ndarray:
        """Run one decode step. ``inputs`` refreshes the device mirrors
        (admission/eviction/page growth); None reuses last step's device
        state. Returns the sampled token per slot, (S,) int32 on the host."""
        return self._run("_decode", None if inputs is None
                         else self._pack_decode(inputs))

    def _decode(self, batch: tuple | None) -> np.ndarray:
        if batch is not None:
            self._refresh(*batch)
        bt, lens, _, mp = self._decode_columns()
        di, df = self._di, self._df
        logits = self.model.decode_step_paged(
            self.cache.pages, bt, lens, di[:, mp + 2:mp + 3])
        toks = pick_tokens(logits, df[:, 0], di[:, mp + 3], df[:, 1],
                           di[:, mp + 4], di[:, mp + 5], self.cfg.vocab_size,
                           self._greedy_only)
        self._advance(toks)
        return toks.cpu().numpy()

    # ------------------------------------------------------------------
    # fused mixed step (decode batch + one prefill chunk, one dispatch)
    # ------------------------------------------------------------------
    def _pack_chunk(self, chunk) -> tuple[np.ndarray, np.ndarray]:
        """Pack one prefill chunk's host state into two arrays:
        ``ci`` (MP+C+4,) int32 = [block-table row | padded tokens | start,
        valid, top_k, seed] and ``cf`` (2,) f32 = [temperature, top_p]."""
        sp = chunk.seq.request.sampling
        row = self.cache.block_tables[chunk.slot]
        mp, c = row.shape[0], chunk.tokens.shape[0]
        ci = np.empty(mp + c + 4, np.int32)
        ci[:mp] = row
        ci[mp:mp + c] = chunk.tokens
        ci[mp + c:] = (chunk.start, chunk.valid, sp.top_k,
                       chunk.seq.handle.seed)
        cf = np.array([sp.temperature, sp.top_p], np.float32)
        return ci, cf

    def _mixed(self, batch: tuple | None, ci: np.ndarray, cf: np.ndarray,
               chunk_greedy: bool) -> np.ndarray:
        """ONE model step for every decode slot AND one prefill chunk:
        S + C single-token rows. Decode rows keep their exact decode
        semantics (same device-mirror feedback); the chunk contributes C
        rows sharing its slot's block-table row and one extra sampled
        token at index 0, meaningful only on the prompt's final chunk.
        Returns the S decode tokens and the chunk's, (S+1,) on the host."""
        if batch is not None:
            self._refresh(*batch)
        greedy_only = self._greedy_only and chunk_greedy
        ci, cf = self._to_device(ci), self._to_device(cf)
        bt, lens, active, mp = self._decode_columns()
        di, df = self._di, self._df
        s = di.shape[0]
        c = ci.shape[0] - mp - 4
        crow, ctoks = ci[:mp], ci[mp:mp + c]
        cstart, cvalid = ci[mp + c], ci[mp + c + 1]
        # rows [0,S): decode slots at position = length (-1 when idle);
        # rows [S,S+C): the chunk at start+i (-1 past valid)
        cidx = torch.arange(c, dtype=torch.int32, device=self.device)
        positions = torch.cat([
            torch.where(active == 1, lens, -1),
            torch.where(cidx < cvalid, cstart + cidx, -1),
        ])
        tables = torch.cat([bt, crow[None, :].expand(c, mp)])
        logits = self.model.mixed_step_paged(
            self.cache.pages, tables, positions,
            torch.cat([di[:, mp + 2:mp + 3], ctoks[:, None]]),
            num_decode=s, chunk_valid=cvalid,
        )  # (S+1, Vp): decode rows + the chunk's row
        zero = torch.zeros((1,), dtype=torch.int32, device=self.device)
        toks = pick_tokens(
            logits,
            torch.cat([df[:, 0], cf[0:1]]),
            torch.cat([di[:, mp + 3], ci[mp + c + 2:mp + c + 3]]),
            torch.cat([df[:, 1], cf[1:2]]),
            torch.cat([di[:, mp + 4], ci[mp + c + 3:mp + c + 4]]),
            torch.cat([di[:, mp + 5], zero]),
            self.cfg.vocab_size,
            greedy_only,
        )
        self._advance(toks[:s])
        return toks.cpu().numpy()

    def step(self, plan: StepPlan) -> tuple[np.ndarray | None, int | None]:
        """Execute one step plan. Returns ``(decode_toks, chunk_tok)``:
        the sampled token per slot ((S,) int32 on the host, None when the
        plan had no decode rows) and the chunk's sampled first token (None
        when the plan had no chunk; meaningful only on a final chunk).

        Degenerate plans route to the specialized dispatches — chunk-only
        runs the chunk kernel without S dead decode rows, decode-only runs
        the decode step with its zero-transfer device mirrors."""
        chunk = plan.chunk
        if not plan.decode_slots:
            ctok = self.prefill_chunk(chunk) if chunk is not None else None
            return None, ctok
        if chunk is None:
            return self.decode(plan.decode), None
        batch = None if plan.decode is None else self._pack_decode(plan.decode)
        sp = chunk.seq.request.sampling
        host = self._run("_mixed", batch, *self._pack_chunk(chunk),
                         sp.temperature <= 0.0)
        return host[:-1], int(host[-1])

    # ------------------------------------------------------------------
    # speculative verify (one bundle = one dispatch)
    # ------------------------------------------------------------------
    def verify(self, bundle: SpecBundle) -> np.ndarray:
        """Dispatch one speculation bundle: the verify forward (a k+1-row
        chunk over the slot's own block table, its K/V written in place)
        and per-row sampling. Row j samples with the request's ``(seed,
        idx0 + j)`` key, the key a sequential decode loop uses for token
        index ``idx0 + j``, so where the drafted prefix matches what
        sequential decoding would produce the samples match too (greedy
        rows are an argmax). Returns the sampled token per bundle row, (W,)
        int32 on the host; rows past ``valid`` are garbage the engine
        ignores. The decode mirrors are untouched: the scheduler re-dirties
        the slot, so the next decode-bearing step refreshes them."""
        sp = bundle.seq.request.sampling
        row = self.cache.block_tables[bundle.slot]
        mp, w = row.shape[0], bundle.tokens.shape[0]
        # one transfer: [block-table row | padded tokens | start, valid,
        # top_k, seed, idx0]
        vi = np.empty(mp + w + 5, np.int32)
        vi[:mp] = row
        vi[mp:mp + w] = bundle.tokens
        vi[mp + w:] = (bundle.start, bundle.valid, sp.top_k,
                       bundle.seq.handle.seed, len(bundle.seq.tokens))
        return self._run("_verify", vi, w, float(sp.temperature),
                         float(sp.top_p))

    def _verify(self, vi: np.ndarray, w: int, temperature: float,
                top_p: float) -> np.ndarray:
        mp = vi.shape[0] - w - 5
        vi = self._to_device(vi)
        logits = self.model.verify_step_paged(
            self.cache.pages, vi[:mp], vi[mp:mp + w], vi[mp + w],
            vi[mp + w + 1])  # (W, Vp): row j scores token index idx0 + j
        ones = torch.ones((w,), dtype=torch.float32, device=self.device)
        toks = pick_tokens(
            logits, ones * temperature, vi[mp + w + 2].expand(w),
            ones * top_p, vi[mp + w + 3].expand(w),
            vi[mp + w + 4] + torch.arange(w, dtype=torch.int32,
                                          device=self.device),
            self.cfg.vocab_size, temperature <= 0.0)
        return toks.cpu().numpy()

    # ------------------------------------------------------------------
    # chunked prefill
    # ------------------------------------------------------------------
    def prefill_chunk(self, work: PrefillChunk) -> int:
        """Dispatch one chunk (model step + page writes + sample); returns
        the sampled first token (meaningful only when this was the prompt's
        final chunk)."""
        return self._run("_chunk", *self._pack_chunk(work),
                         work.seq.request.sampling.temperature <= 0.0)

    def _chunk(self, ci: np.ndarray, cf: np.ndarray, greedy: bool) -> int:
        ci, cf = self._to_device(ci), self._to_device(cf)
        mp = self.cache.block_tables.shape[1]
        c = ci.shape[0] - mp - 4
        logits = self.model.prefill_chunk(
            self.cache.pages, ci[:mp], ci[mp:mp + c], ci[mp + c],
            ci[mp + c + 1])
        tok = pick_tokens(
            logits[None], cf[0:1], ci[mp + c + 2:mp + c + 3], cf[1:2],
            ci[mp + c + 3:mp + c + 4],
            torch.zeros((1,), dtype=torch.int32, device=self.device),
            self.cfg.vocab_size, greedy)
        return int(tok[0])

    # ------------------------------------------------------------------
    # whole-prompt prefill (prefill_chunk=None)
    # ------------------------------------------------------------------
    def _bucket(self, plen: int) -> int:
        """The prompt's padded length: the next power of two from 16,
        capped at ``max_len`` less the vision positions (so prompts over
        half of that all share the top bucket)."""
        b = 16
        while b < plen:
            b *= 2
        return min(b, max(self.max_len - self.nf, 1))

    def prefill_whole(self, request, seed: int, slot: int) -> int:
        """Prefill a whole prompt into its pages and return the first
        token: prefill, page scatter and first-token sample in one call,
        with the logits taken at the last real position. A vlm prompt
        follows ``nf`` zero vision embeddings, its K/V with theirs."""
        plen = len(request.prompt)
        bucket = self._bucket(plen)
        sp = request.sampling
        row = self.cache.block_tables[slot]
        mp = row.shape[0]
        # one transfer: [block-table row | padded tokens | top_k, seed]
        ci = np.zeros(mp + bucket + 2, np.int32)
        ci[:mp] = row
        ci[mp:mp + plen] = request.prompt
        ci[mp + bucket:] = (sp.top_k, seed)
        cf = np.array([sp.temperature, sp.top_p], np.float32)
        return self._run("_prefill_whole", ci, cf, plen, bucket,
                         sp.temperature <= 0.0)

    def _prefill_whole(self, ci: np.ndarray, cf: np.ndarray, plen: int,
                       bucket: int, greedy: bool) -> int:
        ctx = self.nf + plen
        mp = ci.shape[0] - bucket - 2
        ci, cf = self._to_device(ci), self._to_device(cf)
        batch = {"tokens": ci[None, mp:mp + bucket]}
        if self.nf:
            batch["vision_embeds"] = torch.zeros(
                (1, self.nf, self.cfg.d_model), device=self.device,
                dtype=getattr(torch, self.cfg.dtype))
        cache, logits = self.model.prefill(batch, self.nf + bucket,
                                           logits_index=ctx - 1)
        write_prefill_pages(self.cache.pages, cache["k"][:, 0],
                            cache["v"][:, 0], ci[:mp], ctx)
        tok = pick_tokens(
            logits, cf[0:1], ci[mp + bucket:mp + bucket + 1], cf[1:2],
            ci[mp + bucket + 1:],
            torch.zeros((1,), dtype=torch.int32, device=self.device),
            self.cfg.vocab_size, greedy)
        return int(tok[0])
