"""Meshes of ranks: the processes behind the port's tensor parallelism.

The JAX package runs a sharded step as one program over a device mesh
(``shard_map``); the port runs one process per rank instead. A
:class:`Mesh` names its ranks' devices along its axes (``("model",)`` for
serving, ``("data",)`` for the host mesh). Rank 0 is the process that made
the mesh — the caller's own, which keeps the engine, the scheduler and
every host-side table. The first time a mesh of more than one rank is used
(:attr:`Mesh.group`), rank 0 spawns ranks 1..n-1 as followers
(:class:`RankGroup`, the ``spawn`` start method: CUDA cannot fork) and all
ranks join one process group:

* **backend**: NCCL when every rank has a card of its own; gloo when ranks
  share a card (NCCL refuses two ranks on one device) or run on the CPU.
  The choice is made from the mesh's devices before anything starts,
  printed once, and never retried on another backend. gloo reduces host
  tensors, so ranks that share a card stage each collective through the
  host: slow by construction, and not tensor parallelism's speed;
* **rendezvous**: a ``FileStore`` in a fresh temporary directory (or
  ``init_dir``), so concurrent test workers never share an address;
* **kernels**: a mesh on cards builds every CUDA kernel in rank 0 before
  it spawns anything; followers load the libraries it built;
* **control**: one pipe per follower. Rank 0 sends each unit of work as
  one pickled message (:meth:`RankGroup.broadcast`); a follower applies it
  and runs the same step on its shard. Weights travel in a follower's
  ``build`` message (once an executor), as shared-memory CPU tensors,
  never over the collective;
* **failure**: the process group waits ``TIMEOUT_S`` for a rank; a
  follower that dies fails rank 0's next call with the rank and its exit
  code; a follower whose rank 0 has gone (its pipe closes) ends; closing
  the mesh ends and joins every follower.

A follower runs :func:`_follower_main`: it builds the objects rank 0 asks
for (``build``: a package factory called with this rank's mesh and
kwargs, e.g. a serving executor over its weight shard), runs their steps
(``call``), answers reads of their state (``query``; both first apply the
pool operations rank 0 queued since its last message, in order), reports
its kernel launches since it built an object when it is dropped
(``drop``) or since it started (``launches``), lists what it holds
(``held``), and runs single functions on every rank for tests and
tools (:meth:`RankGroup.spmd`, the ``shard_map`` of one call).
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import threading
import time
import traceback
import uuid
from multiprocessing.reduction import ForkingPickler
from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["Comm", "Mesh", "RankGroup", "choose_backend"]

# this process's rank and comm on each mesh it follows (mesh id -> ...)
_FOLLOWING: dict[str, tuple[int, "Comm"]] = {}
# the process group's timeout: a collective or the rendezvous waits this
# long for a rank before it fails
TIMEOUT_S = 300.0
# one start of a mesh's followers at a time: engines built in several
# threads (fleet workers) may all be the first to use a mesh
_STARTING = threading.Lock()


def choose_backend(devices: Sequence[torch.device]) -> tuple[str, str]:
    """(backend, why) for a group whose rank r runs on ``devices[r]``."""
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo", "CPU ranks"
    if kinds != {"cuda"}:
        raise ValueError(f"a mesh's ranks are all CPU or all CUDA, got "
                         f"{[str(d) for d in devices]}")
    idx = [d.index if d.index is not None else 0 for d in devices]
    if len(set(idx)) < len(idx):
        return "gloo", "ranks share a card; NCCL takes one rank per card"
    return "nccl", "one card per rank"


class Comm:
    """One rank's view of its group: the process group, this rank, the
    group size and the backend, plus counters of the collectives run
    (calls and bytes moved by this rank)."""

    def __init__(self, pg, rank: int, size: int, backend: str):
        self.pg, self.rank, self.size, self.backend = pg, rank, size, backend
        self.stats = {"collectives": 0, "bytes": 0}

    def staging_device(self, x: torch.Tensor) -> torch.device:
        """Where a collective on ``x`` runs: the host for gloo."""
        return torch.device("cpu") if self.backend == "gloo" else x.device

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> None:
        """In place, over the group; ``op`` is ``"sum"`` or ``"max"``."""
        import torch.distributed as dist

        opts = dist.AllreduceOptions()
        opts.reduceOp = {"sum": dist.ReduceOp.SUM,
                         "max": dist.ReduceOp.MAX}[op]
        self.pg.allreduce([t], opts).wait()
        self.stats["collectives"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t``, in rank order."""
        out = [torch.empty_like(t) for _ in range(self.size)]
        self.pg.allgather([out], [t]).wait()
        self.stats["collectives"] += 1
        self.stats["bytes"] += t.numel() * t.element_size() * self.size
        return out


def _make_comm(store_path: str, rank: int, size: int, backend: str) -> Comm:
    import torch.distributed as dist

    store = dist.FileStore(store_path, size)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if backend == "gloo":
        pg = dist.ProcessGroupGloo(store, rank, size, timeout)
    else:
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        pg = dist.ProcessGroupNCCL(store, rank, size, opts)
    return Comm(pg, rank, size, backend)


class Mesh:
    """Devices of ranks laid out along named axes (``jax.sharding.Mesh``'s
    counterpart). ``devices`` is an array (nested lists) of
    ``torch.device``-likes whose shape is the mesh's; rank r is the r-th
    device in row-major order. A device may repeat: ranks then share it
    (two ranks on one card, or any number of CPU ranks).

    Picklable: a follower receives the mesh and finds its own rank in it
    (:attr:`rank`). Rank 0 owns the followers (:attr:`group`, started on
    first use); :meth:`close` (or leaving a ``with`` block) ends them."""

    def __init__(self, devices, axis_names: Sequence[str], *,
                 init_dir: str | None = None):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {arr.shape} for axes "
                             f"{self.axis_names}")
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.size = int(arr.size)
        self.init_dir = init_dir
        self.id = uuid.uuid4().hex
        self._group: RankGroup | None = None

    def __repr__(self) -> str:
        return (f"Mesh({'x'.join(f'{k}={v}' for k, v in self.shape.items())}"
                f" on {[str(d) for d in self.flat_devices]})")

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_group"] = None
        return state

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def flat_devices(self) -> list[torch.device]:
        return list(self.devices.reshape(-1))

    @property
    def rank(self) -> int:
        """This process's rank: 0 in the process that made the mesh."""
        return _FOLLOWING[self.id][0] if self.id in _FOLLOWING else 0

    def device_of(self, rank: int) -> torch.device:
        return self.flat_devices[rank]

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.device_of(self.rank)

    @property
    def backend(self) -> tuple[str, str]:
        return choose_backend(self.flat_devices)

    @property
    def group(self) -> "RankGroup":
        """Rank 0's handle on the followers, spawned on first use."""
        if self.id in _FOLLOWING:
            raise RuntimeError("only rank 0 drives a mesh's followers")
        with _STARTING:
            if self._group is None or self._group.closed:
                if self.size > 1 and len(self.axis_names) > 1:
                    raise NotImplementedError(
                        "a group of processes spans one mesh axis; "
                        f"{self!r} has {len(self.axis_names)}")
                self._group = RankGroup(self)
            return self._group

    @property
    def comm(self) -> Comm | None:
        """This rank's :class:`Comm` (None on a one-rank mesh)."""
        if self.size == 1:
            return None
        if self.id in _FOLLOWING:
            return _FOLLOWING[self.id][1]
        return self.group.comm

    @property
    def started(self) -> bool:
        return self._group is not None and not self._group.closed

    def close(self) -> None:
        """End and join every follower (no-op on a follower, or when none
        was started)."""
        if self._group is not None:
            self._group.close()
            self._group = None


class RankGroup:
    """Rank 0's side of a started mesh: the follower processes, their
    pipes, and rank 0's :class:`Comm`."""

    def __init__(self, mesh: Mesh):
        import torch.multiprocessing as mp

        self.mesh = mesh
        self.size = mesh.size
        self.backend, why = mesh.backend
        self.closed = False
        # one unit of work at a time: a call's message and its collectives
        # (engines on one mesh in several threads take turns)
        self.lock = threading.RLock()
        if any(d.type == "cuda" for d in mesh.flat_devices):
            from repro_torch.kernels import build

            build.build()  # here, once: every follower loads what it built
        self._tmp = tempfile.mkdtemp(prefix="tp_group_", dir=mesh.init_dir)
        store = os.path.join(self._tmp, "store")
        ctx = mp.get_context("spawn")
        self.procs, self.conns = [], []
        try:
            for rank in range(1, self.size):
                here, there = ctx.Pipe(duplex=True)
                p = ctx.Process(
                    target=_follower_main, name=f"tp-rank{rank}",
                    args=(rank, mesh, store, self.backend, there),
                    daemon=True)
                p.start()
                there.close()
                self.procs.append(p)
                self.conns.append(here)
            self.comm = self._join(store)
        except BaseException:
            self.close()
            raise
        print(f"tensor-parallel group: {self.size} ranks on "
              f"{[str(d) for d in mesh.flat_devices]}, backend "
              f"{self.backend} ({why})", flush=True)

    def _join(self, store: str) -> Comm:
        """Rank 0 joins the process group while watching the followers: a
        follower that dies before it joins fails the start at once."""
        out: dict[str, Any] = {}

        def join():
            try:
                out["comm"] = _make_comm(store, 0, self.size, self.backend)
            except BaseException as e:  # raised below, in the caller
                out["error"] = e

        t = threading.Thread(target=join, daemon=True)
        t.start()
        while t.is_alive():
            t.join(0.05)
            self.check()
        if "error" in out:
            raise out["error"]
        return out["comm"]

    # ------------------------------------------------------------------
    def check(self) -> None:
        """Raise if a follower has exited (its rank and exit code)."""
        for rank, p in enumerate(self.procs, start=1):
            if p.exitcode is not None:
                raise RuntimeError(
                    f"tensor-parallel rank {rank} of {self.mesh!r} exited "
                    f"with code {p.exitcode}")

    def fail_if_dead(self, wait_s: float = 5.0) -> None:
        """After an error on rank 0: give a dying follower ``wait_s`` to
        exit, then raise naming it (no-op when every follower lives)."""
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            if any(p.exitcode is not None for p in self.procs):
                break
            time.sleep(0.05)
        self.check()

    def _send(self, rank: int, payload: bytes) -> None:
        self.check()
        self.conns[rank - 1].send_bytes(payload)

    def broadcast(self, msg) -> int:
        """One message to every follower (pickled once; it must hold no
        tensors: a shared tensor is handed to one receiver only). Returns
        its size in bytes."""
        payload = bytes(ForkingPickler.dumps(msg))
        for rank in range(1, self.size):
            self._send(rank, payload)
        return len(payload)

    def send_each(self, msgs: dict[int, Any]) -> None:
        """A message of its own to each follower rank (tensors in it travel
        as shared memory)."""
        for rank, msg in msgs.items():
            self._send(rank, bytes(ForkingPickler.dumps(msg)))

    def recv(self, rank: int):
        """The next reply of follower ``rank``, watching it live."""
        conn = self.conns[rank - 1]
        while not conn.poll(0.05):
            self.check()
        try:
            return conn.recv()
        except EOFError:
            self.fail_if_dead()
            raise

    def gather(self) -> dict[int, Any]:
        return {rank: self.recv(rank) for rank in range(1, self.size)}

    # ------------------------------------------------------------------
    def build(self, xid: str, factory, kwargs_by_rank: dict[int, dict]) -> None:
        """Have each follower build ``factory(mesh=..., **kwargs)`` under
        ``xid``, with this process's f32 matmul settings (TF32 on or off)."""
        flags = _matmul_flags()
        with self.lock:
            self.send_each({r: ("build", xid, factory, kw, flags)
                            for r, kw in kwargs_by_rank.items()})

    def drop(self, xid: str) -> dict[int, tuple[dict, Any]]:
        """Release ``xid`` on every follower; returns, per follower, its
        kernel launches since it built ``xid`` (those of any other object
        stepped meanwhile included) and the object's ``rank_info()`` (its
        shard shapes)."""
        if self.closed:
            return {}
        with self.lock:
            self.broadcast(("drop", xid))
            return {r: (reply[1], reply[2])
                    for r, reply in self.gather().items()}

    def launches(self) -> dict[int, dict[str, int]]:
        """Each follower's kernel launches since it started, per kernel
        (engines that share the mesh count together)."""
        with self.lock:
            self.broadcast(("launches",))
            return {r: reply[1] for r, reply in self.gather().items()}

    def held(self) -> dict[int, list[str]]:
        """The ids of the objects each follower still holds (built and not
        yet dropped); {rank: sorted ids}."""
        with self.lock:
            self.broadcast(("held",))
            return {r: reply[1] for r, reply in self.gather().items()}

    def spmd(self, fn, args_by_rank: Sequence[tuple], *,
             vocab_sharded: bool = False) -> list:
        """Run ``fn(*args_by_rank[r])`` on every rank r inside a
        :func:`~repro_torch.parallel.collectives.tensor_parallel` context
        over the group; returns the results in rank order (the followers'
        pickled back). ``fn`` must be importable by name (a function of a
        module, or a bound method of a picklable object)."""
        from repro_torch.parallel.collectives import tensor_parallel

        assert len(args_by_rank) == self.size
        with self.lock:
            self.send_each({r: ("spmd", fn, tuple(args_by_rank[r]),
                                vocab_sharded) for r in range(1, self.size)})
            try:
                with tensor_parallel(self.comm, vocab_sharded=vocab_sharded):
                    mine = fn(*args_by_rank[0])
            except BaseException:
                self.fail_if_dead()
                raise
            theirs = self.gather()
        return [mine] + [theirs[r][1] for r in sorted(theirs)]

    def close(self) -> None:
        """End and join every follower, then remove the rendezvous files."""
        if self.closed:
            return
        self.closed = True
        for p, conn in zip(self.procs, self.conns):
            if p.exitcode is None:
                try:
                    conn.send_bytes(bytes(ForkingPickler.dumps(("exit",))))
                except OSError:
                    pass  # its pipe is already gone: it is ending anyway
        for p in self.procs:
            p.join(timeout=30)
            if p.exitcode is None:
                p.terminate()
                p.join(timeout=10)
        for conn in self.conns:
            conn.close()
        self.comm = None
        shutil.rmtree(self._tmp, ignore_errors=True)


def _matmul_flags() -> tuple[bool, bool]:
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def launch_counts() -> dict[str, int]:
    """This process's kernel launches, per kernel."""
    from repro_torch.kernels import flash_attention, paged_attention, ssd_scan

    return {**paged_attention.LAUNCHES, **ssd_scan.LAUNCHES,
            **flash_attention.LAUNCHES}


def _follower_main(rank: int, mesh: Mesh, store: str, backend: str,
                   conn) -> None:
    """A follower's life: join the group, then serve rank 0's messages
    until ``exit`` or until rank 0's end of the pipe closes. An error ends
    the process with code 1 (its traceback on stderr), which rank 0 reports
    at its next call."""
    from repro_torch.parallel.collectives import tensor_parallel

    device = mesh.device_of(rank)
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(device)
    try:
        comm = _make_comm(store, rank, mesh.size, backend)
        _FOLLOWING[mesh.id] = (rank, comm)
        objects: dict[str, Any] = {}
        built_at: dict[str, dict[str, int]] = {}  # launch counts at build
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                return  # rank 0 has gone
            kind = msg[0]
            if kind == "exit":
                return
            if kind == "build":
                _, xid, factory, kwargs, flags = msg
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = flags
                objects[xid] = factory(mesh=mesh, **kwargs)
                built_at[xid] = launch_counts()
            elif kind == "call":
                _, xid, ops, method, args = msg
                objects[xid].run_call(ops, method, args)
            elif kind == "query":
                _, xid, ops, method, args = msg
                conn.send(("result", objects[xid].run_query(ops, method,
                                                            args)))
            elif kind == "held":
                conn.send(("held", sorted(objects)))
            elif kind == "drop":
                obj = objects.pop(msg[1], None)
                info = obj.rank_info() if hasattr(obj, "rank_info") else None
                base = built_at.pop(msg[1], {})
                conn.send(("dropped", {k: v - base.get(k, 0) for k, v in
                                       launch_counts().items()}, info))
            elif kind == "launches":
                conn.send(("launches", launch_counts()))
            elif kind == "spmd":
                _, fn, args, vocab = msg
                with tensor_parallel(comm, vocab_sharded=vocab):
                    out = fn(*args)
                conn.send(("result", out))
            else:
                raise ValueError(f"unknown message {kind!r}")
    except BaseException:
        traceback.print_exc()
        os._exit(1)
