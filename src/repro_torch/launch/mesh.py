"""Meshes of ranks for the port (the counterpart of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module starts
nothing. A mesh of more than one rank spawns its followers only when
first used (``parallel/group.py``); the production meshes of the dry run
are never used that way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel.group import Mesh


def _local_devices(kind: str) -> list[torch.device]:
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod:  (pod=2, data=16, model=16) = 512 ranks.

    Every rank's device is ``meta``: the dry run (``launch/dryrun.py``)
    shards meta tensors over it (``Sharding.shard_shape``) and never
    starts its ranks (``Mesh.group``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.full(shape, "meta", dtype=object), axes)


def make_host_mesh() -> Mesh:
    """A 1-D ``("data",)`` mesh of this process on the CPU, one rank —
    tests and examples."""
    return Mesh(["cpu"], ("data",))


def make_serving_mesh(size: int | None = None, devices=None, *,
                      init_dir: str | None = None) -> Mesh:
    """1-D ``("model",)`` mesh for the tensor-parallel serving executors.

    ``devices`` lists each rank's device and may repeat one (two ranks on
    one card, or CPU ranks, whose number is not limited); ``size`` takes
    its first ``size`` entries. Without ``devices``: the local cards, the
    first ``size`` of them (None: all), and ``size`` beyond their count is
    out of range. Rank 0 is the calling process."""
    if devices is None:
        pool = _local_devices("cuda")
        if size is None and not pool:
            raise ValueError("no CUDA device: pass devices= (e.g. ['cpu', "
                             "'cpu'] for CPU ranks)")
    else:
        pool = [torch.device(d) for d in devices]
    n = len(pool) if size is None else size
    if not 1 <= n <= len(pool):
        raise ValueError(f"serving mesh size {n} out of range [1, {len(pool)}]")
    return Mesh(pool[:n], ("model",), init_dir=init_dir)


def describe_mesh(mesh: Mesh) -> str:
    return "x".join(f"{k}={v}" for k, v in mesh.shape.items())
