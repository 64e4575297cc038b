"""Meshes of ranks for the port (the counterpart of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module starts
nothing. A mesh of more than one rank spawns its followers only when
first used (``parallel/group.py``). ``make_production_mesh`` (the 16x16
and 2x16x16 pod meshes of the dry run) comes with ``launch/dryrun.py``
(ROADMAP A.13).
"""

from __future__ import annotations

import torch

from repro_torch.parallel.group import Mesh


def _local_devices(kind: str) -> list[torch.device]:
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


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
