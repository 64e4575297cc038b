"""Elastic rescale: rolling-update semantics for sharded training state.

The paper's RollingUpdate (maxSurge/maxUnavailable) moves stateless pods one
at a time. For training, "moving a pod" means re-laying-out the sharded
TrainState onto a different mesh. The primitive here:

    plan  = RescalePlan(state_axes, old_mesh, new_mesh)
    state = plan.apply(state)        # in-memory reshard
or through a checkpoint boundary (node count actually changed):
    ckpt.save(step, state); state = ckpt.restore(like, shardings=plan.new_shardings)

``rolling_phases`` yields the paper-faithful phase sequence (cordon/drain ≤
maxUnavailable slices -> reshard -> resume) that the trainer logs as events.

In the port a mesh's ranks are processes (``parallel/group.py``) and a
sharded leaf is each rank's slice of it: ``apply`` cuts this rank's slices
out of a full state, or first gathers a state sharded over the old mesh
(``old``: its shardings) over that mesh's group, and places each slice on
this rank's device; ``restore(shardings=...)`` does the same from a
checkpoint. ``rolling_phases`` is pure Python and ported as it is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator

from repro_torch.models.common import tree_map
from repro_torch.parallel import make_shardings


@dataclass
class RescalePlan:
    state_axes: Any
    new_mesh: Any
    rules: dict | None = None

    def new_shardings(self, state_shapes: Any = None):
        """The tree of :class:`~repro_torch.parallel.Sharding` over the new
        mesh (``state_shapes``: leaves with ``shape``, for the
        divisibility-aware rule drop)."""
        return make_shardings(
            self.state_axes, self.new_mesh, rules=self.rules,
            shapes_tree=state_shapes)

    def apply(self, state: Any, old: Any = None) -> Any:
        """This rank's slices of ``state`` on the new mesh, each on this
        rank's device. ``state`` is the full state, or, with ``old`` (the
        tree of shardings it is laid out by over the old mesh), this rank's
        slices there, gathered over the old mesh first."""
        if old is not None:
            state = tree_map(lambda x, s: s.gather(x), state, old)
        shardings = self.new_shardings(state)
        return tree_map(lambda x, s: s.shard(x), state, shardings)


def rolling_phases(
    old_slices: int, new_slices: int, max_unavailable: int = 1
) -> Iterator[dict]:
    """Phase records for a rolling data-parallel rescale old->new."""
    yield {"phase": "checkpoint_barrier", "old": old_slices, "new": new_slices}
    moved = 0
    delta = abs(new_slices - old_slices)
    while moved < delta:
        batch = min(max_unavailable, delta - moved)
        yield {
            "phase": "drain" if new_slices < old_slices else "surge",
            "slices": batch,
            "progress": f"{moved + batch}/{delta}",
        }
        moved += batch
    yield {"phase": "reshard", "target_slices": new_slices}
    yield {"phase": "resume", "slices": new_slices}
