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

The port has no sharded train state yet: ``RescalePlan`` needs the logical
axes -> device-mesh shardings of tensor parallelism (ROADMAP A.10) and
refuses to be built until then. ``rolling_phases`` is pure Python and
ported as it is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator


@dataclass
class RescalePlan:
    state_axes: Any
    new_mesh: Any
    rules: dict | None = None

    def __post_init__(self):
        raise NotImplementedError(
            "RescalePlan reshards a train state over a device mesh, which "
            "the port does not have yet (ROADMAP A.10: tensor parallelism)")


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
