"""Horizontal autoscaler (paper §3.5 HPA), lag/throughput driven.

Watches a bus topic's consumer lag (serving) or heartbeat step-rate
(training) and computes a desired replica count in [min, max] with
hysteresis. For training, a scale decision is an *elastic rescale event*
(checkpoint -> reshard -> resume; see elastic.py) rather than naive pod
addition — DESIGN.md changed-assumption #3.

:class:`ServingAutoscaler` is the serving-fleet adaptation: consumer lag
alone undercounts demand once workers have *admitted* everything (lag 0,
every decode slot full, queues growing inside the engines), so it also
consults the fleet's slot-occupancy/page-utilization gauges (the ones
``serving/metrics.py`` already records) via an injected ``gauges``
callable — saturated workers with pending lag trigger a scale-up even
when the lag/replica ratio alone would not.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.bus import TopicBus
from repro_torch.core.events import EventLog


@dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    target_lag_per_replica: float = 8.0
    scale_down_grace_s: float = 1.0  # hysteresis: don't thrash downward
    # serving adaptation: scale up when mean slot occupancy exceeds this
    # while lag is nonzero (None disables the gauge term)
    target_occupancy: float | None = None


@dataclass
class Autoscaler:
    bus: TopicBus
    topic: str
    group: str
    cfg: AutoscalerConfig = field(default_factory=AutoscalerConfig)
    events: EventLog | None = None
    current: int = 1
    clock: Callable[[], float] = time.time
    _last_scale_down_ok: float | None = None

    def __post_init__(self):
        if self._last_scale_down_ok is None:
            self._last_scale_down_ok = self.clock()

    def desired_replicas(self) -> int:
        lag = self.bus.lag(self.topic, self.group)
        want = max(1, -(-lag // int(self.cfg.target_lag_per_replica)))  # ceil
        return max(self.cfg.min_replicas, min(self.cfg.max_replicas, want))

    def observe(self) -> tuple[int, bool]:
        """Returns (desired, changed). Applies hysteresis on scale-down:
        a lower desired count is only adopted once it has been wanted for
        ``scale_down_grace_s`` continuously, so an oscillating load never
        thrashes replicas down and immediately back up."""
        desired = self.desired_replicas()
        now = self.clock()
        if desired > self.current:
            changed = True
        elif desired < self.current:
            if now - self._last_scale_down_ok < self.cfg.scale_down_grace_s:
                return self.current, False
            changed = True
        else:
            self._last_scale_down_ok = now
            return self.current, False
        old = self.current
        self.current = desired
        self._last_scale_down_ok = now
        if self.events is not None:
            self.events.emit(
                "autoscale", step=self.topic, attempt=-1,
                old=old, new=desired, lag=self.bus.lag(self.topic, self.group),
            )
        return desired, changed


@dataclass
class ServingAutoscaler(Autoscaler):
    """Lag + engine-gauge driven replica count for the serving fleet.

    ``gauges`` returns the fleet's current aggregate gauges, at least
    ``{"slot_occupancy_mean": float in [0, 1]}`` (see
    :meth:`repro_torch.serving.fleet.FleetSupervisor.gauges`). When mean
    occupancy exceeds ``cfg.target_occupancy`` and there is still lag on
    the work topic, one more replica is requested than the lag ratio
    alone — the workers are slot-bound, so splitting the queue across
    another engine is the only way lag can drain faster. Scale-down keeps
    the base class hysteresis.
    """

    gauges: Callable[[], dict] | None = None

    def desired_replicas(self) -> int:
        want = super().desired_replicas()
        if self.gauges is not None and self.cfg.target_occupancy is not None:
            g = self.gauges() or {}
            occ = g.get("slot_occupancy_mean", 0.0)
            if (occ >= self.cfg.target_occupancy
                    and self.bus.lag(self.topic, self.group) > 0):
                want = max(want, self.current + 1)
        return max(self.cfg.min_replicas, min(self.cfg.max_replicas, want))
