"""Liveness/readiness probes (paper §3.5), bus-record edition.

A pod's step loop publishes heartbeats on the ``health`` topic. The monitor
declares a pod:
  * not READY   — no heartbeat yet (still initializing / compiling),
  * LIVE        — last heartbeat within ``liveness_window``,
  * LIVELOCKED  — heartbeats still arriving, the pod reports work in
                  flight (``busy``), but its ``progress`` counter has not
                  advanced for longer than ``livelock_window`` — the pod
                  is spinning, not serving (serving-fleet adaptation; off
                  unless a window is configured),
  * DEAD        — liveness window exceeded -> the supervisor restarts it
                  from its spec / the last checkpoint.

Stronger than the paper's HTTP probes: a heartbeat carries a *forward
progress* counter (train steps completed, serving tokens emitted), so a
livelocked pod is detected too, not just a crashed one — an HTTP 200 from
a wedged worker looks exactly like one from a healthy worker, but a flat
progress counter does not.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

from repro_torch.core.bus import TopicBus

TOPIC = "health"


@dataclass
class PodHealth:
    pod: str
    last_ts: float
    last_progress: int
    ready: bool
    progress_ts: float = 0.0   # when ``progress`` last ADVANCED
    busy: bool = False         # pod-reported: work in flight right now

    def state(self, now: float, window: float,
              livelock_window: float | None = None) -> str:
        if not self.ready:
            return "not_ready"
        if (now - self.last_ts) > window:
            return "dead"
        if (livelock_window is not None and self.busy
                and (now - self.progress_ts) > livelock_window):
            return "livelocked"
        return "live"


class HeartbeatWriter:
    def __init__(self, bus: TopicBus, pod: str):
        self.bus, self.pod = bus, pod

    def ready(self):
        self.bus.publish(TOPIC, {"pod": self.pod, "kind": "ready"}, key=self.pod)

    def beat(self, progress: int = 0, **info):
        """One liveness beat. ``progress`` is a monotonic forward-progress
        counter; serving workers additionally pass ``busy=True`` while
        requests are in flight so the monitor can tell "idle" (no progress
        expected) from "livelocked" (progress owed but not happening)."""
        self.bus.publish(
            TOPIC,
            {"pod": self.pod, "kind": "beat", "progress": progress, **info},
            key=self.pod,
        )


class HealthMonitor:
    """Replays the ``health`` topic into per-pod state.

    ``livelock_window_s=None`` (default) disables livelock detection —
    the train-era workflow scheduler only distinguishes live/dead.
    ``clock`` is injectable so hysteresis/window tests are deterministic.
    """

    def __init__(self, bus: TopicBus, liveness_window_s: float = 10.0,
                 livelock_window_s: float | None = None,
                 clock: Callable[[], float] = time.time):
        self.bus = bus
        self.window = liveness_window_s
        self.livelock_window = livelock_window_s
        self.clock = clock
        self._state: dict[str, PodHealth] = {}
        self._cursor = 0

    def refresh(self):
        msgs = self.bus.read(TOPIC, start=self._cursor)
        for m in msgs:
            self._cursor = m.offset + 1
            v = m.value
            pod = v["pod"]
            h = self._state.get(pod) or PodHealth(pod, 0.0, 0, False)
            if v["kind"] == "ready":
                h.ready = True
                h.progress_ts = m.ts
            progress = v.get("progress", h.last_progress)
            if progress != h.last_progress:
                h.progress_ts = m.ts
            h.last_ts = m.ts
            h.last_progress = progress
            h.busy = bool(v.get("busy", h.busy))
            self._state[pod] = h

    def status(self, pod: str) -> str:
        self.refresh()
        h = self._state.get(pod)
        if h is None:
            return "unknown"
        return h.state(self.clock(), self.window, self.livelock_window)

    def dead_pods(self) -> list[str]:
        self.refresh()
        now = self.clock()
        return [p for p, h in self._state.items()
                if h.state(now, self.window) == "dead"]

    def unhealthy_pods(self) -> list[tuple[str, str]]:
        """(pod, state) for every pod currently dead OR livelocked — the
        serving supervisor restarts both kinds."""
        self.refresh()
        now = self.clock()
        out = []
        for p, h in self._state.items():
            s = h.state(now, self.window, self.livelock_window)
            if s in ("dead", "livelocked"):
                out.append((p, s))
        return out

    def forget(self, pod: str) -> None:
        """Drop a pod from the view (it was retired/replaced); its stale
        heartbeats must not keep reporting it dead forever."""
        self._state.pop(pod, None)

    def progress(self, pod: str) -> int:
        self.refresh()
        h = self._state.get(pod)
        return h.last_progress if h else 0

    def heartbeat_times(self) -> dict[str, float]:
        self.refresh()
        return {p: h.last_ts for p, h in self._state.items()}
