"""ServiceRegistry: cluster-IP service discovery (paper §3.4), on the bus.

``get-cluster-ip()``/``communicate-with-service()`` from the paper map to
``resolve()``/liveness-gated lookups: services register an endpoint record
on the ``services`` topic; resolution replays the topic and returns the
latest record whose owner still heartbeats.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.core.bus import TopicBus

TOPIC = "services"


@dataclass(frozen=True)
class Endpoint:
    service: str
    namespace: str
    address: str  # e.g. "pod://train-0" or "10.0.0.12:8080" on a real cluster
    pod: str
    ts: float


class ServiceRegistry:
    def __init__(self, bus: TopicBus, liveness_window_s: float = 30.0):
        self.bus = bus
        self.window = liveness_window_s

    def register(self, service: str, address: str, pod: str, namespace: str = "default"):
        self.bus.publish(
            TOPIC,
            {"service": service, "namespace": namespace, "address": address, "pod": pod},
            key=f"{namespace}/{service}",
        )

    def deregister(self, service: str, namespace: str = "default"):
        self.bus.publish(TOPIC, {"service": service, "namespace": namespace,
                                 "address": None, "pod": None},
                         key=f"{namespace}/{service}")

    def resolve(self, service: str, namespace: str = "default",
                heartbeats: dict[str, float] | None = None) -> Endpoint | None:
        """Latest live endpoint (the get-cluster-ip analogue)."""
        latest: Endpoint | None = None
        for m in self.bus.read(TOPIC):
            v = m.value
            if v.get("service") == service and v.get("namespace") == namespace:
                if v.get("address") is None:
                    latest = None
                else:
                    latest = Endpoint(service, namespace, v["address"], v["pod"], m.ts)
        if latest and heartbeats is not None:
            hb = heartbeats.get(latest.pod, 0.0)
            if time.time() - hb > self.window:
                return None
        return latest
