"""WorkerPod: the runtime stand-in for a Kubernetes pod running one sealed step.

A pod is a host thread (one per attempt) executing ``StepImage.step`` with:
  * a ``PodContext`` handle — heartbeats, kill-switch (fault injection /
    speculative-loser cancellation), store/bus access, attempt metadata;
  * outputs published to the ArtifactStore, completion records to the bus.

Step functions may accept (inputs) or (inputs, ctx); long-running steps use
ctx to heartbeat, checkpoint and die cooperatively (the SIGKILL analogue —
an uncatchable-by-design ``PodKilled`` raised at the next progress point).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from inspect import signature
from typing import Any

from repro_torch.core.bus import TopicBus
from repro_torch.core.events import EventLog
from repro_torch.core.probes import HeartbeatWriter
from repro_torch.core.storage import ArtifactStore


class PodKilled(BaseException):
    """Simulated pod death (chaos injection or cancellation)."""


@dataclass
class KillSwitch:
    _event: threading.Event = field(default_factory=threading.Event)
    reason: str = ""

    def kill(self, reason: str = "killed"):
        self.reason = reason
        self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set()


@dataclass
class PodContext:
    pod_name: str
    step_name: str
    attempt: int
    bus: TopicBus
    store: ArtifactStore
    kill: KillSwitch
    heartbeat: HeartbeatWriter
    claim_path: str = ""

    def beat(self, progress: int = 0, **info):
        if self.kill.is_set():
            raise PodKilled(self.kill.reason)
        self.heartbeat.beat(progress=progress, **info)

    def check(self):
        if self.kill.is_set():
            raise PodKilled(self.kill.reason)


class WorkerPod(threading.Thread):
    def __init__(
        self,
        pod_name: str,
        image,                      # StepImage
        inputs: dict,
        bus: TopicBus,
        store: ArtifactStore,
        events: EventLog,
        attempt: int,
        claim_path: str = "",
    ):
        super().__init__(daemon=True, name=pod_name)
        self.pod_name = pod_name
        self.image = image
        self.inputs = inputs
        self.attempt = attempt
        self.kill_switch = KillSwitch()
        self.events = events
        self.ctx = PodContext(
            pod_name=pod_name,
            step_name=image.step.name,
            attempt=attempt,
            bus=bus,
            store=store,
            kill=self.kill_switch,
            heartbeat=HeartbeatWriter(bus, pod_name),
            claim_path=claim_path,
        )
        self.outputs: dict | None = None
        self.error: BaseException | None = None
        self.started_ts: float = 0.0
        self.finished_ts: float = 0.0

    # ------------------------------------------------------------------
    def run(self):
        self.started_ts = time.time()
        step = self.image.step
        try:
            self.ctx.heartbeat.ready()
            self.ctx.check()
            fn = step.fn
            if fn is not None and len(signature(fn).parameters) >= 2:
                out = fn(self.inputs, self.ctx)
            else:
                out = step.run(self.inputs)
            missing = step.writes - set(out)
            if missing:
                raise ValueError(f"step {step.name} missing outputs {missing}")
            self.ctx.check()
            self.outputs = out
        except PodKilled as e:
            self.error = e
        except BaseException as e:  # noqa: BLE001 — pod crash, report upward
            self.error = e
            self.events.error(step.name, self.attempt, e)
        finally:
            self.finished_ts = time.time()

    @property
    def state(self) -> str:
        if not self.started_ts:
            return "pending"
        if self.is_alive():
            return "running"
        if self.outputs is not None:
            return "succeeded"
        return "failed"
