"""Structured event log (paper §3.5 'error handling and logging') on the bus."""

from __future__ import annotations

import traceback
from typing import Any

from repro_torch.core.bus import TopicBus

TOPIC = "workflow.events"


class EventLog:
    def __init__(self, bus: TopicBus, workflow: str = "wf"):
        self.bus = bus
        self.workflow = workflow

    def emit(self, kind: str, step: str = "", attempt: int = -1, **fields: Any) -> int:
        rec = {"workflow": self.workflow, "kind": kind, "step": step,
               "attempt": attempt, **fields}
        return self.bus.publish(TOPIC, rec, key=f"{step}:{attempt}")

    def error(self, step: str, attempt: int, exc: BaseException):
        self.emit(
            "step_error", step, attempt,
            error=repr(exc),
            trace="".join(traceback.format_exception(exc))[-2000:],
        )

    def history(self, kind: str | None = None) -> list[dict]:
        out = []
        for m in self.bus.read(TOPIC):
            if m.value.get("workflow") != self.workflow:
                continue
            if kind is None or m.value.get("kind") == kind:
                out.append(m.value)
        return out
