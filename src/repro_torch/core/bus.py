"""TopicBus: the Kafka analogue (paper §3.4), file-backed and broker-less.

Semantics kept from Kafka (what the scheduler/monitors rely on):
  * topics are append-only ordered logs; messages get monotonic offsets;
  * producers append (atomic O_APPEND line writes — multi-process safe);
  * consumer groups track committed offsets; delivery is at-least-once
    (commit AFTER processing), so consumers must be idempotent — step
    attempts carry idempotency keys for exactly this reason;
  * replay: a new group (or ``seek(0)``) re-reads history — this is how a
    restarted monitor rebuilds its view of the workflow.

Large payloads do NOT travel on the bus: steps exchange ArtifactStore refs
(the Kafka + object-store pattern). On a real TPU cluster this bus is the
host-side control plane; device tensors move over ICI collectives.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator


@dataclass(frozen=True)
class Message:
    topic: str
    offset: int
    ts: float
    key: str
    value: Any


class TopicBus:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _log(self, topic: str) -> Path:
        d = self.root / topic
        d.mkdir(parents=True, exist_ok=True)
        return d / "log.jsonl"

    def _offsets_dir(self, topic: str) -> Path:
        d = self.root / topic / "offsets"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def topics(self) -> list[str]:
        return sorted(
            str(p.parent.relative_to(self.root))
            for p in self.root.glob("**/log.jsonl")
        )

    # ------------------------------------------------------------------
    def publish(self, topic: str, value: Any, key: str = "") -> int:
        """Append one message; returns its offset."""
        line = None
        with self._lock:
            log = self._log(topic)
            offset = self._end_offset(topic)
            rec = {"o": offset, "t": time.time(), "k": key, "v": value}
            line = json.dumps(rec, separators=(",", ":"), default=str) + "\n"
            with open(log, "a", buffering=1) as f:
                f.write(line)
        return offset

    def _end_offset(self, topic: str) -> int:
        log = self._log(topic)
        if not log.exists():
            return 0
        with open(log, "rb") as f:
            return sum(1 for _ in f)

    def end_offset(self, topic: str) -> int:
        with self._lock:
            return self._end_offset(topic)

    # ------------------------------------------------------------------
    def read(self, topic: str, start: int = 0, limit: int | None = None) -> list[Message]:
        log = self._log(topic)
        if not log.exists():
            return []
        out: list[Message] = []
        with open(log) as f:
            for i, line in enumerate(f):
                if i < start:
                    continue
                if limit is not None and len(out) >= limit:
                    break
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail write from a crashed producer
                out.append(Message(topic, rec["o"], rec["t"], rec["k"], rec["v"]))
        return out

    # ------------------------------------------------------------------
    def committed(self, topic: str, group: str) -> int:
        f = self._offsets_dir(topic) / group
        if not f.exists():
            return 0
        try:
            return int(f.read_text().strip() or 0)
        except ValueError:
            return 0

    def commit(self, topic: str, group: str, offset: int):
        f = self._offsets_dir(topic) / group
        # unique tmp per writer: concurrent committers must not rename each
        # other's tmp away (last rename wins, which at-least-once tolerates)
        tmp = f.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        tmp.write_text(str(offset))
        tmp.rename(f)  # atomic

    def consume(self, topic: str, group: str, limit: int | None = None) -> list[Message]:
        """Fetch messages after the group's committed offset (no auto-commit)."""
        start = self.committed(topic, group)
        return self.read(topic, start=start, limit=limit)

    def lag(self, topic: str, group: str) -> int:
        return self.end_offset(topic) - self.committed(topic, group)


class Consumer:
    """Convenience looping consumer with at-least-once processing."""

    def __init__(self, bus: TopicBus, topic: str, group: str):
        self.bus, self.topic, self.group = bus, topic, group

    def poll(self, handler: Callable[[Message], None], max_msgs: int = 100) -> int:
        msgs = self.bus.consume(self.topic, self.group, limit=max_msgs)
        n = 0
        for m in msgs:
            handler(m)  # may raise -> nothing committed -> redelivery
            n += 1
            self.bus.commit(self.topic, self.group, m.offset + 1)
        return n
