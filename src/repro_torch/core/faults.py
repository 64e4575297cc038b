"""Chaos/fault injection used by the FT integration tests and examples.

Deterministic (seeded) pod-killing: the injector arms WorkerPods' kill
switches according to a schedule or a seeded random process — the test
harness for every paper-§3.5 claim (retries, probes, restart-from-ckpt).

Two kill models live here, one per pod family:

* :class:`KillRule` — the train-era model: a timer armed when a workflow
  pod *starts*, firing ``after_s`` seconds later. Wall-clock by design
  (it simulates a node dying underneath a long step).
* :class:`WorkerKillRule` — the serving-fleet model: the *worker itself*
  calls :meth:`FaultInjector.check_worker` once per engine step, and the
  rule fires deterministically on the worker's own progress counters
  (steps run / tokens emitted this attempt), never on wall clock — which
  is what lets the fleet chaos tests pin a crash mid-prefill or at an
  exact token index and stay reproducible under any thread scheduling.

All kill accounting is guarded by one lock: rules are consulted from the
scheduler thread, from every worker thread, and (for timer kills) from
timer threads, so the check-then-increment on ``_killed`` must be atomic —
without the lock a ``times=1`` rule can arm two kills when two pods start
concurrently (pinned by ``tests/test_faults.py``).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field


@dataclass
class KillRule:
    step: str
    attempt: int | None = None     # None: any attempt
    after_s: float = 0.0           # kill this long after the pod starts
    times: int = 1                 # how many attempts to kill in total


@dataclass
class WorkerKillRule:
    """Deterministic kill condition for a serving engine worker.

    Fires when the worker named ``worker`` (``None``: any worker), on
    attempt ``attempt`` (``None``: any), reaches the given progress point:
    ``after_steps`` engine steps run this attempt, or ``after_tokens``
    tokens emitted this attempt (whichever is set; both set means both
    must be reached). ``times`` bounds how many attempts this rule kills
    in total, so a restarted worker is not killed forever.
    """

    worker: str | None = None
    attempt: int | None = None
    after_steps: int | None = None
    after_tokens: int | None = None
    times: int = 1


class FaultInjector:
    def __init__(self, rules: list[KillRule] | None = None, seed: int = 0,
                 random_kill_prob: float = 0.0,
                 worker_rules: list[WorkerKillRule] | None = None):
        self.rules = list(rules or [])
        self.worker_rules = list(worker_rules or [])
        self.rng = random.Random(seed)
        self.random_kill_prob = random_kill_prob
        # kills armed per rule key; mutated from scheduler/worker/timer
        # threads, so every check-then-increment holds _lock
        self._killed: dict[str, int] = {}
        self._timers: list[threading.Timer] = []
        self._armed = 0
        self._lock = threading.Lock()

    def on_pod_start(self, pod) -> bool:
        """Called by the scheduler for every launched WorkerPod. Returns
        True when a kill was armed for this pod."""
        step = pod.image.step.name
        for rule in self.rules:
            if rule.step != step:
                continue
            if rule.attempt is not None and rule.attempt != pod.attempt:
                continue
            with self._lock:
                if self._killed.get(step, 0) >= rule.times:
                    continue
                self._killed[step] = self._killed.get(step, 0) + 1
                self._armed += 1
                t = threading.Timer(
                    rule.after_s, pod.kill_switch.kill,
                    kwargs={"reason": f"chaos:{step}"},
                )
                t.daemon = True
                t.start()
                self._timers.append(t)
            return True
        if self.random_kill_prob and self.rng.random() < self.random_kill_prob:
            delay = self.rng.uniform(0.01, 0.2)
            t = threading.Timer(delay, pod.kill_switch.kill, kwargs={"reason": "chaos:random"})
            t.daemon = True
            with self._lock:
                self._timers.append(t)
                self._armed += 1
            t.start()
            return True
        return False

    # ------------------------------------------------------------------
    # serving-worker kills (progress-deterministic, no timers)
    # ------------------------------------------------------------------
    def check_worker(self, worker: str, attempt: int, *, steps: int,
                     tokens: int) -> str | None:
        """Consult the worker rules at one engine-step boundary. Returns a
        kill reason when a rule fires, else None. Called synchronously
        from the worker's own loop, so the kill lands at a deterministic
        point in that worker's progress regardless of thread scheduling."""
        for i, rule in enumerate(self.worker_rules):
            if rule.worker is not None and rule.worker != worker:
                continue
            if rule.attempt is not None and rule.attempt != attempt:
                continue
            if rule.after_steps is None and rule.after_tokens is None:
                continue
            if rule.after_steps is not None and steps < rule.after_steps:
                continue
            if rule.after_tokens is not None and tokens < rule.after_tokens:
                continue
            key = f"worker_rule:{i}"
            with self._lock:
                if self._killed.get(key, 0) >= rule.times:
                    continue
                # one rule kills one attempt once: a worker that survives
                # the kill point (already past it when armed) must not be
                # re-killed every subsequent step of the same attempt
                seen = f"{key}:{worker}:a{attempt}"
                if self._killed.get(seen):
                    continue
                self._killed[key] = self._killed.get(key, 0) + 1
                self._killed[seen] = 1
                self._armed += 1
            return (f"chaos:{worker}:a{attempt}:steps={steps}"
                    f":tokens={tokens}")
        return None

    def kills_armed(self) -> int:
        """Total kills armed so far (timer + worker rules)."""
        with self._lock:
            return self._armed

    def cancel_all(self):
        with self._lock:
            timers, self._timers = self._timers, []
        for t in timers:
            t.cancel()
