"""Fault-tolerant serving fleet: supervised engine workers over the bus.

This module fuses the Jup2Kub orchestration layer (paper §3.5:
supervised pods, liveness/readiness probes, restart, HPA) with the serving
arc. A :class:`FleetSupervisor` runs N :class:`EngineWorker` pods — in this
repo's pod model a pod is a host thread with a kill switch, exactly like
``core/executor.WorkerPod`` (one XLA-compiled engine per OS process would
put a multi-minute compile inside every tier-1 restart; the thread model
keeps the *protocol* identical while the bus, the only coupling between
supervisor and worker, stays process-shape-agnostic — ``launch/serve.py
--role worker`` runs the same loop as a real separate process against a
shared bus directory).

Topics (all on one ``core.bus.TopicBus``):

* ``requests``      — client ingress (same schema as ``launch/serve.py``).
* ``fleet.work``    — supervisor -> workers. Workers share one consumer
  group; claims are serialized by a claim lock, and each claim publishes
  an ``accept`` *before* committing, so a worker that dies mid-claim
  either leaves the message uncommitted (redelivered) or leaves an accept
  on the log (the supervisor knows the owner and resubmits). At-least-once
  either way; duplicates are harmless because delivery de-duplicates.
* ``fleet.events``  — workers -> supervisor: ``accept`` / ``delta`` /
  ``finish``. The supervisor relays deltas to ``responses``.
* ``fleet.control`` — cancel broadcast; every worker attempt replays the
  full history, so cancels outlive the worker that first received them.
* ``health``        — heartbeats (``core/probes.py``); a beat carries the
  worker's token counter as forward progress plus ``busy``, so a
  livelocked worker (beating, busy, zero progress) is detected, not just
  a dead one.
* ``responses``     — supervisor -> clients, same delta/finish schema as
  ``launch/serve.py``, but **exactly-once per token index**.

The recovery algorithm (the point of this module): the supervisor tracks
per-request delivery state — every token it has relayed, keyed by index.
When a worker dies, each of its in-flight requests is resubmitted to the
work topic with the *same seed*; because sampling is keyed off
``(seed, token_index)`` and placement-independent, the replacement
worker regenerates a byte-identical stream, and the supervisor forwards
only the first occurrence of each index — the client stream resumes at
exactly the next undelivered token, with no token re-emitted or skipped
across the crash boundary. A duplicate delta whose token differs from the
recorded one would falsify that contract; the supervisor counts it
(``FleetMetrics.mismatched_deltas``) and the chaos tests pin it at zero.

Requests that were cancelled and then orphaned by a crash are finished
``cancelled`` directly by the supervisor instead of being resubmitted —
a cancel must never resurrect work, and must never hang.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from statistics import fmean

from repro_torch.core.autoscaler import AutoscalerConfig, ServingAutoscaler
from repro_torch.core.bus import TopicBus
from repro_torch.core.events import EventLog
from repro_torch.core.executor import PodKilled
from repro_torch.core.faults import FaultInjector
from repro_torch.core.podspec import PodSpec
from repro_torch.core.probes import HealthMonitor, HeartbeatWriter
from repro_torch.serving.api import request_from_message
from repro_torch.serving.metrics import FleetMetrics

WORK_TOPIC = "fleet.work"
EVENTS_TOPIC = "fleet.events"
CONTROL_TOPIC = "fleet.control"
REQUESTS_TOPIC = "requests"
RESPONSES_TOPIC = "responses"
SUPERVISOR_GROUP = "fleet-supervisor"
WORKER_GROUP = "fleet-workers"


def fleet_seed(seed_base: int, n: int) -> int:
    """Seed stamped on the n-th ingressed request when the client left
    ``seed`` unset. Same derivation as ``EngineBase.submit`` so a seeded
    single-engine oracle replay of the trace reproduces the fleet's
    streams byte-for-byte."""
    return (seed_base * 1_000_003 + n) & 0x7FFFFFFF


@dataclass
class FleetConfig:
    workers: int = 2                   # initial replica count
    min_replicas: int = 1
    max_replicas: int = 4
    target_lag_per_replica: float = 4.0
    target_occupancy: float | None = 0.85
    scale_down_grace_s: float = 0.5
    autoscale: bool = True
    liveness_window_s: float = 5.0     # heartbeat gap -> dead
    livelock_window_s: float | None = None  # busy w/o progress -> restart
    beat_interval_s: float = 0.02      # min spacing between heartbeats
    seed_base: int = 1234              # for stamping unseeded requests
    max_restarts: int = 5              # attempts per worker name
    idle_sleep_s: float = 0.002

    @classmethod
    def from_spec(cls, spec: PodSpec, **overrides) -> "FleetConfig":
        """Derive the runtime supervision parameters from a Listing-1
        :class:`PodSpec` (``core/podspec.serving_worker_spec``): replica
        count and probe cadence come from the spec, the rest from
        defaults/overrides — the same object that renders the k8s YAML
        drives the in-process fleet."""
        kw = dict(
            workers=spec.replicas,
            beat_interval_s=spec.liveness_interval_s / 2.0,
            liveness_window_s=spec.liveness_interval_s * 2.5,
        )
        kw.update(overrides)
        return cls(**kw)


@dataclass
class RequestState:
    """Supervisor-side delivery ledger for one request: the payload it can
    resubmit verbatim (seed included), every token relayed so far (the
    dedupe reference), and crash-recovery bookkeeping."""

    uid: str
    payload: dict
    tokens: list[int] = field(default_factory=list)
    finish_reason: str | None = None
    error: str | None = None
    owner: str | None = None           # pod id of the accepting worker
    cancel_requested: bool = False
    resubmits: int = 0
    resume_from: int = 0               # next undelivered index at crash
    t_crash: float | None = None       # pending recovery-latency stopwatch
    recovery_s: float | None = None


class EngineWorker:
    """One supervised serving pod: a thread running the ``launch/serve.py``
    worker loop (claim -> submit -> step -> publish) over a fresh engine,
    with heartbeats and a deterministic chaos hook.

    The chaos hook is :meth:`FaultInjector.check_worker`, consulted
    synchronously at every loop top on this attempt's own progress
    counters — a kill therefore lands at an exact (steps, tokens) point in
    this worker's execution regardless of thread scheduling, which is what
    keeps the fleet chaos tests reproducible. Death is silent by design:
    a killed worker publishes nothing further (no finish, no goodbye
    beat), exactly like a SIGKILLed pod.
    """

    def __init__(self, name: str, attempt: int, bus: TopicBus, engine_factory,
                 claim_lock: threading.Lock, cfg: FleetConfig,
                 injector: FaultInjector | None = None):
        self.name = name
        self.attempt = attempt
        self.pod_id = f"{name}-a{attempt}"
        self.bus = bus
        self.engine_factory = engine_factory
        self.claim_lock = claim_lock
        self.cfg = cfg
        self.injector = injector
        self.stop = threading.Event()       # supervisor-initiated shutdown
        self.draining = threading.Event()   # stop claiming, finish in-flight
        self.stopped_cleanly = False
        self.handled = False                # supervisor bookkeeping
        self.kill_reason: str | None = None
        self.error: str | None = None
        self.steps_run = 0                  # this attempt
        self.tokens_emitted = 0             # this attempt
        self.inflight: set[str] = set()
        self.gauge: dict = {}               # last-step occupancy snapshot
        self.thread = threading.Thread(
            target=self._run, name=self.pod_id, daemon=True)

    def start(self) -> None:
        self.thread.start()

    def retire(self) -> None:
        """Graceful scale-down: claim nothing more, drain, then exit."""
        self.draining.set()

    # ------------------------------------------------------------------
    def _run(self) -> None:
        hb = HeartbeatWriter(self.bus, self.pod_id)
        engine = None
        try:
            engine = self.engine_factory()
            hb.ready()
            self._loop(engine, hb)
            self.stopped_cleanly = True
        except PodKilled:
            pass  # crash: silence — the supervisor must *detect* this
        except BaseException as e:  # noqa: BLE001 — a pod death is a pod death
            self.error = repr(e)
        finally:
            # every exit releases the engine: at tp > 1 its executor (page
            # pool, weight slices) lives on every follower rank too
            self._close(engine)

    def _close(self, engine) -> None:
        """Close ``engine`` (if built); a failing close is recorded, never
        raised over the exit's own outcome."""
        if engine is None:
            return
        try:
            engine.close()
        except BaseException as e:  # noqa: BLE001
            if self.error is None:
                self.error = f"close: {e!r}"

    def _loop(self, engine, hb: HeartbeatWriter) -> None:
        accepted: set[str] = set()
        cancelled: set[str] = set()
        handles: dict[str, object] = {}
        ctl_cursor = 0
        last_beat = 0.0
        while not self.stop.is_set():
            if self.injector is not None:
                reason = self.injector.check_worker(
                    self.name, self.attempt,
                    steps=self.steps_run, tokens=self.tokens_emitted)
                if reason is not None:
                    self.kill_reason = reason
                    raise PodKilled(reason)
            # cancels: replay from the start of the topic each attempt, so
            # a cancel issued before this worker existed still applies
            for m in self.bus.read(CONTROL_TOPIC, start=ctl_cursor):
                ctl_cursor = m.offset + 1
                if m.value.get("kind") == "cancel":
                    uid = str(m.value["uid"])
                    cancelled.add(uid)
                    engine.cancel(uid)
            if not self.draining.is_set():
                self._claim(engine, accepted, cancelled, handles)
            now = time.monotonic()
            if now - last_beat >= self.cfg.beat_interval_s:
                last_beat = now
                hb.beat(progress=self.tokens_emitted, busy=not engine.idle)
            if engine.idle:
                if self.draining.is_set():
                    return
                time.sleep(self.cfg.idle_sleep_s)
                continue
            for ev in engine.step():
                if ev.kind == "token":
                    self.tokens_emitted += 1
                    self.bus.publish(EVENTS_TOPIC, {
                        "kind": "delta", "uid": ev.uid, "token": ev.token,
                        "index": ev.index, "worker": self.pod_id,
                    })
                elif ev.kind == "finish":
                    self.inflight.discard(ev.uid)
                    h = handles.pop(ev.uid, None)
                    self.bus.publish(EVENTS_TOPIC, {
                        "kind": "finish", "uid": ev.uid,
                        "finish_reason": ev.finish_reason.value,
                        "error": getattr(h, "error", None),
                        "worker": self.pod_id,
                    })
            self.steps_run += 1
            u = engine.utilization
            self.gauge = {
                "slot_occupancy": u.slot_samples[-1] if u.slot_samples else 0.0,
                "page_util": u.page_samples[-1] if u.page_samples else None,
            }

    def _claim(self, engine, accepted: set[str], cancelled: set[str],
               handles: dict) -> None:
        cap = engine.capacity()
        if cap <= 0:
            return
        with self.claim_lock:
            for m in self.bus.consume(WORK_TOPIC, WORKER_GROUP, limit=cap):
                v = m.value
                uid = str(v.get("uid", "?")) if isinstance(v, dict) else "?"
                if uid in accepted:  # at-least-once redelivery
                    self.bus.commit(WORK_TOPIC, WORKER_GROUP, m.offset + 1)
                    continue
                try:
                    req = request_from_message(v)
                except (ValueError, KeyError, TypeError) as e:
                    self.bus.publish(EVENTS_TOPIC, {
                        "kind": "finish", "uid": uid,
                        "finish_reason": "rejected", "error": str(e),
                        "worker": self.pod_id,
                    })
                    self.bus.commit(WORK_TOPIC, WORKER_GROUP, m.offset + 1)
                    continue
                h = engine.submit(req)
                accepted.add(uid)
                if h.done:  # rejected at the API boundary
                    self.bus.publish(EVENTS_TOPIC, {
                        "kind": "finish", "uid": uid,
                        "finish_reason": h.finish_reason.value,
                        "error": h.error, "worker": self.pod_id,
                    })
                else:
                    # accept BEFORE commit: die between the two and the
                    # supervisor still learns who owned this uid
                    self.bus.publish(EVENTS_TOPIC, {
                        "kind": "accept", "uid": uid, "worker": self.pod_id,
                    })
                    self.inflight.add(uid)
                    handles[uid] = h
                    if uid in cancelled:
                        engine.cancel(uid)
                self.bus.commit(WORK_TOPIC, WORKER_GROUP, m.offset + 1)


class FleetSupervisor:
    """Supervises N engine workers: ingress, delta relay with exactly-once
    per-index delivery, crash detection + resubmit recovery, livelock
    restart, and lag/occupancy-driven autoscaling.

    Drive it with :meth:`poll` (one supervision round, synchronous — the
    chaos tests interleave assertions between rounds) or :meth:`run`
    (poll until every expected request is terminal). Workers are real
    threads; everything the supervisor knows arrives via the bus or
    ``Thread.is_alive()``, so the supervisor itself is single-threaded
    and deterministic given the bus logs.
    """

    def __init__(self, bus: TopicBus, engine_factory,
                 cfg: FleetConfig | None = None,
                 injector: FaultInjector | None = None,
                 events: EventLog | None = None):
        self.bus = bus
        self.engine_factory = engine_factory
        self.cfg = cfg or FleetConfig()
        self.injector = injector
        self.events = events or EventLog(bus, workflow="serving-fleet")
        self.metrics = FleetMetrics()
        self.monitor = HealthMonitor(
            bus, liveness_window_s=self.cfg.liveness_window_s,
            livelock_window_s=self.cfg.livelock_window_s)
        self.scaler: ServingAutoscaler | None = None
        if self.cfg.autoscale:
            self.scaler = ServingAutoscaler(
                bus, WORK_TOPIC, WORKER_GROUP,
                AutoscalerConfig(
                    min_replicas=self.cfg.min_replicas,
                    max_replicas=self.cfg.max_replicas,
                    target_lag_per_replica=self.cfg.target_lag_per_replica,
                    scale_down_grace_s=self.cfg.scale_down_grace_s,
                    target_occupancy=self.cfg.target_occupancy,
                ),
                events=self.events, current=self.cfg.workers,
                gauges=self.gauges)
        self.states: dict[str, RequestState] = {}
        self.workers: dict[str, EngineWorker] = {}
        self._claim_lock = threading.Lock()
        self._spawned = 0
        self._ingressed = 0
        self._started = False

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for _ in range(self.cfg.workers):
            self._spawn()

    def shutdown(self) -> None:
        for w in self.workers.values():
            w.stop.set()
        for w in self.workers.values():
            w.thread.join(timeout=10)

    def _spawn(self, name: str | None = None, attempt: int = 0) -> EngineWorker:
        if name is None:
            name = f"w{self._spawned}"
            self._spawned += 1
        w = EngineWorker(name, attempt, self.bus, self.engine_factory,
                         self._claim_lock, self.cfg, injector=self.injector)
        self.workers[name] = w
        w.start()
        return w

    # -- client surface -------------------------------------------------
    def submit(self, payload: dict) -> None:
        """Client ingress helper: publish one request payload (the
        ``launch/serve.py`` schema) onto the requests topic."""
        self.bus.publish(REQUESTS_TOPIC, payload)

    def cancel(self, uid: str) -> bool:
        """Broadcast a cancel. Terminal state is guaranteed: a live owner
        cancels through its engine; an owner that dies first is caught by
        the failure handler, which finishes orphaned cancels directly."""
        st = self.states.get(uid)
        if st is None or st.finish_reason is not None:
            return False
        st.cancel_requested = True
        self.bus.publish(CONTROL_TOPIC, {"kind": "cancel", "uid": uid})
        return True

    def results(self) -> dict[str, RequestState]:
        return dict(self.states)

    def gauges(self) -> dict:
        """Aggregate last-step engine gauges over live workers — the
        occupancy signal the autoscaler folds in on top of consumer lag."""
        occ, pages = [], []
        for w in self.workers.values():
            g = w.gauge
            if not g or not w.thread.is_alive():
                continue
            occ.append(g.get("slot_occupancy", 0.0))
            if g.get("page_util") is not None:
                pages.append(g["page_util"])
        return {
            "slot_occupancy_mean": fmean(occ) if occ else 0.0,
            "page_util_mean": fmean(pages) if pages else 0.0,
        }

    # -- supervision ----------------------------------------------------
    def poll(self) -> None:
        """One supervision round: ingress -> relay -> detect failures ->
        reconcile replica count."""
        self.start()
        self._ingress()
        self._drain_events()
        self._detect_failures()
        self._reconcile()

    def run(self, expected: list[str] | None = None, timeout_s: float = 120.0,
            poll_s: float = 0.002) -> bool:
        """Poll until every expected uid (default: every ingressed request)
        is terminal. Returns False on timeout — callers assert on it."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.poll()
            if self._complete(expected):
                return True
            time.sleep(poll_s)
        return False

    def _complete(self, expected: list[str] | None) -> bool:
        if self.bus.lag(REQUESTS_TOPIC, SUPERVISOR_GROUP) > 0:
            return False
        if expected is not None:
            return all(
                u in self.states and self.states[u].finish_reason is not None
                for u in expected)
        return bool(self.states) and all(
            st.finish_reason is not None for st in self.states.values())

    # -- ingress --------------------------------------------------------
    def _ingress(self) -> None:
        for m in self.bus.consume(REQUESTS_TOPIC, SUPERVISOR_GROUP, limit=64):
            v = m.value
            if isinstance(v, dict) and "uid" in v:
                uid = str(v["uid"])
                payload = dict(v)
                if payload.get("seed") is None:
                    # stamp a deterministic seed NOW: recovery replays this
                    # exact payload, so the regenerated stream is identical
                    payload["seed"] = fleet_seed(self.cfg.seed_base,
                                                 self._ingressed)
                self._ingressed += 1
                if uid in self.states:
                    self.bus.publish(RESPONSES_TOPIC, {
                        "uid": uid, "event": "finish", "tokens": [],
                        "finish_reason": "rejected",
                        "error": f"request {uid}: uid already in flight",
                    })
                else:
                    self.states[uid] = RequestState(uid, payload)
                    self.bus.publish(WORK_TOPIC, payload)
            else:
                self.bus.publish(RESPONSES_TOPIC, {
                    "uid": "?", "event": "finish", "tokens": [],
                    "finish_reason": "rejected", "error": "malformed payload",
                })
            self.bus.commit(REQUESTS_TOPIC, SUPERVISOR_GROUP, m.offset + 1)

    # -- worker events --------------------------------------------------
    def _drain_events(self) -> None:
        for m in self.bus.consume(EVENTS_TOPIC, SUPERVISOR_GROUP, limit=512):
            v = m.value
            kind = v.get("kind")
            st = self.states.get(str(v.get("uid")))
            if st is not None:
                if kind == "accept":
                    # latest accept wins: on resubmit the new owner replaces
                    # the dead one
                    st.owner = v["worker"]
                elif kind == "delta":
                    self._on_delta(st, v)
                elif kind == "finish":
                    self._on_finish(st, v)
            self.bus.commit(EVENTS_TOPIC, SUPERVISOR_GROUP, m.offset + 1)

    def _on_delta(self, st: RequestState, v: dict) -> None:
        if st.finish_reason is not None:
            return  # late delta from a zombie attempt after cancel/finish
        idx, tok = int(v["index"]), int(v["token"])
        if idx < len(st.tokens):
            # regenerated prefix from a resubmit (or a zombie's duplicate):
            # drop it, but CHECK it — replay-identical recovery means the
            # regenerated token must equal what was already delivered
            self.metrics.duplicate_deltas += 1
            if st.tokens[idx] != tok:
                self.metrics.mismatched_deltas += 1
            return
        if idx > len(st.tokens):
            self.metrics.gapped_deltas += 1  # must never happen
            return
        st.tokens.append(tok)
        self.bus.publish(RESPONSES_TOPIC, {
            "uid": st.uid, "event": "delta", "token": tok, "index": idx,
        })
        if st.t_crash is not None and idx >= st.resume_from:
            st.recovery_s = time.monotonic() - st.t_crash
            self.metrics.record_recovery(st.recovery_s)
            st.t_crash = None

    def _on_finish(self, st: RequestState, v: dict) -> None:
        if st.finish_reason is not None:
            return  # first finish wins (zombie/redelivery duplicates)
        st.finish_reason = v["finish_reason"]
        st.error = v.get("error")
        self._publish_finish(st)

    def _publish_finish(self, st: RequestState) -> None:
        self.bus.publish(RESPONSES_TOPIC, {
            "uid": st.uid, "event": "finish", "tokens": list(st.tokens),
            "finish_reason": st.finish_reason, "error": st.error,
        })

    # -- failure detection + recovery ----------------------------------
    def _detect_failures(self) -> None:
        for name, w in list(self.workers.items()):
            if w.handled:
                continue
            if not w.thread.is_alive():
                if w.stopped_cleanly:
                    w.handled = True
                    self.monitor.forget(w.pod_id)
                    del self.workers[name]
                else:
                    self._handle_failure(name, w, w.kill_reason or w.error
                                         or "died")
        if self.cfg.livelock_window_s is not None:
            for pod, state in self.monitor.unhealthy_pods():
                if state != "livelocked":
                    continue
                for name, w in list(self.workers.items()):
                    if w.pod_id == pod and not w.handled:
                        w.stop.set()  # best effort; zombie output dedupes
                        self._handle_failure(name, w, "livelocked")

    def _handle_failure(self, name: str, w: EngineWorker, reason: str) -> None:
        w.handled = True
        # the worker is confirmed dead, so every delta it ever published is
        # already on the bus: drain once more so resume_from is the true
        # next-undelivered index (otherwise an undrained pre-crash tail
        # would stop the recovery stopwatch without any replay happening)
        self._drain_events()
        self.monitor.forget(w.pod_id)
        self.metrics.crashes += 1
        self.events.emit("worker_failed", step=name, attempt=w.attempt,
                         reason=reason)
        now = time.monotonic()
        for st in self.states.values():
            if st.owner != w.pod_id or st.finish_reason is not None:
                continue
            st.owner = None
            if st.cancel_requested:
                # cancelled then orphaned: never resubmit, never hang
                st.finish_reason = "cancelled"
                self.metrics.direct_cancels += 1
                self._publish_finish(st)
            else:
                st.t_crash = now
                st.resume_from = len(st.tokens)
                st.resubmits += 1
                self.metrics.resubmitted += 1
                self.bus.publish(WORK_TOPIC, st.payload)
        del self.workers[name]
        if w.attempt + 1 <= self.cfg.max_restarts:
            self.metrics.restarts += 1
            self.events.emit("worker_restarted", step=name,
                             attempt=w.attempt + 1, reason=reason)
            self._spawn(name, attempt=w.attempt + 1)

    # -- autoscaling ----------------------------------------------------
    def _reconcile(self) -> None:
        active = [w for w in self.workers.values()
                  if not w.handled and not w.draining.is_set()
                  and w.thread.is_alive()]
        desired = len(active)
        if self.scaler is not None:
            desired, _ = self.scaler.observe()
        for _ in range(max(0, desired - len(active))):
            active.append(self._spawn())
        extra = len(active) - desired
        if extra > 0:
            # retire the emptiest workers; draining finishes in-flight work
            for w in sorted(active, key=lambda w: len(w.inflight))[:extra]:
                w.retire()


__all__ = [
    "EngineWorker",
    "FleetConfig",
    "FleetSupervisor",
    "RequestState",
    "fleet_seed",
]
