"""WorkflowScheduler: runs a StepGraph with the paper-§3.5 FT stack.

Per-step guarantees:
  * k speculative replicas (ReplicaSet analogue) — first success wins,
    losers are cancelled; long-running (checkpointed) steps force k=1 and
    get restart-based FT instead (DESIGN.md, changed-assumption #2);
  * retries with exponential backoff up to ``RetryPolicy.max_attempts``;
  * liveness: a running attempt whose heartbeats stop for longer than the
    window is declared dead and rescheduled (probe analogue);
  * at-least-once + idempotent completion: results are recorded once per
    step under an idempotency key; duplicate successes are dropped;
  * inter-step pipes go through the ArtifactStore (refs), events/heartbeats
    through the TopicBus — the paper's Kafka/PV split.

``device`` is where the workflow's steps run (``"cuda"`` unless the caller
passes ``"cpu"``; asking for CUDA without a card raises): each step's
capsule records it as its backend.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core.bus import TopicBus
from repro_torch.core.capsule import StepImage, seal_step
from repro_torch.core.dag import StepGraph
from repro_torch.core.events import EventLog
from repro_torch.core.executor import WorkerPod
from repro_torch.core.probes import HealthMonitor
from repro_torch.core.storage import ArtifactStore
from repro_torch.models.common import resolve_device


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0

    def delay(self, attempt: int) -> float:
        return self.backoff_s * (self.backoff_mult ** max(attempt - 1, 0))


@dataclass
class _StepState:
    image: StepImage
    attempts_used: int = 0
    pods: list[WorkerPod] = field(default_factory=list)
    done: bool = False
    outputs: dict | None = None
    next_launch_ts: float = 0.0


class WorkflowScheduler:
    def __init__(
        self,
        graph: StepGraph,
        bus: TopicBus,
        store: ArtifactStore,
        *,
        workflow: str = "wf",
        retry: RetryPolicy = RetryPolicy(),
        liveness_window_s: float = 10.0,
        fault_injector=None,
        claim_paths: dict[str, str] | None = None,
        poll_interval_s: float = 0.02,
        hedge_after_s: float | None = None,
        device="cuda",
    ):
        """``hedge_after_s``: straggler mitigation — if a (non-long-running)
        step's only attempt has been running this long, launch ONE hedged
        speculative attempt; first success wins (tail-latency hedging)."""
        self.graph = graph
        self.bus = bus
        self.store = store
        self.retry = retry
        self.events = EventLog(bus, workflow)
        self.monitor = HealthMonitor(bus, liveness_window_s)
        self.faults = fault_injector
        self.claim_paths = claim_paths or {}
        self.poll = poll_interval_s
        self.hedge_after_s = hedge_after_s
        self.device = resolve_device(device)
        self._state: dict[str, _StepState] = {}

    # ------------------------------------------------------------------
    def _replicas_for(self, step) -> int:
        if step.long_running:
            return 1  # restart-based FT; see DESIGN.md changed-assumption #2
        return max(1, step.replicas)

    def _launch_one(self, name: str, inputs: dict, replica: int = 0):
        st = self._state[name]
        st.attempts_used += 1
        attempt = st.attempts_used
        pod = WorkerPod(
            pod_name=f"{name}-a{attempt}",
            image=st.image,
            inputs=inputs,
            bus=self.bus,
            store=self.store,
            events=self.events,
            attempt=attempt,
            claim_path=self.claim_paths.get(name, ""),
        )
        st.pods.append(pod)
        self.events.emit("pod_start", name, attempt, replica=replica)
        pod.start()
        if self.faults is not None:
            self.faults.on_pod_start(pod)

    def _launch(self, name: str, inputs: dict):
        step = self._state[name].image.step
        for r in range(self._replicas_for(step)):
            self._launch_one(name, inputs, replica=r)

    def _inputs_for(self, name: str, artifacts: dict) -> dict:
        step = self.graph.steps[name]
        missing = {r for r in step.reads if r not in artifacts}
        if missing:
            raise KeyError(f"step {name} missing inputs {missing}")
        return {r: artifacts[r] for r in step.reads}

    # ------------------------------------------------------------------
    def join(self, timeout_s: float | None = None) -> None:
        """Wait for every pod of the run to end. :meth:`run` returns once
        each step has a winner; a replica it superseded stops only at its
        next heartbeat, and until then still holds (and uses) its device
        memory."""
        for st in self._state.values():
            for pod in st.pods:
                pod.join(timeout_s)

    def run(self, external_inputs: dict | None = None, timeout_s: float = 120.0) -> dict:
        artifacts: dict = dict(external_inputs or {})
        for name, step in self.graph.steps.items():
            self._state[name] = _StepState(
                image=seal_step(step, device=self.device))
        order = self.graph.topological()
        self.events.emit("workflow_start", fields_steps=order)
        deadline = time.time() + timeout_s

        while True:
            progressed = False
            now = time.time()
            for name in order:
                st = self._state[name]
                if st.done:
                    continue
                deps = self.graph.deps(name)
                if not all(self._state[d].done for d in deps):
                    continue

                # snapshot each pod's state ONCE per iteration: state is a
                # live property, and a pod finishing between two reads must
                # not be miscounted (a fast hedge dying between the winner
                # check and the running-pod count triggered a spurious
                # second hedge)
                states = [(p, p.state) for p in st.pods]

                # 1) harvest — first success wins (idempotent record)
                winner = next((p for p, s in states if s == "succeeded"), None)
                if winner is not None:
                    for p in st.pods:
                        if p is not winner and p.is_alive():
                            p.kill_switch.kill("superseded_by_replica")
                    st.done = True
                    st.outputs = winner.outputs
                    refs = {}
                    for k, v in winner.outputs.items():
                        try:
                            refs[k] = self.store.put(v, name=f"{name}.{k}")
                        except (TypeError, AttributeError, ValueError):
                            # modules / live handles: in-process pipe only
                            refs[k] = f"inline://{name}.{k}"
                    artifacts.update(winner.outputs)
                    self.events.emit(
                        "step_done", name, winner.attempt,
                        pod=winner.pod_name, refs=refs,
                        wall_s=round(winner.finished_ts - winner.started_ts, 4),
                    )
                    progressed = True
                    continue

                # 2) liveness: kill zombie attempts whose heartbeats stopped
                for p, s in states:
                    if s == "running" and self.monitor.status(p.pod_name) == "dead":
                        p.kill_switch.kill("liveness_probe_failed")
                        self.events.emit("pod_liveness_kill", name, p.attempt)

                running_pods = [p for p, s in states if s in ("running", "pending")]
                if running_pods:
                    # straggler hedging: one extra speculative attempt
                    if (
                        self.hedge_after_s is not None
                        and not st.image.step.long_running
                        and len(running_pods) == 1
                        and st.attempts_used
                        < self.retry.max_attempts * self._replicas_for(st.image.step)
                        and running_pods[0].started_ts
                        and now - running_pods[0].started_ts > self.hedge_after_s
                    ):
                        self.events.emit("pod_hedged", name, st.attempts_used + 1)
                        self._launch_one(name, self._inputs_for(name, artifacts))
                        progressed = True
                    continue  # still working

                # 3) nothing running, no winner -> (re)launch after backoff
                if st.pods and now < st.next_launch_ts:
                    continue
                if st.attempts_used >= self.retry.max_attempts * self._replicas_for(st.image.step):
                    raise RuntimeError(
                        f"step {name} failed after {st.attempts_used} attempts; "
                        f"events={self.events.history('step_error')[-3:]}"
                    )
                if st.pods:
                    self.events.emit(
                        "step_retry_scheduled", name, st.attempts_used,
                        delay_s=self.retry.delay(st.attempts_used),
                    )
                self._launch(name, self._inputs_for(name, artifacts))
                st.next_launch_ts = now + self.retry.delay(st.attempts_used)
                progressed = True

            if all(s.done for s in self._state.values()):
                self.events.emit("workflow_done")
                return artifacts
            if time.time() > deadline:
                states = {n: [p.state for p in s.pods] for n, s in self._state.items()}
                raise TimeoutError(f"workflow timed out; pod states: {states}")
            if not progressed:
                time.sleep(self.poll)
