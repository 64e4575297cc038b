"""The public serving surface: one engine protocol, streamed request lifecycle.

Every engine — the lockstep micro-batcher, the paged continuous batcher, and
future sharded/SSM engines — speaks the same contract, so the bus worker in
``launch/serve.py``, the workflow scheduler's retry/hedging machinery, and
benchmarks drive them identically:

* :class:`SamplingParams` — temperature, top-k, top-p, stop tokens,
  ``max_new_tokens`` and an optional per-request seed. Seeded requests
  reproduce the same tokens regardless of batch placement (the sampler keys
  RNG off ``(seed, token_index)``, never off engine-global step counters).
* :class:`Request` — uid + prompt + sampling, plus ``priority`` and
  ``deadline_s`` consumed by admission policies. The legacy
  ``max_new_tokens=`` / ``temperature=`` constructor arguments still work
  and fold into ``sampling``.
* :class:`EngineCore` — the protocol: ``submit() -> RequestHandle``,
  ``step() -> list[StreamEvent]``, ``cancel(uid)``, ``abort_all()``,
  ``capacity()``, ``idle``.
* :class:`RequestHandle` — the live view of one request: incremental token
  deltas (:meth:`RequestHandle.new_tokens`), TTFT / inter-token gaps, and a
  typed :class:`FinishReason` (length / stop / cancelled / rejected /
  preempted).
* :class:`AdmissionPolicy` — pluggable queue ordering: :class:`FIFOAdmission`
  (default), :class:`PriorityAdmission` (higher ``Request.priority`` first),
  :class:`DeadlineAdmission` (earliest deadline first; queued requests whose
  deadline lapses finish ``rejected`` instead of serving dead work).

Validation lives at this boundary (:func:`validate_request` +
:meth:`SamplingParams.validate`): empty prompts, non-positive
``max_new_tokens``, and prompts that exceed an engine's context budget are
rejected identically whether a request arrives via :meth:`EngineBase.submit`,
the deprecated ``enqueue``, or a bus topic (:func:`request_from_message`).
``submit`` never raises — an invalid request comes back as a handle already
finished with ``FinishReason.REJECTED`` and ``error`` set.

The driving loop every caller shares::

    handle = engine.submit(Request("r0", prompt, sampling=SamplingParams(...)))
    while not engine.idle:
        for ev in engine.step():       # StreamEvents: token deltas + finishes
            ...
    result = handle.result()           # tokens, ttft, itl, finish_reason
"""

from __future__ import annotations

import enum
import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable


class FinishReason(str, enum.Enum):
    """Why a request stopped producing tokens (terminal, exactly one each)."""

    LENGTH = "length"        # produced sampling.max_new_tokens tokens
    STOP = "stop"            # sampled a token in sampling.stop_tokens
    CANCELLED = "cancelled"  # cancel(uid) / abort_all()
    REJECTED = "rejected"    # failed validation, or deadline lapsed queued
    PREEMPTED = "preempted"  # evicted under pressure past max_preemptions


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls, validated at the API boundary.

    ``temperature <= 0`` means greedy (top-k/top-p are then irrelevant).
    ``top_k=0`` and ``top_p=1.0`` disable their filters. ``stop_tokens``
    terminate the request with ``FinishReason.STOP``; the stop token itself
    is not emitted. ``seed`` pins the request's RNG stream: the same seeded
    request produces the same tokens no matter how it is batched.
    ``speculative=False`` opts this request out of speculative decoding on
    engines that enable it (streams are identical either way — the
    ``(seed, token_index)``-keyed sampler makes acceptance exact — so this
    is a latency/throughput knob, not a quality one).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_tokens: tuple[int, ...] = ()
    max_new_tokens: int = 16
    seed: int | None = None
    speculative: bool = True

    def __post_init__(self):
        if not isinstance(self.stop_tokens, tuple):
            object.__setattr__(self, "stop_tokens", tuple(self.stop_tokens))

    def validate(self) -> None:
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if any(not isinstance(t, int) or t < 0 for t in self.stop_tokens):
            raise ValueError(f"stop_tokens must be non-negative ints: "
                             f"{self.stop_tokens}")


@dataclass
class Request:
    """One generation request.

    ``sampling`` is authoritative; the legacy ``max_new_tokens`` /
    ``temperature`` constructor arguments are kept for callers of the old
    two-field API and fold into a :class:`SamplingParams` when ``sampling``
    is not given (when it is, the legacy fields are synced *from* it, so both
    views always agree). ``priority`` and ``deadline_s`` (seconds after
    arrival) are consumed by :class:`PriorityAdmission` /
    :class:`DeadlineAdmission` and ignored by FIFO.
    """

    uid: str
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    # optional caller-supplied arrival time for TTFT; when None the engine
    # stamps submit time itself (engine-side; the Request is never mutated
    # after construction, so resubmission stays safe)
    arrival_t: float | None = None
    sampling: SamplingParams | None = None
    priority: int = 0
    deadline_s: float | None = None

    def __post_init__(self):
        if self.sampling is None:
            self.sampling = SamplingParams(
                temperature=self.temperature,
                max_new_tokens=self.max_new_tokens,
            )
        else:
            self.max_new_tokens = self.sampling.max_new_tokens
            self.temperature = self.sampling.temperature


@dataclass
class Result:
    """Terminal summary of one request (see :meth:`RequestHandle.result`)."""

    uid: str
    tokens: list[int] = field(default_factory=list)
    ttft: float | None = None      # seconds, submit -> first token
    itl: list[float] = field(default_factory=list)  # inter-token gaps (s)
    finish_reason: FinishReason | None = None
    error: str | None = None


@dataclass(frozen=True)
class StreamEvent:
    """One observable lifecycle transition, returned by ``engine.step()``.

    ``kind`` is ``"token"`` (one incremental delta; ``token``/``index`` set),
    ``"finish"`` (terminal; ``finish_reason`` set), or ``"preempted"``
    (non-terminal: the request was evicted and requeued; its already-streamed
    tokens remain valid and will NOT be re-emitted when it regenerates).
    Within one ``step()`` batch a request's token events precede its finish
    event, and indices are consecutive.
    """

    uid: str
    kind: str  # "token" | "finish" | "preempted"
    token: int | None = None
    index: int | None = None
    finish_reason: FinishReason | None = None
    t: float = 0.0


class RequestHandle:
    """Live, caller-facing view of one submitted request.

    The engine appends tokens as they are produced; callers either poll
    :meth:`new_tokens` (drains deltas since the last call) or watch the
    :class:`StreamEvent` stream from ``engine.step()``. ``ttft``/``itl`` are
    stamped at emission time, and :meth:`result` snapshots everything once
    ``done``. Preemption is transparent: regenerated tokens are de-duplicated
    against what was already streamed (sampling is keyed off
    ``(seed, token_index)``, so a regenerated stream is identical).
    """

    def __init__(self, request: Request, engine: "EngineBase | None" = None):
        self.request = request
        self.uid = request.uid
        self.tokens: list[int] = []
        self.ttft: float | None = None
        self.itl: list[float] = []
        self.finish_reason: FinishReason | None = None
        self.error: str | None = None
        self.arrival: float | None = None
        self.seed: int = 0           # effective sampling seed (engine-set)
        self.preemptions: int = 0
        self._engine = engine
        self._cursor = 0
        self._last_t: float | None = None

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    def new_tokens(self) -> list[int]:
        """Drain and return the tokens emitted since the last call."""
        out = self.tokens[self._cursor:]
        self._cursor = len(self.tokens)
        return out

    def cancel(self) -> bool:
        """Cancel this request on its engine (queued or mid-decode)."""
        return self._engine.cancel(self.uid) if self._engine else False

    def result(self) -> Result:
        return Result(
            self.uid, list(self.tokens), ttft=self.ttft, itl=list(self.itl),
            finish_reason=self.finish_reason, error=self.error,
        )

    def _emit(self, tok: int, now: float) -> None:
        if not self.tokens:
            if self.arrival is not None:
                self.ttft = now - self.arrival
        elif self._last_t is not None:
            self.itl.append(now - self._last_t)
        self._last_t = now
        self.tokens.append(tok)


# ---------------------------------------------------------------------------
# admission policies
# ---------------------------------------------------------------------------


class AdmissionPolicy:
    """Orders the waiting queue; engines only ever see the head.

    ``push`` adds a newly submitted request; ``requeue`` re-adds a preempted
    one (policies should place it no later than its original position);
    ``peek``/``pop`` expose the next admission candidate; ``remove`` supports
    cancellation of queued requests; ``take_expired`` drains requests whose
    deadline lapsed before admission (the engine finishes them ``rejected``).
    """

    def push(self, req: Request, arrival: float) -> None:
        raise NotImplementedError

    def requeue(self, req: Request, arrival: float) -> None:
        self.push(req, arrival)

    def peek(self, now: float) -> Request | None:
        raise NotImplementedError

    def pop(self, now: float) -> Request:
        raise NotImplementedError

    def remove(self, uid: str) -> Request | None:
        raise NotImplementedError

    def take_expired(self, now: float) -> list[Request]:
        return []

    def __len__(self) -> int:
        raise NotImplementedError


class FIFOAdmission(AdmissionPolicy):
    """Arrival order; preempted requests rejoin at the front."""

    def __init__(self):
        self._q: deque[tuple[Request, float]] = deque()

    def push(self, req, arrival):
        self._q.append((req, arrival))

    def requeue(self, req, arrival):
        self._q.appendleft((req, arrival))

    def peek(self, now):
        return self._q[0][0] if self._q else None

    def pop(self, now):
        return self._q.popleft()[0]

    def remove(self, uid):
        for i, (r, _) in enumerate(self._q):
            if r.uid == uid:
                del self._q[i]
                return r
        return None

    def __len__(self):
        return len(self._q)


class _LazyHeapAdmission(AdmissionPolicy):
    """Heap-ordered queue with lazy deletion, shared by the priority and
    deadline policies. Subclasses define :meth:`_key` (the heap sort key
    for a request). Removal tombstones key off OBJECT identity, not uid: a
    uid freed by cancellation may be resubmitted while the stale entry
    still sits in the heap, and the new entry must not be swallowed.
    """

    def __init__(self):
        self._heap: list[tuple] = []  # (key, seq, req)
        self._gone: set[int] = set()
        self._seq = 0

    def _key(self, req: Request, arrival: float):
        raise NotImplementedError

    def push(self, req, arrival):
        self._seq += 1
        heapq.heappush(self._heap, (self._key(req, arrival), self._seq, req))

    def _clean(self):
        while self._heap and id(self._heap[0][2]) in self._gone:
            self._gone.discard(id(heapq.heappop(self._heap)[2]))

    def peek(self, now):
        self._clean()
        return self._heap[0][2] if self._heap else None

    def pop(self, now):
        self._clean()
        return heapq.heappop(self._heap)[2]

    def remove(self, uid):
        for _, _, r in self._heap:
            if r.uid == uid and id(r) not in self._gone:
                self._gone.add(id(r))
                return r
        return None

    def __len__(self):
        return len(self._heap) - len(self._gone)


class PriorityAdmission(_LazyHeapAdmission):
    """Higher ``Request.priority`` first; FIFO within a priority level.

    Preempted requests rejoin ahead of equal-priority arrivals (they already
    held resources once).
    """

    def __init__(self):
        super().__init__()
        self._front = 0

    def _key(self, req, arrival):
        return -req.priority

    def requeue(self, req, arrival):
        self._front -= 1
        heapq.heappush(self._heap, (self._key(req, arrival), self._front, req))


class DeadlineAdmission(_LazyHeapAdmission):
    """Earliest ``arrival + deadline_s`` first (EDF); no deadline sorts last.

    Queued requests whose deadline has already lapsed are surfaced through
    :meth:`take_expired` — the engine finishes them ``rejected`` instead of
    spending decode slots on answers nobody is waiting for.
    """

    _NO_DEADLINE = float("inf")

    def _key(self, req, arrival):
        if req.deadline_s is None:
            return self._NO_DEADLINE
        return arrival + req.deadline_s

    def take_expired(self, now):
        out = []
        self._clean()
        while self._heap and self._heap[0][0] < now:
            out.append(heapq.heappop(self._heap)[2])
            self._clean()
        return out


# ---------------------------------------------------------------------------
# validation + bus parsing (the shared API boundary)
# ---------------------------------------------------------------------------


class UnsupportedConfigError(ValueError):
    """No serving engine supports this model config.

    Raised by launch-time engine selection instead of silently falling
    back to a weaker engine: a driver asked for a family/feature
    combination (e.g. encoder-decoder behind the paged engine) that every
    available engine rejects, so the deployment must fail loudly up front
    rather than serve with surprising semantics.
    """


def validate_request(req: Request, *, max_len: int, extra_ctx: int = 0) -> None:
    """Boundary checks shared by every engine and ingress path.

    ``extra_ctx`` covers non-token context the engine prepends (e.g. vlm
    frontend tokens). Raises ValueError with a stable message; engines add
    their own capacity checks on top.
    """
    req.sampling.validate()
    if not req.prompt:
        raise ValueError(f"request {req.uid}: empty prompt")
    ctx = extra_ctx + len(req.prompt)
    if ctx + req.sampling.max_new_tokens > max_len:
        raise ValueError(
            f"request {req.uid}: context {ctx}+{req.sampling.max_new_tokens} "
            f"exceeds engine max_len={max_len}"
        )


def request_from_message(v: dict) -> Request:
    """Build a Request from a bus message value, carrying EVERY sampling
    field (the old per-engine parsers silently dropped ``temperature``).
    Raises KeyError/TypeError/ValueError on malformed payloads — callers
    treat those as poison messages."""
    sp = SamplingParams(
        temperature=float(v.get("temperature", 0.0)),
        top_k=int(v.get("top_k", 0)),
        top_p=float(v.get("top_p", 1.0)),
        stop_tokens=tuple(int(t) for t in v.get("stop_tokens", ())),
        max_new_tokens=int(v.get("max_new_tokens", 16)),
        seed=None if v.get("seed") is None else int(v["seed"]),
    )
    return Request(
        str(v["uid"]), [int(t) for t in v["prompt"]], sampling=sp,
        arrival_t=v.get("arrival_t"),
        priority=int(v.get("priority", 0)),
        deadline_s=None if v.get("deadline_s") is None else float(v["deadline_s"]),
    )


# ---------------------------------------------------------------------------
# the engine protocol + shared lifecycle machinery
# ---------------------------------------------------------------------------


@runtime_checkable
class EngineCore(Protocol):
    """What every serving engine exposes. ``submit`` never raises (invalid
    requests return a handle already finished ``rejected``); ``step`` runs
    one scheduling quantum and returns the lifecycle events it produced;
    ``capacity`` hints how many new requests the engine wants pulled from
    an ingress queue."""

    def submit(self, request: Request) -> RequestHandle: ...

    def step(self) -> list[StreamEvent]: ...

    def cancel(self, uid: str) -> bool: ...

    def abort_all(self) -> int: ...

    def capacity(self) -> int: ...

    @property
    def idle(self) -> bool: ...


class EngineBase:
    """Shared request-lifecycle machinery behind :class:`EngineCore`.

    Concrete engines provide ``_validate`` (capacity checks beyond
    :func:`validate_request`), ``_cancel_active`` (tear down an
    admitted/decoding request), ``step``, ``capacity`` and ``idle``; this
    base owns handles, the admission queue, event buffering, rejection
    bookkeeping and the deprecated synchronous wrappers."""

    def _init_api(self, *, admission: AdmissionPolicy | None, seed: int) -> None:
        self.admission = admission if admission is not None else FIFOAdmission()
        self._handles: dict[str, RequestHandle] = {}
        self._events: list[StreamEvent] = []
        self.rejections: list[tuple[str, str]] = []
        self.stats: dict[str, int] = {"tokens": 0, "rejected": 0}
        self._seed_base = seed
        self._submit_counter = 0

    # -- engine hooks ---------------------------------------------------
    def _validate(self, request: Request) -> None:
        raise NotImplementedError

    def _cancel_active(self, uid: str) -> bool:
        raise NotImplementedError

    # -- protocol -------------------------------------------------------
    def submit(self, request: Request) -> RequestHandle:
        """Validate and queue a request. Never raises: an invalid request
        returns a handle already finished ``FinishReason.REJECTED``."""
        h = RequestHandle(request, engine=self)
        try:
            self._validate(request)
            if request.uid in self._handles:
                raise ValueError(
                    f"request {request.uid}: uid already in flight"
                )
        except (ValueError, TypeError) as e:
            h.finish_reason = FinishReason.REJECTED
            h.error = str(e)
            self.rejections.append((request.uid, str(e)))
            self.stats["rejected"] += 1
            return h
        now = time.perf_counter()
        h.arrival = request.arrival_t if request.arrival_t is not None else now
        self._submit_counter += 1
        sp = request.sampling
        h.seed = (
            sp.seed if sp.seed is not None
            else (self._seed_base * 1_000_003 + self._submit_counter)
        ) & 0x7FFFFFFF
        self._handles[request.uid] = h
        self.admission.push(request, h.arrival)
        return h

    def cancel(self, uid: str) -> bool:
        """Cancel a queued or in-flight request; returns False when the uid
        is unknown or already finished. Streamed tokens stay on the handle;
        the finish event (reason ``cancelled``) is delivered by the next
        ``step()``."""
        h = self._handles.get(uid)
        if h is None or h.done:
            return False
        if self.admission.remove(uid) is not None:
            self._finish_handle(h, FinishReason.CANCELLED)
            return True
        return self._cancel_active(uid)

    def abort_all(self) -> int:
        """Cancel every queued and in-flight request; returns the count."""
        return sum(self.cancel(uid) for uid in list(self._handles))

    def capacity(self) -> int:
        raise NotImplementedError

    @property
    def idle(self) -> bool:
        raise NotImplementedError

    def step(self) -> list[StreamEvent]:
        raise NotImplementedError

    def close(self) -> None:
        """Release what the engine holds beyond its own process (a
        tensor-parallel executor's followers); a no-op unless an engine
        has such. The engine serves no more steps after it."""

    # -- shared internals ----------------------------------------------
    def _drain_events(self) -> list[StreamEvent]:
        out, self._events = self._events, []
        return out

    def _finish_handle(
        self,
        h: RequestHandle,
        reason: FinishReason,
        error: str | None = None,
        now: float | None = None,
    ) -> None:
        h.finish_reason = reason
        h.error = error
        self._handles.pop(h.uid, None)
        self._events.append(StreamEvent(
            h.uid, "finish", finish_reason=reason,
            t=time.perf_counter() if now is None else now,
        ))

    def _deliver(self, h: RequestHandle, tok: int, idx: int, now: float) -> bool:
        """Process one sampled token for ``h`` (attempt-local index ``idx``):
        de-duplicates regenerated tokens after preemption, applies stop
        tokens (the stop token is not emitted), emits the delta event, and
        finishes on length. Returns True when the request finished."""
        if idx < len(h.tokens):
            return False  # regenerating after preemption: already streamed
        sp = h.request.sampling
        if tok in sp.stop_tokens:
            self._finish_handle(h, FinishReason.STOP, now=now)
            return True
        h._emit(tok, now)
        self._events.append(StreamEvent(
            h.uid, "token", token=tok, index=len(h.tokens) - 1, t=now
        ))
        self.stats["tokens"] += 1
        if len(h.tokens) >= sp.max_new_tokens:
            self._finish_handle(h, FinishReason.LENGTH, now=now)
            return True
        return False

    def _expire_queue(self, now: float) -> None:
        for req in self.admission.take_expired(now):
            h = self._handles.get(req.uid)
            if h is not None:
                err = (f"request {req.uid}: deadline exceeded before "
                       f"admission")
                self._finish_handle(h, FinishReason.REJECTED, error=err,
                                    now=now)
                self.rejections.append((req.uid, err))
                self.stats["rejected"] += 1

    # -- ingress + deprecated wrappers ---------------------------------
    def admit_from_bus(self, bus, topic: str, group: str,
                       max_msgs: int = 32) -> int:
        """Pull pending requests from a ``core.bus`` topic (at-least-once:
        each message is committed after handling). Malformed or unservable
        messages are rejected — recorded in ``self.rejections`` /
        ``stats['rejected']`` — and still committed, so one poison message
        never wedges the consumer group."""
        n = 0
        if max_msgs <= 0:
            return 0
        for m in bus.consume(topic, group, limit=max_msgs):
            v = m.value
            try:
                req = request_from_message(v)
            except (ValueError, KeyError, TypeError) as e:
                uid = v.get("uid", "?") if isinstance(v, dict) else "?"
                self.rejections.append((str(uid), str(e)))
                self.stats["rejected"] += 1
            else:
                if self.submit(req).finish_reason is None:
                    n += 1
            bus.commit(topic, group, m.offset + 1)
        return n

    def drain_rejections(self) -> list[tuple[str, str]]:
        out, self.rejections = self.rejections, []
        return out

    def enqueue(self, req: Request) -> None:
        """Deprecated: :meth:`submit` with raise-on-reject semantics."""
        h = self.submit(req)
        if h.finish_reason is FinishReason.REJECTED:
            raise ValueError(h.error)

    def generate(self, requests: list[Request]) -> list[Result]:
        """Deprecated synchronous wrapper: drain ``requests`` through the
        engine and return Results in submission order. New callers should
        use :meth:`submit` + :meth:`step` (streaming, cancellable)."""
        handles = [self.submit(r) for r in requests]
        for h in handles:
            if h.finish_reason is FinishReason.REJECTED:
                raise ValueError(h.error)
        while not self.idle:
            self.step()
        return [h.result() for h in handles]


__all__ = [
    "AdmissionPolicy",
    "DeadlineAdmission",
    "EngineBase",
    "EngineCore",
    "FIFOAdmission",
    "FinishReason",
    "PriorityAdmission",
    "Request",
    "RequestHandle",
    "Result",
    "SamplingParams",
    "StreamEvent",
    "request_from_message",
    "validate_request",
]
