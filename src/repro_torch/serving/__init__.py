"""Serving layer: one engine protocol over a paged, prefix-shared KV cache.

``repro_torch.serving.api`` is the single public surface — :class:`EngineCore`
(``submit``/``step``/``cancel``/``abort_all``), :class:`SamplingParams`,
:class:`RequestHandle` streaming, typed :class:`FinishReason`, and pluggable
:class:`AdmissionPolicy` queues (all carried over from ``repro.serving``
unchanged). ``ContinuousBatchingEngine`` is the ported hot path — continuous
admission, chunked prefill fused with decode, copy-on-write prefix sharing
with parked prefix pages (``repro_torch.serving.kv_tiers``), or
whole-prompt prefill through the flash kernel — running its paged
attention through the hand-written CUDA kernels on the card.
``GenerationEngine`` is the lockstep baseline over a dense cache (dense,
ssm and hybrid families; its attention prefill through the flash kernel).
``SSMEngine`` serves the ssm (mamba2) and hybrid (zamba2) families over a
:class:`SlotStateBank` of per-slot recurrent state (the hybrid's shared
attention over a paged pool beside it), through the SSD and paged kernels
on the card.

Still to port (ROADMAP A): the fleet, speculative decoding and the moe
and vlm families.
"""

from repro_torch.serving.api import (
    AdmissionPolicy,
    DeadlineAdmission,
    EngineCore,
    FIFOAdmission,
    FinishReason,
    PriorityAdmission,
    Request,
    RequestHandle,
    Result,
    SamplingParams,
    StreamEvent,
    UnsupportedConfigError,
    request_from_message,
)
from repro_torch.serving.engine import (
    ContinuousBatchingEngine,
    GenerationEngine,
)
from repro_torch.serving.kv_cache import PagedKVCache, PagePool
from repro_torch.serving.kv_tiers import KVTierManager
from repro_torch.serving.metrics import (
    FleetMetrics,
    format_latency,
    latency_percentiles,
)
from repro_torch.serving.ssm_engine import SlotStateBank, SSMEngine

__all__ = [
    "AdmissionPolicy",
    "ContinuousBatchingEngine",
    "DeadlineAdmission",
    "EngineCore",
    "FIFOAdmission",
    "FinishReason",
    "FleetMetrics",
    "GenerationEngine",
    "KVTierManager",
    "PagedKVCache",
    "PagePool",
    "PriorityAdmission",
    "Request",
    "RequestHandle",
    "Result",
    "SSMEngine",
    "SamplingParams",
    "SlotStateBank",
    "StreamEvent",
    "UnsupportedConfigError",
    "format_latency",
    "latency_percentiles",
    "request_from_message",
]
