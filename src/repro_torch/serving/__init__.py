"""Serving layer: one engine protocol over a paged, prefix-shared KV cache.

``repro_torch.serving.api`` is the single public surface — :class:`EngineCore`
(``submit``/``step``/``cancel``/``abort_all``), :class:`SamplingParams`,
:class:`RequestHandle` streaming, typed :class:`FinishReason`, and pluggable
:class:`AdmissionPolicy` queues (all carried over from ``repro.serving``
unchanged). ``ContinuousBatchingEngine`` is the ported hot path — continuous
admission, chunked prefill fused with decode, copy-on-write prefix sharing
with parked prefix pages (``repro_torch.serving.kv_tiers``), or
whole-prompt prefill through the flash kernel — running its paged
attention through the hand-written CUDA kernels on the card, for the
dense, moe and vlm families (vlm prompts, which carry vision embeddings,
always take the whole-prompt prefill). ``GenerationEngine`` is the
lockstep baseline over a dense cache (every decoder family and the
encoder-decoder; its attention prefill through the flash kernel).
``SSMEngine`` serves the ssm (mamba2) and hybrid (zamba2) families over a
:class:`SlotStateBank` of per-slot recurrent state (the hybrid's shared
attention over a paged pool beside it), through the SSD and paged kernels
on the card.

Speculative decoding (``serving.speculative``: the ngram and draft-model
proposers) rides the paged engine's chunk path; ``serving.fleet`` runs
engines as supervised workers over the bus, with heartbeats, crash replay
and autoscaling. ``serving.executor`` shards the paged and SSM engines
over a ``("model",)`` mesh of ranks (``pick_tp``,
``serving_mesh_scope``, ``set_default_serving_mesh``), as the JAX
package's executor does; the engine signatures stay mesh-free.
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
from repro_torch.serving.fleet import (
    EngineWorker,
    FleetConfig,
    FleetSupervisor,
    fleet_seed,
)
from repro_torch.serving.kv_cache import PagedKVCache, PagePool
from repro_torch.serving.kv_tiers import KVTierManager
from repro_torch.serving.metrics import (
    FleetMetrics,
    format_latency,
    latency_percentiles,
)
from repro_torch.serving.speculative import (
    DraftModelProposer,
    NgramProposer,
    SpeculativeProposer,
    build_proposer,
)
from repro_torch.serving.ssm_engine import SlotStateBank, SSMEngine

__all__ = [
    "AdmissionPolicy",
    "ContinuousBatchingEngine",
    "DeadlineAdmission",
    "DraftModelProposer",
    "EngineCore",
    "EngineWorker",
    "FIFOAdmission",
    "FinishReason",
    "FleetConfig",
    "FleetMetrics",
    "FleetSupervisor",
    "GenerationEngine",
    "KVTierManager",
    "NgramProposer",
    "PagedKVCache",
    "PagePool",
    "PriorityAdmission",
    "Request",
    "RequestHandle",
    "Result",
    "SSMEngine",
    "SamplingParams",
    "SlotStateBank",
    "SpeculativeProposer",
    "StreamEvent",
    "UnsupportedConfigError",
    "build_proposer",
    "fleet_seed",
    "format_latency",
    "latency_percentiles",
    "request_from_message",
]
