"""Serving (counterpart: ``eventstreamgpt_tpu/serving``): the CI and NA generation
engine with its speculative decoding and hot swap, the prefill stream, the SLO
lanes, the service over engine replicas, and the fleet over services with its
consistent-hash router."""

from .engine import GenerationEngine, PrefillHandoff
from .errors import (
    BlockLedgerError,
    DeadlineExceeded,
    MalformedPromptRejected,
    PromotionError,
    ReplicaDeadError,
    ReplicaHungError,
    ServingError,
    SlotHealthError,
)
from .fleet import FleetHealthConfig, FleetResult, PrefillStream, ServingFleet
from .router import ConsistentHashRouter, stable_hash
from .scheduler import AdmissionRejected, EngineResult, ForkSpec, Request
from .service import ServiceResult, ServingService, latency_quantiles
from .slo import BATCH, DEFAULT_LANES, INTERACTIVE, LaneConfig, LaneQueues
from .spec import SpecConfig, truncated_draft

__all__ = [
    "BATCH",
    "DEFAULT_LANES",
    "INTERACTIVE",
    "AdmissionRejected",
    "BlockLedgerError",
    "ConsistentHashRouter",
    "DeadlineExceeded",
    "EngineResult",
    "FleetHealthConfig",
    "FleetResult",
    "ForkSpec",
    "GenerationEngine",
    "LaneConfig",
    "LaneQueues",
    "MalformedPromptRejected",
    "PrefillHandoff",
    "PrefillStream",
    "PromotionError",
    "ReplicaDeadError",
    "ReplicaHungError",
    "Request",
    "ServiceResult",
    "ServingError",
    "ServingFleet",
    "ServingService",
    "SlotHealthError",
    "SpecConfig",
    "latency_quantiles",
    "stable_hash",
    "truncated_draft",
]
