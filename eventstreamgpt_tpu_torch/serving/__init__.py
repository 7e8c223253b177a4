"""Serving (counterpart: ``eventstreamgpt_tpu/serving``): the CI and NA generation
engine with its speculative decoding and hot swap, the prefill stream, the SLO
lanes and the service over engine replicas."""

from .engine import GenerationEngine, PrefillHandoff
from .errors import BlockLedgerError, DeadlineExceeded, MalformedPromptRejected, ServingError, SlotHealthError
from .fleet import PrefillStream
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
    "DeadlineExceeded",
    "EngineResult",
    "ForkSpec",
    "GenerationEngine",
    "LaneConfig",
    "LaneQueues",
    "MalformedPromptRejected",
    "PrefillHandoff",
    "PrefillStream",
    "Request",
    "ServiceResult",
    "ServingError",
    "ServingService",
    "SlotHealthError",
    "SpecConfig",
    "latency_quantiles",
    "truncated_draft",
]
