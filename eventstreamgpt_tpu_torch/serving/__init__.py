"""Serving (counterpart: ``eventstreamgpt_tpu/serving``): the CI generation engine and its speculative decoding."""

from .engine import GenerationEngine
from .errors import BlockLedgerError, MalformedPromptRejected, ServingError, SlotHealthError
from .scheduler import AdmissionRejected, EngineResult, ForkSpec, Request
from .spec import SpecConfig, truncated_draft

__all__ = [
    "AdmissionRejected",
    "BlockLedgerError",
    "EngineResult",
    "ForkSpec",
    "GenerationEngine",
    "MalformedPromptRejected",
    "Request",
    "ServingError",
    "SlotHealthError",
    "SpecConfig",
    "truncated_draft",
]
