"""Serving (counterpart: ``eventstreamgpt_tpu/serving``): the CI generation engine."""

from .engine import GenerationEngine
from .errors import BlockLedgerError, MalformedPromptRejected, ServingError, SlotHealthError
from .scheduler import AdmissionRejected, EngineResult, ForkSpec, Request

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
]
