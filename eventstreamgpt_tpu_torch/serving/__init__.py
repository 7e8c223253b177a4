"""Serving (counterpart: ``eventstreamgpt_tpu/serving``): the CI generation engine."""

from .engine import GenerationEngine
from .errors import MalformedPromptRejected, ServingError, SlotHealthError
from .scheduler import AdmissionRejected, EngineResult, Request

__all__ = [
    "AdmissionRejected",
    "EngineResult",
    "GenerationEngine",
    "MalformedPromptRejected",
    "Request",
    "ServingError",
    "SlotHealthError",
]
