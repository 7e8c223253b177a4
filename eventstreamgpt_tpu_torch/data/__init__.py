"""Data types and configs (counterpart: ``eventstreamgpt_tpu/data``)."""

from .config import MeasurementConfig
from .types import DataModality, EventStreamBatch, TemporalityType

__all__ = [
    "DataModality",
    "EventStreamBatch",
    "MeasurementConfig",
    "TemporalityType",
]
