"""Generation helpers (counterpart: ``eventstreamgpt_tpu/generation``)."""

from .stopping_criteria import DeadRowCriteria, DeviceCriterion, MaxLengthCriteria

__all__ = ["DeadRowCriteria", "DeviceCriterion", "MaxLengthCriteria"]
