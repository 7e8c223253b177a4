"""Autoregressive generation: sampling, fixed-shape batch updates, the cohort loop
(counterpart: ``eventstreamgpt_tpu/generation``)."""

from .generation_utils import GenerationOutput, generate
from .sampling import sample_predictions
from .stopping_criteria import (
    DeadRowCriteria,
    DeviceCriterion,
    MaxLengthCriteria,
    StoppingCriteria,
    StoppingCriteriaList,
)

__all__ = [
    "DeadRowCriteria",
    "DeviceCriterion",
    "GenerationOutput",
    "MaxLengthCriteria",
    "StoppingCriteria",
    "StoppingCriteriaList",
    "generate",
    "sample_predictions",
]
