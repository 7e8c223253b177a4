"""Evaluation: trajectory generation at scale and the model-free MCF / CRPS evaluation.

Counterpart: ``eventstreamgpt_tpu/evaluation/`` (the same exports, plus
`dl_frame`, which turns the converted format's rows into the column dicts
the MCF functions take).
"""

from .general_generative_evaluation import GenerateConfig, generate_trajectories
from .mcf_evaluation import (
    align_time_and_eval_predicates,
    crps,
    dl_frame,
    eval_range,
    get_aligned_timestamps,
    get_MCF,
    get_MCF_coordinates,
)

__all__ = [
    "GenerateConfig",
    "align_time_and_eval_predicates",
    "crps",
    "dl_frame",
    "eval_range",
    "generate_trajectories",
    "get_MCF",
    "get_MCF_coordinates",
    "get_aligned_timestamps",
]
