"""Models (counterpart: ``eventstreamgpt_tpu/models``)."""

from .ci_model import CIPPTForGenerativeSequenceModeling
from .config import StructuredTransformerConfig
from .na_model import NAPPTForGenerativeSequenceModeling

__all__ = ["CIPPTForGenerativeSequenceModeling", "NAPPTForGenerativeSequenceModeling", "StructuredTransformerConfig"]
