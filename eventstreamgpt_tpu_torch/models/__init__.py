"""Models (counterpart: ``eventstreamgpt_tpu/models``)."""

from .ci_model import CIPPTForGenerativeSequenceModeling
from .config import StructuredTransformerConfig

__all__ = ["CIPPTForGenerativeSequenceModeling", "StructuredTransformerConfig"]
