"""Framework-neutral helpers (counterpart: ``eventstreamgpt_tpu/utils``)."""

from .enums import StrEnum
from .serialization import JSONableMixin, config_dataclass

__all__ = ["JSONableMixin", "StrEnum", "config_dataclass"]
