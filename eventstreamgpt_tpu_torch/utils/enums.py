"""String-valued enums (counterpart: ``eventstreamgpt_tpu/utils/enums.py``)."""

from __future__ import annotations

import enum


class StrEnum(str, enum.Enum):
    """An enum whose members are (and serialize as) lowercase strings.

    ``enum.auto()`` resolves to the lowercased member name, so JSON configs
    written by either package read back in the other.

    Examples:
        >>> class Color(StrEnum):
        ...     RED = enum.auto()
        >>> Color.RED.value, str(Color.RED), Color("red") is Color.RED
        ('red', 'red', True)
    """

    def __str__(self) -> str:
        return str(self.value)

    @staticmethod
    def _generate_next_value_(name, start, count, last_values) -> str:
        return name.lower()

    @classmethod
    def values(cls) -> list[str]:
        """Returns all member values of this enum."""
        return [c.value for c in cls]


class SeqPaddingSide(StrEnum):
    """Which side of the sequence gets padding in collated batches
    (counterpart: ``eventstreamgpt_tpu/data/config.py``)."""

    RIGHT = enum.auto()
    LEFT = enum.auto()


class SubsequenceSamplingStrategy(StrEnum):
    """How to sample a subsequence when a subject has more events than fit
    (counterpart: ``eventstreamgpt_tpu/data/config.py``)."""

    TO_END = enum.auto()
    FROM_START = enum.auto()
    RANDOM = enum.auto()
