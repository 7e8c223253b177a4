"""Per-row stopping criteria for the serving engine (device protocol).

Counterpart: ``eventstreamgpt_tpu/generation/stopping_criteria.py``
(`DeviceCriterion`, `MaxLengthCriteria`, `DeadRowCriteria`). A criterion
judges every row from the engine's per-row state, on the device, with no
host sync. The whole-batch host protocol belongs to the cohort
``generate()`` path, not ported yet.
"""

from __future__ import annotations

import abc

import torch

from ..data.types import EventStreamBatch
from ..ops.tensor_ops import take_event


class DeviceCriterion(abc.ABC):
    """Per-row stopping protocol: ``row_done`` returns an ``(n_slots,)`` bool tensor."""

    @abc.abstractmethod
    def row_done(
        self,
        *,
        big: EventStreamBatch,
        cursor: torch.Tensor,
        base_len: torch.Tensor,
        n_generated: torch.Tensor,
        budget: torch.Tensor,
    ) -> torch.Tensor:
        """Per-row done verdicts after a completed decode step."""


class MaxLengthCriteria(DeviceCriterion):
    """A row is done once it holds ``max_length`` events."""

    def __init__(self, max_length: int):
        self.max_length = max_length

    def row_done(self, *, cursor, **kwargs):
        return cursor >= self.max_length


class DeadRowCriteria(DeviceCriterion):
    """Stops rows whose newest generated event is a non-event.

    A masked event propagates to every later one, so such a row can never
    produce another real event.
    """

    def row_done(self, *, big, cursor, base_len, **kwargs):
        last_real = take_event(big.event_mask, (cursor - 1).clamp(max=big.event_mask.shape[1] - 1))
        return (~last_real) & (cursor > base_len)
