"""Stopping criteria: the host protocol of ``generate()`` and the engine's device protocol.

Counterpart: ``eventstreamgpt_tpu/generation/stopping_criteria.py``. Two
protocols:

* the host protocol (`StoppingCriteria.__call__`): a criterion judges the
  whole batch between events; ``generate()`` consults it after every
  completed event, one host sync an event;
* the device protocol (`DeviceCriterion.row_done`): a criterion judges every
  row from the serving engine's per-row state, on the device, with no host
  sync.

`MaxLengthCriteria` implements both, so one object works on either path.
"""

from __future__ import annotations

import abc

import torch

from ..data.types import EventStreamBatch
from ..ops.tensor_ops import take_event


class StoppingCriteria(abc.ABC):
    """Decides whether generation should stop for the whole batch."""

    @abc.abstractmethod
    def __call__(self, batch: EventStreamBatch, **kwargs) -> bool: ...


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


class MaxLengthCriteria(StoppingCriteria, DeviceCriterion):
    """Stops once the batch (on the device protocol: a row) holds ``max_length`` events."""

    def __init__(self, max_length: int):
        self.max_length = max_length

    def __call__(self, batch: EventStreamBatch, n_events: int | None = None, **kwargs) -> bool:
        n = n_events if n_events is not None else batch.sequence_length
        return n >= self.max_length

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


class StoppingCriteriaList(list, StoppingCriteria):
    """Stops when any member criterion fires."""

    def __call__(self, batch: EventStreamBatch, **kwargs) -> bool:
        return any(criteria(batch, **kwargs) for criteria in self)

    @property
    def max_length(self) -> int | None:
        """The tightest max length across members (any member firing stops generation)."""
        lengths = [c.max_length for c in self if isinstance(c, MaxLengthCriteria)]
        return min(lengths) if lengths else None
