"""One-event views and prediction slicing for the serving engine.

Counterpart: ``_trim_to_event``, ``_slice_preds_at`` and
``_mask_through_cursor`` of ``eventstreamgpt_tpu/generation/
generation_utils.py``. The cohort ``generate()`` loop is not ported yet.
"""

from __future__ import annotations

import torch

from ..data.types import EventStreamBatch
from ..models.model_output import GenerativeSequenceModelPredictions
from ..models.transformer import time_from_deltas
from ..ops.tensor_ops import take_event


def _slice_preds_at(preds: GenerativeSequenceModelPredictions, idx) -> GenerativeSequenceModelPredictions:
    """Slices ``(B, L, ...)`` prediction parameters down to event ``idx``: ``(B, ...)``."""
    return preds.map(lambda x: x[:, 0] if x.shape[1] == 1 else take_event(x, idx))


def _trim_to_event(batch: EventStreamBatch, idx) -> EventStreamBatch:
    """A one-event view of the batch at event ``idx`` (per row), with absolute time set."""
    t_full = time_from_deltas(batch)
    return batch.replace(
        event_mask=take_event(batch.event_mask, idx)[:, None],
        time_delta=take_event(batch.time_delta, idx)[:, None],
        time=take_event(t_full, idx)[:, None],
        dynamic_indices=take_event(batch.dynamic_indices, idx)[:, None],
        dynamic_measurement_indices=take_event(batch.dynamic_measurement_indices, idx)[:, None],
        dynamic_values=take_event(batch.dynamic_values, idx)[:, None],
        dynamic_values_mask=take_event(batch.dynamic_values_mask, idx)[:, None],
    )


def _mask_through_cursor(batch: EventStreamBatch, cursor: torch.Tensor) -> EventStreamBatch:
    """Event mask restricted to positions ``< cursor`` (hides the preallocated tail)."""
    positions = torch.arange(batch.sequence_length, device=cursor.device)[None, :]
    return batch.replace(event_mask=batch.event_mask & (positions < cursor[:, None]))
