"""Core data-model types: modality/temporality enums and the tensor batch.

Counterpart: ``eventstreamgpt_tpu/data/types.py``. `EventStreamBatch` keeps
the JAX batch's field names and shapes; its leaves are ``torch.Tensor``s
(or ``None``) and it is a plain dataclass with ``replace`` and ``slice``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import torch

from ..utils import StrEnum

# The JAX package runs with x64 off: it holds 64-bit integers and floats in
# 32 bits, and so do the port's engine rows and train-step buffers.
X32 = {torch.int64: torch.int32, torch.float64: torch.float32}


class TemporalityType(StrEnum):
    """The ways a measurement can vary in time."""

    STATIC = enum.auto()
    DYNAMIC = enum.auto()
    FUNCTIONAL_TIME_DEPENDENT = enum.auto()


class DataModality(StrEnum):
    """The modality of a data element."""

    DROPPED = enum.auto()
    SINGLE_LABEL_CLASSIFICATION = enum.auto()
    MULTI_LABEL_CLASSIFICATION = enum.auto()
    MULTIVARIATE_REGRESSION = enum.auto()
    UNIVARIATE_REGRESSION = enum.auto()


Tensor = Any  # torch.Tensor (``None`` for absent fields)


@dataclasses.dataclass
class EventStreamBatch:
    """A static-shape batch of event-stream data.

    Shapes (``B`` batch, ``L`` events, ``M`` dynamic data elements, ``S``
    static data elements): ``event_mask`` bool ``(B, L)``; ``time_delta`` /
    ``time`` float ``(B, L)``; ``static_indices`` /
    ``static_measurement_indices`` int ``(B, S)``; ``dynamic_indices`` /
    ``dynamic_measurement_indices`` int ``(B, L, M)``; ``dynamic_values``
    float and ``dynamic_values_mask`` bool ``(B, L, M)``; ``start_time``
    float ``(B,)``; the remaining fields as in the JAX batch.
    """

    event_mask: Optional[Tensor] = None
    time_delta: Optional[Tensor] = None
    time: Optional[Tensor] = None

    static_indices: Optional[Tensor] = None
    static_measurement_indices: Optional[Tensor] = None

    dynamic_indices: Optional[Tensor] = None
    dynamic_measurement_indices: Optional[Tensor] = None
    dynamic_values: Optional[Tensor] = None
    dynamic_values_mask: Optional[Tensor] = None

    start_time: Optional[Tensor] = None
    start_idx: Optional[Tensor] = None
    end_idx: Optional[Tensor] = None
    subject_id: Optional[Tensor] = None

    stream_labels: Optional[dict[str, Tensor]] = None

    valid_mask: Optional[Tensor] = None

    segment_ids: Optional[Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.event_mask.shape[0]

    @property
    def sequence_length(self) -> int:
        return self.event_mask.shape[1]

    @property
    def n_data_elements(self) -> int:
        return self.dynamic_indices.shape[2]

    def replace(self, **updates: Any) -> "EventStreamBatch":
        return dataclasses.replace(self, **updates)

    def map(self, fn) -> "EventStreamBatch":
        """Applies ``fn`` to every tensor field (``stream_labels`` included)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                out[f.name] = None
            elif isinstance(v, dict):
                out[f.name] = {k: fn(x) for k, x in v.items()}
            else:
                out[f.name] = fn(v)
        return EventStreamBatch(**out)

    def slice(self, index) -> "EventStreamBatch":
        """Slices batch (dim 0), sequence (dim 1), and data-element (dim 2) axes."""
        if not isinstance(index, tuple):
            index = (index,)
        if len(index) == 0 or len(index) > 3:
            raise ValueError(f"Invalid index {index}: must have 1-3 elements.")
        b = index[0]
        s = index[1] if len(index) > 1 else slice(None)
        m = index[2] if len(index) > 2 else slice(None)

        def _b(x):
            return None if x is None else x[b]

        def _bs(x):
            return None if x is None else x[b, s]

        def _bsm(x):
            return None if x is None else x[b, s, m]

        return EventStreamBatch(
            event_mask=_bs(self.event_mask),
            time_delta=_bs(self.time_delta),
            time=_bs(self.time),
            static_indices=_b(self.static_indices),
            static_measurement_indices=_b(self.static_measurement_indices),
            dynamic_indices=_bsm(self.dynamic_indices),
            dynamic_measurement_indices=_bsm(self.dynamic_measurement_indices),
            dynamic_values=_bsm(self.dynamic_values),
            dynamic_values_mask=_bsm(self.dynamic_values_mask),
            start_time=_b(self.start_time),
            start_idx=_b(self.start_idx),
            end_idx=_b(self.end_idx),
            subject_id=_b(self.subject_id),
            stream_labels=(
                None if self.stream_labels is None else {k: v[b] for k, v in self.stream_labels.items()}
            ),
            valid_mask=_b(self.valid_mask),
            segment_ids=_bs(self.segment_ids),
        )

