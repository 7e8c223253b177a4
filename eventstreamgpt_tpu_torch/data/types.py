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

    def repeat_batch_elements(self, expand_size: int) -> "EventStreamBatch":
        """Repeats each batch element ``expand_size`` times, in order (rows ``b``
        of the result are ``b // expand_size`` of this batch).

        Examples:
            >>> b = EventStreamBatch(event_mask=torch.tensor([[True], [False]]))
            >>> b.repeat_batch_elements(2).event_mask[:, 0].tolist()
            [True, True, False, False]
        """
        return self.map(lambda x: x.repeat_interleave(expand_size, dim=0))

    def split_repeated_batch(self, n_splits: int) -> list["EventStreamBatch"]:
        """Inverse of `repeat_batch_elements`: ``n_splits`` batches, the ``i``-th
        holding the ``i``-th repeated sample of each original element."""

        def sel(x, i):
            return x.reshape((x.shape[0] // n_splits, n_splits) + tuple(x.shape[1:]))[:, i]

        return [self.map(lambda x, i=i: sel(x, i)) for i in range(n_splits)]

    def convert_to_DL(self):
        """The batch in the sparse deep-learning format, as the converted cache
        holds it (`data.dl_cache.DLReps`; JAX's ``convert_to_DL_DF`` without
        pandas): a row a subject. ``time_delta`` / ``time`` keep each row's
        real events (``event_mask``); ``static_indices`` /
        ``static_measurement_indices`` the static elements whose index is not
        0; ``dynamic_indices`` / ``dynamic_measurement_indices`` /
        ``dynamic_values`` an inner list an event of the elements whose index
        is not 0, an unobserved value (``dynamic_values_mask`` False) as NaN,
        the converted format's null. ``start_time``, ``subject_id``,
        ``start_idx`` and ``end_idx`` pass through as scalar columns, as the
        batch holds them (``start_time`` in minutes). Values keep the batch's
        types, read to the host.

        Examples:
            >>> b = EventStreamBatch(event_mask=torch.tensor([[True, False]]), time=torch.tensor([[0.0, 2.0]]),
            ...                      dynamic_indices=torch.tensor([[[3, 0], [4, 5]]]),
            ...                      dynamic_measurement_indices=torch.tensor([[[1, 0], [1, 2]]]),
            ...                      dynamic_values=torch.tensor([[[0.5, 0.0], [1.0, 2.0]]]),
            ...                      dynamic_values_mask=torch.tensor([[[False, False], [True, True]]]))
            >>> reps = b.convert_to_DL()
            >>> reps.lists["time"].values.tolist(), reps.lists["dynamic_values"].values.tolist()
            ([0.0], [nan])
        """
        import numpy as np

        from .dl_cache import DLReps, RaggedColumn, lengths_to_offsets

        b = self.map(lambda x: x.detach().cpu().numpy())
        events = b.event_mask.astype(bool)
        event_offsets = lengths_to_offsets(events.sum(1))
        lists = {k: RaggedColumn(getattr(b, k)[events], event_offsets)
                 for k in ("time_delta", "time") if getattr(b, k) is not None}  # fmt: skip
        if b.static_indices is not None:
            keep = b.static_indices != 0
            offsets = lengths_to_offsets(keep.sum(1))
            for k in ("static_indices", "static_measurement_indices"):
                lists[k] = RaggedColumn(getattr(b, k)[keep], offsets)
        dyn = b.dynamic_indices[events]
        keep = dyn != 0
        inner = lengths_to_offsets(keep.sum(1))
        values = np.where(b.dynamic_values_mask, b.dynamic_values, np.nan).astype(b.dynamic_values.dtype)
        for k, x in (("dynamic_indices", dyn), ("dynamic_measurement_indices", b.dynamic_measurement_indices[events]),
                     ("dynamic_values", values[events])):  # fmt: skip
            lists[k] = RaggedColumn(x[keep], event_offsets, inner)
        scalars = {k: getattr(b, k) for k in ("start_time", "subject_id", "start_idx", "end_idx")
                   if getattr(b, k) is not None}  # fmt: skip
        return DLReps(scalars, lists)

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

