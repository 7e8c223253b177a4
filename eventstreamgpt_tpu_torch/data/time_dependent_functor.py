"""Functional time-dependent measurements (age, time of day), generation half.

Counterpart: ``eventstreamgpt_tpu/data/time_dependent_functor.py``. A
functor's ``update_from_prior_timepoint`` computes a new event's element from
the prior event's and the sampled time, on tensors, inside every program
that appends an event. Its parameters (vocabulary indices, the normalizer
and outlier thresholds, the host's offset from UTC) are Python scalars read
when the program is traced or captured: they enter a CUDA graph as kernel
arguments, never as host values copied to the device.

The arithmetic is that of JAX's generation programs, which run the updates
jitted: XLA turns a division by a constant into a product with its fp32
reciprocal and fuses a product and a sum into one fused multiply-add. The
port writes both out (`_f32`, `_fma`), so its elements equal JAX's bit for
bit on either device.

``compute`` (the ETL evaluation over pandas frames) is not ported: it
raises ``ValueError`` naming ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import abc
import math
import struct
from datetime import datetime
from typing import Any

import torch

from .types import DataModality
from .vocabulary import Vocabulary

MINUTES_PER_YEAR = 60 * 24 * 365.25

# Where the ETL half of the functors waits (its ValueError names it).
FUNCTOR_ETL = "ROADMAP Queue 1 item 10: ETL and host data"


def _f32(x: float) -> float:
    """``x`` rounded to fp32 (the value XLA folds a constant's reciprocal to)."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _fma(a: torch.Tensor, b: float, c) -> torch.Tensor:
    """``a * b + c`` rounded once to fp32, as XLA's fused multiply-add gives it
    (``b`` an fp32 value: the fp64 product of two fp32 values is exact)."""
    return (a.double() * b + (c.double() if torch.is_tensor(c) else c)).float()


def _no_bound(x) -> bool:
    """JAX's ``x is None or pd.isna(x)`` for a threshold: no bound."""
    return x is None or (isinstance(x, float) and math.isnan(x))


class TimeDependentFunctor(abc.ABC):
    """A measurement that is an analytic function of time and static data.

    ``to_dict`` / ``from_dict`` are JAX's serialized form
    (``{"class": ..., "params": ...}``).
    """

    OUTPUT_MODALITY: DataModality = DataModality.DROPPED

    def __init__(self, **fn_params):
        for k, val in fn_params.items():
            setattr(self, k, val)
        self.link_static_cols: list[str] = []

    def to_dict(self) -> dict[str, Any]:
        return {
            "class": self.__class__.__name__,
            "params": {k: v for k, v in vars(self).items() if k != "link_static_cols"},
        }

    @classmethod
    def from_dict(cls, in_dict: dict[str, Any]) -> "TimeDependentFunctor":
        return cls(**in_dict["params"])

    def __eq__(self, other) -> bool:
        return isinstance(other, TimeDependentFunctor) and self.to_dict() == other.to_dict()

    def compute(self, timestamps, static_row_df):
        """The ETL evaluation over pandas frames: not part of the port."""
        raise ValueError(
            f"{type(self).__name__}.compute (the ETL evaluation) is not part of the PyTorch port yet ({FUNCTOR_ETL})"
        )

    @abc.abstractmethod
    def update_from_prior_timepoint(
        self,
        prior_indices: torch.Tensor,
        prior_values: torch.Tensor,
        new_delta: torch.Tensor,
        new_time: torch.Tensor,
        vocab: Vocabulary | None,
        measurement_metadata: dict | None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(new_indices, new_values)`` ``(B,)`` of the new event from the
        prior event's ``(B,)`` index (within the measurement's vocabulary) and
        value, the sampled time to the new event and its absolute time
        (minutes since the epoch)."""


class AgeFunctor(TimeDependentFunctor):
    """The subject's age, in fixed-length (365.25-day) years.

    Examples:
        >>> f = AgeFunctor(dob_col="dob")
        >>> mm = {"normalizer": {"mean_": 40.0, "std_": 10.0},
        ...       "outlier_model": {"thresh_large_": 40.5, "thresh_small_": float("nan")}}
        >>> i, v = f.update_from_prior_timepoint(torch.tensor([0, 0]), torch.tensor([0.0, 0.05]),
        ...                                      torch.tensor([MINUTES_PER_YEAR, 0.0]), None, None, mm)
        >>> i.tolist(), v.tolist()
        ([0, 0], [nan, 0.05000000074505806])
    """

    OUTPUT_MODALITY: DataModality = DataModality.UNIVARIATE_REGRESSION

    def __init__(self, dob_col: str):
        self.dob_col = dob_col
        self.link_static_cols = [dob_col]

    def update_from_prior_timepoint(self, prior_indices, prior_values, new_delta, new_time, vocab, measurement_metadata):
        """De-normalizes the prior age, advances it by ``new_delta`` minutes and
        re-normalizes; an age past a fitted outlier threshold becomes NaN (a
        NaN or None threshold is no bound)."""
        mean = float(measurement_metadata["normalizer"]["mean_"])
        std = float(measurement_metadata["normalizer"]["std_"])
        thresh_large = measurement_metadata["outlier_model"]["thresh_large_"]
        thresh_small = measurement_metadata["outlier_model"]["thresh_small_"]

        prior_age = _fma(prior_values, _f32(std), _f32(mean))
        new_age = _fma(new_delta, _f32(1 / MINUTES_PER_YEAR), prior_age)
        oob = torch.zeros_like(new_age, dtype=torch.bool)
        if not _no_bound(thresh_large):
            oob = oob | (new_age > float(thresh_large))
        if not _no_bound(thresh_small):
            oob = oob | (new_age < float(thresh_small))
        new_age = torch.where(oob, math.nan, new_age)
        return prior_indices, (new_age - mean) * _f32(1 / std)


class TimeOfDayFunctor(TimeDependentFunctor):
    """The event's local time of day: EARLY_AM (hour < 6), AM (< 12), PM
    (< 21), else LATE_PM.

    Examples:
        >>> vocab = Vocabulary(["EARLY_AM", "AM", "PM", "LATE_PM"], [4, 3, 2, 1])
        >>> utc = datetime(1970, 1, 1).timestamp() / 60  # local midnight, in minutes since the epoch
        >>> i, v = TimeOfDayFunctor().update_from_prior_timepoint(
        ...     torch.zeros(4, dtype=torch.int64), torch.zeros(4), None,
        ...     torch.tensor([0.0, 7 * 60, 13 * 60, 22 * 60]) + utc, vocab, None)
        >>> i.tolist(), bool(v.isnan().all())
        ([1, 2, 3, 4], True)
    """

    OUTPUT_MODALITY: DataModality = DataModality.SINGLE_LABEL_CLASSIFICATION

    def update_from_prior_timepoint(self, prior_indices, prior_values, new_delta, new_time, vocab, measurement_metadata):
        """Buckets each new absolute time (minutes since the epoch) by its
        hour in the host's time zone, read here as JAX reads it."""
        hrs_local_at_midnight_epoch = datetime(1970, 1, 1).timestamp() / 60 / 60
        new_hour_local = (new_time * _f32(1 / 60) - hrs_local_at_midnight_epoch) % 24
        early_am, am, pm, late_pm = (vocab.idxmap.get(k, 0) for k in ("EARLY_AM", "AM", "PM", "LATE_PM"))
        new_indices = torch.where(
            new_hour_local < 6,
            early_am,
            torch.where(new_hour_local < 12, am, torch.where(new_hour_local < 21, pm, late_pm)),
        )
        return new_indices.to(prior_indices.dtype), math.nan * prior_values


FUNCTORS = {"AgeFunctor": AgeFunctor, "TimeOfDayFunctor": TimeOfDayFunctor}


def functor_from_dict(in_dict: dict) -> TimeDependentFunctor:
    """The functor of a serialized ``{"class": ..., "params": ...}`` dict."""
    return FUNCTORS[in_dict["class"]].from_dict(in_dict)
