"""The measurement configuration the model config needs.

Counterpart: ``eventstreamgpt_tpu/data/config.py::MeasurementConfig``. The
port keeps the serialized form only: the vocabulary stays a plain
``{"vocabulary", "obs_frequencies"}`` dict, fitted metadata stays the dict
(or path) it was serialized as, and a functor stays its dict. ``to_dict``
returns what ``from_dict`` was given, so a ``config.json`` written by the JAX
package loads here and writes back unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..utils import JSONableMixin
from .types import DataModality, TemporalityType


@dataclasses.dataclass
class MeasurementConfig(JSONableMixin):
    """Configuration of a single measurement (serialized form)."""

    name: str | None = None
    temporality: TemporalityType | None = None
    modality: DataModality | None = None
    observation_frequency: float | None = None
    functor: dict | None = None
    vocabulary: dict | None = None
    values_column: str | None = None
    _measurement_metadata: Any = None

    def __post_init__(self):
        if isinstance(self.temporality, str):
            self.temporality = TemporalityType(self.temporality)
        if isinstance(self.modality, str):
            self.modality = DataModality(self.modality)
        if self.functor is not None and not isinstance(self.functor, dict):
            raise TypeError(f"functor must be a serialized dict; got {type(self.functor)}")
        if self.modality == DataModality.MULTIVARIATE_REGRESSION and self.values_column is None:
            raise ValueError(f"values_column must be set on a {self.modality} MeasurementConfig")
        if (
            self.modality
            in (
                DataModality.SINGLE_LABEL_CLASSIFICATION,
                DataModality.MULTI_LABEL_CLASSIFICATION,
                DataModality.UNIVARIATE_REGRESSION,
            )
            and self.values_column is not None
        ):
            raise ValueError(f"values_column must be None on a {self.modality} MeasurementConfig")

    @property
    def is_dropped(self) -> bool:
        return self.modality == DataModality.DROPPED

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "temporality": str(self.temporality) if self.temporality is not None else None,
            "modality": str(self.modality) if self.modality is not None else None,
            "observation_frequency": self.observation_frequency,
            "functor": self.functor,
            "vocabulary": (
                None
                if self.vocabulary is None
                else {
                    "vocabulary": list(self.vocabulary["vocabulary"]),
                    "obs_frequencies": [float(f) for f in self.vocabulary["obs_frequencies"]],
                }
            ),
            "values_column": self.values_column,
            "_measurement_metadata": (
                str(self._measurement_metadata)
                if self._measurement_metadata is not None
                and not isinstance(self._measurement_metadata, dict)
                else self._measurement_metadata
            ),
        }

    def __eq__(self, other) -> bool:
        return isinstance(other, MeasurementConfig) and self.to_dict() == other.to_dict()
