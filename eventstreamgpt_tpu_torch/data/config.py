"""The data configurations: measurements, the vocabulary and the dataset.

Counterpart: ``eventstreamgpt_tpu/data/config.py`` (`MeasurementConfig`,
`VocabularyConfig`, `PytorchDatasetConfig`). The port keeps the serialized
form of a measurement: the vocabulary stays a plain
``{"vocabulary", "obs_frequencies"}`` dict, fitted metadata stays the dict
(or path) it was serialized as, and a functor stays its dict. ``to_dict``
returns what ``from_dict`` was given, so a ``config.json``,
``vocabulary_config.json`` or ``data_config.json`` written by the JAX
package loads here and writes back unchanged, and the other way round.
Generation reads the objects behind them: `MeasurementConfig.functor_object`,
`vocabulary_object` and `measurement_metadata` (the fitted metadata, read
from its CSV with ``csv`` and ``ast``, never ``eval``).
"""

from __future__ import annotations

import ast
import csv
import dataclasses
import random
import re
from pathlib import Path
from typing import Any, Hashable

from ..utils import JSONableMixin, config_dataclass
from ..utils.enums import SeqPaddingSide, SubsequenceSamplingStrategy
from .time_dependent_functor import TimeDependentFunctor, functor_from_dict
from .types import DataModality, TemporalityType
from .vocabulary import Vocabulary

def _literal_cell(cell: str):
    """A metadata CSV cell read with `ast.literal_eval` (dict reprs
    included), a ``nan`` in it (pandas' repr of a NaN) as None, both meaning
    "no bound" to a threshold; a cell that is not a literal stays text.

    Examples:
        >>> _literal_cell("{'thresh_large_': nan, 'thresh_small_': -4.5}")
        {'thresh_large_': None, 'thresh_small_': -4.5}
        >>> _literal_cell("float")
        'float'
    """
    try:
        return ast.literal_eval(re.sub(r"\bnan\b", "None", cell.strip()))
    except (SyntaxError, ValueError):
        return cell


def read_metadata_csv(fp: Path | str, univariate: bool) -> dict:
    """A measurement's fitted metadata CSV (JAX's ``pd.read_csv(fp,
    index_col=0)`` with ``outlier_model`` and ``normalizer`` parsed): a
    univariate measurement's single column as ``{row: value}``, otherwise
    ``{column: {row: value}}``. Cells of ``outlier_model`` and
    ``normalizer`` are parsed with `_literal_cell`; empty cells are None."""
    with open(fp, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0][1:], rows[1:]
    if univariate and len(header) != 1:
        raise ValueError(f"Expected a single-column metadata file for univariate regression; got columns {header}")

    def cell(key: str, text: str):
        if text == "":
            return None
        return _literal_cell(text) if key in ("outlier_model", "normalizer") else text

    if univariate:
        return {r[0]: cell(r[0], r[1]) for r in body}
    return {c: {r[0]: cell(c, r[j + 1]) for r in body} for j, c in enumerate(header)}


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

    @property
    def functor_object(self) -> TimeDependentFunctor | None:
        """The functor of the serialized ``functor`` dict (JAX's ``functor``)."""
        return None if self.functor is None else functor_from_dict(self.functor)

    @property
    def vocabulary_object(self) -> Vocabulary | None:
        """The `Vocabulary` of the serialized ``vocabulary`` dict (JAX's ``vocabulary``)."""
        return None if self.vocabulary is None else Vocabulary(**self.vocabulary)

    @property
    def measurement_metadata(self) -> dict | None:
        """The fitted metadata (JAX's ``measurement_metadata``): the dict it
        was serialized as, or its CSV read by `read_metadata_csv`."""
        mm = self._measurement_metadata
        if mm is None or isinstance(mm, dict):
            return mm
        if isinstance(mm, (str, Path)):
            return read_metadata_csv(mm, univariate=self.modality == DataModality.UNIVARIATE_REGRESSION)
        raise ValueError(f"_measurement_metadata is invalid! Got {mm}")

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

    @classmethod
    def from_dict(cls, as_dict: dict, base_dir: Path | str | None = None) -> "MeasurementConfig":
        """The config of a serialized dict. With ``base_dir`` (the dataset
        directory), a metadata path is resolved as JAX resolves it: a relative
        one under ``base_dir``; an absolute one that does not exist (written on
        another machine) re-rooted at ``base_dir/inferred_measurement_metadata``
        when that file exists."""
        as_dict = dict(as_dict)
        mm = as_dict.get("_measurement_metadata")
        if isinstance(mm, (str, Path)) and base_dir is not None:
            fp = Path(mm)
            if not fp.is_absolute():
                fp = Path(base_dir) / fp
            elif not fp.exists():
                local = Path(base_dir) / "inferred_measurement_metadata" / fp.name
                if local.exists():
                    fp = local
            as_dict["_measurement_metadata"] = fp
        return cls(**as_dict)


@dataclasses.dataclass
class VocabularyConfig(JSONableMixin):
    """The unified vocabulary of a dataset (``vocabulary_config.json``).

    Examples:
        >>> config = VocabularyConfig(
        ...     vocab_sizes_by_measurement={"m1": 10, "m2": 3},
        ...     vocab_offsets_by_measurement={"m1": 5, "m2": 15, "m3": 18})
        >>> config.total_vocab_size
        19
    """

    vocab_sizes_by_measurement: dict[str, int] | None = None
    vocab_offsets_by_measurement: dict[str, int] | None = None
    measurements_idxmap: dict[str, dict[Hashable, int]] | None = None
    measurements_per_generative_mode: dict[str, list[str]] | None = None
    event_types_idxmap: dict[str, int] | None = None

    @property
    def total_vocab_size(self) -> int:
        return (
            sum(self.vocab_sizes_by_measurement.values())
            + min(self.vocab_offsets_by_measurement.values())
            + (len(self.vocab_offsets_by_measurement) - len(self.vocab_sizes_by_measurement))
        )


@config_dataclass
class PytorchDatasetConfig(JSONableMixin):
    """The dataset's settings: where its DL cache is, how subjects are
    filtered, cropped, padded and subsampled, and which light fields a batch
    carries (``data_config.json``, JAX's field set and validation).

    ``max_n_dynamic`` / ``max_n_static`` None: the data's widest event /
    subject. ``task_df_name`` selects task data, which the port refuses
    (`data.torch_dataset.TorchDataset`).
    """

    save_dir: Path | None = None

    max_seq_len: int = 256
    min_seq_len: int = 2
    seq_padding_side: SeqPaddingSide = SeqPaddingSide.RIGHT
    subsequence_sampling_strategy: SubsequenceSamplingStrategy = SubsequenceSamplingStrategy.RANDOM

    train_subset_size: int | float | str = "FULL"
    train_subset_seed: int | None = None

    task_df_name: str | None = None

    do_include_subsequence_indices: bool = False
    do_include_subject_id: bool = False
    do_include_start_time_min: bool = False

    max_n_dynamic: int | None = None
    max_n_static: int | None = None

    def __post_init__(self):
        self.seq_padding_side = SeqPaddingSide(self.seq_padding_side)
        self.subsequence_sampling_strategy = SubsequenceSamplingStrategy(self.subsequence_sampling_strategy)
        if self.min_seq_len is None or self.min_seq_len < 0:
            raise ValueError(f"min_seq_len must be non-negative! Got {self.min_seq_len}")
        if self.max_seq_len is None or self.max_seq_len < self.min_seq_len:
            raise ValueError(f"max_seq_len must be >= min_seq_len! Got {self.max_seq_len} < {self.min_seq_len}")
        if self.save_dir is not None and not isinstance(self.save_dir, Path):
            self.save_dir = Path(self.save_dir)

        size = self.train_subset_size
        if size is None or size == "FULL":
            pass
        elif isinstance(size, int) and size < 0:
            raise ValueError(f"If integral, train_subset_size must be positive! Got {size}")
        elif isinstance(size, float) and (size <= 0 or size >= 1):
            raise ValueError(f"If float, train_subset_size must be in (0, 1)! Got {size}")
        elif not isinstance(size, (int, float)):
            raise TypeError(f"train_subset_size is of unrecognized type {type(size)}.")

        if size in (None, "FULL"):
            if self.train_subset_seed is not None:
                raise ValueError(
                    f"train_subset_seed {self.train_subset_seed} should be None if train_subset_size is FULL."
                )
        elif self.train_subset_seed is None:
            self.train_subset_seed = int(random.randint(1, int(1e6)))

    def to_dict(self) -> dict:
        as_dict = dataclasses.asdict(self)
        as_dict["save_dir"] = str(self.save_dir) if self.save_dir is not None else None
        as_dict["seq_padding_side"] = str(self.seq_padding_side)
        as_dict["subsequence_sampling_strategy"] = str(self.subsequence_sampling_strategy)
        return as_dict

    @classmethod
    def from_dict(cls, as_dict: dict) -> "PytorchDatasetConfig":
        return cls(**as_dict)
