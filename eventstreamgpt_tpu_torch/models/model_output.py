"""Output containers and the shared generative output layer, generation path.

Counterpart: ``eventstreamgpt_tpu/models/model_output.py``
(`GenerativeSequenceModelPredictions`, `GenerativeSequenceModelOutput`,
`GenerativeOutputLayerBase`). Losses and labels belong to the training
slice and are not ported yet; the layer computes the predicted
distributions of every head.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..data.types import DataModality
from ..distributions import Bernoulli, Categorical, dist_map
from ..ops.tensor_ops import dense
from .config import StructuredTransformerConfig, TimeToEventGenerationHeadType
from .generative_layers import (
    ExponentialTTELayer,
    GaussianIndexedRegressionLayer,
    GaussianRegressionLayer,
    LogNormalMixtureTTELayer,
)


@dataclasses.dataclass
class GenerativeSequenceModelPredictions:
    """Predicted distributions per head.

    ``classification`` and ``regression`` map measurement -> ``(is_observed
    dist | None, dist)``; ``time_to_event`` is the TTE distribution.
    """

    classification: Optional[dict] = None
    regression: Optional[dict] = None
    regression_indices: Optional[dict] = None
    time_to_event: Optional[object] = None

    def map(self, fn) -> "GenerativeSequenceModelPredictions":
        """Applies ``fn`` to every tensor parameter of every distribution."""

        def pair(p):
            return tuple(None if d is None else dist_map(d, fn) for d in p)

        return GenerativeSequenceModelPredictions(
            classification=None if self.classification is None else {k: pair(v) for k, v in self.classification.items()},
            regression=None if self.regression is None else {k: pair(v) for k, v in self.regression.items()},
            regression_indices=self.regression_indices,
            time_to_event=None if self.time_to_event is None else dist_map(self.time_to_event, fn),
        )


@dataclasses.dataclass
class GenerativeSequenceModelOutput:
    preds: Optional[GenerativeSequenceModelPredictions] = None
    event_mask: Optional[torch.Tensor] = None
    dynamic_values_mask: Optional[torch.Tensor] = None
    past_key_values: Optional[tuple] = None


def get_measurement_vocab_slice(config: StructuredTransformerConfig, measurement: str) -> tuple[int, int]:
    """[vocab_start, vocab_end) of a measurement in the unified vocabulary."""
    vocab_start = config.vocab_offsets_by_measurement[measurement]
    vocab_end = min(
        o for o in list(config.vocab_offsets_by_measurement.values()) + [config.vocab_size] if o > vocab_start
    )
    return vocab_start, vocab_end


class GenerativeOutputLayerBase(nn.Module):
    """TTE head + is-observed head + unified classification head + regression heads.

    Submodule names follow the flax paths (``IsObservedLayer``,
    ``ClassificationLayer``, ``regression_layer_<m>``, ``TTE_layer``).
    """

    def __init__(self, config: StructuredTransformerConfig):
        super().__init__()
        self.config = config
        E = config.hidden_size
        if config.TTE_generation_layer_type == TimeToEventGenerationHeadType.LOG_NORMAL_MIXTURE:
            self.TTE_layer = LogNormalMixtureTTELayer(
                E,
                config.TTE_lognormal_generation_num_components,
                config.mean_log_inter_event_time_min,
                config.std_log_inter_event_time_min,
            )
        elif config.TTE_generation_layer_type == TimeToEventGenerationHeadType.EXPONENTIAL:
            self.TTE_layer = ExponentialTTELayer(E)
        else:
            raise ValueError(f"Invalid TTE_generation_layer_type {config.TTE_generation_layer_type}")
        self.IsObservedLayer = nn.Linear(E, len(config.measurements_idxmap))
        self.ClassificationLayer = nn.Linear(E, config.vocab_size)
        self.regression_names = []
        for m in config.measurements_for(DataModality.MULTIVARIATE_REGRESSION):
            self._add_regression(m, GaussianIndexedRegressionLayer(E, config.vocab_sizes_by_measurement[m]))
        for m in config.measurements_for(DataModality.UNIVARIATE_REGRESSION):
            if m in self.regression_names:
                raise ValueError(f"{m} duplicated!")
            self._add_regression(m, GaussianRegressionLayer(E))
        self.classification_mode_per_measurement = {}
        for mode, measurements in config.measurements_per_generative_mode.items():
            if mode not in (DataModality.SINGLE_LABEL_CLASSIFICATION, DataModality.MULTI_LABEL_CLASSIFICATION):
                continue
            for m in measurements:
                assert m not in self.classification_mode_per_measurement
                self.classification_mode_per_measurement[m] = DataModality(mode)

    def _add_regression(self, measurement: str, layer: nn.Module) -> None:
        self.regression_names.append(measurement)
        setattr(self, f"regression_layer_{measurement}", layer)

    def regression_layer(self, measurement: str) -> nn.Module:
        return getattr(self, f"regression_layer_{measurement}")

    def get_classification_outputs(self, encoded, valid_measurements) -> dict:
        if not valid_measurements:
            return {}
        is_observed_score = dense(encoded, self.IsObservedLayer).float()
        # Full-plane projection then column slices: column-exact with the JAX
        # layer's narrow projections, which compute the same columns.
        scores_all = dense(encoded, self.ClassificationLayer).float()
        dists = {}
        for m, mode in self.classification_mode_per_measurement.items():
            if m not in valid_measurements:
                continue
            start, end = get_measurement_vocab_slice(self.config, m)
            scores = scores_all[..., start:end]
            if mode == DataModality.SINGLE_LABEL_CLASSIFICATION:
                idx = self.config.measurements_idxmap[m]
                dists[m] = (Bernoulli(is_observed_score[..., idx - 1]), Categorical(scores))
            else:
                dists[m] = (None, Bernoulli(scores))
        return dists

    def get_regression_outputs(self, encoded, valid_measurements) -> dict:
        if not valid_measurements:
            return {}
        dists = {}
        for m in self.config.measurements_for(DataModality.MULTIVARIATE_REGRESSION):
            if m in valid_measurements:
                dists[m] = (None, self.regression_layer(m)(encoded))
        univariate = [m for m in self.config.measurements_for(DataModality.UNIVARIATE_REGRESSION) if m in valid_measurements]
        if univariate:
            is_observed_score = dense(encoded, self.IsObservedLayer).float()
            for m in univariate:
                idx = self.config.measurements_idxmap[m]
                dists[m] = (Bernoulli(is_observed_score[..., idx - 1]), self.regression_layer(m)(encoded))
        return dists
