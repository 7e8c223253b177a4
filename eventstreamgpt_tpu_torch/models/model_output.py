"""Output containers and the shared generative output layer.

Counterpart: ``eventstreamgpt_tpu/models/model_output.py``
(`GenerativeSequenceModelLosses`, `GenerativeSequenceModelPredictions`,
`GenerativeSequenceModelLabels`, `GenerativeSequenceModelOutput`,
`StreamClassificationModelOutput`, `GenerativeOutputLayerBase`). Each head returns its predicted
distributions and, in training (``is_generation=False``), its loss and
labels with the JAX layer's averaging contracts: per label, then per event,
then per subject, then over the batch (`ops.tensor_ops.weighted_loss`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..data.types import DataModality, EventStreamBatch
from ..distributions import Bernoulli, Categorical, dist_map
from ..ops.tensor_ops import dense, exact_dense, safe_weighted_avg, weighted_loss
from .config import StructuredTransformerConfig, TimeToEventGenerationHeadType
from .embedding import DataEmbeddingLayer
from .generative_layers import (
    ExponentialTTELayer,
    GaussianIndexedRegressionLayer,
    GaussianRegressionLayer,
    LogNormalMixtureTTELayer,
)


@dataclasses.dataclass
class GenerativeSequenceModelLosses:
    """Per-head losses: measurement -> scalar, and the TTE negative log-likelihood."""

    classification: Optional[dict] = None
    regression: Optional[dict] = None
    time_to_event: Optional[torch.Tensor] = None


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
class GenerativeSequenceModelLabels:
    """Labels per head."""

    classification: Optional[dict] = None
    regression: Optional[dict] = None
    regression_indices: Optional[dict] = None
    time_to_event: Optional[torch.Tensor] = None


@dataclasses.dataclass
class GenerativeSequenceModelOutput:
    loss: Optional[torch.Tensor] = None
    losses: Optional[GenerativeSequenceModelLosses] = None
    preds: Optional[GenerativeSequenceModelPredictions] = None
    labels: Optional[GenerativeSequenceModelLabels] = None
    event_mask: Optional[torch.Tensor] = None
    dynamic_values_mask: Optional[torch.Tensor] = None
    past_key_values: Optional[tuple] = None
    contextualized: Optional[tuple] = None  # an NA forward's, with ``return_contextualized``


@dataclasses.dataclass
class StreamClassificationModelOutput:
    """A stream classifier's output: the loss, the fp32 logits (``preds``) and the labels."""

    loss: torch.Tensor
    preds: Optional[torch.Tensor] = None
    labels: Optional[torch.Tensor] = None


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
        self.dtype = config.compute_dtype
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
            self._add_regression(m, GaussianIndexedRegressionLayer(E, config.vocab_sizes_by_measurement[m], self.dtype))
        for m in config.measurements_for(DataModality.UNIVARIATE_REGRESSION):
            if m in self.regression_names:
                raise ValueError(f"{m} duplicated!")
            self._add_regression(m, GaussianRegressionLayer(E, self.dtype))
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

    def get_TTE_outputs(self, batch: EventStreamBatch, encoded, is_generation: bool = True):
        """``(TTE log-likelihood, TTE distribution, TTE labels)``; the first and
        last are None in generation.

        The likelihood averages over each subject's observed gaps (a fake
        last observation covers the final event; the denominator is at least
        1, so an event-free subject gives 0, not NaN), then over subjects.
        """
        TTE_dist = self.TTE_layer(encoded, exact=is_generation)
        if is_generation:
            return None, TTE_dist, None
        TTE_obs_mask = batch.event_mask[:, 1:] & batch.event_mask[:, :-1]
        if batch.segment_ids is not None:
            # Packed rows: the gap into the next subject is not an inter-event time.
            TTE_obs_mask = TTE_obs_mask & (batch.segment_ids[:, 1:] == batch.segment_ids[:, :-1])
        TTE_true = torch.where(TTE_obs_mask, batch.time_delta[:, :-1], 1.0)
        TTE_true_exp = torch.cat([TTE_true, torch.ones_like(TTE_true[:, -1:])], dim=-1)
        obs = torch.cat([TTE_obs_mask, torch.zeros_like(TTE_obs_mask[:, -1:])], dim=-1).float()
        TTE_LL = TTE_dist.log_prob(TTE_true_exp)
        TTE_LL_per_patient = (TTE_LL * obs).sum(-1) / torch.clamp(obs.sum(-1), min=1.0)
        return TTE_LL_per_patient.mean(), TTE_dist, TTE_true

    def get_classification_outputs(self, batch: EventStreamBatch, encoded, valid_measurements, is_generation=True):
        """``(losses, dists, labels)`` per classification measurement; losses and
        labels are empty in generation."""
        if not valid_measurements:
            return {}, {}, {}
        product = exact_dense if is_generation else dense  # generation: a row's scores whatever its batch
        is_observed_score = product(encoded, self.IsObservedLayer, self.dtype).float()
        # Full-plane projection then column slices: column-exact with the JAX
        # layer's narrow projections, which compute the same columns.
        scores_all = product(encoded, self.ClassificationLayer, self.dtype).float()
        losses, dists, labels_out = {}, {}, {}
        indices64 = None  # the index plane as scatter's int64 index, cast once
        for m, mode in self.classification_mode_per_measurement.items():
            if m not in valid_measurements:
                continue
            start, end = get_measurement_vocab_slice(self.config, m)
            scores = scores_all[..., start:end]
            measurement_idx = self.config.measurements_idxmap[m]
            if mode == DataModality.SINGLE_LABEL_CLASSIFICATION:
                # measurement_idx 0 is withheld for missing data, hence the -1.
                dists[m] = (Bernoulli(is_observed_score[..., measurement_idx - 1]), Categorical(scores))
            else:
                dists[m] = (None, Bernoulli(scores))
            if is_generation:
                continue
            event_mask = batch.event_mask
            tensor_idx = batch.dynamic_measurement_indices == measurement_idx
            if mode == DataModality.SINGLE_LABEL_CLASSIFICATION:
                events_with_label = tensor_idx.any(dim=-1)
                is_obs_loss = -dists[m][0].log_prob(events_with_label)
                labels = ((batch.dynamic_indices * tensor_idx).sum(dim=-1) - start) * events_with_label
                loss_per_event = -dists[m][1].log_prob(labels) + is_obs_loss
                event_mask = event_mask & events_with_label
            else:
                # Multi-hot labels by scattering ones into a (..., V + 1) plane;
                # slot value 0 (another measurement, padding or out of range)
                # lands in column 0, which is dropped.
                V = end - start
                if indices64 is None:
                    indices64 = batch.dynamic_indices.long()
                label_or_zero = torch.where(tensor_idx, indices64 - start + 1, 0)
                label_or_zero = torch.where((label_or_zero >= 1) & (label_or_zero <= V), label_or_zero, 0)
                plane = torch.zeros(label_or_zero.shape[:-1] + (V + 1,), dtype=scores.dtype, device=scores.device)
                labels = plane.scatter_(-1, label_or_zero, 1.0)[..., 1:]
                loss_per_event = -dists[m][1].log_prob(labels).mean(dim=-1)
            losses[m] = weighted_loss(loss_per_event, event_mask)
            labels_out[m] = labels
        return losses, dists, labels_out

    def get_regression_outputs(self, batch: EventStreamBatch, encoded, valid_measurements, is_generation=True):
        """``(losses, dists, labels, indices)`` per regression measurement;
        losses, labels and indices are empty in generation."""
        if not valid_measurements:
            return {}, {}, {}, {}
        losses, dists, labels_out, indices_out = {}, {}, {}, {}
        for m in self.config.measurements_for(DataModality.MULTIVARIATE_REGRESSION):
            if m not in valid_measurements:
                continue
            if is_generation:
                dists[m] = (None, self.regression_layer(m)(encoded))
                continue
            measurement_idx = self.config.measurements_idxmap[m]
            vocab_start = self.config.vocab_offsets_by_measurement[m]
            tensor_idx = (batch.dynamic_measurement_indices == measurement_idx) & batch.dynamic_values_mask
            indices = torch.where(tensor_idx, batch.dynamic_indices - vocab_start, 0)
            dist = self.regression_layer(m)(encoded, idx=indices)
            values = torch.where(tensor_idx, batch.dynamic_values, 0.0).float()
            loss_per_event, _ = safe_weighted_avg(-dist.log_prob(values), tensor_idx)
            losses[m] = weighted_loss(loss_per_event, batch.event_mask & tensor_idx.any(dim=-1))
            dists[m] = (None, dist)
            labels_out[m] = values
            indices_out[m] = indices
        univariate = [m for m in self.config.measurements_for(DataModality.UNIVARIATE_REGRESSION) if m in valid_measurements]
        if univariate:
            is_observed_score = dense(encoded, self.IsObservedLayer, self.dtype).float()
        for m in univariate:
            measurement_idx = self.config.measurements_idxmap[m]
            is_obs_dist = Bernoulli(is_observed_score[..., measurement_idx - 1])
            dist = self.regression_layer(m)(encoded)
            dists[m] = (is_obs_dist, dist)
            if is_generation:
                continue
            tensor_idx = batch.dynamic_measurement_indices == measurement_idx
            is_obs_loss = -is_obs_dist.log_prob(tensor_idx.any(dim=-1))
            with_labels = tensor_idx & batch.dynamic_values_mask
            events_with_label = with_labels.any(dim=-1)
            values = (
                torch.where(with_labels, batch.dynamic_values, 0.0).float().sum(dim=-1) * events_with_label.float()
            )[..., None]
            loss_per_event = -dist.log_prob(values)[..., 0]
            losses[m] = weighted_loss(loss_per_event + is_obs_loss, batch.event_mask & events_with_label)
            labels_out[m] = values
            indices_out[m] = None
        return losses, dists, labels_out, indices_out


def cast_to_compute_dtype(model: nn.Module) -> nn.Module:
    """Casts, once, the weights flax casts on every call; returns ``model``.

    flax keeps fp32 parameters and ``nn.Dense(dtype=compute_dtype)`` casts
    kernel and bias to the compute dtype inside each call, as the embedding
    layer does its tables; casting them here gives the same numbers.
    LayerNorm parameters and the TTE projection (a flax Dense without
    ``dtype``, which computes in fp32) stay fp32.
    """
    cdt = model.config.compute_dtype
    for module in model.modules():
        if isinstance(module, nn.Linear) and not getattr(module, "keep_fp32", False):
            module.to(cdt)
        elif isinstance(module, DataEmbeddingLayer):
            for name, p in module.named_parameters(recurse=False):
                p.data = p.data.to(cdt)
    return model
