"""The conditionally-independent event stream model.

Counterpart: ``eventstreamgpt_tpu/models/ci_model.py``
(`ConditionallyIndependentGenerativeOutputLayer`,
`CIPPTForGenerativeSequenceModeling`). Training shifts the encodings right
by one event, so position ``j``'s content predictions come from event
``j - 1`` (zeros at each row's and each packed segment's first event);
generation keeps the unshifted encodings (the last event predicts the
next).
"""

from __future__ import annotations

import torch
from torch import nn

from ..data.types import DataModality, EventStreamBatch
from ..ops.tensor_ops import segment_starts
from .config import StructuredEventProcessingMode, StructuredTransformerConfig
from .model_output import (
    GenerativeOutputLayerBase,
    GenerativeSequenceModelLabels,
    GenerativeSequenceModelLosses,
    GenerativeSequenceModelOutput,
    GenerativeSequenceModelPredictions,
    cast_to_compute_dtype,
)
from .transformer import ConditionallyIndependentPointProcessTransformer


class ConditionallyIndependentGenerativeOutputLayer(GenerativeOutputLayerBase):
    """CI output layer: every head reads the whole-event encoding."""

    def forward(self, batch: EventStreamBatch, encoded: torch.Tensor, is_generation: bool = True):
        cfg = self.config
        if cfg.structured_event_processing_mode != StructuredEventProcessingMode.CONDITIONALLY_INDEPENDENT:
            raise ValueError(f"{cfg.structured_event_processing_mode} invalid!")
        regression_measurements = set(
            cfg.measurements_for(DataModality.MULTIVARIATE_REGRESSION)
            + cfg.measurements_for(DataModality.UNIVARIATE_REGRESSION)
        )
        contents = encoded
        if not is_generation:
            contents = torch.cat([torch.zeros_like(encoded[:, :1]), encoded[:, :-1]], dim=1)
            if batch.segment_ids is not None:
                contents = torch.where(segment_starts(batch.segment_ids)[..., None], 0.0, contents)
        classification = self.get_classification_outputs(
            batch, contents, set(self.classification_mode_per_measurement), is_generation
        )
        regression = self.get_regression_outputs(batch, contents, regression_measurements, is_generation)
        TTE_LL, TTE_dist, TTE_true = self.get_TTE_outputs(batch, encoded, is_generation)
        preds = GenerativeSequenceModelPredictions(
            classification=classification[1],
            regression=regression[1],
            regression_indices=None if is_generation else regression[3],
            time_to_event=TTE_dist,
        )
        out = GenerativeSequenceModelOutput(
            preds=preds, event_mask=batch.event_mask, dynamic_values_mask=batch.dynamic_values_mask
        )
        if is_generation:
            return out
        out.loss = sum(classification[0].values()) + sum(regression[0].values()) - TTE_LL
        out.losses = GenerativeSequenceModelLosses(
            classification=classification[0], regression=regression[0], time_to_event=-TTE_LL
        )
        out.labels = GenerativeSequenceModelLabels(
            classification=classification[2],
            regression=regression[2],
            regression_indices=regression[3],
            time_to_event=TTE_true,
        )
        return out


class CIPPTForGenerativeSequenceModeling(nn.Module):
    """End-to-end CI generative model (``encoder`` + ``output_layer``)."""

    def __init__(self, config: StructuredTransformerConfig):
        super().__init__()
        if config.structured_event_processing_mode != StructuredEventProcessingMode.CONDITIONALLY_INDEPENDENT:
            raise ValueError(f"{config.structured_event_processing_mode} invalid for a CI model")
        self.config = config
        self.encoder = ConditionallyIndependentPointProcessTransformer(config)
        self.output_layer = ConditionallyIndependentGenerativeOutputLayer(config)

    def forward(
        self, batch: EventStreamBatch, past=None, use_cache: bool = False, is_generation: bool = True, dropout=None
    ):
        """``is_generation=False`` computes the losses; ``dropout`` (a
        ``torch.Generator`` on the batch's device) turns dropout on, as a
        ``"dropout"`` rng does for the flax model."""
        encoded = self.encoder(batch, past=past, use_cache=use_cache, dropout=dropout)
        out = self.output_layer(batch, encoded.last_hidden_state, is_generation=is_generation)
        out.past_key_values = encoded.past_key_values
        return out

    def cast_to_compute_dtype(self) -> "CIPPTForGenerativeSequenceModeling":
        """Casts, once, the weights flax casts on every call (`model_output.cast_to_compute_dtype`)."""
        return cast_to_compute_dtype(self)
