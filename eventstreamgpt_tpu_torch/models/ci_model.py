"""The conditionally-independent event stream model, generation path.

Counterpart: ``eventstreamgpt_tpu/models/ci_model.py``
(`ConditionallyIndependentGenerativeOutputLayer`,
`CIPPTForGenerativeSequenceModeling`). Generation keeps the unshifted
encodings (the last event predicts the next); the shifted training
alignment and the losses come with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from ..data.types import DataModality, EventStreamBatch
from .config import StructuredEventProcessingMode, StructuredTransformerConfig
from .embedding import DataEmbeddingLayer
from .model_output import (
    GenerativeOutputLayerBase,
    GenerativeSequenceModelOutput,
    GenerativeSequenceModelPredictions,
)
from .transformer import ConditionallyIndependentPointProcessTransformer


class ConditionallyIndependentGenerativeOutputLayer(GenerativeOutputLayerBase):
    """CI output layer: every head reads the whole-event encoding."""

    def forward(self, batch: EventStreamBatch, encoded: torch.Tensor, is_generation: bool = True):
        cfg = self.config
        if cfg.structured_event_processing_mode != StructuredEventProcessingMode.CONDITIONALLY_INDEPENDENT:
            raise ValueError(f"{cfg.structured_event_processing_mode} invalid!")
        if not is_generation:
            raise ValueError("the training forward (losses, shifted alignment) is not ported yet")
        regression_measurements = set(
            cfg.measurements_for(DataModality.MULTIVARIATE_REGRESSION)
            + cfg.measurements_for(DataModality.UNIVARIATE_REGRESSION)
        )
        preds = GenerativeSequenceModelPredictions(
            classification=self.get_classification_outputs(
                encoded, set(self.classification_mode_per_measurement)
            ),
            regression=self.get_regression_outputs(encoded, regression_measurements),
            regression_indices=None,
            time_to_event=self.TTE_layer(encoded),
        )
        return GenerativeSequenceModelOutput(
            preds=preds, event_mask=batch.event_mask, dynamic_values_mask=batch.dynamic_values_mask
        )


class CIPPTForGenerativeSequenceModeling(nn.Module):
    """End-to-end CI generative model (``encoder`` + ``output_layer``)."""

    def __init__(self, config: StructuredTransformerConfig):
        super().__init__()
        if config.structured_event_processing_mode != StructuredEventProcessingMode.CONDITIONALLY_INDEPENDENT:
            raise ValueError(
                "nested-attention models are not part of the PyTorch port yet; "
                "only conditionally-independent models are"
            )
        self.config = config
        self.encoder = ConditionallyIndependentPointProcessTransformer(config)
        self.output_layer = ConditionallyIndependentGenerativeOutputLayer(config)

    def forward(self, batch: EventStreamBatch, past=None, use_cache: bool = False, is_generation: bool = True):
        encoded = self.encoder(batch, past=past, use_cache=use_cache)
        out = self.output_layer(batch, encoded.last_hidden_state, is_generation=is_generation)
        out.past_key_values = encoded.past_key_values
        return out

    def cast_to_compute_dtype(self) -> "CIPPTForGenerativeSequenceModeling":
        """Casts, once, the weights flax casts on every call.

        flax keeps fp32 parameters and ``nn.Dense(dtype=compute_dtype)``
        casts kernel and bias to the compute dtype inside each call, as the
        embedding layer does its tables; casting them here gives the same
        numbers. LayerNorm parameters and the TTE projection (a flax Dense
        without ``dtype``, which computes in fp32) stay fp32.
        """
        cdt = self.config.compute_dtype
        for module in self.modules():
            if isinstance(module, nn.Linear) and not getattr(module, "keep_fp32", False):
                module.to(cdt)
            elif isinstance(module, DataEmbeddingLayer):
                for name, p in module.named_parameters(recurse=False):
                    p.data = p.data.to(cdt)
        return self
