"""The nested-attention event stream model, end to end.

Counterpart: ``eventstreamgpt_tpu/models/na_model.py``
(`NestedAttentionGenerativeOutputLayer`, `NAPPTForGenerativeSequenceModeling`).
The encoding of dep-graph level ``i - 1`` predicts the measurements of level
``i``, and the time to the next event comes from the whole-event (last)
element. The structured attention already keeps level ``i - 1`` from seeing
levels ``>= i``, so nothing is shifted. Generation takes a
``dep_graph_el_generation_target``: ``None`` gives every level's heads and
the time to event from the full graph, ``0`` the time to event only (the
just-completed event contextualized), and ``t > 0`` level ``t``'s heads only
(read from element 0 of the one-element graph the cached walk decodes).
"""

from __future__ import annotations

import torch
from torch import nn

from ..data.types import DataModality, EventStreamBatch
from .config import StructuredEventProcessingMode, StructuredTransformerConfig
from .embedding import MeasIndexGroupOptions
from .model_output import (
    GenerativeOutputLayerBase,
    GenerativeSequenceModelLabels,
    GenerativeSequenceModelLosses,
    GenerativeSequenceModelOutput,
    GenerativeSequenceModelPredictions,
    cast_to_compute_dtype,
)
from .transformer import NestedAttentionPointProcessTransformer


def level_measurements(level: list) -> tuple[set, set]:
    """The categorical and numerical measurements of one dep-graph level."""
    categorical, numerical = set(), set()
    for measurement in level:
        mode = MeasIndexGroupOptions.CATEGORICAL_AND_NUMERICAL
        if isinstance(measurement, (tuple, list)):
            measurement, mode = measurement
        if mode not in MeasIndexGroupOptions.values():
            raise ValueError(f"Unknown mode {mode}")
        if mode != MeasIndexGroupOptions.NUMERICAL_ONLY:
            categorical.add(measurement)
        if mode != MeasIndexGroupOptions.CATEGORICAL_ONLY:
            numerical.add(measurement)
    return categorical, numerical


class NestedAttentionGenerativeOutputLayer(GenerativeOutputLayerBase):
    """NA output layer: level ``i``'s heads read the encoding of level ``i - 1``."""

    def forward(
        self,
        batch: EventStreamBatch,
        encoded: torch.Tensor,
        is_generation: bool = False,
        dep_graph_el_generation_target: int | None = None,
    ) -> GenerativeSequenceModelOutput:
        cfg = self.config
        if cfg.structured_event_processing_mode != StructuredEventProcessingMode.NESTED_ATTENTION:
            raise ValueError(f"{cfg.structured_event_processing_mode} invalid for this model!")
        target = dep_graph_el_generation_target
        if target is not None and not is_generation:
            raise ValueError(
                f"If dep_graph_el_generation_target ({target}) is not None, is_generation ({is_generation}) must be True!"
            )
        G = encoded.shape[2]
        levels, do_TTE = range(1, G), True
        if target == 0:
            levels = range(0)
        elif target is not None:
            levels, do_TTE = (range(1, 2) if G == 1 else range(target, target + 1)), False
        classification_measurements = set(self.classification_mode_per_measurement)
        regression_measurements = set(
            cfg.measurements_for(DataModality.MULTIVARIATE_REGRESSION)
            + cfg.measurements_for(DataModality.UNIVARIATE_REGRESSION)
        )
        classification = ({}, {}, {})  # losses, dists, labels
        regression = ({}, {}, {}, {})  # losses, dists, labels, indices
        for i in levels:
            level_encoded = encoded[:, :, i - 1]
            level = cfg.measurements_per_dep_graph_level[target if target is not None else i]
            categorical, numerical = level_measurements(level)
            out = self.get_classification_outputs(
                batch, level_encoded, categorical & classification_measurements, is_generation
            )
            for acc, part in zip(classification, out):
                acc.update(part)
            out = self.get_regression_outputs(batch, level_encoded, numerical & regression_measurements, is_generation)
            for acc, part in zip(regression, out):
                acc.update(part)
        TTE_LL, TTE_dist, TTE_true = None, None, None
        if do_TTE:
            TTE_LL, TTE_dist, TTE_true = self.get_TTE_outputs(batch, encoded[:, :, -1], is_generation)
        out = GenerativeSequenceModelOutput(
            preds=GenerativeSequenceModelPredictions(
                classification=classification[1],
                regression=regression[1],
                regression_indices=None if is_generation else regression[3],
                time_to_event=TTE_dist,
            ),
            event_mask=batch.event_mask,
            dynamic_values_mask=batch.dynamic_values_mask,
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


class NAPPTForGenerativeSequenceModeling(nn.Module):
    """End-to-end NA generative model (``encoder`` + ``output_layer``)."""

    def __init__(self, config: StructuredTransformerConfig):
        super().__init__()
        if config.structured_event_processing_mode != StructuredEventProcessingMode.NESTED_ATTENTION:
            raise ValueError(f"{config.structured_event_processing_mode} invalid for an NA model")
        self.config = config
        self.encoder = NestedAttentionPointProcessTransformer(config)
        self.output_layer = NestedAttentionGenerativeOutputLayer(config)

    def forward(
        self,
        batch: EventStreamBatch,
        past=None,
        use_cache: bool = False,
        is_generation: bool = True,
        dropout=None,
        dep_graph_el_generation_target: int | None = None,
        last_event_index=None,
        partial_content_levels: bool = False,
        history_head: tuple | None = None,
        return_contextualized: bool = False,
    ):
        """``is_generation=False`` computes the losses; ``dropout`` (a
        ``torch.Generator`` on the batch's device) turns dropout on. ``past``
        (`transformer.NAPast`), ``use_cache`` and
        ``dep_graph_el_generation_target`` drive the cached walk, and
        ``last_event_index`` the bucket-padded prefill's dep-graph reset; the
        output's ``past_key_values`` is the encoder's next `NAPast`.
        ``partial_content_levels``, ``history_head`` and
        ``return_contextualized`` are the speculative verify's (the
        encoder's); the contextualized events come back on the output."""
        encoded = self.encoder(
            batch, past=past, use_cache=use_cache, dropout=dropout,
            dep_graph_el_generation_target=dep_graph_el_generation_target, last_event_index=last_event_index,
            partial_content_levels=partial_content_levels, history_head=history_head,
            return_contextualized=return_contextualized,
        )  # fmt: skip
        out = self.output_layer(
            batch, encoded.last_hidden_state, is_generation=is_generation,
            dep_graph_el_generation_target=dep_graph_el_generation_target,
        )  # fmt: skip
        out.past_key_values = encoded.past_key_values
        out.contextualized = encoded.contextualized
        return out

    def cast_to_compute_dtype(self) -> "NAPPTForGenerativeSequenceModeling":
        """Casts, once, the weights flax casts on every call (`model_output.cast_to_compute_dtype`)."""
        return cast_to_compute_dtype(self)
