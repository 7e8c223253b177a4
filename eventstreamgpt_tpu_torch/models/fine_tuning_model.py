"""A model for fine-tuning on stream (whole-sequence) classification tasks.

Counterpart: ``eventstreamgpt_tpu/models/fine_tuning_model.py``
(`ESTForStreamClassification`): the CI or NA encoder (by
``structured_event_processing_mode``), a pooling of the event encodings
into one per subject (`pool_events`: ``cls``, ``last``, ``max``, ``mean``),
a logit layer (one output for a binary task, ``num_labels`` otherwise) and
the BCE or CE loss.

As in JAX, ``last`` pools the last *observed* event of each row (through
``event_mask``, so right-padded rows read no padding), and the loss is
averaged over the ``valid_mask`` rows only, so the fill rows of a short
evaluation batch count for nothing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.types import EventStreamBatch
from ..ops.tensor_ops import dense, safe_masked_max, safe_weighted_avg
from .config import StructuredEventProcessingMode, StructuredTransformerConfig
from .model_output import StreamClassificationModelOutput
from .transformer import ConditionallyIndependentPointProcessTransformer, NestedAttentionPointProcessTransformer

POOLINGS = ("cls", "last", "max", "mean")


def build_encoder(config: StructuredTransformerConfig) -> nn.Module:
    """The CI or NA encoder ``config`` describes."""
    if config.structured_event_processing_mode == StructuredEventProcessingMode.NESTED_ATTENTION:
        return NestedAttentionPointProcessTransformer(config)
    return ConditionallyIndependentPointProcessTransformer(config)


def event_encodings(config: StructuredTransformerConfig, encoded: torch.Tensor) -> torch.Tensor:
    """``(B, L, H)`` event encodings: an NA encoder's ``(B, L, G, H)`` output
    gives its last dependency-graph element, the whole event."""
    if config.structured_event_processing_mode == StructuredEventProcessingMode.NESTED_ATTENTION:
        return encoded[:, :, -1, :]
    return encoded


def pool_events(event_encoded: torch.Tensor, event_mask: torch.Tensor, pooling_method: str) -> torch.Tensor:
    """``(B, H)`` per-subject encodings of ``(B, L, H)`` event encodings
    (``none`` returns them as they are). ``last`` takes each row's last
    observed event (position 0 for a row with none), its index computed on
    the device from ``event_mask``."""
    if pooling_method == "cls":
        return event_encoded[:, 0]
    if pooling_method == "last":
        positions = torch.arange(event_mask.shape[1], device=event_mask.device)
        last = torch.where(event_mask, positions, 0).amax(dim=1)
        return torch.take_along_dim(event_encoded, last[:, None, None], dim=1)[:, 0]
    if pooling_method == "max":
        return safe_masked_max(event_encoded.transpose(1, 2), event_mask)
    if pooling_method == "mean":
        return safe_weighted_avg(event_encoded.transpose(1, 2), event_mask)[0]
    if pooling_method == "none":
        return event_encoded
    raise ValueError(f"{pooling_method} is not a supported pooling method.")


def lecun_normal_(weight: torch.Tensor, seed: int) -> torch.Tensor:
    """Fills a ``Linear.weight`` ``(out, in)`` from flax ``Dense``'s default
    law (lecun normal: a normal truncated at two standard deviations, scaled
    to variance ``1 / in``), drawn with ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    out_f, in_f = weight.shape
    draw = rng.standard_normal((in_f, out_f))
    while (bad := np.abs(draw) > 2.0).any():
        draw[bad] = rng.standard_normal(int(bad.sum()))
    std = np.sqrt(1.0 / in_f) / 0.87962566103423978  # the truncated unit normal's standard deviation
    with torch.no_grad():
        weight.copy_(torch.from_numpy((draw * std).T.astype(np.float32)))
    return weight


class ESTForStreamClassification(nn.Module):
    """Encoder, pooling and logit layer for stream classification (flax
    names ``encoder`` and ``logit_layer``)."""

    def __init__(self, config: StructuredTransformerConfig):
        super().__init__()
        self.config = config
        self.encoder = build_encoder(config)
        self.pooling_method = (config.task_specific_params or {}).get("pooling_method", "last")
        if self.pooling_method not in POOLINGS:
            raise ValueError(f"{self.pooling_method} is not a supported pooling method.")
        if self.is_binary and config.num_labels != 2:
            raise ValueError(f"Binary task must have num_labels == 2; got {config.num_labels}")
        self.logit_layer = nn.Linear(config.hidden_size, 1 if self.is_binary else config.num_labels)

    @property
    def is_binary(self) -> bool:
        return self.config.id2label == {0: False, 1: True}

    def reset_logit_layer(self, seed: int) -> "ESTForStreamClassification":
        """A fresh logit layer as flax draws one: lecun-normal kernel, zero bias."""
        lecun_normal_(self.logit_layer.weight, seed)
        with torch.no_grad():
            self.logit_layer.bias.zero_()
        return self

    def forward(
        self, batch: EventStreamBatch, is_generation: bool = False, dropout=None
    ) -> StreamClassificationModelOutput:
        """The loss, fp32 logits and labels of ``batch`` (its
        ``stream_labels[config.finetuning_task]``). ``dropout`` (a
        ``torch.Generator`` on the batch's device) turns dropout on;
        ``is_generation`` is taken for the train step's call and changes nothing."""
        config = self.config
        encoded = self.encoder(batch, dropout=dropout).last_hidden_state
        stream = pool_events(event_encodings(config, encoded), batch.event_mask, self.pooling_method)
        logits = dense(stream, self.logit_layer, config.compute_dtype).float()
        labels = batch.stream_labels[config.finetuning_task]
        B = logits.shape[0]
        valid = (
            batch.valid_mask.float()
            if batch.valid_mask is not None
            else torch.ones(B, dtype=torch.float32, device=logits.device)
        )
        denom = valid.sum().clamp_min(1.0)
        if self.is_binary:
            logits = logits[..., 0]
            y = labels.float()
            per_ex = -(y * F.logsigmoid(logits) + (1 - y) * F.logsigmoid(-logits))
        else:
            log_probs = F.log_softmax(logits, dim=-1)
            per_ex = -torch.take_along_dim(log_probs, labels.long()[:, None], dim=-1)[:, 0]
        loss = (per_ex * valid).sum() / denom
        return StreamClassificationModelOutput(loss=loss, preds=logits, labels=labels)
