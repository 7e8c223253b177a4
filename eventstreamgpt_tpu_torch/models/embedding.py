"""Sparse event-data embedding.

Counterpart: ``eventstreamgpt_tpu/models/embedding.py::DataEmbeddingLayer``
(joint and split modes, static sum/drop, measurement-index normalization).
Tables hold fp32 parameters; like the JAX layer, each call casts them to
the compute dtype and looks up in it. With ``split_by_measurement_indices``
(the nested-attention dep-graph grouping) the output is ``(B, L, G, out_dim)``:
every group sums the event's tokens with its own weights, from one table
gather (`ops.tensor_ops.grouped_embedding_bag`).
"""

from __future__ import annotations

import enum

import torch
from torch import nn

from ..data.types import EventStreamBatch
from ..ops.tensor_ops import dense, embedding_bag, grouped_embedding_bag, measurement_index_normalization
from ..utils import StrEnum


class MeasIndexGroupOptions(StrEnum):
    """How a measurement's categorical/numerical parts join a dep-graph group."""

    CATEGORICAL_ONLY = enum.auto()
    CATEGORICAL_AND_NUMERICAL = enum.auto()
    NUMERICAL_ONLY = enum.auto()


class StaticEmbeddingMode(StrEnum):
    """How static embeddings combine with dynamic embeddings."""

    DROP = enum.auto()
    SUM_ALL = enum.auto()


class DataEmbeddingLayer(nn.Module):
    """Embeds an `EventStreamBatch` into ``(B, L, out_dim)`` per-event embeddings."""

    def __init__(
        self,
        n_total_embeddings: int,
        out_dim: int,
        static_embedding_mode: str = StaticEmbeddingMode.SUM_ALL,
        categorical_embedding_dim: int | None = None,
        numerical_embedding_dim: int | None = None,
        split_by_measurement_indices=None,
        do_normalize_by_measurement_index: bool = False,
        static_weight: float = 0.5,
        dynamic_weight: float = 0.5,
        categorical_weight: float = 0.5,
        numerical_weight: float = 0.5,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.split_by_measurement_indices = split_by_measurement_indices
        if (categorical_embedding_dim is None) != (numerical_embedding_dim is None):
            raise ValueError(
                "If either `categorical_embedding_dim` or `numerical_embedding_dim` is not `None`, "
                "then both must be not `None`."
            )
        self.static_embedding_mode = StaticEmbeddingMode(static_embedding_mode)
        self.do_normalize_by_measurement_index = do_normalize_by_measurement_index
        self.static_frac = static_weight / (static_weight + dynamic_weight)
        self.dynamic_frac = dynamic_weight / (static_weight + dynamic_weight)
        self.categorical_frac = categorical_weight / (categorical_weight + numerical_weight)
        self.numerical_frac = numerical_weight / (categorical_weight + numerical_weight)
        self.joint = categorical_embedding_dim is None
        # Drawn as flax draws them (normal, std 0.02), never left as uninitialised memory.
        if self.joint:
            self.embed_table = nn.Parameter(torch.empty(n_total_embeddings, out_dim).normal_(std=0.02))
        else:
            self.categorical_embed_table = nn.Parameter(
                torch.empty(n_total_embeddings, categorical_embedding_dim).normal_(std=0.02)
            )
            self.cat_proj = nn.Linear(categorical_embedding_dim, out_dim)
            self.numerical_embed_table = nn.Parameter(
                torch.empty(n_total_embeddings, numerical_embedding_dim).normal_(std=0.02)
            )
            self.num_proj = nn.Linear(numerical_embedding_dim, out_dim)

    def _embed(self, indices, measurement_indices, values=None, values_mask=None):
        cdt = self.compute_dtype
        if self.joint:
            if values is None:
                values = torch.ones(indices.shape, dtype=cdt, device=indices.device)
            else:
                values = torch.where(values_mask, values, 1.0)
            if self.do_normalize_by_measurement_index:
                values = values * measurement_index_normalization(measurement_indices)
            return embedding_bag(self.embed_table.to(cdt), indices, values)

        cat_values = torch.ones(indices.shape, dtype=cdt, device=indices.device)
        if self.do_normalize_by_measurement_index:
            meas_norm = measurement_index_normalization(measurement_indices)
            cat_values = cat_values * meas_norm
        cat_embeds = dense(embedding_bag(self.categorical_embed_table.to(cdt), indices, cat_values), self.cat_proj, cdt)
        if values is None:
            return cat_embeds
        num_values = torch.where(values_mask, values, 0.0)
        if self.do_normalize_by_measurement_index:
            num_values = num_values * meas_norm
        num_embeds = dense(embedding_bag(self.numerical_embed_table.to(cdt), indices, num_values), self.num_proj, cdt)
        return self.categorical_frac * cat_embeds + self.numerical_frac * num_embeds

    def _split_batch_into_measurement_index_buckets(self, measurement_indices):
        """Per-group categorical and numerical membership masks, ``(B, L, G, M)`` each."""
        categorical, numerical = [], []
        for i, group in enumerate(self.split_by_measurement_indices):
            if len(group) == 0 and i > 0:
                raise ValueError(
                    f"Empty measurement index group: {group} at index {i}! Only the first (i=0) group can be "
                    "empty (in cases where there are no FUNCTIONAL_TIME_DEPENDENT measurements)."
                )
            group_cat = torch.zeros_like(measurement_indices, dtype=torch.bool)
            group_num = torch.zeros_like(measurement_indices, dtype=torch.bool)
            for meas_index in group:
                mode = MeasIndexGroupOptions.CATEGORICAL_AND_NUMERICAL
                if isinstance(meas_index, (tuple, list)):
                    meas_index, mode = meas_index
                if mode not in MeasIndexGroupOptions.values():
                    raise ValueError(f"Invalid group mode: {mode}")
                new_mask = measurement_indices == meas_index
                if mode != MeasIndexGroupOptions.NUMERICAL_ONLY:
                    group_cat = group_cat | new_mask
                if mode != MeasIndexGroupOptions.CATEGORICAL_ONLY:
                    group_num = group_num | new_mask
            categorical.append(group_cat)
            numerical.append(group_num)
        return torch.stack(categorical, dim=-2), torch.stack(numerical, dim=-2)

    def _embed_grouped(self, indices, measurement_indices, values, values_mask_g, cat_mask):
        """The G groups' embeddings: in each group a token weighs its value
        inside the group's numerical mask and 1 elsewhere (joint mode), or
        its categorical and numerical weights inside the group's masks and 0
        elsewhere (split mode)."""
        cdt = self.compute_dtype
        if self.do_normalize_by_measurement_index:
            norm = measurement_index_normalization(measurement_indices)[..., None, :]
        else:
            norm = torch.ones(indices.shape, device=indices.device)[..., None, :]
        if self.joint:
            w = torch.where(values_mask_g, values[..., None, :], 1.0) * norm
            return grouped_embedding_bag(self.embed_table.to(cdt), indices, w)
        cat_w = torch.where(cat_mask, norm, 0.0)
        cat_embeds = grouped_embedding_bag(self.categorical_embed_table.to(cdt), indices, cat_w)
        cat_embeds = dense(cat_embeds, self.cat_proj, cdt)
        num_w = torch.where(values_mask_g, values[..., None, :] * norm, 0.0)
        num_embeds = grouped_embedding_bag(self.numerical_embed_table.to(cdt), indices, num_w)
        num_embeds = dense(num_embeds, self.num_proj, cdt)
        return self.categorical_frac * cat_embeds + self.numerical_frac * num_embeds

    def _dynamic_embedding(self, batch: EventStreamBatch) -> torch.Tensor:
        if self.split_by_measurement_indices:
            cat_mask, num_mask = self._split_batch_into_measurement_index_buckets(batch.dynamic_measurement_indices)
            values_mask_g = batch.dynamic_values_mask[..., None, :] & num_mask
            return self._embed_grouped(
                batch.dynamic_indices, batch.dynamic_measurement_indices, batch.dynamic_values, values_mask_g, cat_mask
            )
        return self._embed(
            batch.dynamic_indices,
            batch.dynamic_measurement_indices,
            batch.dynamic_values,
            batch.dynamic_values_mask,
        )

    def forward(self, batch: EventStreamBatch) -> torch.Tensor:
        """``(B, L, out_dim)``, or ``(B, L, G, out_dim)`` with dep-graph groups."""
        embedded = self._dynamic_embedding(batch)
        mask = batch.event_mask.reshape(batch.event_mask.shape + (1,) * (embedded.ndim - 2))
        embedded = torch.where(mask, embedded, 0.0)
        if self.static_embedding_mode == StaticEmbeddingMode.DROP or batch.static_indices is None:
            return embedded
        static_embedded = self._embed(batch.static_indices, batch.static_measurement_indices)  # (B, E)
        static_embedded = static_embedded.reshape((embedded.shape[0],) + (1,) * (embedded.ndim - 2) + (-1,))
        embedded = self.dynamic_frac * embedded + self.static_frac * static_embedded
        return torch.where(mask, embedded, 0.0)
