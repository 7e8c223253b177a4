"""Sparse-feature ops and event selection on tensors.

Counterpart: ``eventstreamgpt_tpu/ops/tensor_ops.py``. The JAX versions
rewrite gathers as one-hot reductions for the TPU; here they are plain
gathers, which select the same values exactly.
"""

from __future__ import annotations

import torch


def embedding_bag(
    table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Sum-mode embedding bag with padding index 0.

    Equivalent to ``torch.nn.EmbeddingBag(mode="sum", padding_idx=0)`` with
    ``per_sample_weights``: index 0 contributes nothing whatever its weight.
    Out-of-range indices read the edge row (the JAX ``mode="clip"`` gather).

    Examples:
        >>> t = torch.arange(6.0).reshape(3, 2)
        >>> embedding_bag(t, torch.tensor([[0, 1, 2]]), torch.tensor([[5.0, 1.0, 2.0]]))
        tensor([[10., 13.]])
    """
    pad_mask = (indices != 0).to(table.dtype)
    w = pad_mask if weights is None else weights.to(table.dtype) * pad_mask
    gathered = table[indices.clamp(0, table.shape[0] - 1)]  # (..., M, D)
    return torch.einsum("...md,...m->...d", gathered, w)


def grouped_embedding_bag(
    table: torch.Tensor, indices: torch.Tensor, group_weights: torch.Tensor
) -> torch.Tensor:
    """`embedding_bag` over G weight groups ``(..., G, M)`` sharing one gather."""
    pad_mask = (indices != 0).to(table.dtype)
    w = group_weights.to(table.dtype) * pad_mask[..., None, :]
    gathered = table[indices.clamp(0, table.shape[0] - 1)]
    return torch.einsum("...md,...gm->...gd", gathered, w)


def measurement_index_normalization(measurement_indices: torch.Tensor) -> torch.Tensor:
    """Per-row weights giving each unique measurement equal total mass.

    Examples:
        >>> measurement_index_normalization(torch.tensor([[1, 2, 5, 2, 2]])).round(decimals=4)
        tensor([[0.3333, 0.1111, 0.3333, 0.1111, 0.1111]])
    """
    eq = measurement_indices[..., :, None] == measurement_indices[..., None, :]
    counts = eq.sum(dim=-1).to(torch.float32)
    vals = torch.where(measurement_indices == 0, 0.0, 1.0 / counts)
    denom = vals.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0, 1.0, denom)
    return vals / denom


def take_event(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[:, idx]``; with a per-row ``(B,)`` index, row ``b`` takes ``x[b, idx[b]]``.

    Examples:
        >>> x = torch.tensor([[[1, 2], [3, 4], [5, 6]], [[7, 8], [9, 10], [11, 12]]])
        >>> take_event(x, torch.tensor([1, 2]))
        tensor([[ 3,  4],
                [11, 12]])
    """
    if isinstance(idx, int) or (torch.is_tensor(idx) and idx.ndim == 0):
        return x[:, idx]
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def gather_last(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(plane, idx, axis=-1)`` with ``idx`` over the leading dims."""
    return torch.gather(plane, -1, idx)


def segment_starts(segment_ids: torch.Tensor) -> torch.Tensor:
    """True at each packed segment's first position."""
    return torch.cat(
        [
            torch.ones_like(segment_ids[:, :1], dtype=torch.bool),
            segment_ids[:, 1:] != segment_ids[:, :-1],
        ],
        dim=1,
    )


def dense(x: torch.Tensor, layer) -> torch.Tensor:
    """flax ``nn.Dense``: operands in the layer's dtype, the product, then the bias add.

    ``layer`` is an ``nn.Linear`` whose weight already holds the dtype the
    flax layer computes in (the port casts ``Dense(dtype=bf16)`` weights to
    bf16 once at load, which gives the numbers flax's per-call cast gives).
    The bias is added after the product, as flax does, not fused into it.
    """
    y = x.to(layer.weight.dtype) @ layer.weight.T
    return y if layer.bias is None else y + layer.bias


def flax_layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float, out_dtype: torch.dtype
) -> torch.Tensor:
    """``flax.linen.LayerNorm`` written out: statistics in fp32 (at least),
    ``var = max(0, E[x^2] - E[x]^2)``, ``(x - mean) * (rsqrt(var + eps) * scale)
    + bias`` in fp32, then the cast to ``out_dtype``. ``torch.nn.LayerNorm``
    computes the variance another way and is not used."""
    xs = x.to(torch.promote_types(torch.float32, x.dtype))
    mean = xs.mean(dim=-1, keepdim=True)
    var = torch.clamp((xs * xs).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale
    return ((xs - mean) * mul + bias).to(out_dtype)
