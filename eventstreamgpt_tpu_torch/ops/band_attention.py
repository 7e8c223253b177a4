"""Narrow-window local attention as a chunked band product.

Counterpart: ``eventstreamgpt_tpu/ops/band_attention.py::band_local_attention``,
the route the JAX model takes under ``attention_implementation="pallas_flash"``
for a local layer whose window is at most 128 and divides the sequence
length. The JAX package computes it with plain einsums outside any Pallas
kernel, so it stays plain PyTorch here, on the CPU and on the card alike.

The sequence is cut into window-sized chunks; a query in chunk ``n`` attends
only keys in chunks ``n - 1`` and ``n``, which cover its causal window
``(q - W, q]``, so the logits plane is ``(C, 2C)`` per chunk. Packed segments
follow the fused kernels' convention: padding rides as segment ``-1``, and a
row's first chunk gets a predecessor of segment ``-2``, which nothing matches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["band_local_attention"]

F32_MIN = torch.finfo(torch.float32).min


def band_local_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    segment_ids: torch.Tensor,
    window: int,
    chunk_size: int | None = None,
) -> torch.Tensor:
    """Exact sliding-window attention: ``k <= q`` and ``k > q - window``.

    Args:
        query, key, value: ``(B, H, L, D)`` with ``L`` divisible by the chunk size.
        segment_ids: ``(B, L)`` integer segment ids; queries attend only keys
            of their own segment (``-1`` for padding).
        window: the local window width ``W``.
        chunk_size: the chunk width ``C >= W`` dividing ``L`` (``None``: ``W``);
            every such ``C`` computes the same function.

    Returns:
        ``(B, H, L, D)`` in the value dtype; unscaled logits, fp32 softmax.

    Examples:
        >>> q = torch.zeros(1, 1, 4, 2)
        >>> v = torch.arange(4.0).reshape(1, 1, 4, 1).expand(1, 1, 4, 2)
        >>> band_local_attention(q, q, v, torch.zeros(1, 4, dtype=torch.int32), window=2)[0, 0, :, 0]
        tensor([0.0000, 0.5000, 1.5000, 2.5000])
    """
    B, H, L, D = query.shape
    C = window if chunk_size is None else chunk_size
    if C < window:
        raise ValueError(f"chunk_size {C} must be >= window {window}: a chunk and its predecessor must cover it")
    if L % C:
        raise ValueError(f"sequence length {L} must be divisible by the chunk size {C} (window {window})")
    nc = L // C

    def chunk(x):  # (B, H, L, D) -> (B, H, nc, C, D)
        return x.reshape(B, H, nc, C, D)

    def with_prev(x):  # (B, H, nc, C, D) -> (B, H, nc, 2C, D)
        return torch.cat([F.pad(x[:, :, :-1], (0, 0, 0, 0, 1, 0)), x], dim=3)

    qc, k2, v2 = chunk(query), with_prev(chunk(key)), with_prev(chunk(value))
    # Relative positions: query n*C + c against key (n-1)*C + j, j in [0, 2C).
    c_off = torch.arange(C, device=query.device)
    j_off = torch.arange(2 * C, device=query.device)
    rel = (C + c_off[:, None]) - j_off[None, :]
    band = (rel >= 0) & (rel < window)

    seg_c = segment_ids.reshape(B, 1, nc, C)
    seg_prev = F.pad(seg_c[:, :, :-1], (0, 0, 1, 0), value=-2)
    seg2 = torch.cat([seg_prev, seg_c], dim=3)  # (B, 1, nc, 2C)
    mask = band & (seg_c[..., :, None] == seg2[..., None, :])  # (B, 1, nc, C, 2C)

    logits = torch.matmul(qc.float(), k2.float().transpose(-1, -2))
    logits = torch.where(mask, logits, F32_MIN)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v2.dtype), v2).reshape(B, H, L, D)
