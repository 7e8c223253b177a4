"""Sparse-feature ops, event selection, dense layers, dropout and the loss
reductions, on tensors.

Counterpart: ``eventstreamgpt_tpu/ops/tensor_ops.py``. The JAX versions
rewrite gathers as one-hot reductions for the TPU; here they are plain
gathers, which select the same values exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


# Rows a partial sum of `table_grad` adds up before the partials of a table row are summed.
_PARTIAL_ROWS = 256


def table_grad(indices: torch.Tensor, grad: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The ``(n_rows, D)`` gradient of an embedding table with padding index 0
    from a lookup's ``(N,)`` indices and ``(N, D)`` cotangent, summed in fp32
    in one fixed order, whatever the device and whether the program runs
    eagerly or as a CUDA graph: the rows sorted by index (stable), each
    table row's run cut into partial sums of at most `_PARTIAL_ROWS` rows in
    order, the partials summed in order (``segment_reduce``; every size
    fixed, so it captures without a host sync). Rows of index 0 add nothing.

    Examples:
        >>> table_grad(torch.tensor([2, 0, 2, 1]), torch.tensor([[1.0], [5.0], [2.0], [4.0]]), 3).tolist()
        [[0.0], [4.0], [3.0]]
    """
    N, _ = grad.shape
    key = torch.where(indices == 0, n_rows, indices)  # padding rows sort last, outside the table
    order = torch.argsort(key, stable=True)
    skey = key[order]
    rows = grad.index_select(0, order).float()
    pos = torch.arange(N, device=grad.device)
    new_row = torch.cat([torch.ones_like(skey[:1], dtype=torch.bool), skey[1:] != skey[:-1]])
    run_start = torch.cummax(torch.where(new_row, pos, 0), dim=0).values
    starts = (new_row | ((pos - run_start) % _PARTIAL_ROWS == 0))
    n_partials = n_rows + 1 + -(-N // _PARTIAL_ROWS)
    starts = torch.nonzero_static(starts, size=n_partials, fill_value=N).reshape(-1)
    partial = torch.segment_reduce(rows, "sum", offsets=torch.cat([starts, starts.new_full((1,), N)]), axis=0,
                                   unsafe=True)  # fmt: skip
    partial_key = torch.where(starts < N, skey[starts.clamp(max=N - 1)], n_rows + 1)
    bounds = torch.searchsorted(partial_key, torch.arange(n_rows + 1, device=grad.device))
    return torch.segment_reduce(partial, "sum", offsets=bounds, axis=0, unsafe=True)


class _Lookup(torch.autograd.Function):
    """``F.embedding(indices, table, padding_idx=0)`` whose backward is
    `table_grad`. CUDA's own embedding backward summed a table row's
    cotangents in an order that could change from one capture of a train
    step to another (ROADMAP Queue 3: the packed chunk-vs-single fault)."""

    @staticmethod
    def forward(ctx, table, indices):
        ctx.save_for_backward(indices)
        ctx.n_rows = table.shape[0]
        return F.embedding(indices, table, padding_idx=0)

    @staticmethod
    def backward(ctx, grad):
        (indices,) = ctx.saved_tensors
        out = table_grad(indices.reshape(-1), grad.reshape(-1, grad.shape[-1]), ctx.n_rows)
        return out.to(grad.dtype), None


def lookup(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``F.embedding(indices, table, padding_idx=0)``; on the card, with
    `table_grad` as its backward (deterministic under capture). The CPU's
    own backward is deterministic and stays."""
    if table.is_cuda and table.requires_grad and torch.is_grad_enabled():
        return _Lookup.apply(table, indices)
    return F.embedding(indices, table, padding_idx=0)


def embedding_bag(
    table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Sum-mode embedding bag with padding index 0.

    Equivalent to ``torch.nn.EmbeddingBag(mode="sum", padding_idx=0)`` with
    ``per_sample_weights``: index 0 contributes nothing whatever its weight.
    Out-of-range indices read the edge row and credit it in the backward (the
    JAX ``mode="clip"`` gather): a negative index reads and credits row 0.
    The lookup is ``F.embedding`` with ``padding_idx=0`` (`lookup`), whose
    backward skips every slot that reads row 0, so the many padding duplicates
    of a training batch are not summed one after another as an indexing
    gather's backward sums them; `_negative_slots_grad` then credits row 0
    for the negative slots alone.

    Examples:
        >>> t = torch.arange(6.0).reshape(3, 2)
        >>> embedding_bag(t, torch.tensor([[0, 1, 2]]), torch.tensor([[5.0, 1.0, 2.0]]))
        tensor([[10., 13.]])
    """
    pad_mask = (indices != 0).to(table.dtype)
    w = pad_mask if weights is None else weights.to(table.dtype) * pad_mask
    gathered = lookup(table, indices.clamp(0, table.shape[0] - 1))  # (..., M, D)
    out = torch.einsum("...md,...m->...d", gathered, w)
    return out + _negative_slots_grad(table, indices, w)


def grouped_embedding_bag(
    table: torch.Tensor, indices: torch.Tensor, group_weights: torch.Tensor
) -> torch.Tensor:
    """`embedding_bag` over G weight groups ``(..., G, M)`` sharing one gather
    (`lookup`, as in `embedding_bag`).

    Examples:
        >>> t = torch.arange(6.0).reshape(3, 2)
        >>> grouped_embedding_bag(t, torch.tensor([[0, 1, 2]]), torch.tensor([[[5.0, 1.0, 2.0], [1.0, 0.0, 1.0]]]))
        tensor([[[10., 13.],
                 [ 4.,  5.]]])
    """
    pad_mask = (indices != 0).to(table.dtype)
    w = group_weights.to(table.dtype) * pad_mask[..., None, :]
    gathered = lookup(table, indices.clamp(0, table.shape[0] - 1))  # (..., M, D)
    out = torch.einsum("...md,...gm->...gd", gathered, w)
    return out + _negative_slots_grad(table, indices[..., None, :], w)


def _negative_slots_grad(table: torch.Tensor, indices: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Zero in value; in the backward it credits row 0 with each output's
    cotangent times the weight sum of its negative slots (``indices`` and
    ``w`` broadcast to ``(..., M)``), which ``padding_idx=0`` withheld. The
    weights are detached: their gradient already comes from the lookup."""
    s = torch.where(indices < 0, w, 0).sum(dim=-1).detach()
    row0 = table[0]
    return (row0 - row0.detach()) * s[..., None]


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


def safe_masked_max(X: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max over the last axis of ``X`` where ``mask`` is True; 0 for empty rows.

    ``mask`` has X's shape, or X's shape without its second-to-last axis
    (column masks).

    Examples:
        >>> X = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
        >>> safe_masked_max(X, torch.tensor([[True, True, False], [False, False, False]]))
        tensor([2., 0.])
        >>> X = torch.tensor([[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], [[7.0, 8.0, 9.0], [10.0, 11.0, 12.0]]])
        >>> safe_masked_max(X, torch.tensor([[False, True, False], [True, False, True]]))
        tensor([[ 2.,  5.],
                [ 9., 12.]])
    """
    if mask.ndim < X.ndim:
        if mask.shape != X.shape[:-2] + X.shape[-1:]:
            raise AssertionError(f"mask {tuple(mask.shape)} does not fit X {tuple(X.shape)}")
        mask = mask[..., None, :].expand(X.shape)
    elif mask.shape != X.shape:
        raise AssertionError(f"mask {tuple(mask.shape)} does not fit X {tuple(X.shape)}")
    maxes = torch.where(mask, X, float("-inf")).amax(dim=-1)
    return torch.where(torch.isneginf(maxes), 0.0, maxes)


def safe_weighted_avg(X: torch.Tensor, weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted average over the last axis; ``(0, 0)`` where the weights sum to zero.

    Returns ``(avg, denom)``. ``weights`` has X's shape, or X's shape without
    its second-to-last axis (column weights). A slot of weight 0 gets a
    gradient of exactly 0, and a zero denominator no NaN.

    Examples:
        >>> X = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
        >>> safe_weighted_avg(X, torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]))
        (tensor([0., 4.]), tensor([0., 1.]))
    """
    if weights.ndim < X.ndim:
        if weights.shape != X.shape[:-2] + X.shape[-1:]:
            raise AssertionError(f"weights {tuple(weights.shape)} do not fit X {tuple(X.shape)}")
        weights = weights[..., None, :].expand(X.shape)
    elif weights.shape != X.shape:
        raise AssertionError(f"weights {tuple(weights.shape)} do not fit X {tuple(X.shape)}")
    weights = weights.to(torch.float32)
    denom = weights.sum(dim=-1)
    safe_denom = torch.where(denom > 0, denom, 1.0)
    avg = torch.where(denom > 0, (X * weights).sum(dim=-1) / safe_denom, 0.0)
    return avg, denom


def weighted_loss(loss_per_event: torch.Tensor, event_mask: torch.Tensor) -> torch.Tensor:
    """Macro-average: per-event -> per-subject mean -> mean over subjects with events.

    Examples:
        >>> weighted_loss(torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]),
        ...               torch.tensor([[1.0, 1.0, 1.0], [1.0, 0.0, 0.0]]))
        tensor(3.)
    """
    loss_per_subject, events_per_subject = safe_weighted_avg(loss_per_event, event_mask)
    return safe_weighted_avg(loss_per_subject, events_per_subject > 0)[0]


def dense(x: torch.Tensor, layer, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, weight and bias cast to ``dtype``,
    the product, then the bias add.

    ``layer`` is an ``nn.Linear``. Training keeps its parameters in fp32 and
    casts them on every call, as flax does; the serving engine casts them to
    the compute dtype once (``cast_to_compute_dtype``), after which the casts
    here do nothing. The bias is added after the product, as flax does, not
    fused into it.
    """
    y = x.to(dtype) @ layer.weight.to(dtype).T
    return y if layer.bias is None else y + layer.bias.to(dtype)


def exact_dense(x: torch.Tensor, layer, dtype: torch.dtype) -> torch.Tensor:
    """`dense` whose product, on the card, runs in fp64 and is rounded once to
    ``dtype``; elsewhere `dense`. cuBLAS picks its algorithm (its reduction
    order) by the number of rows, so a row's result would change in the last
    bit with the rows beside it, and a request's greedy draws with its
    prefill group or its engine's slot count (`tools/row_invariance.py`); in
    fp64 the order's error falls far below ``dtype``'s rounding. The model's
    heads use it in generation (training keeps `dense`)."""
    if x.is_cuda:
        return dense(x, layer, torch.float64).to(dtype)
    return dense(x, layer, dtype)


def generator_of(rng) -> torch.Generator | None:
    """The ``torch.Generator`` behind a dropout source: the generator itself,
    None, or the one a `models.remat.RematTape` draws from."""
    return rng if rng is None or isinstance(rng, torch.Generator) else rng.generator


def keep_mask(shape, keep_prob: float, rng, device) -> torch.Tensor:
    """A dropout keep mask, ``rand(shape) < keep_prob``, drawn from a
    ``torch.Generator`` or handed out by a `models.remat.RematTape` (which
    draws it once and gives the recompute of a rematerialized block the same
    mask)."""
    if isinstance(rng, torch.Generator):
        return torch.rand(shape, generator=rng, device=device) < keep_prob
    return rng.keep(shape, keep_prob, device)


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(keep, x / keep_prob, 0)`` in x's dtype,
    with the keep mask drawn from ``generator`` (a ``torch.Generator`` or a
    `models.remat.RematTape`, `keep_mask`); the identity when there is no
    generator (deterministic mode) or ``rate`` is 0.

    Examples:
        >>> dropout(torch.ones(4), 0.5, None)
        tensor([1., 1., 1., 1.])
        >>> sorted(set(dropout(torch.ones(64), 0.5, torch.Generator().manual_seed(0)).tolist()))
        [0.0, 2.0]
    """
    if generator_of(generator) is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = keep_mask(x.shape, keep_prob, generator, x.device)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


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
