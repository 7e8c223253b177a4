"""The point-process transformer encoders, conditionally independent and nested.

Counterpart: ``eventstreamgpt_tpu/models/transformer.py``: `KVCache`,
`PagedKVCache` (the serving engine's block pool), `time_from_deltas`,
`TemporalPositionEncoding`, `make_causal_mask`,
`InnerSelfAttention` (the einsum path and its cache branches, the fused
dep-graph route to kernel D, and the ``pallas_flash`` routes: kernel E for
global layers, the band for narrow local windows, kernel F for wide ones),
`InnerMLP`, `InnerBlock`, the CI input layer
and transformer, and the nested-attention (NA) input layer and transformer
with `StructuredTransformerBlock`, `NAPast` and the cached per-level walk,
and `scan_period`. Remat runs each block under the configured policy
(`models.remat`). Scan-over-layers (``scan_layers=True``) is a parameter
layout in torch, not a compile saving: the scanned model builds the same
per-layer modules ``h{i}`` and computes what the unrolled one does bit for
bit; `convert.py` stacks and unstacks JAX's ``h_scan`` tree. Module attribute names
follow the flax parameter paths (``encoder.h0.attn.attention.q_proj``,
``encoder.h0.block.dep_graph_block.mlp.c_fc``...), so
`convert.load_jax_params` maps one tree onto the other by name.

Numerics kept from the JAX model: attention logits are **not** scaled by
``1/sqrt(head_dim)``; logits and softmax are fp32; masked logits take the
fp32 minimum and are clamped there (a fully masked row softmaxes to
uniform); LayerNorm is flax's formula (`ops.tensor_ops.flax_layer_norm`);
``gelu`` is the tanh approximation (``flax.linen.gelu``'s default).

Parameters are fp32 and every dense layer casts them to the compute dtype
on each call, as flax's ``nn.Dense(dtype=...)`` does (the serving engine
casts them once instead). Dropout sits where the JAX model has it (input
embedding, attention weights, attention output, MLP output) and is on only
when the forward is given a ``torch.Generator`` (`ops.tensor_ops.dropout`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..data.types import EventStreamBatch
from ..ops.band_attention import band_local_attention
from ..ops.dep_graph import dep_graph_attention
from ..ops.flash_attention import flash_attention
from ..ops.kv_quant import dequantize_kv, is_quantized_dtype, quantize_kv, resolve_cache_dtype, storage
from ..ops.tensor_ops import dense, dropout, flax_layer_norm, generator_of, keep_mask, segment_starts, take_event
from .config import StructuredTransformerConfig
from .embedding import DataEmbeddingLayer
from .remat import attend, remat_block
from .structured_attention import StructuredAttention

F32_MIN = torch.finfo(torch.float32).min


def activation(name: str):
    """The activation named by ``config.activation_function`` (flax's ACT2FN)."""
    if name in ("gelu", "gelu_new"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    if name in ("silu", "swish"):
        return F.silu
    if name == "tanh":
        return torch.tanh
    raise ValueError(f"Unknown activation_function {name!r}")


@dataclasses.dataclass
class KVCache:
    """A fixed-size per-layer key/value cache with a write cursor.

    ``key``/``value`` are ``(B, H, max_len, head_dim)``; ``mask`` is the
    accumulated key-padding mask ``(B, max_len)``; ``length`` is the number
    of positions written: a python int on the prefill path, or a per-row
    ``(B,)`` int32 tensor on the serving engine's decode path. Quantized
    caches (int8 or fp8 planes, `ops.kv_quant`) also carry ``key_scale`` /
    ``value_scale``, ``(B, H, max_len)`` fp32, written with the planes and
    read by the dequantization before attention; float caches carry ``None``.
    """

    key: torch.Tensor
    value: torch.Tensor
    mask: torch.Tensor
    length: object
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None

    @classmethod
    def init(cls, batch_size, num_heads, max_len, head_dim, dtype=torch.float32, *, device):
        def z():
            return torch.zeros(batch_size, num_heads, max_len, head_dim, dtype=dtype, device=device)

        def scale():  # ones: zero codes dequantize to zeros
            return torch.ones(batch_size, num_heads, max_len, device=device) if is_quantized_dtype(dtype) else None

        return cls(
            key=z(),
            value=z(),
            mask=torch.zeros(batch_size, max_len, dtype=torch.bool, device=device),
            length=0,
            key_scale=scale(),
            value_scale=scale(),
        )

    @property
    def max_len(self) -> int:
        return self.key.shape[2]

    @property
    def storage_dtype(self) -> torch.dtype:
        return self.key.dtype

    @property
    def quantized(self) -> bool:
        return self.key_scale is not None

    def write_at(self, start, chunks, scales, mask) -> "KVCache":
        """The cache with each row's ``S`` new keys and values (``chunks``,
        ``(B, H, S, D)`` in the storage type, with their ``(B, H, S)`` scales
        when quantized) selected in at positions ``start[b] .. start[b] + S -
        1`` of row ``b`` (positions past ``max_len`` are not written), the
        mask ``mask`` and every row's length ``start + S``; new planes.
        ``S == 1`` is a one-hot select; a wider chunk (the speculative verify
        window) is gathered to the buffer's positions first, buffer position
        ``p`` taking chunk element ``clip(p - start[b], 0, S - 1)``: a
        selection, so the values land bit for bit as ``S`` one-event writes."""
        S = chunks[0].shape[2]
        write, src = _write_range(start, S, torch.arange(self.max_len, device=start.device))
        new_key, new_value = (
            _where_rows(write[:, None, :, None], _gather_positions(new, src), old)
            for new, old in zip(chunks, (self.key, self.value))
        )
        if scales is not None:  # quantize on write: the scales ride the same select
            scales = tuple(
                torch.where(write[:, None, :], _gather_positions(new, src), old)
                for new, old in zip(scales, (self.key_scale, self.value_scale))
            )
        return KVCache(new_key, new_value, mask, start + S, *(scales or (None, None)))

    def read(self, dtype: torch.dtype) -> tuple:
        """The keys and values attention reads: the planes, dequantized to
        ``dtype`` when the cache is quantized."""
        if self.key_scale is None:
            return self.key, self.value
        return dequantize_kv(self.key, self.key_scale, dtype), dequantize_kv(self.value, self.value_scale, dtype)


@dataclasses.dataclass
class PagedKVCache:
    """A block-pool (paged) per-layer key/value cache with per-row block tables.

    The serving engine's copy-on-write decode cache (JAX's `PagedKVCache`):
    keys and values live in a pool of fixed-size blocks (``pool_key`` /
    ``pool_value``, ``(num_blocks, H, block_size, head_dim)``) and row ``b``
    holds ``block_table[b]``, the ``max_len // block_size`` physical blocks
    of its positions; rows whose tables share block ids share those bytes
    (``fork()``'s prefix). ``mask`` ``(B, max_len)`` and ``length`` ``(B,)``
    stay dense per row, as in `KVCache`'s per-row-cursor form; quantized
    pools carry ``pool_key_scale`` / ``pool_value_scale`` ``(num_blocks, H,
    block_size)`` fp32.

    Block 0 is the zero block: it backs every unallocated table entry and is
    never written (`write_at` drops a write aimed at it or past ``max_len``),
    so an unallocated position reads the zeros a monolithic cache holds
    there. The pool is written in place (JAX's functional scatter returns
    new planes; here the planes are the engine's buffers, written at one
    position a row a step), and `read` gathers each row's dense ``(H,
    max_len, D)`` view through its table.
    """

    pool_key: torch.Tensor
    pool_value: torch.Tensor
    block_table: torch.Tensor  # (B, max_len // block_size) int32; 0 = the zero block
    mask: torch.Tensor
    length: torch.Tensor
    pool_key_scale: Optional[torch.Tensor] = None
    pool_value_scale: Optional[torch.Tensor] = None

    @property
    def block_size(self) -> int:
        return self.pool_key.shape[2]

    @property
    def num_blocks(self) -> int:
        return self.pool_key.shape[0]

    @property
    def max_len(self) -> int:
        return self.block_table.shape[1] * self.pool_key.shape[2]

    @property
    def storage_dtype(self) -> torch.dtype:
        return self.pool_key.dtype

    @property
    def quantized(self) -> bool:
        return self.pool_key_scale is not None

    @classmethod
    def init(cls, batch_size, num_heads, num_blocks, block_size, max_len, head_dim, dtype=torch.float32, *, device):
        if max_len % block_size != 0:
            raise ValueError(f"paged cache needs block_size ({block_size}) to divide max_len ({max_len})")

        def scale():  # ones: the zero block dequantizes to zeros, as a fresh monolithic cache does
            return torch.ones(num_blocks, num_heads, block_size, device=device) if is_quantized_dtype(dtype) else None

        def z():
            return torch.zeros(num_blocks, num_heads, block_size, head_dim, dtype=dtype, device=device)

        return cls(
            pool_key=z(),
            pool_value=z(),
            block_table=torch.zeros(batch_size, max_len // block_size, dtype=torch.int32, device=device),
            mask=torch.zeros(batch_size, max_len, dtype=torch.bool, device=device),
            length=torch.zeros(batch_size, dtype=torch.int32, device=device),
            pool_key_scale=scale(),
            pool_value_scale=scale(),
        )

    def write_at(self, start, chunks, scales, mask) -> "PagedKVCache":
        """`KVCache.write_at` on the pool, which it writes in place (the
        cache it returns shares the pool): row ``b``'s key and value at
        offset ``start[b] % block_size`` of the block its table maps position
        ``start[b]`` to. The drop rule of JAX's scatter: a row whose target is
        the zero block (a row never admitted, a position past its
        allocation) or lies past ``max_len`` writes back what block 0 holds
        at that offset instead, so the zero block stays zero and every index
        written to twice gets one value."""
        bs, T = self.block_size, self.block_table.shape[1]
        B, H = start.shape[0], self.pool_key.shape[1]
        phys = self.block_table.gather(1, torch.clamp(start // bs, 0, T - 1).long()[:, None])[:, 0]
        keep = (phys != 0) & (start < self.max_len)
        phys = torch.where(keep, phys, 0).long()
        # One index a (row, head) into the pool seen as (num_blocks * H * block_size) rows.
        heads = torch.arange(H, device=start.device)
        idx = ((phys[:, None] * H + heads) * bs + (start % bs).long()[:, None]).reshape(-1)
        keep_rows = keep[:, None].expand(B, H).reshape(-1)
        pairs = [(self.pool_key, chunks[0]), (self.pool_value, chunks[1])]
        if scales is not None:
            pairs += [(self.pool_key_scale, scales[0]), (self.pool_value_scale, scales[1])]
        for pool, chunk in pairs:
            flat = storage(pool).view(self.num_blocks * H * bs, -1)
            new = storage(chunk).reshape(B * H, -1)
            flat.index_copy_(0, idx, torch.where(keep_rows[:, None], new, flat.index_select(0, idx)))
        return dataclasses.replace(self, mask=mask, length=start + 1)

    def gather(self, pool: torch.Tensor) -> torch.Tensor:
        """``pool`` ``(num_blocks, H, block_size, ...)`` read through the
        tables: each row's dense ``(B, H, max_len, ...)`` view."""
        B, T = self.block_table.shape
        g = storage(pool).index_select(0, self.block_table.reshape(-1).long())
        g = g.view(B, T, *g.shape[1:]).transpose(1, 2)
        return g.reshape(B, g.shape[1], T * g.shape[3], *g.shape[4:]).view(pool.dtype)

    def read(self, dtype: torch.dtype) -> tuple:
        """The dense keys and values attention reads (`KVCache.read` of the
        gathered view)."""
        key, value = self.gather(self.pool_key), self.gather(self.pool_value)
        if self.pool_key_scale is None:
            return key, value
        return (dequantize_kv(key, self.gather(self.pool_key_scale), dtype),
                dequantize_kv(value, self.gather(self.pool_value_scale), dtype))  # fmt: skip


def init_kv_caches(
    config: StructuredTransformerConfig, batch_size: int, max_len: int, device, cache_dtype: str | None = None
) -> tuple:
    """One `KVCache` per hidden layer, in the model's compute dtype or in the
    storage type ``cache_dtype`` names (`ops.kv_quant.resolve_cache_dtype`)."""
    dtype, _ = resolve_cache_dtype(cache_dtype, config.compute_dtype)
    return tuple(
        KVCache.init(batch_size, config.num_attention_heads, max_len, config.head_dim, dtype=dtype, device=device)
        for _ in range(config.num_hidden_layers)
    )


def paged_kv_bytes_per_block(
    num_layers: int, num_heads: int, block_size: int, head_dim: int, cache_dtype, compute_dtype
) -> int:
    """Device bytes one block pins across all layers (two planes and, quantized, their scale rows).

    Examples:
        >>> paged_kv_bytes_per_block(2, 4, 16, 64, "bf16", torch.bfloat16)
        32768
        >>> paged_kv_bytes_per_block(2, 4, 16, 64, "int8", torch.bfloat16)
        17408
    """
    dtype, quantized = resolve_cache_dtype(cache_dtype, compute_dtype)
    plane = num_heads * block_size * head_dim * dtype.itemsize
    scale = num_heads * block_size * 4 if quantized else 0
    return num_layers * 2 * (plane + scale)


def init_paged_kv_caches(
    config: StructuredTransformerConfig,
    batch_size: int,
    num_blocks: int,
    block_size: int,
    device,
    max_len: int | None = None,
    cache_dtype: str | None = None,
) -> tuple:
    """One `PagedKVCache` per hidden layer, in the compute dtype or the storage type ``cache_dtype`` names."""
    dtype, _ = resolve_cache_dtype(cache_dtype, config.compute_dtype)
    max_len = config.max_seq_len if max_len is None else max_len
    return tuple(
        PagedKVCache.init(batch_size, config.num_attention_heads, num_blocks, block_size, max_len, config.head_dim,
                          dtype=dtype, device=device)  # fmt: skip
        for _ in range(config.num_hidden_layers)
    )


def _where_rows(cond, new, old):
    """``torch.where`` into a cache plane of any storage type (fp8 as bytes)."""
    return torch.where(cond, storage(new), storage(old)).view(old.dtype)


def _write_range(start: torch.Tensor, S: int, pos: torch.Tensor) -> tuple:
    """The per-row write of ``S`` positions from ``start`` into a buffer of
    positions ``pos`` (``arange(max_len)``): the ``(B, max_len)`` mask of the
    positions written and, for ``S > 1``, each buffer position's chunk element
    ``clip(p - start, 0, S - 1)`` (``None`` for one position, which broadcasts)."""
    if S == 1:
        return pos[None, :] == start[:, None], None
    offset = pos[None, :] - start[:, None]
    return (offset >= 0) & (offset < S), offset.clamp(0, S - 1)


def _gather_positions(chunk: torch.Tensor, src) -> torch.Tensor:
    """A ``(B, H, S, ...)`` chunk (or ``(B, S)`` mask) laid out on the
    buffer's positions by `_write_range`'s ``src`` (as it is when ``src`` is
    ``None``); any storage type, gathered as bytes."""
    if src is None:
        return chunk
    if chunk.ndim == 2:  # a mask (B, S)
        return chunk.gather(1, src)
    idx = src[:, None, :].expand(chunk.shape[0], chunk.shape[1], src.shape[1])
    if chunk.ndim == 4:
        idx = idx[..., None].expand(*idx.shape, chunk.shape[3])
    return storage(chunk).gather(2, idx).view(chunk.dtype)


def time_from_deltas(batch: EventStreamBatch) -> torch.Tensor:
    """Cumulative time-since-start from per-event deltas.

    Examples:
        >>> b = EventStreamBatch(event_mask=torch.tensor([[True, True, True], [True, True, False]]),
        ...                      time_delta=torch.tensor([[1.0, 3.2, 0.0], [1.4, 0.0, 1.0]]))
        >>> time_from_deltas(b)
        tensor([[0.0000, 1.0000, 4.2000],
                [0.0000, 1.4000, 1.4000]])
    """
    t_deltas = batch.time_delta
    if batch.event_mask is not None:
        t_deltas = torch.where(batch.event_mask, t_deltas, 0.0)
    # Accumulated in fp64, as the CPU's fp32 cumsum accumulates (bit for bit
    # the same there). CUDA's fp32 scan shapes its reduction tree by the
    # number of rows, so a row's times would change in the last bit with the
    # rows beside it (`tools/row_invariance.py`), and the sinusoids of times
    # of ~1e4 carry that into every later float; in fp64 the order's error
    # falls far below fp32's rounding.
    csum = torch.cumsum(t_deltas, dim=-1, dtype=torch.float64).to(t_deltas.dtype)
    t = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=1)
    if batch.segment_ids is not None:
        seg_start = segment_starts(batch.segment_ids)
        offsets = torch.cummax(torch.where(seg_start, t, -math.inf), dim=1).values
        t = t - offsets
    return t


def temporal_position_encoding(t: torch.Tensor, embedding_dim: int, max_timepoint: float = 10000.0):
    """Sinusoids over continuous time, interleaved: ``out[..., 0::2] = sin``,
    ``out[..., 1::2] = cos`` (counterpart: `TemporalPositionEncoding`)."""
    div_term = torch.exp(
        torch.arange(0, embedding_dim, 2, dtype=torch.float32, device=t.device)
        * (-math.log(max_timepoint) / embedding_dim)
    )
    cos_div = div_term if embedding_dim % 2 == 0 else div_term[:-1]
    t = t[..., None]
    out = torch.zeros(t.shape[:-1] + (embedding_dim,), dtype=torch.float32, device=t.device)
    out[..., 0::2] = torch.sin(t * div_term)
    out[..., 1::2] = torch.cos(t * cos_div)
    return out


def make_causal_mask(q_positions, k_positions, window_size: int | None = None):
    """Boolean ``(..., Q, K)`` mask: ``k <= q``, and ``k > q - window`` when local."""
    q = q_positions[..., :, None]
    k = k_positions[..., None, :]
    mask = k <= q
    if window_size is not None:
        mask = mask & (k > q - window_size)
    return mask


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=compute_dtype)``: fp32 ``weight``/``bias``
    (flax ``scale``/``bias``) whatever the compute dtype, output in it."""

    def __init__(self, dim: int, eps: float, out_dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = float(eps)
        self.out_dtype = out_dtype

    def forward(self, x):
        return flax_layer_norm(x, self.weight, self.bias, self.eps, self.out_dtype)


class InnerSelfAttention(nn.Module):
    """Multi-head causal self-attention with optional local windowing.

    ``is_dep_graph`` marks the nested-attention dep-graph attention. Its
    uncached forward runs `ops.dep_graph.dep_graph_attention` (kernel D on
    the card) on the ``(N, S, H, D)`` projections as they are and takes no
    padding mask or packing; with a cache or ``use_cache`` (the NA cached
    walk) it runs the einsum path below, as the JAX model routes it, where
    ``static_kv_first`` drops graph position 0 from the queries and puts
    query ``i`` at position ``start + i + 1``.

    Under ``attention_implementation="pallas_flash"`` an uncached sequence
    layer follows the JAX model's gates: a global layer runs
    `ops.flash_attention.flash_attention` (kernel E on the card), a local
    layer whose window is at most 128 and divides ``S`` the band product
    `ops.band_attention.band_local_attention`, and any other local layer
    `flash_attention` with its window (kernel F). Where a gate fails (a
    cache, attention dropout with a dropout generator, ``S`` not a multiple
    of 128) the layer keeps the einsum path, as the JAX model does.
    """

    def __init__(self, config: StructuredTransformerConfig, window_size: int | None, is_dep_graph: bool = False):
        super().__init__()
        E = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        self.window_size = window_size
        self.is_dep_graph = is_dep_graph
        self.attention_implementation = config.attention_implementation
        self.dtype = config.compute_dtype
        self.attention_dropout = float(config.attention_dropout)
        self.resid_dropout = float(config.resid_dropout)
        self.q_proj = nn.Linear(E, E, bias=False)
        self.k_proj = nn.Linear(E, E, bias=False)
        self.v_proj = nn.Linear(E, E, bias=False)
        self.out_proj = nn.Linear(E, E, bias=True)

    def forward(
        self,
        hidden_states,
        attention_mask=None,
        layer_past: Optional[KVCache] = None,
        use_cache=False,
        segment_ids=None,
        dropout_rng=None,
        static_kv_first: bool = False,
    ):
        """``static_kv_first`` (dep-graph only): graph position 0 is key/value-only
        history; the query (and the output) drop it, and query ``i`` sits at position ``i + 1``."""
        B, S, E = hidden_states.shape
        H, D = self.num_heads, self.head_dim
        if self.is_dep_graph and layer_past is None and not use_cache:
            if attention_mask is not None or segment_ids is not None:
                raise ValueError("dep-graph attention takes no padding mask or segment_ids")
            return self._dep_graph(hidden_states, static_kv_first, dropout_rng), None
        if static_kv_first and not self.is_dep_graph:
            raise ValueError("static_kv_first belongs to dep-graph attention")
        q_off = 1 if static_kv_first else 0
        q_len = S - q_off

        def heads(x):  # (B, S, E) -> (B, H, S, D)
            return x.reshape(B, S, H, D).transpose(1, 2)

        query = heads(dense(hidden_states, self.q_proj, self.dtype))[:, :, q_off:]
        key = heads(dense(hidden_states, self.k_proj, self.dtype))
        value = heads(dense(hidden_states, self.v_proj, self.dtype))
        chunk_mask = (
            attention_mask
            if attention_mask is not None
            else torch.ones(B, S, dtype=torch.bool, device=hidden_states.device)
        )

        # The JAX model's fused-attention gates (its models/transformer.py
        # fused_ok ... use_splash), but for the TPU-backend test: the tensors'
        # device picks the kernel or its plain version in ops/flash_attention.py.
        local = self.window_size is not None
        pallas = self.attention_implementation == "pallas_flash"
        fused_ok = layer_past is None and not use_cache and (
            self.attention_dropout == 0.0 or generator_of(dropout_rng) is None
        )
        kernel_ok = pallas and fused_ok and S % 128 == 0
        use_flash = kernel_ok and not local
        use_band = fused_ok and pallas and local and 1 <= self.window_size <= 128 and S % self.window_size == 0
        use_splash = kernel_ok and not use_band and local and self.window_size >= 1
        if use_flash or use_band or use_splash:
            # Padding rides as its own segment (-1): padded queries attend only
            # among padded keys (finite, and zeroed between layers).
            base = segment_ids if segment_ids is not None else torch.zeros_like(chunk_mask, dtype=torch.int32)
            seg = torch.where(chunk_mask, base.to(torch.int32), -1)
            if use_band:
                out = attend(dropout_rng, lambda rng: band_local_attention(query, key, value, seg, self.window_size))
            else:
                window = self.window_size if use_splash else None
                out = attend(dropout_rng, lambda rng: flash_attention(query, key, value, seg, window))
            out = out.transpose(1, 2).reshape(B, S, E)
            return dropout(dense(out, self.out_proj, self.dtype), self.resid_dropout, dropout_rng), None

        present = None
        if layer_past is not None and torch.is_tensor(layer_past.length):
            # Per-row cursors (the serving engine's decode slots): row b writes
            # its S new keys/values from position length[b] (one event a
            # decode step; the K + 1 events of the speculative verify window),
            # into new planes or, paged, in place into the block its table
            # maps there (a paged past is mutated: its pool is the engine's;
            # one event a step only, as in JAX); the position and mask math
            # after the write is the same for both.
            if S != 1 and isinstance(layer_past, PagedKVCache):
                raise ValueError(
                    "paged caches take one event per step: the multi-event verify window of speculative "
                    "decoding runs on monolithic per-row caches only (JAX refuses paged x spec)"
                )
            max_len = layer_past.max_len
            start = layer_past.length
            pos = torch.arange(max_len, device=hidden_states.device)
            write, src = _write_range(start, S, pos)
            chunks, scales = self._cache_chunks(layer_past, key, value)
            new_mask = torch.where(write, _gather_positions(chunk_mask, src), layer_past.mask)
            q_positions = (
                start[:, None]
                if q_len == 1 and not q_off
                else start[:, None] + torch.arange(q_off, S, device=start.device)
            )
            valid_k = pos[None, :] < (start[:, None] + S)
            present = layer_past.write_at(start, chunks, scales, new_mask)
            key, value = present.read(self.dtype)
            attention_mask = new_mask
            k_positions = pos
        elif layer_past is not None:
            # Fixed buffer with one shared cursor (prefill into a fresh cache).
            max_len = layer_past.key.shape[2]
            start = int(layer_past.length)
            (k_chunk, v_chunk), scales = self._cache_chunks(layer_past, key, value)
            new_key = layer_past.key.clone()
            new_value = layer_past.value.clone()
            new_mask = layer_past.mask.clone()
            storage(new_key)[:, :, start : start + S] = storage(k_chunk)
            storage(new_value)[:, :, start : start + S] = storage(v_chunk)
            new_mask[:, start : start + S] = chunk_mask
            new_scales = (None, None)
            if scales is not None:
                new_scales = (layer_past.key_scale.clone(), layer_past.value_scale.clone())
                for dst, src in zip(new_scales, scales):
                    dst[:, :, start : start + S] = src
            k_positions = torch.arange(max_len, device=hidden_states.device)
            q_positions = start + torch.arange(q_off, S, device=hidden_states.device)
            valid_k = k_positions < (start + S)
            present = KVCache(new_key, new_value, new_mask, start + S, *new_scales)
            key, value = present.read(self.dtype)
            attention_mask = new_mask
        else:
            k_positions = torch.arange(S, device=hidden_states.device)
            q_positions = k_positions[q_off:]
            valid_k = None
            if use_cache:
                present = KVCache(key, value, chunk_mask, S)

        causal = make_causal_mask(q_positions, k_positions, self.window_size)
        mask = causal[None, None] if causal.ndim == 2 else causal[:, None]
        if valid_k is not None:
            mask = mask & (valid_k[None, None, None, :] if valid_k.ndim == 1 else valid_k[:, None, None, :])
        if segment_ids is not None:
            if layer_past is not None:
                raise ValueError("packed (segment_ids) batches do not support KV caching")
            # Packed rows: queries attend only within their own segment.
            mask = mask & (segment_ids[:, None, :, None] == segment_ids[:, None, None, :])

        def core(rng):
            # fp32 logits, no 1/sqrt(d) scaling (GPT-Neo lineage, as the JAX model).
            attn = torch.matmul(query.float(), key.float().transpose(-1, -2))
            attn = torch.where(mask, attn, F32_MIN)
            if attention_mask is not None:
                attn = attn + torch.where(attention_mask[:, None, None, :], 0.0, F32_MIN)
            attn = torch.clamp(attn, min=F32_MIN)
            attn = torch.softmax(attn, dim=-1).to(value.dtype)
            attn = dropout(attn, self.attention_dropout, rng)
            return torch.matmul(attn, value)  # (B, H, q_len, D)

        out = attend(dropout_rng, core).transpose(1, 2).reshape(B, q_len, E)
        out = dropout(dense(out, self.out_proj, self.dtype), self.resid_dropout, dropout_rng)
        return out, (present if use_cache else None)

    @staticmethod
    def _cache_chunks(layer_past, key, value):
        """The new keys and values in the cache's storage type, and their
        ``(key_scale, value_scale)`` when the cache is quantized (else ``None``)."""
        dtype = layer_past.storage_dtype
        if not layer_past.quantized:
            return (key.to(dtype), value.to(dtype)), None
        (k_q, k_s), (v_q, v_s) = quantize_kv(key, dtype), quantize_kv(value, dtype)
        return (k_q, v_q), (k_s, v_s)

    def _dep_graph(self, hidden_states, static_kv_first, dropout_rng):
        B, S, E = hidden_states.shape
        H, D = self.num_heads, self.head_dim
        q_offset = 1 if static_kv_first else 0
        query = dense(hidden_states, self.q_proj, self.dtype).reshape(B, S, H, D)[:, q_offset:]
        key = dense(hidden_states, self.k_proj, self.dtype).reshape(B, S, H, D)
        value = dense(hidden_states, self.v_proj, self.dtype).reshape(B, S, H, D)
        q_len = S - q_offset

        def core(rng):
            # The keep-mask is drawn here, outside the kernel, as the JAX model draws it.
            keep = None
            if generator_of(rng) is not None and self.attention_dropout > 0.0:
                keep = keep_mask((B, q_len, S, H), 1.0 - self.attention_dropout, rng, query.device)
            return dep_graph_attention(
                query, key, value, q_offset=q_offset, window=self.window_size, dropout_mask=keep,
                dropout_rate=self.attention_dropout,
            )  # fmt: skip

        out = attend(dropout_rng, core)
        return dropout(dense(out.reshape(B, q_len, E), self.out_proj, self.dtype), self.resid_dropout, dropout_rng)


class InnerAttention(nn.Module):
    """LayerNorm + attention (flax paths ``attn/layer_norm``, ``attn/attention``).

    ``is_seq`` picks the sequence layer types and window, else the dep-graph ones.
    """

    def __init__(self, config: StructuredTransformerConfig, layer_id: int, is_seq: bool = True):
        super().__init__()
        layers = config.seq_attention_layers if is_seq else config.dep_graph_attention_layers
        attention_type = layers[layer_id]
        if attention_type not in ("global", "local"):
            raise ValueError(f"Only attn layer types 'global' and 'local' exist, got {attention_type}")
        window = None
        if attention_type == "local":
            window = config.seq_window_size if is_seq else config.dep_graph_window_size
        self.layer_norm = LayerNorm(config.hidden_size, config.layer_norm_epsilon, config.compute_dtype)
        self.attention = InnerSelfAttention(config, window, is_dep_graph=not is_seq)

    def forward(self, hidden_states, **kwargs):
        return self.attention(self.layer_norm(hidden_states), **kwargs)


class InnerMLP(nn.Module):
    """Feed-forward block: ``c_fc`` -> activation -> ``c_proj``."""

    def __init__(self, config: StructuredTransformerConfig):
        super().__init__()
        inner = config.intermediate_size if config.intermediate_size is not None else 4 * config.hidden_size
        self.c_fc = nn.Linear(config.hidden_size, inner)
        self.c_proj = nn.Linear(inner, config.hidden_size)
        self.act = activation(config.activation_function)
        self.dtype = config.compute_dtype
        self.resid_dropout = float(config.resid_dropout)

    def forward(self, x, dropout_rng=None):
        h = dense(self.act(dense(x, self.c_fc, self.dtype)), self.c_proj, self.dtype)
        return dropout(h, self.resid_dropout, dropout_rng)


class InnerBlock(nn.Module):
    """Pre-LN attention + MLP residual block."""

    def __init__(self, config: StructuredTransformerConfig, layer_id: int, is_seq: bool = True):
        super().__init__()
        self.attn = InnerAttention(config, layer_id, is_seq)
        self.layer_norm = LayerNorm(config.hidden_size, config.layer_norm_epsilon, config.compute_dtype)
        self.mlp = InnerMLP(config)

    def forward(
        self,
        hidden_states,
        attention_mask=None,
        layer_past=None,
        use_cache=False,
        segment_ids=None,
        dropout_rng=None,
        static_kv_first: bool = False,
    ):
        attn_output, present = self.attn(
            hidden_states,
            attention_mask=attention_mask,
            layer_past=layer_past,
            use_cache=use_cache,
            segment_ids=segment_ids,
            dropout_rng=dropout_rng,
            static_kv_first=static_kv_first,
        )
        hidden_states = attn_output + (hidden_states[:, 1:] if static_kv_first else hidden_states)
        hidden_states = hidden_states + self.mlp(self.layer_norm(hidden_states), dropout_rng)
        return hidden_states, present


class ConditionallyIndependentPointProcessInputLayer(nn.Module):
    """Data embedding + temporal encoding for CI models."""

    def __init__(self, config: StructuredTransformerConfig):
        super().__init__()
        self.hidden_size = config.hidden_size
        self.compute_dtype = config.compute_dtype
        self.input_dropout = float(config.input_dropout)
        self.data_embedding_layer = DataEmbeddingLayer(
            n_total_embeddings=max(config.vocab_size, 1),
            out_dim=config.hidden_size,
            categorical_embedding_dim=config.categorical_embedding_dim,
            numerical_embedding_dim=config.numerical_embedding_dim,
            static_embedding_mode=config.static_embedding_mode,
            do_normalize_by_measurement_index=config.do_normalize_by_measurement_index,
            static_weight=config.static_embedding_weight,
            dynamic_weight=config.dynamic_embedding_weight,
            categorical_weight=config.categorical_embedding_weight,
            numerical_weight=config.numerical_embedding_weight,
            compute_dtype=config.compute_dtype,
        )

    def forward(self, batch: EventStreamBatch, dropout_rng=None) -> torch.Tensor:
        data_embed = self.data_embedding_layer(batch)
        t = batch.time if batch.time is not None else time_from_deltas(batch)
        # Sinusoids in fp32; the sum drops to the compute dtype afterwards.
        embed = (data_embed + temporal_position_encoding(t, self.hidden_size)).to(self.compute_dtype)
        embed = torch.where(batch.event_mask[..., None], embed, 0.0)
        return dropout(embed, self.input_dropout, dropout_rng)


@dataclasses.dataclass
class TransformerOutputWithPast:
    last_hidden_state: torch.Tensor
    past_key_values: Optional[tuple] = None
    # An NA forward's per-layer contextualized events ``(B, L, hidden)``
    # (``return_contextualized``: the speculative verify's history heads).
    contextualized: Optional[tuple] = None


def scan_period(config: StructuredTransformerConfig) -> tuple[int, int]:
    """``(period, n_groups)`` of the attention-type pattern under scan (JAX's
    `scan_period`): the smallest ``p`` dividing ``num_hidden_layers`` such
    that every attention-type list (``seq_attention_layers`` and, for NA
    models, ``dep_graph_attention_layers``) is ``p``-periodic; JAX's scanned
    tree stacks layer ``g * p + j`` as group ``g`` of ``h_scan/b{j}``.

    Examples:
        >>> scan_period(StructuredTransformerConfig(num_hidden_layers=4, seq_attention_types=["local", "global"]))
        (2, 2)
        >>> scan_period(StructuredTransformerConfig(num_hidden_layers=3, seq_attention_types=["global"]))
        (1, 3)
    """
    L = config.num_hidden_layers
    lists = [config.seq_attention_layers]
    if getattr(config, "dep_graph_attention_layers", None) is not None:
        lists.append(config.dep_graph_attention_layers)
    for p in range(1, L + 1):
        if L % p != 0:
            continue
        if all(lst[i] == lst[i % p] for lst in lists for i in range(L)):
            return p, L // p
    return L, 1


class ConditionallyIndependentPointProcessTransformer(nn.Module):
    """Stack of `InnerBlock`s over whole-event embeddings (flax names
    ``h{i}``), each under ``config.gradient_checkpointing`` (`models.remat`)."""

    def __init__(self, config: StructuredTransformerConfig):
        super().__init__()
        self.config = config
        self.input_layer = ConditionallyIndependentPointProcessInputLayer(config)
        self.layer_names = [f"h{i}" for i in range(config.num_hidden_layers)]
        for i, name in enumerate(self.layer_names):
            setattr(self, name, InnerBlock(config, i))
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon, config.compute_dtype)

    def blocks(self) -> list[InnerBlock]:
        return [getattr(self, n) for n in self.layer_names]

    def forward(self, batch: EventStreamBatch, past=None, use_cache=False, dropout=None) -> TransformerOutputWithPast:
        """``dropout``: a ``torch.Generator`` on the batch's device turns
        dropout on; None (the default) is deterministic."""
        hidden_states = self.input_layer(batch, dropout)
        presents = [] if use_cache else None
        policy = "none" if use_cache or past is not None else self.config.gradient_checkpointing
        for i, block in enumerate(self.blocks()):
            hidden_states, present = remat_block(
                policy,
                block,
                hidden_states,
                attention_mask=batch.event_mask,
                layer_past=past[i] if past is not None else None,
                use_cache=use_cache,
                segment_ids=batch.segment_ids,
                dropout_rng=dropout,
            )
            # Zero masked events' hidden states between layers (JAX parity).
            hidden_states = torch.where(batch.event_mask[..., None], hidden_states, 0.0)
            if use_cache:
                presents.append(present)
        return TransformerOutputWithPast(
            last_hidden_state=self.ln_f(hidden_states),
            past_key_values=tuple(presents) if use_cache else None,
        )


@dataclasses.dataclass
class NAPast:
    """The two-level NA cache: per-layer sequence caches and per-layer dep-graph caches."""

    seq_past: Optional[tuple] = None
    dep_graph_past: Optional[tuple] = None


class StructuredTransformerBlock(nn.Module):
    """One nested-attention layer: a sequence module and a dep-graph module
    under `StructuredAttention` (flax path ``h{i}/block``), each a full
    `InnerBlock` or a bare `InnerAttention` per
    ``do_full_block_in_{seq,dep_graph}_attention``."""

    def __init__(self, config: StructuredTransformerConfig, layer_id: int):
        super().__init__()
        if config.do_full_block_in_seq_attention:
            seq = ("seq_block", InnerBlock(config, layer_id, is_seq=True))
        else:
            seq = ("seq_attn", InnerAttention(config, layer_id, is_seq=True))
        if config.do_full_block_in_dep_graph_attention:
            dep = ("dep_graph_block", InnerBlock(config, layer_id, is_seq=False))
        else:
            dep = ("dep_graph_attn", InnerAttention(config, layer_id, is_seq=False))
        self.block = StructuredAttention(seq, dep)

    def forward(self, hidden_states, **kwargs):
        return self.block(hidden_states, **kwargs)


def dep_graph_split(config: StructuredTransformerConfig) -> tuple:
    """``measurements_per_dep_graph_level`` as measurement indices (and modes)."""
    levels = []
    for measurement_list in config.measurements_per_dep_graph_level:
        out = []
        for m in measurement_list:
            if isinstance(m, str):
                out.append(config.measurements_idxmap[m])
            elif isinstance(m, (tuple, list)) and len(m) == 2:
                out.append((config.measurements_idxmap[m[0]], m[1]))
            else:
                raise ValueError(f"Unexpected measurement {type(m)}: {m}\n{config.measurements_per_dep_graph_level}")
        levels.append(tuple(out))
    return tuple(levels)


def na_level_of_measurement(config: StructuredTransformerConfig) -> torch.Tensor:
    """The measurement-index -> dep-graph-level table, ``int32`` (JAX's
    `na_level_of_measurement`): unlisted measurements (functors, the padding
    index 0) map to level 0. The one level map of every partial-content
    consumer: the input layer's ``partial_content_levels``, the speculative
    engine's strip of a correction event's rejected levels and its draft's
    teacher-forced walk replays. Split-mode entries raise JAX's error."""
    lvl = torch.zeros(max(config.measurements_idxmap.values()) + 1, dtype=torch.int32)
    for level, meas_list in enumerate(config.measurements_per_dep_graph_level):
        for m in meas_list:
            if isinstance(m, (tuple, list)):
                raise ValueError(
                    "split-mode (CATEGORICAL_ONLY/NUMERICAL_ONLY) dep-graph levels are not supported by per-level "
                    f"content masking (speculative decoding) yet; got {m!r}"
                )
            lvl[config.measurements_idxmap[m]] = level
    return lvl


def mask_batch_to_levels(batch: EventStreamBatch, level_of_meas: torch.Tensor, level) -> EventStreamBatch:
    """The batch with the dynamic tokens of dep-graph levels above ``level``
    masked away (index, measurement and value 0, value mask off): the zero
    padding an event carries before its walk writes those levels (JAX's
    `mask_batch_to_levels`). ``level`` is an int or a per-row ``(B,)`` tensor."""
    lvl = level_of_meas[batch.dynamic_measurement_indices.long()]
    if torch.is_tensor(level):
        level = level.reshape(level.shape + (1,) * (lvl.ndim - level.ndim))
    keep = lvl <= level
    return batch.replace(
        dynamic_indices=torch.where(keep, batch.dynamic_indices, 0),
        dynamic_measurement_indices=torch.where(keep, batch.dynamic_measurement_indices, 0),
        dynamic_values=torch.where(keep, batch.dynamic_values, 0.0),
        dynamic_values_mask=batch.dynamic_values_mask & keep,
    )


class NestedAttentionPointProcessInputLayer(nn.Module):
    """Dep-graph-split input embeddings ``(B, L, G, hidden)`` for NA models.

    The time embedding joins graph slot 0 and a cumsum over the graph axis
    makes the last slot a whole-event summary, both in fp32, then the cast
    to the compute dtype, the event-mask zeroing and the input dropout.

    ``partial_content_levels`` (the speculative verify window, JAX's flag)
    builds slot ``l`` from the event with the tokens of levels above ``l``
    masked away, one embedding pass a level: in joint embedding mode every
    slot sums all the event's tokens, and the cached walk wrote slot ``l``'s
    key and value when the event held levels ``<= l`` only.
    """

    def __init__(self, config: StructuredTransformerConfig):
        super().__init__()
        self.hidden_size = config.hidden_size
        self.compute_dtype = config.compute_dtype
        self.input_dropout = float(config.input_dropout)
        self.data_embedding_layer = DataEmbeddingLayer(
            n_total_embeddings=max(config.vocab_size, 1),
            out_dim=config.hidden_size,
            categorical_embedding_dim=config.categorical_embedding_dim,
            numerical_embedding_dim=config.numerical_embedding_dim,
            static_embedding_mode=config.static_embedding_mode,
            split_by_measurement_indices=dep_graph_split(config),
            do_normalize_by_measurement_index=config.do_normalize_by_measurement_index,
            static_weight=config.static_embedding_weight,
            dynamic_weight=config.dynamic_embedding_weight,
            categorical_weight=config.categorical_embedding_weight,
            numerical_weight=config.numerical_embedding_weight,
            compute_dtype=config.compute_dtype,
        )
        self.config = config
        self._level_maps: dict = {}  # device -> `na_level_of_measurement` there, built at first use

    def level_of_measurement(self, device) -> torch.Tensor:
        """`na_level_of_measurement` on ``device``, built once (a captured
        program reads the copy its eager warm-up built)."""
        device = torch.device(device)
        if device not in self._level_maps:
            self._level_maps[device] = na_level_of_measurement(self.config).to(device)
        return self._level_maps[device]

    def forward(
        self, batch: EventStreamBatch, dropout_rng=None, dep_graph_el_generation_target=None,
        partial_content_levels: bool = False,
    ) -> torch.Tensor:  # fmt: skip
        """``dep_graph_el_generation_target`` (the cached walk) keeps only graph
        element ``target - 1``: the last, whole-event element at target 0."""
        t = batch.time if batch.time is not None else time_from_deltas(batch)
        time_embed = temporal_position_encoding(t, self.hidden_size)

        def slots_from(b: EventStreamBatch) -> torch.Tensor:
            e = self.data_embedding_layer(b).float()
            e = torch.cat([(e[:, :, 0] + time_embed)[:, :, None], e[:, :, 1:]], dim=2)
            return torch.cumsum(e, dim=2).to(self.compute_dtype)

        if partial_content_levels:
            lvl = self.level_of_measurement(batch.event_mask.device)
            G = len(self.config.measurements_per_dep_graph_level)
            embed = torch.stack([slots_from(mask_batch_to_levels(batch, lvl, level))[:, :, level]
                                 for level in range(G)], dim=2)  # fmt: skip
        else:
            embed = slots_from(batch)
        if dep_graph_el_generation_target is not None:
            embed = embed[:, :, dep_graph_el_generation_target - 1][:, :, None]
        embed = torch.where(batch.event_mask[:, :, None, None], embed, 0.0)
        return dropout(embed, self.input_dropout, dropout_rng)


class NestedAttentionPointProcessTransformer(nn.Module):
    """NA encoder: `StructuredTransformerBlock`s ``h{i}`` over the graph
    embeddings, then ``ln_f``, with the JAX encoder's three-way cache state
    machine. ``dep_graph_el_generation_target`` picks the mode: ``None`` is
    the full forward (with ``use_cache``, the prefix: both cache levels
    written, the dep-graph caches then reset); ``0`` contextualizes the
    just-completed event through the sequence caches and resets the
    dep-graph caches; ``> 0`` decodes one graph element against the
    dep-graph caches, the sequence module skipped.

    The reset leaves each layer a dep-graph cache of
    ``len(measurements_per_dep_graph_level) + 1`` positions (the history
    slot and every element decoded before the next reset) holding, at
    position 0, the key and value of the last written position of each
    row's last event, with length 1 (a python int, as the cursor of a cache
    whose writes are known when the walk is built).
    """

    def __init__(self, config: StructuredTransformerConfig):
        super().__init__()
        self.config = config
        self.input_layer = NestedAttentionPointProcessInputLayer(config)
        self.layer_names = [f"h{i}" for i in range(config.num_hidden_layers)]
        for i, name in enumerate(self.layer_names):
            setattr(self, name, StructuredTransformerBlock(config, i))
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon, config.compute_dtype)

    def forward(
        self,
        batch: EventStreamBatch,
        past: Optional[NAPast] = None,
        use_cache=False,
        dropout=None,
        dep_graph_el_generation_target: int | None = None,
        last_event_index=None,
        partial_content_levels: bool = False,
        history_head: tuple | None = None,
        return_contextualized: bool = False,
    ) -> TransformerOutputWithPast:
        """``dropout``: a ``torch.Generator`` on the batch's device turns dropout
        on. ``past`` is an `NAPast`; with ``use_cache`` the output's
        ``past_key_values`` is the next one. ``last_event_index`` (``(B,)``,
        the serving engine's bucket-padded prefill) seeds each row's reset
        dep-graph history from its event at that index, not from the last
        position of the (padded) input. The speculative verify's plumbing, as
        in JAX: ``partial_content_levels`` (the input layer's),
        ``history_head`` (one ``(B, hidden)`` history a layer for the first
        event) and ``return_contextualized`` (each layer's contextualized
        events on the output); they need the unrolled stack, and a
        ``scan_layers`` model refuses them with JAX's words. Each block runs
        under ``config.gradient_checkpointing`` (`models.remat`)."""
        if (history_head is not None or return_contextualized) and self.config.scan_layers:
            raise NotImplementedError(
                "history_head / return_contextualized (the speculative-decoding verify plumbing) require the "
                "unrolled layer stack; migrate the checkpoint with unstack_layer_params"
            )
        if batch.segment_ids is not None and (use_cache or past is not None):
            raise NotImplementedError(
                "Packed (segment_ids) batches do not support KV-cached NA decoding; train/eval forwards handle "
                "packing (segment-aware seq attention + history), generation requires padded batches."
            )
        target = dep_graph_el_generation_target
        update_seq = update_dep = reset_dep = False
        prepend, update_last = True, True
        if use_cache:
            if target is None:
                if past is not None and past.dep_graph_past is not None:
                    raise ValueError(f"dep_graph_past should be None if gen target is None; got {past.dep_graph_past}")
                update_seq = update_dep = reset_dep = True
            elif target == 0:
                update_seq = update_dep = reset_dep = True
                prepend = False
            elif target > 0:
                if past is None or past.dep_graph_past is None:
                    raise ValueError(f"dep_graph_past should not be None if dep_graph_el_generation_target is {target}.")
                update_dep = True
                prepend = update_last = False
            else:
                raise ValueError(
                    f"While use_cache=True, dep_graph generation target must be a non-negative int; got {target}."
                )
        seq_past = past.seq_past if past is not None else None
        dep_past = past.dep_graph_past if past is not None else None

        hidden_states = self.input_layer(batch, dropout, dep_graph_el_generation_target=target,
                                         partial_content_levels=partial_content_levels)  # fmt: skip
        B, L = hidden_states.shape[:2]
        presents_seq, presents_dep, contextualized = [], [], []
        policy = "none" if use_cache or past is not None else self.config.gradient_checkpointing
        for i, name in enumerate(self.layer_names):
            hidden_states, seq_present, dep_present, ctx = remat_block(
                policy,
                getattr(self, name),
                hidden_states,
                history_head=None if history_head is None else history_head[i],
                seq_attention_mask=batch.event_mask,
                event_mask=batch.event_mask,
                segment_ids=batch.segment_ids,
                dropout_rng=dropout,
                prepend_graph_with_history_embeddings=prepend,
                update_last_graph_el_to_history_embedding=update_last,
                seq_module_kwargs=dict(layer_past=None if seq_past is None else seq_past[i], use_cache=update_seq),
                dep_graph_module_kwargs=dict(layer_past=None if dep_past is None else dep_past[i], use_cache=update_dep),
            )
            presents_seq.append(seq_present)
            presents_dep.append(dep_present)
            contextualized.append(ctx)
        hidden_states = self.ln_f(hidden_states)
        contextualized = tuple(contextualized) if return_contextualized else None
        if not use_cache:
            return TransformerOutputWithPast(last_hidden_state=hidden_states, contextualized=contextualized)
        if not update_seq:
            presents_seq = list(seq_past) if seq_past is not None else None
        if reset_dep:
            G = len(self.config.measurements_per_dep_graph_level) + 1
            presents_dep = [_reset_dep_graph_cache(kv, B, L, G, last_event_index) for kv in presents_dep]
        return TransformerOutputWithPast(
            last_hidden_state=hidden_states,
            past_key_values=NAPast(
                seq_past=tuple(presents_seq) if presents_seq is not None else None, dep_graph_past=tuple(presents_dep)
            ),
            contextualized=contextualized,
        )


def _reset_dep_graph_cache(kv: KVCache, B: int, L: int, max_dep_len: int, last_event_index=None) -> KVCache:
    """A fresh ``max_dep_len``-position dep-graph cache holding, at position 0,
    ``kv``'s last written position (``length - 1``) of each row's last event,
    or of its event ``last_event_index[b]`` when given (JAX's reset,
    ``transformer.py:1882-1936``)."""
    last = int(kv.length) - 1

    def last_el(x):  # (B * L, H, S, D) -> (B, H, max_dep_len, D)
        x_last = x[:, :, last].reshape(B, L, x.shape[1], x.shape[3])
        x_last = x_last[:, -1] if last_event_index is None else take_event(x_last, last_event_index)
        pad = x_last.new_zeros(B, x_last.shape[1], max_dep_len - 1, x_last.shape[2])
        return torch.cat([x_last[:, :, None], pad], dim=2)

    mask = (torch.arange(max_dep_len, device=kv.mask.device) == 0).expand(B, max_dep_len).contiguous()
    return KVCache(key=last_el(kv.key), value=last_el(kv.value), mask=mask, length=1)
