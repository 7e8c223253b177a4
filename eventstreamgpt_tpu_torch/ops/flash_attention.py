"""Causal, segment-masked, optionally windowed attention, forward and backward (kernels E and F).

Replaces the two library TPU kernels that the JAX model calls under
``attention_implementation="pallas_flash"``:

* E, ``eventstreamgpt_tpu/models/transformer.py:864``: JAX's Pallas
  ``flash_attention`` (global layers);
* F, ``eventstreamgpt_tpu/models/transformer.py:900-912``: JAX's Pallas
  ``splash_attention`` with ``LocalMask((S, S), (W - 1, 0))`` (local layers
  whose window is above 128 or does not divide ``S``).

Their contract, on heads-first ``(B, H, S, D)`` tensors: causal; a key is seen
only within its query's segment (padding rides as segment ``-1``); with a
``window``, only keys ``k > q - window``; logits unscaled (``sm_scale = 1``)
in fp32; fp32 softmax statistics; the output in the value's dtype. The CUDA
source, its design and its bounds are in ``csrc/flash_attention.cu``.

`flash_attention` runs `flash_attention_reference` (the plain PyTorch
version, differentiated by autograd) on CPU tensors and, on CUDA tensors, an
autograd function whose forward saves the output and every row's fp32
softmax statistics (its running max ``m`` and normaliser ``l``, the
residuals the TPU kernel saves) and whose backward launches the dq kernel,
which also writes ``di = sum(o * do)`` in fp32, then the dk/dv kernel. On
CUDA, bf16 q, k and v need 16-byte aligned rows. `tile_schedule` is the
plain version of the (query tile, key tile) pairs the kernels visit;
`tiles_walked` reads how many tiles the kernels walked, counted on the card. Each
direction counts its launches on its own entry point, the windowed calls
apart: `flash_attention_fwd`, `flash_attention_bwd` (E) and
`flash_attention_window_fwd`, `flash_attention_window_bwd` (F); one backward
launch is the two backward kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

__all__ = [
    "causal_tiles",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_fwd",
    "flash_attention_reference",
    "flash_attention_window_bwd",
    "flash_attention_window_fwd",
    "tile_schedule",
    "tiles_walked",
]

SOURCE = "flash_attention.cu"
DTYPES = {torch.bfloat16: 1, torch.float32: 0}
HEAD_DIMS = (32, 64, 128)  # the kernel's template instances
TILE = 64  # queries and keys per tile: S must be a multiple
MAX_TILES = 65535  # tiles of a row: the grid's y dimension
ALIGN = 16  # bytes: the kernels load rows in 16-byte pieces
F32_MIN = torch.finfo(torch.float32).min


def attention_mask(segment_ids: torch.Tensor, window: int | None = None) -> torch.Tensor:
    """The ``(B, 1, S, S)`` mask: key ``k`` is visible to query ``q`` when
    ``k <= q``, both lie in one segment, and ``k > q - window``.

    Examples:
        >>> attention_mask(torch.tensor([[0, 0, 1, -1]]))[0, 0].int()
        tensor([[1, 0, 0, 0],
                [1, 1, 0, 0],
                [0, 0, 1, 0],
                [0, 0, 0, 1]], dtype=torch.int32)
        >>> attention_mask(torch.zeros(1, 4, dtype=torch.int32), window=2)[0, 0].int()
        tensor([[1, 0, 0, 0],
                [1, 1, 0, 0],
                [0, 1, 1, 0],
                [0, 0, 1, 1]], dtype=torch.int32)
    """
    S = segment_ids.shape[-1]
    pos = torch.arange(S, device=segment_ids.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    return mask[None, None] & (segment_ids[:, None, :, None] == segment_ids[:, None, None, :])


def tile_schedule(segment_ids: torch.Tensor, window: int | None = None, tile: int = TILE) -> torch.Tensor:
    """The ``(B, S/tile, S/tile)`` (query tile, key tile) pairs the kernels visit.

    A pair inside the causal (and window) range is visited when the intervals
    ``[min, max]`` of the two tiles' real segment ids (``>= 0``) meet, or when
    both tiles hold padding (a negative id). Disjoint intervals share no id, so
    every allowed pair of `attention_mask` lies in a visited tile, whatever the
    ids; the schedule is tight when real ids do not decrease along a row. The
    kernels compute the same predicate themselves.

    Examples:
        >>> tile_schedule(torch.tensor([[0, 0, 1, 1, 2, 2, -1, -1]]), tile=2)[0].int()
        tensor([[1, 0, 0, 0],
                [0, 1, 0, 0],
                [0, 0, 1, 0],
                [0, 0, 0, 1]], dtype=torch.int32)
    """
    B, S = segment_ids.shape
    n = S // tile
    ids = segment_ids.reshape(B, n, tile).long()
    real = ids >= 0
    lo = torch.where(real, ids, torch.iinfo(torch.int64).max).amin(-1)
    hi = torch.where(real, ids, torch.iinfo(torch.int64).min).amax(-1)
    pad = (~real).any(-1)
    meet = torch.maximum(lo[:, :, None], lo[:, None, :]) <= torch.minimum(hi[:, :, None], hi[:, None, :])
    visit = meet | (pad[:, :, None] & pad[:, None, :])
    return visit & causal_tiles(n, window, tile, segment_ids.device)[None]


def causal_tiles(n: int, window: int | None = None, tile: int = TILE, device=None) -> torch.Tensor:
    """The ``(n, n)`` (query tile, key tile) pairs inside the causal (and
    window) range: ``kt <= qt`` and some key of ``kt`` within the window of
    some query of ``qt``.

    Examples:
        >>> causal_tiles(3, window=60, tile=64).int()
        tensor([[1, 0, 0],
                [1, 1, 0],
                [0, 1, 1]], dtype=torch.int32)
    """
    qt = torch.arange(n, device=device)[:, None]
    kt = torch.arange(n, device=device)[None, :]
    in_range = kt <= qt
    if window is not None:
        in_range = in_range & (kt * tile + tile - 1 > qt * tile - window)
    return in_range


def flash_attention_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    segment_ids: torch.Tensor,
    window: int | None = None,
) -> torch.Tensor:
    """The plain PyTorch version: the full ``(S, S)`` mask, fp32 logits and
    softmax, and the probabilities rounded to the value dtype before the
    ``p @ v`` product, as the einsum path rounds them."""
    logits = torch.matmul(query.float(), key.float().transpose(-1, -2))
    logits = torch.where(attention_mask(segment_ids, window), logits, F32_MIN)
    return torch.matmul(torch.softmax(logits, dim=-1).to(value.dtype), value)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the signatures of the C entry points of a build of ``csrc/flash_attention.cu``; returns ``lib``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    shape = [ptr, i32, i32, i32, i32, i32, ptr]  # strides, B, H, S, D, window, stream
    lib.esgpt_flash_fwd.argtypes = [i32] + [ptr] * 6 + shape
    lib.esgpt_flash_bwd.argtypes = [i32] + [ptr] * 11 + shape
    lib.esgpt_flash_tiles.argtypes = [ptr]
    entries = [lib.esgpt_flash_fwd, lib.esgpt_flash_bwd, lib.esgpt_flash_tiles]
    if hasattr(lib, "esgpt_flash_trace"):  # built with -DESGPT_FLASH_TRACE
        lib.esgpt_flash_trace.argtypes = [ptr]
        entries.append(lib.esgpt_flash_trace)
    for fn in entries:
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _kernels() -> ctypes.CDLL:
    """The source's library, built and loaded once, with its signatures set once."""
    return bind(load_library(SOURCE))


def tiles_walked(lib: ctypes.CDLL | None = None) -> dict[str, int]:
    """The tiles the kernels' blocks walked since the last call, read from
    the card after every launch before it, then zeroed: ``fwd``, ``dq`` and
    ``dkv`` (kernels E and F, both types). Each equals ``H`` times
    ``tile_schedule(...).sum()`` summed over the launches. It synchronises
    the device: never call it inside a captured region."""
    counts = (ctypes.c_uint64 * 3)()
    torch.cuda.synchronize()  # launches on any stream
    err = (lib or _kernels()).esgpt_flash_tiles(counts)
    if err != 0:
        raise RuntimeError(f"reading the flash attention tile counts failed: CUDA error {err}")
    return dict(zip(("fwd", "dq", "dkv"), (int(c) for c in counts)))


def _checked(query, key, value, segment_ids, window, what):
    """Raises on what the kernels do not take; returns ``(B, H, S, D)`` and
    the segment ids as contiguous int32."""
    B, H, S, D = query.shape
    dev = query.device
    if dev.type != "cuda" or key.device != dev or value.device != dev or segment_ids.device != dev:
        raise ValueError(f"{what} takes CUDA tensors on one device, got {dev}, {key.device}, {value.device}, "
                         f"{segment_ids.device}")  # fmt: skip
    if query.dtype not in DTYPES or key.dtype != query.dtype or value.dtype != query.dtype:
        raise ValueError(
            f"{what} takes bf16 or fp32 q, k, v of one dtype, got {query.dtype}, {key.dtype}, {value.dtype}"
        )
    if key.shape != query.shape or value.shape != query.shape or segment_ids.shape != (B, S):
        raise ValueError(f"{what}: q {tuple(query.shape)}, k {tuple(key.shape)}, v {tuple(value.shape)}, "
                         f"segment ids {tuple(segment_ids.shape)} do not fit")  # fmt: skip
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} is not one of the kernel's {HEAD_DIMS}")
    if S % TILE:
        raise ValueError(f"{what}: the sequence length {S} is not a multiple of the kernel's tile {TILE}")
    if S // TILE > MAX_TILES:
        raise ValueError(f"{what}: the sequence length {S} exceeds the kernel's grid of {MAX_TILES} tiles")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} must be None or >= 1")
    if any(t.stride(3) != 1 for t in (query, key, value)):
        raise ValueError(f"{what}: the head_dim axis of q, k and v must be contiguous")
    if not all(_rows_aligned(t) for t in (query, key, value)):
        raise ValueError(
            f"{what}: bf16 q, k and v need 16-byte aligned rows: a 16-byte aligned base pointer and (b, h, s) "
            f"strides in multiples of {ALIGN // query.element_size()} elements"
        )
    if segment_ids.dtype.is_floating_point or segment_ids.dtype == torch.bool:
        raise ValueError(f"{what}: segment ids must be integers, got {segment_ids.dtype}")
    return (B, H, S, D), _aligned(segment_ids.to(torch.int32))


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t``'s ``(B, H, S, D)`` rows: any fp32
    rows (the fp32 kernels read one element at a time); bf16 rows that start
    on 16 bytes, as the bf16 kernels' 16-byte loads need."""
    if t.dtype != torch.bfloat16:
        return True
    step = ALIGN // t.element_size()
    return t.data_ptr() % ALIGN == 0 and all(t.stride(i) % step == 0 for i in range(3) if t.shape[i] > 1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % ALIGN == 0 else t.clone()


def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its ``D`` axis is contiguous and its rows 16-byte aligned, else an aligned copy."""
    return t if t.stride(3) == 1 and _rows_aligned(t) else _aligned(t)


def _strides(*tensors) -> torch.Tensor:
    """The ``(b, h, s)`` element strides of each ``(B, H, S, D)`` tensor, as
    an int64 host array (kept alive by the caller). The C launcher reads it
    on the host into the kernel's arguments before it returns, so a launch
    captured into a CUDA graph carries the values and nothing is copied to
    the device."""
    return torch.tensor([t.stride()[i] for t in tensors for i in range(3)], dtype=torch.int64)


def _heads_first_like(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``(B, H, S, D)`` tensor laid out as ``(B, S, H, D)``:
    the layout the model merges heads from without a copy."""
    B, H, S, D = x.shape
    return torch.empty((B, S, H, D), dtype=x.dtype, device=x.device).transpose(1, 2)


def _fwd(query, key, value, segment_ids, window, what, lib=None):
    (B, H, S, D), seg = _checked(query, key, value, segment_ids, window, what)
    out = _heads_first_like(value)
    stats = torch.empty((2, B, H, S), dtype=torch.float32, device=value.device)
    strides = _strides(query, key, value, out)
    err = (lib or _kernels()).esgpt_flash_fwd(
        DTYPES[value.dtype], query.data_ptr(), key.data_ptr(), value.data_ptr(), seg.data_ptr(), out.data_ptr(),
        stats.data_ptr(), strides.data_ptr(), B, H, S, D, window or 0,
        torch.cuda.current_stream(value.device).cuda_stream,
    )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"flash attention forward kernel launch failed: CUDA error {err}")
    return out, stats


def _bwd(query, key, value, segment_ids, out, stats, g, window, what, lib=None):
    (B, H, S, D), seg = _checked(query, key, value, segment_ids, window, what)
    if g.shape != out.shape or g.device != out.device or stats.shape != (2, B, H, S):
        raise ValueError(f"{what}: the cotangent {tuple(g.shape)} or statistics {tuple(stats.shape)} do not fit")
    # The kernels read the output (for di = sum(o * do)) and the cotangent by stride, as q, k and v.
    out, g = _aligned_rows(out.to(value.dtype)), _aligned_rows(g.to(value.dtype))
    stats = _aligned(stats)
    # Scratch the dq kernel writes and the dk/dv kernel reads: di, m log2(e) and 1 / l of every row.
    rows = torch.empty((3, B, H, S), dtype=torch.float32, device=value.device)
    dq, dk, dv = _heads_first_like(query), _heads_first_like(key), _heads_first_like(value)
    strides = _strides(query, key, value, out, g, dq, dk, dv)
    err = (lib or _kernels()).esgpt_flash_bwd(
        DTYPES[value.dtype], *(t.data_ptr() for t in (query, key, value, seg, out, g, stats, rows, dq, dk, dv)),
        strides.data_ptr(), B, H, S, D, window or 0, torch.cuda.current_stream(value.device).cuda_stream,
    )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: CUDA error {err}")
    return dq, dk, dv


def flash_attention_fwd(query, key, value, segment_ids):
    """Kernel E's forward on CUDA tensors: ``(out, stats)``, the output in the
    value dtype and the fp32 ``(2, B, H, S)`` statistics ``m`` and ``l`` of every row."""
    res = _fwd(query, key, value, segment_ids, None, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return res


def flash_attention_bwd(query, key, value, segment_ids, out, stats, g):
    """Kernel E's backward on CUDA tensors: ``(dq, dk, dv)`` from the output,
    its statistics and its cotangent ``g`` (cast to the value dtype)."""
    res = _bwd(query, key, value, segment_ids, out, stats, g, None, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return res


def flash_attention_window_fwd(query, key, value, segment_ids, window: int):
    """Kernel F's forward: `flash_attention_fwd` with a sliding window."""
    res = _fwd(query, key, value, segment_ids, int(window), "flash_attention_window_fwd")
    flash_attention_window_fwd.launches += 1
    return res


def flash_attention_window_bwd(query, key, value, segment_ids, out, stats, g, window: int):
    """Kernel F's backward: `flash_attention_bwd` with a sliding window."""
    res = _bwd(query, key, value, segment_ids, out, stats, g, int(window), "flash_attention_window_bwd")
    flash_attention_window_bwd.launches += 1
    return res


for _fn in (flash_attention_fwd, flash_attention_bwd, flash_attention_window_fwd, flash_attention_window_bwd):
    _fn.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query, key, value, segment_ids, window):
        if window is None:
            out, stats = flash_attention_fwd(query, key, value, segment_ids)
        else:
            out, stats = flash_attention_window_fwd(query, key, value, segment_ids, window)
        ctx.save_for_backward(query, key, value, segment_ids, out, stats)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, g):
        query, key, value, segment_ids, out, stats = ctx.saved_tensors
        if ctx.window is None:
            dq, dk, dv = flash_attention_bwd(query, key, value, segment_ids, out, stats, g)
        else:
            dq, dk, dv = flash_attention_window_bwd(query, key, value, segment_ids, out, stats, g, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    segment_ids: torch.Tensor,
    window: int | None = None,
) -> torch.Tensor:
    """Causal attention within packed segments, optionally windowed.

    Args:
        query, key, value: ``(B, H, S, D)``; on CUDA the ``D`` axis must be
            contiguous (the model's ``(B, S, H, D)`` projections viewed
            heads-first are read as they are), ``D`` 32 or 64 and ``S`` a
            multiple of 64.
        segment_ids: ``(B, S)`` integers; a query sees keys of its own
            segment only (padding as ``-1``).
        window: only keys ``k > q - window`` are seen (``None``: all up to ``q``).

    Returns:
        ``(B, H, S, D)`` in the value dtype.
    """
    if query.device.type == "cpu":
        return flash_attention_reference(query, key, value, segment_ids, window)
    if query.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {query.device}")
    return _FlashAttention.apply(query, key, value, segment_ids, window)
