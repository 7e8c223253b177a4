"""Quantized KV-cache storage for decode: int8 / fp8 planes plus scale tables.

Counterpart: ``eventstreamgpt_tpu/ops/kv_quant.py``, with the same names and
formulas. Symmetric absmax quantization with one fp32 scale per ``(row,
head, cache position)``, reduced over ``head_dim`` only:

* ``scale = where(amax > 0, amax / qmax, 1.0)`` (``qmax`` 127 for int8, 448
  for ``float8_e4m3fn``), so an all-zero row keeps scale 1 and dequantizes
  to zeros;
* codes are ``x / scale`` (a true division): int8 rounds half to even and
  clips to +-127, fp8 casts to ``torch.float8_e4m3fn``;
* dequantization is ``(q.float() * scale).to(dtype)``.

Keys and values are quantized once, when they are written (at admission and
at the decode cursor), and dequantized where they are read. Prefill runs on
float caches. A slot's cache bytes (`kv_cache_bytes_per_slot`) count the two
planes, their scale tables and the mask byte a position.
"""

from __future__ import annotations

import torch

__all__ = [
    "FP8_DTYPE",
    "CACHE_DTYPES",
    "resolve_cache_dtype",
    "is_quantized_dtype",
    "cache_dtype_name",
    "quantize_kv",
    "dequantize_kv",
    "kv_cache_bytes_per_slot",
    "storage",
]

FP8_DTYPE = torch.float8_e4m3fn
_FP8_MAX = 448.0  # e4m3fn's largest finite value
_INT8_MAX = 127.0

CACHE_DTYPES = ("fp32", "bf16", "int8", "fp8")


def resolve_cache_dtype(name: str | None, compute_dtype: torch.dtype) -> tuple[torch.dtype, bool]:
    """``(buffer dtype, quantized?)`` for a cache-dtype name; ``None`` or
    ``"auto"`` keeps the compute dtype.

    Examples:
        >>> resolve_cache_dtype("bfloat16", torch.float32)
        (torch.bfloat16, False)
        >>> resolve_cache_dtype("int8", torch.bfloat16)
        (torch.int8, True)
    """
    if name in (None, "auto"):
        return compute_dtype, False
    if name in ("fp32", "f32", "float32"):
        return torch.float32, False
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16, False
    if name == "int8":
        return torch.int8, True
    if name == "fp8":
        return FP8_DTYPE, True
    raise ValueError(f"unknown kv_cache_dtype {name!r}; expected one of {CACHE_DTYPES}")


def is_quantized_dtype(dtype: torch.dtype) -> bool:
    return dtype in (torch.int8, FP8_DTYPE)


def cache_dtype_name(dtype: torch.dtype) -> str:
    """The canonical `CACHE_DTYPES` name of a resolved buffer dtype.

    Examples:
        >>> cache_dtype_name(resolve_cache_dtype("float32", torch.bfloat16)[0])
        'fp32'
    """
    names = {torch.int8: "int8", FP8_DTYPE: "fp8", torch.bfloat16: "bf16", torch.float32: "fp32"}
    if dtype not in names:
        raise ValueError(f"no canonical cache-dtype name for {dtype}")
    return names[dtype]


def _qmax(dtype: torch.dtype) -> float:
    return _INT8_MAX if dtype == torch.int8 else _FP8_MAX


def quantize_kv(x: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax quantization over the last (head_dim) axis.

    Returns ``(q, scale)``: ``q`` in ``dtype`` with ``x ~ q * scale[..., None]``,
    ``scale`` fp32 of shape ``x.shape[:-1]``.

    Examples:
        >>> q, s = quantize_kv(torch.tensor([[2.54, -1.0, 0.0], [0.0, 0.0, 0.0]]), torch.int8)
        >>> q.tolist(), s.tolist()
        ([[127, -50, 0], [0, 0, 0]], [0.019999999552965164, 1.0])
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / _qmax(dtype), torch.ones_like(amax))
    scaled = xf / scale[..., None]
    if dtype == torch.int8:
        q = torch.clamp(torch.round(scaled), -_INT8_MAX, _INT8_MAX).to(torch.int8)
    else:
        q = scaled.to(dtype)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``q * scale[..., None]`` in fp32, rounded to ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)


def storage(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the tensor its copies and selects go through: an fp8 plane as
    its bytes (``torch.where`` and indexed writes take no fp8 on every
    backend), any other tensor as it is."""
    return x.view(torch.uint8) if x.dtype == FP8_DTYPE else x


def kv_cache_bytes_per_slot(
    num_layers: int,
    num_heads: int,
    max_len: int,
    head_dim: int,
    cache_dtype: str | None,
    compute_dtype: torch.dtype = torch.float32,
) -> int:
    """Device bytes of the sequence KV cache a decode slot holds at a cache dtype.

    Examples:
        >>> kv_cache_bytes_per_slot(2, 4, 256, 64, "bf16"), kv_cache_bytes_per_slot(2, 4, 256, 64, "int8")
        (524800, 279040)
    """
    dtype, quantized = resolve_cache_dtype(cache_dtype, compute_dtype)
    plane = num_heads * max_len * head_dim * dtype.itemsize
    scales = num_heads * max_len * 4 if quantized else 0
    mask = max_len  # bool
    return num_layers * (2 * plane + 2 * scales + mask)
