"""Fused categorical sampling for the serving engine's decode tail (kernel A).

Replaces the TPU kernel ``eventstreamgpt_tpu/ops/fused_sampling.py::
fused_categorical`` (``_sample_2d`` / ``_sample_kernel``). Per row: mask the
logits by ``keep`` (to the fp32 minimum), ``score = f32(round_to_logits_dtype(
f32(gumbel) + f32(logits)))``, the first index of the maximum (``V`` for a
row holding a NaN score), and ``fill`` for inactive rows. The
add-in-fp32-then-round chain is the JAX contract: it reproduces
``jax.random.categorical``'s bf16 add, and near-tied tokens order
differently without it.

Two entries, one CUDA kernel template (``csrc/fused_sampling.cu``, where its
design and bound are):

* `fused_categorical` takes the Gumbel noise as a tensor, as the JAX kernel
  does; the CPU tests hold it against JAX's ``_sample_2d``.
* `fused_categorical_stream` takes a `generation.sampling.RowStreams` and
  draws the noise inside the kernel, bit for bit ``gumbel(stream,
  logits.shape).to(logits.dtype)``; the stream's draw count advances as one
  ``uniform`` call advances it. The serving engine calls this one: the noise
  never goes through memory and the sampled draw of a categorical head is
  one launch.

On CPU tensors each entry runs its plain version (`fused_categorical_reference`,
after ``gumbel(stream)`` for the stream entry); on CUDA tensors it launches
the kernel or raises. Each counts its launches. `gumbel_noise` (the kernel's
noise alone) and `launch_floor` (an empty kernel) serve the tests and the
measurements.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..distributions import gumbel as stream_gumbel
from .build import load_library

__all__ = [
    "fused_categorical",
    "fused_categorical_reference",
    "fused_categorical_stream",
    "gumbel_noise",
    "launch_floor",
    "topk_topp_mask",
]

F32_MIN = torch.finfo(torch.float32).min
SOURCE = "fused_sampling.cu"
DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def topk_topp_mask(logits: torch.Tensor, top_k: int | None = None, top_p: float | None = None):
    """The boolean keep mask for tie-inclusive top-k / nucleus filtering.

    top-k keeps every logit ``>=`` the k-th largest; top-p keeps every token
    whose probability is ``>=`` the smallest probability in the nucleus (the
    descending prefix whose exclusive cumulative probability is ``< top_p``).
    ``None`` when both filters are off. Counterpart:
    ``eventstreamgpt_tpu/ops/fused_sampling.py::topk_topp_mask``.
    """
    if top_k is None and top_p is None:
        return None
    keep = torch.ones(logits.shape, dtype=torch.bool, device=logits.device)
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        keep = keep & (logits >= kth)
    if top_p is not None:
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        probs = torch.softmax(logits.float(), dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        csum = torch.cumsum(sp, dim=-1)
        in_nucleus = (csum - sp) < top_p
        cutoff = torch.where(in_nucleus, sp, torch.inf).min(dim=-1, keepdim=True).values
        keep = keep & (probs >= cutoff)
    return keep


def fused_categorical_reference(logits, gumbel, keep=None, active=None, fill: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same inputs, same outputs)."""
    V = logits.shape[-1]
    z = logits.float()
    if keep is not None:
        z = torch.where(keep.bool(), z, F32_MIN)
    score = (gumbel.float() + z).to(logits.dtype).float()
    m = score.max(dim=-1, keepdim=True).values
    iota = torch.arange(V, device=logits.device)
    idx = torch.where(score == m, iota, V).min(dim=-1).values.to(torch.int32)
    if active is not None:
        idx = torch.where(active.bool(), idx, torch.tensor(fill, dtype=torch.int32, device=idx.device))
    return idx


def bind(lib: ctypes.CDLL) -> dict:
    """The C entry points of a build of ``csrc/fused_sampling.cu``, their signatures set."""
    P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    signatures = {
        "esgpt_fused_categorical": [I, P, LL, P, P, P, P, LL, I, I, P],
        "esgpt_fused_categorical_stream": [I, P, LL, P, P, U, LL, P, P, P, LL, I, I, P],
        "esgpt_gumbel_noise": [I, P, P, U, LL, P, LL, I, P],
        "esgpt_launch_floor": [P],
    }
    fns = {}
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        fns[name] = fn
    return fns


@functools.cache
def _kernels() -> dict:
    """The checkout's entry points, built and loaded once."""
    return bind(load_library(SOURCE))


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _operands(name, logits, keep, active):
    """Checks a CUDA call's logits, keep and active; returns the ``(rows, V)``
    logits view (unit column stride, rows strided), keep and active as
    contiguous bools (or None), and the batch shape."""
    if logits.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {logits.device}")
    if logits.dtype not in DTYPES:
        raise ValueError(f"{name} takes fp32 or bf16 logits, got {logits.dtype}")
    if logits.dim() < 1 or logits.shape[-1] < 1:
        raise ValueError(f"{name} takes logits (..., V) with V >= 1, got {tuple(logits.shape)}")
    for label, t in (("keep", keep), ("active", active)):
        if t is not None and t.device != logits.device:
            raise ValueError(f"{name}: {label} is on {t.device}, logits on {logits.device}")
    batch_shape, V = logits.shape[:-1], logits.shape[-1]
    if keep is not None and keep.shape != logits.shape:
        raise ValueError(f"{name}: keep must have the logits' shape {tuple(logits.shape)}, got {tuple(keep.shape)}")
    if active is not None and active.shape != batch_shape:
        raise ValueError(f"{name}: active must have shape {tuple(batch_shape)}, got {tuple(active.shape)}")
    # 2-D logits with unit column stride and contiguous bool masks (the
    # engine's) pass through untouched: no copy, no conversion launch, no
    # view; the host's time is most of a launch-sized kernel's cost.
    z = logits if logits.dim() == 2 else logits.reshape(-1, V)
    if z.stride(-1) != 1 or (z.shape[0] > 1 and z.stride(0) < V):
        z = z.contiguous()
    k = None if keep is None else _contiguous_bool(keep if keep.dim() == 2 else keep.reshape(-1, V))
    a = None if active is None else _contiguous_bool(active if active.dim() == 1 else active.reshape(-1))
    return z, k, a, batch_shape


def _contiguous_bool(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.bool and t.is_contiguous() else t.bool().contiguous()


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def fused_categorical(logits, gumbel, keep=None, active=None, fill: int = 0) -> torch.Tensor:
    """One fused categorical draw per row: mask + Gumbel add + first argmax.

    Args:
        logits: ``(..., V)`` fp32 or bf16 unnormalized log-probabilities.
        gumbel: Gumbel noise of the logits' shape and dtype (drawn by the caller).
        keep: optional bool ``(..., V)`` filter mask (`topk_topp_mask`).
        active: optional bool ``(...)``; inactive rows return ``fill``.

    Returns:
        ``(...)`` int32 indices.
    """
    if logits.device.type == "cpu":
        return fused_categorical_reference(logits, gumbel, keep, active, fill)
    z, k, a, batch_shape = _operands("fused_categorical", logits, keep, active)
    if gumbel.device != logits.device or gumbel.shape != logits.shape or gumbel.dtype != logits.dtype:
        raise ValueError(f"fused_categorical: gumbel must match the logits' device, shape and dtype, got "
                         f"{gumbel.device} {tuple(gumbel.shape)} {gumbel.dtype}")  # fmt: skip
    g = _contiguous(gumbel.reshape(z.shape))
    out = torch.empty(z.shape[0], dtype=torch.int32, device=logits.device)
    err = _kernels()["esgpt_fused_categorical"](
        DTYPES[z.dtype], z.data_ptr(), z.stride(0), g.data_ptr(), _ptr(k), _ptr(a), out.data_ptr(), z.shape[0],
        z.shape[1], int(fill), _stream_ptr(z.device),
    )  # fmt: skip
    _raise_on(err, "fused_categorical")
    fused_categorical.launches += 1
    return out if len(batch_shape) == 1 else out.reshape(batch_shape)


def _stream_rows(name, shape, device, stream):
    """The stream's seeds and counters (int64, contiguous, on ``device``) and
    how many rows of a ``(B, ..., V)`` plane of ``shape`` one stream row covers."""
    seeds, counters = stream.seeds, stream.counters
    if len(shape) < 2 or shape[0] != seeds.shape[0]:
        raise ValueError(f"{name}: the stream has {seeds.shape[0]} rows, the plane is {tuple(shape)}")
    for label, t in (("seeds", seeds), ("counters", counters)):
        if t.device != device or t.dtype != torch.int64 or t.shape != (shape[0],):
            raise ValueError(f"{name}: stream {label} must be int64 ({shape[0]},) on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")  # fmt: skip
    return _contiguous(seeds), _contiguous(counters), math.prod(shape[1:-1])


def fused_categorical_stream(logits, stream, keep=None, active=None, fill: int = 0) -> torch.Tensor:
    """`fused_categorical` with the noise of ``stream``'s next draw made in the kernel.

    Args:
        logits: ``(B, ..., V)`` fp32 or bf16 unnormalized log-probabilities.
        stream: a `generation.sampling.RowStreams` of ``B`` rows (its
            ``seeds``, ``counters`` and ``next_draw_salt()``); the noise is
            ``gumbel(stream, logits.shape, logits.device).to(logits.dtype)``
            and the stream advances by that one draw. The salt goes to the
            kernel as a host integer, which a CUDA graph capture bakes in:
            the engine's salts depend on the head and the draw only, the
            same at every step, and its seeds and counters are read on the
            device.
        keep, active, fill: as in `fused_categorical`.

    Returns:
        ``(B, ...)`` int32 indices.
    """
    if logits.device.type == "cpu":
        noise = stream_gumbel(stream, logits.shape, logits.device).to(logits.dtype)
        return fused_categorical_reference(logits, noise, keep, active, fill)
    z, k, a, batch_shape = _operands("fused_categorical_stream", logits, keep, active)
    seeds, counters, inner = _stream_rows("fused_categorical_stream", logits.shape, logits.device, stream)
    out = torch.empty(z.shape[0], dtype=torch.int32, device=logits.device)
    err = _kernels()["esgpt_fused_categorical_stream"](
        DTYPES[z.dtype], z.data_ptr(), z.stride(0), seeds.data_ptr(), counters.data_ptr(), stream.next_draw_salt(),
        inner, _ptr(k), _ptr(a), out.data_ptr(), z.shape[0], z.shape[1], int(fill), _stream_ptr(z.device),
    )  # fmt: skip
    _raise_on(err, "fused_categorical_stream")
    fused_categorical_stream.launches += 1
    return out if len(batch_shape) == 1 else out.reshape(batch_shape)


def gumbel_noise(stream, shape, dtype: torch.dtype) -> torch.Tensor:
    """The noise `fused_categorical_stream` draws for logits of ``shape`` and
    ``dtype``, written out by the kernel's own device function (CUDA only;
    uncounted). The stream advances by one draw."""
    shape, device = tuple(shape), stream.seeds.device
    if device.type != "cuda" or dtype not in DTYPES:
        raise ValueError(f"gumbel_noise takes a CUDA stream and fp32 or bf16, got {device}, {dtype}")
    seeds, counters, inner = _stream_rows("gumbel_noise", shape, device, stream)
    out = torch.empty(shape, dtype=dtype, device=device)
    err = _kernels()["esgpt_gumbel_noise"](
        DTYPES[dtype], seeds.data_ptr(), counters.data_ptr(), stream.next_draw_salt(), inner, out.data_ptr(),
        math.prod(shape[:-1]), shape[-1], _stream_ptr(device),
    )  # fmt: skip
    _raise_on(err, "gumbel_noise")
    return out


def launch_floor() -> None:
    """Launches an empty kernel on the current CUDA stream (the launch floor
    beside which the launch-sized kernels' times are read)."""
    _raise_on(_kernels()["esgpt_launch_floor"](_stream_ptr(torch.device("cuda"))), "launch_floor")


fused_categorical.launches = 0
fused_categorical_stream.launches = 0
