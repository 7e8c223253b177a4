"""Gathers from the regression projection plane, forward and backward (kernel C).

Replaces the TPU kernel ``eventstreamgpt_tpu/ops/pallas_heads.py::
vocab_gather``: ``take_along_axis(z, ci, -1)`` upcast to fp32, where an index
outside ``[0, V)`` gives 0 (the TPU kernel's one-hot contract); the backward
returns a plane of z's dtype in which duplicate indices of a row are summed in
fp32 before the cast, and out-of-range indices receive nothing. The CUDA
source, its design and its bounds are in ``csrc/vocab_gather.cu``.

`vocab_gather` runs `vocab_gather_reference` (the plain PyTorch version) on
CPU tensors and, on CUDA tensors, an autograd function whose forward and
backward launch the two kernels (`vocab_gather_fwd`, `vocab_gather_bwd`,
each counting its launches) or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import load_library

__all__ = ["vocab_gather", "vocab_gather_bwd", "vocab_gather_fwd", "vocab_gather_reference"]

SOURCE = "vocab_gather.cu"
DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def vocab_gather_reference(z: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the gather from the fp32 plane, so autograd
    scatter-adds the cotangent into an fp32 plane, in slot order on the CPU,
    and casts it to z's dtype once."""
    V = z.shape[-1]
    valid = (ci >= 0) & (ci < V)
    out = torch.gather(z.float(), -1, ci.clamp(0, V - 1).long())
    return torch.where(valid, out, 0.0)


def bind(lib: ctypes.CDLL) -> tuple:
    """The forward and backward C entry points of a build of ``csrc/vocab_gather.cu``, their signatures set."""
    fns = (lib.esgpt_vocab_gather_fwd, lib.esgpt_vocab_gather_bwd)
    for fn in fns:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        fn.argtypes += [ctypes.c_void_p]
    return fns


@functools.cache
def _kernels():
    """The checkout's two entry points, built and loaded once, with their signatures set once."""
    return bind(load_library(SOURCE))


def _check(t: torch.Tensor, name: str, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"vocab_gather: {name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"vocab_gather: {name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"vocab_gather: {name} must be contiguous")


def vocab_gather_fwd(z: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """The forward kernel on CUDA tensors: ``(..., V)`` z, ``(..., M)`` int32 ci -> ``(..., M)`` fp32."""
    out = _fwd(z, ci)
    vocab_gather_fwd.launches += 1
    return out


def _fwd(z: torch.Tensor, ci: torch.Tensor, fn=None) -> torch.Tensor:
    """Checks the inputs and launches the forward entry point ``fn`` (default:
    the checkout's), uncounted."""
    _check(z, "z", tuple(DTYPES), z.device)
    _check(ci, "ci", (torch.int32,), z.device)
    if z.device.type != "cuda" or ci.shape[:-1] != z.shape[:-1]:
        raise ValueError(f"vocab_gather_fwd takes CUDA z (..., V) and ci (..., M), got {z.device} "
                         f"{tuple(z.shape)} and {tuple(ci.shape)}")  # fmt: skip
    out = torch.empty(ci.shape, dtype=torch.float32, device=z.device)
    V, M = z.shape[-1], ci.shape[-1]
    err = (fn or _kernels()[0])(DTYPES[z.dtype], z.data_ptr(), ci.data_ptr(), out.data_ptr(), math.prod(ci.shape[:-1]),
                                V, M, torch.cuda.current_stream(z.device).cuda_stream)  # fmt: skip
    if err != 0:
        raise RuntimeError(f"vocab_gather forward kernel launch failed: CUDA error {err}")
    return out


def vocab_gather_bwd(g: torch.Tensor, ci: torch.Tensor, V: int, dtype: torch.dtype) -> torch.Tensor:
    """The backward kernel on CUDA tensors: fp32 ``(..., M)`` g -> ``(..., V)`` dz of ``dtype``."""
    dz = _bwd(g, ci, V, dtype)
    vocab_gather_bwd.launches += 1
    return dz


def _bwd(g: torch.Tensor, ci: torch.Tensor, V: int, dtype: torch.dtype, fn=None) -> torch.Tensor:
    """Checks the inputs and launches the backward entry point ``fn`` (default:
    the checkout's), uncounted."""
    _check(g, "g", (torch.float32,), g.device)
    _check(ci, "ci", (torch.int32,), g.device)
    if g.device.type != "cuda" or ci.shape != g.shape or dtype not in DTYPES:
        raise ValueError(f"vocab_gather_bwd takes CUDA g and ci of one shape and a bf16/fp32 dtype, got "
                         f"{g.device} {tuple(g.shape)}, {tuple(ci.shape)}, {dtype}")  # fmt: skip
    dz = torch.empty(ci.shape[:-1] + (V,), dtype=dtype, device=g.device)
    M = ci.shape[-1]
    err = (fn or _kernels()[1])(DTYPES[dtype], g.data_ptr(), ci.data_ptr(), dz.data_ptr(), math.prod(ci.shape[:-1]),
                                V, M, torch.cuda.current_stream(g.device).cuda_stream)  # fmt: skip
    if err != 0:
        raise RuntimeError(f"vocab_gather backward kernel launch failed: CUDA error {err}")
    return dz


vocab_gather_fwd.launches = 0
vocab_gather_bwd.launches = 0


class _VocabGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, ci):
        ctx.save_for_backward(ci)
        ctx.V, ctx.dtype = z.shape[-1], z.dtype
        return vocab_gather_fwd(z, ci)

    @staticmethod
    def backward(ctx, g):
        (ci,) = ctx.saved_tensors
        return vocab_gather_bwd(g.contiguous(), ci, ctx.V, ctx.dtype), None


def vocab_gather(z: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(z, ci, -1)`` upcast to fp32; out-of-range indices give 0.

    Args:
        z: ``(..., V)`` projection plane, bf16 or fp32.
        ci: ``(..., M)`` indices into the last axis (int32 on CUDA).

    Returns:
        ``(..., M)`` fp32 gathered values. The gradient with respect to ``z``
        is a z-dtype plane with duplicate indices summed in fp32.
    """
    if z.device.type == "cpu":
        return vocab_gather_reference(z, ci)
    if z.device.type != "cuda":
        raise ValueError(f"vocab_gather runs on CUDA or CPU tensors, got {z.device}")
    return _VocabGather.apply(z, ci)
