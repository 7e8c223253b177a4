"""Fused categorical sampling for the serving engine's decode tail (kernel A).

Replaces the TPU kernel ``eventstreamgpt_tpu/ops/fused_sampling.py::
fused_categorical`` (``_sample_2d`` / ``_sample_kernel``). Per row: mask the
logits by ``keep`` (to the fp32 minimum), ``score = f32(round_to_logits_dtype(
f32(gumbel) + f32(logits)))``, the first index of the maximum, and ``fill``
for inactive rows. The add-in-fp32-then-round chain is the JAX contract:
it reproduces ``jax.random.categorical``'s bf16 add, and near-tied tokens
order differently without it.

The Gumbel noise is drawn outside the kernel (as the JAX code draws it
outside its Pallas call), so kernel and plain version see the same inputs.

Route: Triton, one program per row with a power-of-two block of
``next_pow2(V)`` lanes: one elementwise prologue and one row reduction.
Bound: at the serving shape (32 slots x the 40-way ``event_type`` head) the
call moves about 10 KB, a few nanoseconds of memory time; it is bound by
launch latency, and the design does nothing about that beyond being one
launch. Tie-break: the minimum index where ``score == max``, written out,
not left to ``tl.argmax``.

On CPU tensors `fused_categorical` runs `fused_categorical_reference`; on
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .build import triton_modules

__all__ = ["fused_categorical", "fused_categorical_reference", "topk_topp_mask"]

F32_MIN = torch.finfo(torch.float32).min

triton = tl = None  # bound by _kernel() at the first CUDA launch
_KERNEL = None


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


def _sample_rows_kernel(
    z_ptr,
    g_ptr,
    keep_ptr,
    active_ptr,
    out_ptr,
    V,
    fill,
    HAS_KEEP: "tl.constexpr",
    HAS_ACTIVE: "tl.constexpr",
    ROUND_BF16: "tl.constexpr",
    BLOCK: "tl.constexpr",
):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    inb = cols < V
    base = row.to(tl.int64) * V
    z = tl.load(z_ptr + base + cols, mask=inb, other=0.0).to(tl.float32)
    g = tl.load(g_ptr + base + cols, mask=inb, other=0.0).to(tl.float32)
    if HAS_KEEP:
        k = tl.load(keep_ptr + base + cols, mask=inb, other=0)
        z = tl.where(k != 0, z, -3.4028234663852886e38)
    score = g + z
    if ROUND_BF16:
        score = score.to(tl.bfloat16).to(tl.float32)
    score = tl.where(inb, score, float("-inf"))
    m = tl.max(score, axis=0)
    idx = tl.min(tl.where(score == m, cols, V), axis=0)
    if HAS_ACTIVE:
        a = tl.load(active_ptr + row)
        idx = tl.where(a != 0, idx, fill)
    tl.store(out_ptr + row, idx.to(tl.int32))


def _kernel():
    global triton, tl, _KERNEL
    if _KERNEL is None:
        triton, tl = triton_modules()
        _KERNEL = triton.jit(_sample_rows_kernel)
    return _KERNEL


def fused_categorical(logits, gumbel, keep=None, active=None, fill: int = 0) -> torch.Tensor:
    """One fused categorical draw per row: mask + Gumbel add + first argmax.

    Args:
        logits: ``(..., V)`` fp32 or bf16 unnormalized log-probabilities.
        gumbel: Gumbel noise of the same shape (drawn by the caller).
        keep: optional bool ``(..., V)`` filter mask (`topk_topp_mask`).
        active: optional bool ``(...)``; inactive rows return ``fill``.

    Returns:
        ``(...)`` int32 indices.
    """
    if logits.device.type == "cpu":
        return fused_categorical_reference(logits, gumbel, keep, active, fill)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_categorical runs on CUDA or CPU tensors, got {logits.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_categorical takes fp32 or bf16 logits, got {logits.dtype}")
    for name, t in (("gumbel", gumbel), ("keep", keep), ("active", active)):
        if t is not None and t.device != logits.device:
            raise ValueError(f"{name} is on {t.device}, logits on {logits.device}")
    if gumbel.shape != logits.shape or (keep is not None and keep.shape != logits.shape):
        raise ValueError("gumbel and keep must have the logits' shape")
    batch_shape, V = logits.shape[:-1], logits.shape[-1]
    if active is not None and active.shape != batch_shape:
        raise ValueError(f"active must have shape {tuple(batch_shape)}, got {tuple(active.shape)}")
    z = logits.reshape(-1, V).contiguous()
    g = gumbel.reshape(-1, V).contiguous()
    k = z if keep is None else keep.reshape(-1, V).to(torch.int8).contiguous()
    a = z if active is None else active.reshape(-1).to(torch.int8).contiguous()
    rows = z.shape[0]
    out = torch.empty(rows, dtype=torch.int32, device=logits.device)
    if rows:
        _kernel()[(rows,)](
            z,
            g,
            k,
            a,
            out,
            V,
            int(fill),
            HAS_KEEP=keep is not None,
            HAS_ACTIVE=active is not None,
            ROUND_BF16=logits.dtype == torch.bfloat16,
            BLOCK=max(16, 1 << (V - 1).bit_length()),
            num_warps=1 if V <= 1024 else 4,
        )
        fused_categorical.launches += 1
    return out.reshape(batch_shape)


fused_categorical.launches = 0
