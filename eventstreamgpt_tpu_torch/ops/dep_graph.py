"""Attention over each event's dependency graph, forward and backward (kernel D).

Replaces the TPU kernel ``eventstreamgpt_tpu/ops/pallas_dep_graph.py::
dep_graph_attention_pallas`` and its reference formulation
``eventstreamgpt_tpu/ops/band_attention.py::_dep_graph_attention_xla``:
``(N, Q, H, D)`` queries against ``(N, S, H, D)`` keys and values of the
same event row, unscaled fp32 logits, a static causal mask over graph
positions (query ``qi`` sits at position ``qi + q_offset``; with a
``window``, only the last ``window`` positions up to it), an fp32 softmax,
attention dropout as ``where(keep, p / keep_prob, 0)`` from an external
``(N, Q, S, H)`` keep-mask, and the probabilities cast to the value dtype
before the fp32 PV sum. The CUDA source, its design and its bounds are in
``csrc/dep_graph.cu``.

`dep_graph_attention` runs `dep_graph_attention_reference` (the plain
PyTorch version, differentiated by autograd) on CPU tensors and, on CUDA
tensors, an autograd function whose forward and backward launch the two
kernels (`dep_graph_fwd`, `dep_graph_bwd`, each counting its launches) or
raise. On CUDA the kernels move every head slice as 16-byte vectors, so q,
k and v must start on 16-byte boundaries and the query's row and query
strides be multiples of 16 bytes (`misalignment`); the wrapper raises
otherwise. The JAX wrapper's ``probs_transform`` hook is not ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

__all__ = ["dep_graph_attention", "dep_graph_attention_reference", "dep_graph_bwd", "dep_graph_fwd"]

SOURCE = "dep_graph.cu"
DTYPES = {torch.bfloat16: 1, torch.float32: 0}
MAX_POSITIONS = 8  # the kernel's cap on Q and S (csrc/dep_graph.cu kMaxPos)
F32_MIN = torch.finfo(torch.float32).min
ALIGN = 16  # bytes: the kernels move every head slice as 16-byte vectors


def graph_mask(Q: int, S: int, q_offset: int, window: int | None, device=None) -> torch.Tensor:
    """The static ``(Q, S)`` mask: position ``s`` is visible to query ``qi``
    when ``s <= qi + q_offset`` (and ``s > qi + q_offset - window``).

    Examples:
        >>> graph_mask(3, 4, 1, None).int()
        tensor([[1, 1, 0, 0],
                [1, 1, 1, 0],
                [1, 1, 1, 1]], dtype=torch.int32)
        >>> graph_mask(3, 4, 1, 2).int()
        tensor([[1, 1, 0, 0],
                [0, 1, 1, 0],
                [0, 0, 1, 1]], dtype=torch.int32)
    """
    q_pos = torch.arange(Q, device=device)[:, None] + q_offset
    k_pos = torch.arange(S, device=device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def dep_graph_attention_reference(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    q_offset: int = 0,
    window: int | None = None,
    dropout_mask: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """The plain PyTorch version, op for op the JAX reference formulation."""
    Q, S = query.shape[1], key.shape[1]
    mask = graph_mask(Q, S, q_offset, window, query.device)
    # bf16 products are exact in fp32, so upcast-then-multiply gives the
    # bf16-multiply, fp32-accumulate numbers of a matrix unit.
    logits = (query.float()[:, :, None] * key.float()[:, None, :]).sum(dim=-1)  # (N, Q, S, H)
    logits = torch.where(mask[None, :, :, None], logits, F32_MIN)
    probs = torch.softmax(logits, dim=2)
    if dropout_mask is not None:
        # A device tensor: CUDA divides by a host scalar as a product with its reciprocal.
        keep_prob = torch.tensor(1.0 - float(dropout_rate), device=probs.device)
        probs = torch.where(dropout_mask, probs / keep_prob, 0.0)
    pv = probs.to(value.dtype).float()[..., None] * value.float()[:, None]  # (N, Q, S, H, D)
    return pv.sum(dim=2).to(value.dtype)


def bind(lib: ctypes.CDLL) -> tuple:
    """The forward and backward C entry points of a build of ``csrc/dep_graph.cu``, their signatures set."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # N, Q, S, H, D, q_offset, window, keep_prob, stream
    shape = [i64, i32, i32, i32, i32, i32, i32, ctypes.c_float, ptr]
    lib.esgpt_dep_graph_fwd.argtypes = [i32, ptr, i64, i64, ptr, ptr, ptr, ptr] + shape
    lib.esgpt_dep_graph_bwd.argtypes = [i32, ptr, i64, i64, ptr, ptr, ptr, ptr, ptr, ptr, ptr] + shape
    for fn in (lib.esgpt_dep_graph_fwd, lib.esgpt_dep_graph_bwd):
        fn.restype = ctypes.c_int
    return lib.esgpt_dep_graph_fwd, lib.esgpt_dep_graph_bwd


@functools.cache
def _kernels():
    """The checkout's two entry points, built and loaded once, with their signatures set once."""
    return bind(load_library(SOURCE))


def misalignment(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> str | None:
    """What keeps the kernels' 16-byte vector loads off these tensors, or None.

    Every tensor must start on a 16-byte boundary, and the query's row and
    query strides (over axes longer than 1) must be multiples of 16 bytes;
    the ``(H, D)`` axes are contiguous and ``D`` a multiple of 32, so every
    head slice then starts on one. The model's projections and their
    ``[:, 1:]`` views always do.

    Examples:
        >>> full = torch.zeros((2, 4, 2, 32), dtype=torch.bfloat16)
        >>> misalignment(full[:, 1:], full, full) is None
        True
        >>> misalignment(torch.zeros(2 * 3 * 2 * 32 + 1, dtype=torch.bfloat16)[1:].view(2, 3, 2, 32), full, full)
        'the query starts 2 bytes past a 16-byte boundary'
    """
    for name, t in (("the query", query), ("the key", key), ("the value", value)):
        if t.data_ptr() % ALIGN:
            return f"{name} starts {t.data_ptr() % ALIGN} bytes past a {ALIGN}-byte boundary"
    esz = query.element_size()
    for axis, what in ((0, "row"), (1, "query")):
        if query.shape[axis] > 1 and (query.stride(axis) * esz) % ALIGN:
            return f"the query's {what} stride of {query.stride(axis) * esz} bytes is not a multiple of {ALIGN}"
    return None


def _checked(query, key, value, dropout_mask, q_offset, window, what):
    """Raises on what the kernels do not take; returns ``(N, Q, S, H, D)``."""
    N, Q, H, D = query.shape
    S = key.shape[1]
    dev = query.device
    if dev.type != "cuda" or key.device != dev or value.device != dev:
        raise ValueError(f"{what} takes CUDA tensors on one device, got {query.device}, {key.device}, {value.device}")
    if query.dtype not in DTYPES or key.dtype != query.dtype or value.dtype != query.dtype:
        raise ValueError(
            f"{what} takes bf16 or fp32 q, k, v of one dtype, got {query.dtype}, {key.dtype}, {value.dtype}"
        )
    if key.shape != (N, S, H, D) or value.shape != key.shape:
        raise ValueError(f"{what}: q {tuple(query.shape)}, k {tuple(key.shape)}, v {tuple(value.shape)} do not fit")
    if not (1 <= Q <= MAX_POSITIONS and 1 <= S <= MAX_POSITIONS):
        raise ValueError(f"{what}: Q={Q} and S={S} must lie in [1, {MAX_POSITIONS}]")
    if D % 32 or not 32 <= D <= 256:
        raise ValueError(f"{what}: head_dim {D} must be a multiple of 32 up to 256")
    if q_offset < 0 or (window is not None and window < 1):
        raise ValueError(f"{what}: q_offset {q_offset} must be >= 0 and window {window} None or >= 1")
    if not bool(graph_mask(Q, S, q_offset, window).any(dim=1).all()):
        raise ValueError(f"{what}: a query sees no graph position (Q={Q}, S={S}, q_offset={q_offset}, window={window})")
    if query.stride(3) != 1 or query.stride(2) != D:
        raise ValueError(f"{what}: the query's (H, D) axes must be contiguous, got strides {query.stride()}")
    if not (key.is_contiguous() and value.is_contiguous()):
        raise ValueError(f"{what}: key and value must be contiguous")
    problem = misalignment(query, key, value)
    if problem is not None:
        raise ValueError(f"{what}: {problem} (q, k and v must sit on {ALIGN}-byte boundaries)")
    if dropout_mask is not None:
        if dropout_mask.shape != (N, Q, S, H) or dropout_mask.dtype != torch.bool or dropout_mask.device != dev:
            raise ValueError(f"{what}: the keep-mask must be a bool {(N, Q, S, H)} tensor on {dev}")
        if not dropout_mask.is_contiguous():
            raise ValueError(f"{what}: the keep-mask must be contiguous")
    return N, Q, S, H, D


def _mask_ptr(dropout_mask):
    return None if dropout_mask is None else dropout_mask.data_ptr()


def dep_graph_fwd(query, key, value, q_offset=0, window=None, dropout_mask=None, keep_prob=1.0) -> torch.Tensor:
    """The forward kernel on CUDA tensors: ``(N, Q, H, D)`` out in the value dtype."""
    out = _fwd(query, key, value, q_offset, window, dropout_mask, keep_prob)
    dep_graph_fwd.launches += 1
    return out


def _fwd(query, key, value, q_offset=0, window=None, dropout_mask=None, keep_prob=1.0, fn=None) -> torch.Tensor:
    """Checks the inputs and launches the forward entry point ``fn`` (default: the checkout's), uncounted."""
    N, Q, S, H, D = _checked(query, key, value, dropout_mask, q_offset, window, "dep_graph_fwd")
    out = torch.empty((N, Q, H, D), dtype=value.dtype, device=value.device)
    err = (fn or _kernels()[0])(
        DTYPES[value.dtype], query.data_ptr(), query.stride(0), query.stride(1), key.data_ptr(), value.data_ptr(),
        _mask_ptr(dropout_mask), out.data_ptr(), N, Q, S, H, D, q_offset, window or 0, keep_prob,
        torch.cuda.current_stream(value.device).cuda_stream,
    )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"dep_graph forward kernel launch failed: CUDA error {err}")
    return out


def dep_graph_bwd(query, key, value, g, q_offset=0, window=None, dropout_mask=None, keep_prob=1.0):
    """The backward kernel on CUDA tensors: ``(dq, dk, dv)`` from the output's
    cotangent ``g`` (cast to the value dtype, as the TPU kernel casts it)."""
    grads = _bwd(query, key, value, g, q_offset, window, dropout_mask, keep_prob)
    dep_graph_bwd.launches += 1
    return grads


def _bwd(query, key, value, g, q_offset=0, window=None, dropout_mask=None, keep_prob=1.0, fn=None):
    """Checks the inputs and launches the backward entry point ``fn`` (default: the checkout's), uncounted."""
    N, Q, S, H, D = _checked(query, key, value, dropout_mask, q_offset, window, "dep_graph_bwd")
    if g.shape != (N, Q, H, D) or g.device != value.device:
        raise ValueError(f"dep_graph_bwd: g {tuple(g.shape)} on {g.device} does not fit {(N, Q, H, D)}")
    g = g.to(value.dtype).contiguous()
    if g.data_ptr() % ALIGN:  # a view autograd handed over: an aligned copy
        g = g.clone()
    dq = torch.empty((N, Q, H, D), dtype=query.dtype, device=value.device)
    dk, dv = torch.empty_like(key), torch.empty_like(value)
    err = (fn or _kernels()[1])(
        DTYPES[value.dtype], query.data_ptr(), query.stride(0), query.stride(1), key.data_ptr(), value.data_ptr(),
        _mask_ptr(dropout_mask), g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), N, Q, S, H, D,
        q_offset, window or 0, keep_prob, torch.cuda.current_stream(value.device).cuda_stream,
    )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"dep_graph backward kernel launch failed: CUDA error {err}")
    return dq, dk, dv


dep_graph_fwd.launches = 0
dep_graph_bwd.launches = 0


class _DepGraph(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query, key, value, dropout_mask, q_offset, window, keep_prob):
        ctx.save_for_backward(query, key, value, dropout_mask)
        ctx.args = (q_offset, window, keep_prob)
        return dep_graph_fwd(query, key, value, q_offset, window, dropout_mask, keep_prob)

    @staticmethod
    def backward(ctx, g):
        query, key, value, dropout_mask = ctx.saved_tensors
        q_offset, window, keep_prob = ctx.args
        dq, dk, dv = dep_graph_bwd(query, key, value, g, q_offset, window, dropout_mask, keep_prob)
        return dq, dk, dv, None, None, None, None


def dep_graph_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    q_offset: int = 0,
    window: int | None = None,
    dropout_mask: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Causal attention over each row's tiny dependency graph.

    Args:
        query: ``(N, Q, H, D)``; on CUDA its ``(H, D)`` axes must be
            contiguous (a ``[:, 1:]`` view of the projections is taken as it is).
        key, value: ``(N, S, H, D)``.
        q_offset: graph position of query 0 (1 when position 0 is key/value-only history).
        window: only the last ``window`` positions up to a query's own are
            visible (``None``: all up to it).
        dropout_mask: optional bool ``(N, Q, S, H)`` keep-mask for attention dropout.
        dropout_rate: the rate the mask was drawn at.

    Returns:
        ``(N, Q, H, D)`` in the value dtype.
    """
    if query.device.type == "cpu":
        return dep_graph_attention_reference(query, key, value, q_offset, window, dropout_mask, dropout_rate)
    if query.device.type != "cuda":
        raise ValueError(f"dep_graph_attention runs on CUDA or CPU tensors, got {query.device}")
    keep_prob = 1.0 if dropout_mask is None else 1.0 - float(dropout_rate)
    return _DepGraph.apply(query, key, value, dropout_mask, int(q_offset), window, keep_prob)
