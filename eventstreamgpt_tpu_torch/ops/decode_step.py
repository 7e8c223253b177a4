"""The fused CI decode step through the whole layer stack (kernel B).

Replaces the TPU kernel ``eventstreamgpt_tpu/ops/pallas_decode_step.py::
decode_stack_step`` (``_stack_kernel`` / ``_layer_math``): everything
between the input embedding and ``ln_f`` for one event per slot row. The
CUDA source, its design and its bound are in ``csrc/decode_step.cu``: one
thread-block cluster of `cluster_size` CTAs per slot row, each CTA owning
some heads and a share of every product's columns, exchanging whole vectors
through distributed shared memory, and reading K and V over each row's live
positions only. The step needs the weights once and K and V at those
positions, about 9.6 MB or 3 us at 3.35 TB/s at the serving shape.

Quantized caches (int8 or fp8 planes, `ops.kv_quant`) come with their
``(L, B, H, M)`` fp32 scale tables (``key_scale`` / ``value_scale``, both or
neither): the new key and value are quantized at the cursor and every
position attention reads is dequantized to the compute dtype, as the JAX
kernel's ``_layer_math`` does with ``quantized=True``. On the card that is
the source's second entry (``esgpt_decode_stack_step_quant``), counted apart
(``decode_stack_step.launches_int8`` / ``launches_fp8``); the float entry
keeps its C signature, so `bind` loads older builds too.

`decode_stack_step` runs `decode_stack_step_reference` (the plain PyTorch
version of the same function) on CPU tensors, and on CUDA tensors launches
the kernel or raises. Both write the new keys/values (and scales) into the
caches IN PLACE at each row's cursor (the JAX function returns new arrays)
and return ``(h, key_cache, value_cache, key_scale, value_scale, new_mask,
new_length)``, the scales being the caller's tensors or ``None``; given an ``active``
row mask, inactive rows keep their old mask and length (the engine's merge,
done in the kernel). Weights come stacked
by `stack_layer_weights` with a leading layer axis and the flax ``(in, out)``
kernel layout.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.transformer import activation as act_fn
from .build import load_library
from .kv_quant import FP8_DTYPE, dequantize_kv, quantize_kv, storage
from .tensor_ops import flax_layer_norm

__all__ = [
    "CACHE_TYPES",
    "WEIGHT_NAMES",
    "cluster_size",
    "decode_stack_step",
    "decode_stack_step_reference",
    "stack_layer_weights",
]

F32_MIN = torch.finfo(torch.float32).min
SOURCE = "decode_step.cu"
THREADS = 256
CANNOT_PLACE = -1  # the C entry point's return when no cluster fits on the card
ACTIVATIONS = {"gelu": 0, "gelu_new": 0, "relu": 1}
CACHE_TYPES = {torch.int8: 1, FP8_DTYPE: 2}  # the quantized entry's cache-type code
# Kernel argument order; LayerNorm parameters (ln*) stay fp32.
WEIGHT_NAMES = ("ln1_s", "ln1_b", "wq", "wk", "wv", "wo", "bo", "ln2_s", "ln2_b", "wfc", "bfc", "wpr", "bpr")


def stack_layer_weights(blocks, dtype: torch.dtype) -> dict:
    """Stacks the port's ``InnerBlock`` parameters into leading-``L`` tensors.

    Dense weights are transposed to the flax ``(in, out)`` layout and cast to
    ``dtype`` (the compute dtype); LayerNorm parameters stay fp32. Done once
    per engine, not per step.
    """

    def stack(get, dt, transpose=False):
        ts = [get(b).detach() for b in blocks]
        return torch.stack([t.T if transpose else t for t in ts]).to(dt).contiguous()

    f32 = torch.float32
    return {
        "ln1_s": stack(lambda b: b.attn.layer_norm.weight, f32),
        "ln1_b": stack(lambda b: b.attn.layer_norm.bias, f32),
        "wq": stack(lambda b: b.attn.attention.q_proj.weight, dtype, True),
        "wk": stack(lambda b: b.attn.attention.k_proj.weight, dtype, True),
        "wv": stack(lambda b: b.attn.attention.v_proj.weight, dtype, True),
        "wo": stack(lambda b: b.attn.attention.out_proj.weight, dtype, True),
        "bo": stack(lambda b: b.attn.attention.out_proj.bias, dtype),
        "ln2_s": stack(lambda b: b.layer_norm.weight, f32),
        "ln2_b": stack(lambda b: b.layer_norm.bias, f32),
        "wfc": stack(lambda b: b.mlp.c_fc.weight, dtype, True),
        "bfc": stack(lambda b: b.mlp.c_fc.bias, dtype),
        "wpr": stack(lambda b: b.mlp.c_proj.weight, dtype, True),
        "bpr": stack(lambda b: b.mlp.c_proj.bias, dtype),
    }


def _mask_update(start, event_mask, mask):
    """The layer-shared cache-tracking update: this event's bit at the cursor."""
    pos = torch.arange(mask.shape[1], device=mask.device)
    new_mask = torch.where(pos[None, :] == start[:, None], event_mask[:, None], mask)
    return new_mask, start + 1


def _gate(active, new_mask, new_length, mask, start):
    """Inactive rows keep their old mask and length."""
    if active is None:
        return new_mask, new_length
    return torch.where(active[:, None], new_mask, mask), torch.where(active, new_length, start)


def _layer_reference(h, kc, vc, ks, vs, start, event_mask, new_mask, w, window, act, eps):
    """One InnerBlock at S=1 against the per-row-cursor cache (``_layer_math``);
    ``ks``/``vs`` are the scale tables of a quantized cache, else ``None``."""
    B, E = h.shape
    H, M, D = kc.shape[1], kc.shape[2], kc.shape[3]
    cdt = h.dtype

    def dense(x, k, b=None):
        y = x @ k
        return y if b is None else y + b

    n1 = flax_layer_norm(h, w["ln1_s"], w["ln1_b"], eps, cdt)
    q = dense(n1, w["wq"]).reshape(B, H, D)
    k = dense(n1, w["wk"]).reshape(B, H, D)
    v = dense(n1, w["wv"]).reshape(B, H, D)
    rows = torch.nonzero((start >= 0) & (start < M)).flatten()
    at = start[rows].long()
    if ks is None:
        kc[rows, :, at, :] = k[rows].to(kc.dtype)  # in place
        vc[rows, :, at, :] = v[rows].to(vc.dtype)
        key, value = kc, vc
    else:  # quantize on write, in place; attention reads the whole plane dequantized
        for plane, scale, x in ((kc, ks, k), (vc, vs, v)):
            codes, sc = quantize_kv(x[rows], plane.dtype)
            storage(plane)[rows, :, at, :] = storage(codes)
            scale[rows, :, at] = sc
        key, value = dequantize_kv(kc, ks, cdt), dequantize_kv(vc, vs, cdt)

    pos = torch.arange(M, device=h.device)
    causal = pos[None, :] <= start[:, None]
    if window > 0:
        causal = causal & (pos[None, :] > start[:, None] - window)
    logits = torch.einsum("bhd,bhmd->bhm", q.float(), key.float())
    logits = torch.where(causal[:, None, :], logits, F32_MIN)
    logits = logits + torch.where(new_mask[:, None, :], 0.0, F32_MIN)
    probs = torch.softmax(torch.clamp(logits, min=F32_MIN), dim=-1).to(value.dtype)
    out = torch.einsum("bhm,bhmd->bhd", probs, value).reshape(B, E)
    x = dense(out, w["wo"], w["bo"]) + h
    m = act(dense(flax_layer_norm(x, w["ln2_s"], w["ln2_b"], eps, cdt), w["wfc"], w["bfc"]))
    x = x + dense(m, w["wpr"], w["bpr"])
    return torch.where(event_mask[:, None], x, 0.0)


def _check_scales(key_scale, value_scale):
    if (key_scale is None) != (value_scale is None):
        raise ValueError("key_scale and value_scale must both be set or both None")


def decode_stack_step_reference(
    weights, key_cache, value_cache, h0, start, event_mask, mask, *, windows, activation, layer_norm_eps, active=None,
    key_scale=None, value_scale=None,
):  # fmt: skip
    """The plain PyTorch version of the kernel; see `decode_stack_step`."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"decode_stack_step supports {sorted(ACTIVATIONS)}, got {activation!r}")
    _check_scales(key_scale, value_scale)
    new_mask, new_length = _mask_update(start, event_mask, mask)
    act = act_fn(activation)
    h = h0
    for l in range(key_cache.shape[0]):
        w = {name: weights[name][l] for name in WEIGHT_NAMES}
        ks, vs = (None, None) if key_scale is None else (key_scale[l], value_scale[l])
        h = _layer_reference(
            h, key_cache[l], value_cache[l], ks, vs, start, event_mask, new_mask, w, int(windows[l]), act,
            layer_norm_eps,
        )  # fmt: skip
    return (h, key_cache, value_cache, key_scale, value_scale, *_gate(active, new_mask, new_length, mask, start))


def _check(weights, key_cache, value_cache, h0, start, event_mask, mask, windows, active, key_scale, value_scale):
    L, B, H, M, D = key_cache.shape
    E = H * D
    cdt = h0.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_stack_step takes fp32 or bf16 activations, got {cdt}")
    I = weights["wfc"].shape[-1]
    shapes = {
        "ln1_s": (L, E), "ln1_b": (L, E), "wq": (L, E, E), "wk": (L, E, E), "wv": (L, E, E),
        "wo": (L, E, E), "bo": (L, E), "ln2_s": (L, E), "ln2_b": (L, E), "wfc": (L, E, I),
        "bfc": (L, I), "wpr": (L, I, E), "bpr": (L, E),
    }  # fmt: skip
    tensors = dict(weights, key_cache=key_cache, value_cache=value_cache, h0=h0, start=start,
                   event_mask=event_mask, mask=mask)  # fmt: skip
    if active is not None:
        tensors["active"] = active
    _check_scales(key_scale, value_scale)
    if key_scale is not None:
        tensors.update(key_scale=key_scale, value_scale=value_scale)
    for name, t in tensors.items():
        if t.device != h0.device:
            raise ValueError(f"{name} is on {t.device}, h0 on {h0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, shape in shapes.items():
        if tuple(weights[name].shape) != shape:
            raise ValueError(f"weights[{name!r}] has shape {tuple(weights[name].shape)}, expected {shape}")
        want = torch.float32 if name.startswith("ln") else cdt
        if weights[name].dtype != want:
            raise ValueError(f"weights[{name!r}] is {weights[name].dtype}, expected {want}")
    if value_cache.shape != key_cache.shape or value_cache.dtype != key_cache.dtype:
        raise ValueError("key/value caches must be (L, B, H, M, D) of one dtype")
    if key_scale is None and key_cache.dtype != cdt:
        raise ValueError(f"a float cache must be in h0's dtype ({cdt}), got {key_cache.dtype}")
    if key_scale is not None:
        if key_cache.dtype not in CACHE_TYPES:
            raise ValueError(f"a cache with scale tables must be int8 or float8_e4m3fn, got {key_cache.dtype}")
        for t in (key_scale, value_scale):
            if t.shape != (L, B, H, M) or t.dtype != torch.float32:
                raise ValueError(f"scale tables must be {(L, B, H, M)} fp32, got {tuple(t.shape)} {t.dtype}")
    if h0.shape != (B, E) or start.shape != (B,) or event_mask.shape != (B,) or mask.shape != (B, M):
        raise ValueError("h0 (B, E), start (B,), event_mask (B,), mask (B, M) expected")
    if start.dtype != torch.int32 or event_mask.dtype != torch.bool or mask.dtype != torch.bool:
        raise ValueError("start must be int32; event_mask and mask bool")
    if active is not None and (active.shape != (B,) or active.dtype != torch.bool):
        raise ValueError("active must be a (B,) bool mask")
    if len(windows) != L:
        raise ValueError(f"windows must have one entry per layer ({L}), got {len(windows)}")
    return L, B, H, M, D, I


_WINDOWS: dict = {}


def _windows_tensor(windows: tuple, device) -> torch.Tensor:
    """The per-layer windows as a device tensor, made once per device: a
    fresh host-to-device copy per step would block the host on the stream.
    The first call for a key copies from the host, which a CUDA graph
    capture forbids: the captured programs make it in their warm-up."""
    key = (windows, str(device))
    if key not in _WINDOWS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_stack_step: its first call for these windows is under a CUDA graph capture; "
                               "run it once before capturing")  # fmt: skip
        _WINDOWS[key] = torch.tensor(windows, dtype=torch.int32, device=device)
    return _WINDOWS[key]


def cluster_size(H: int) -> int:
    """CTAs in each slot row's cluster for ``H`` heads (asked of the built kernel)."""
    return int(load_library(SOURCE).esgpt_decode_cluster_size(int(H)))


def bind(lib: ctypes.CDLL):
    """The float C entry point of a build of ``csrc/decode_step.cu``, its signature set."""
    fn = lib.esgpt_decode_stack_step
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 24 + [ctypes.c_int] * 6 + [ctypes.c_float]
    fn.argtypes += [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return fn


def bind_quant(lib: ctypes.CDLL):
    """The quantized-cache C entry point of a build, its signature set: the
    float entry's arguments with a cache-type code after the dtype and the
    two scale tables after the caches."""
    fn = lib.esgpt_decode_stack_step_quant
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 26 + [ctypes.c_int] * 6 + [ctypes.c_float]
    fn.argtypes += [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return fn


@functools.cache
def _kernel():
    """The checkout's float entry point, built and loaded once, with its signature set once."""
    return bind(load_library(SOURCE))


@functools.cache
def _kernel_quant():
    """The checkout's quantized-cache entry point, as `_kernel`."""
    return bind_quant(load_library(SOURCE))


def _launch(weights, key_cache, value_cache, h0, start, event_mask, mask, windows, activation, layer_norm_eps,
            active, fn=None, key_scale=None, value_scale=None):
    """Checks the inputs and launches the entry point ``fn`` (default: the
    checkout's float entry, or its quantized one when the scales are given),
    uncounted; returns the outputs."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"decode_stack_step supports {sorted(ACTIVATIONS)}, got {activation!r}")
    L, B, H, M, D, I = _check(weights, key_cache, value_cache, h0, start, event_mask, mask, windows, active,
                              key_scale, value_scale)  # fmt: skip
    win = _windows_tensor(tuple(int(w) for w in windows), h0.device)
    h, new_mask, new_length = torch.empty_like(h0), torch.empty_like(mask), torch.empty_like(start)
    ptrs = [t.data_ptr() for t in (h0, start, event_mask, mask)]
    ptrs += [None if active is None else active.data_ptr(), win.data_ptr()]
    ptrs += [weights[name].data_ptr() for name in WEIGHT_NAMES]
    ptrs += [t.data_ptr() for t in (key_cache, value_cache)]
    codes = [1 if h0.dtype == torch.bfloat16 else 0]
    if key_scale is not None:
        codes.append(CACHE_TYPES[key_cache.dtype])
        ptrs += [key_scale.data_ptr(), value_scale.data_ptr()]
        fn = fn or _kernel_quant()
    ptrs += [t.data_ptr() for t in (h, new_mask, new_length)]
    err = (fn or _kernel())(
        *codes,
        *ptrs,
        L, B, H, M, D, I,
        float(layer_norm_eps),
        ACTIVATIONS[activation],
        THREADS,
        torch.cuda.current_stream(h0.device).cuda_stream,
    )  # fmt: skip
    if err == CANNOT_PLACE:
        raise RuntimeError(
            f"decode_stack_step: no cluster of {cluster_size(H)} CTAs with the shared memory of (H={H}, M={M}, "
            f"D={D}, I={I}) fits on {torch.cuda.get_device_name(h0.device)}"
        )
    if err != 0:
        raise RuntimeError(f"decode_stack_step kernel launch failed: CUDA error {err}")
    return h, key_cache, value_cache, key_scale, value_scale, new_mask, new_length


def decode_stack_step(
    weights: dict,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    h0: torch.Tensor,
    start: torch.Tensor,
    event_mask: torch.Tensor,
    mask: torch.Tensor,
    *,
    windows: tuple,
    activation: str,
    layer_norm_eps: float,
    active: torch.Tensor | None = None,
    key_scale: torch.Tensor | None = None,
    value_scale: torch.Tensor | None = None,
):
    """One CI decode step through the whole layer stack.

    Args:
        weights: `stack_layer_weights` dict (leading axis ``L``).
        key_cache / value_cache: ``(L, B, H, M, D)``, in the compute dtype,
            or int8 / float8_e4m3fn with scale tables; updated in place.
        h0: ``(B, E)`` input-layer embedding of the current event.
        start: ``(B,)`` int32 per-row cache cursors.
        event_mask: ``(B,)`` bool mask bit of the decoded event.
        mask: ``(B, M)`` bool padding mask BEFORE this event.
        windows: per-layer window sizes, 0 = global.
        activation: ``config.activation_function`` (gelu or relu).
        layer_norm_eps: ``config.layer_norm_epsilon``.
        active: optional ``(B,)`` bool; rows that are False keep ``mask``
            and ``start`` as their new mask and length.
        key_scale / value_scale: ``(L, B, H, M)`` fp32 scale tables of a
            quantized cache (both or neither); updated in place.

    Returns:
        ``(h, key_cache, value_cache, key_scale, value_scale, new_mask,
        new_length)``: ``h`` is the hidden state before ``ln_f``;
        ``new_length = start + 1``.
    """
    if h0.device.type == "cpu":
        return decode_stack_step_reference(
            weights, key_cache, value_cache, h0, start, event_mask, mask, windows=windows, activation=activation,
            layer_norm_eps=layer_norm_eps, active=active, key_scale=key_scale, value_scale=value_scale,
        )  # fmt: skip
    if h0.device.type != "cuda":
        raise ValueError(f"decode_stack_step runs on CUDA or CPU tensors, got {h0.device}")
    out = _launch(weights, key_cache, value_cache, h0, start, event_mask, mask, windows, activation,
                  layer_norm_eps, active, key_scale=key_scale, value_scale=value_scale)  # fmt: skip
    if key_scale is None:
        decode_stack_step.launches += 1
    elif key_cache.dtype == torch.int8:
        decode_stack_step.launches_int8 += 1
    else:
        decode_stack_step.launches_fp8 += 1
    return out


decode_stack_step.launches = 0  # float caches
decode_stack_step.launches_int8 = 0
decode_stack_step.launches_fp8 = 0
