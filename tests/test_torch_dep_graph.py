"""Kernel D's plain version against the JAX dep-graph attention, on the CPU.

`eventstreamgpt_tpu_torch.ops.dep_graph.dep_graph_attention_reference` (what
the port runs on CPU tensors, and what kernel D is held against on the card)
and JAX's ``dep_graph_attention`` with ``impl="pallas_interpret"`` (the TPU
kernel, interpreted) and ``impl="xla"`` (its reference formulation) take the
same numpy inputs: N = 300 rows (not a multiple of the TPU kernel's 256-row
tile), S = 4 graph positions, H = 2, D = 8, every ``(q_offset, window)`` of
{(1, None), (0, None), (1, 2), (0, 2)}, with and without a keep-mask, in fp32
and bf16. Forward outputs and the ``jax.vjp`` gradients dq, dk, dv are compared.

Tolerances:

* fp32: within 1e-6 of the compared tensor's largest magnitude (sums over D
  and S run in other orders).
* bf16 forward and dv: within one bf16 ulp of each element (the value-dtype
  roundings of the probabilities and the output are the same; an fp32
  last-bit difference may tip one of them).
* bf16 dq and dk: within one bf16 ulp of the tensor's largest magnitude
  against ``xla``, two against ``pallas_interpret``. Autodiff (XLA's and
  PyTorch's) carries the probabilities' cotangent through their cast to
  bf16, so it rounds that cotangent to bf16; the TPU kernel (and kernel D)
  keeps it in fp32, and the softmax backward's difference
  ``dP - sum p dP`` magnifies that rounding in the small entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.ops.band_attention import dep_graph_attention as jax_dep_graph_attention
from eventstreamgpt_tpu_torch.ops.dep_graph import (
    dep_graph_attention,
    dep_graph_attention_reference,
    dep_graph_bwd,
    dep_graph_fwd,
    graph_mask,
    misalignment,
)

N, S, H, D = 300, 4, 2, 8
RATE = 0.1
GRID = [(1, None), (0, None), (1, 2), (0, 2)]
JAX_DTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def bf16_ulp(x):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(x)) - 7)


def inputs(q_offset, with_mask, seed=0):
    rng = np.random.default_rng(seed)
    Q = S - q_offset
    q, g = (rng.normal(size=(N, Q, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(N, S, H, D)).astype(np.float32) for _ in range(2))
    mask = rng.random((N, Q, S, H)) < 1.0 - RATE if with_mask else None
    return q, k, v, g, mask


def jax_run(impl, dtype, q_offset, window, q, k, v, g, mask):
    dt = JAX_DTYPES[dtype]

    def f(a, b, c):
        return jax_dep_graph_attention(
            a, b, c, q_offset=q_offset, window=window, dropout_mask=None if mask is None else jnp.asarray(mask),
            dropout_rate=RATE if mask is not None else 0.0, impl=impl,
        )  # fmt: skip

    out, vjp = jax.vjp(f, *(jnp.asarray(x).astype(dt) for x in (q, k, v)))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *vjp(jnp.asarray(g).astype(dt)))]


def port_run(dtype, q_offset, window, q, k, v, g, mask):
    dt = TORCH_DTYPES[dtype]
    tq, tk, tv = (torch.from_numpy(x).to(dt).requires_grad_(True) for x in (q, k, v))
    m = None if mask is None else torch.from_numpy(mask)
    out = dep_graph_attention_reference(tq, tk, tv, q_offset, window, m, RATE if mask is not None else 0.0)
    assert out.dtype == dt
    out.backward(torch.from_numpy(g).to(dt))
    return [t.detach().float().numpy() for t in (out, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "keep_mask"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("q_offset,window", GRID)
def test_plain_version_matches_jax(q_offset, window, dtype, with_mask, impl):
    args = inputs(q_offset, with_mask, seed=10 * q_offset + (window or 0))
    want = jax_run(impl, dtype, q_offset, window, *args)
    got = port_run(dtype, q_offset, window, *args)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        err = np.abs(a - b)
        if dtype == "fp32":
            assert err.max() <= 1e-6 * np.abs(b).max(), (name, err.max(), np.abs(b).max())
        elif name in ("out", "dv"):
            assert (err <= bf16_ulp(np.maximum(np.abs(a), np.abs(b)))).all(), (name, err.max())
        else:
            ulps = 1 if impl == "xla" else 2
            assert err.max() <= ulps * bf16_ulp(np.abs(b).max()), (name, err.max(), np.abs(b).max())


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    q, k, v, g, mask = inputs(1, True, seed=3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    launches = dep_graph_fwd.launches, dep_graph_bwd.launches
    got = dep_graph_attention(tq[:, :], tk, tv, q_offset=1, dropout_mask=torch.from_numpy(mask), dropout_rate=RATE)
    want = dep_graph_attention_reference(tq, tk, tv, 1, None, torch.from_numpy(mask), RATE)
    assert torch.equal(got, want)
    assert (dep_graph_fwd.launches, dep_graph_bwd.launches) == launches


def test_strided_query_view_equals_a_copy():
    """The model passes ``query[:, 1:]`` of the projections, a strided view."""
    rng = np.random.default_rng(4)
    full = torch.from_numpy(rng.normal(size=(N, S, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(N, S, H, D)).astype(np.float32)) for _ in range(2))
    view = full[:, 1:]
    assert not view.is_contiguous()
    assert torch.equal(dep_graph_attention(view, k, v, q_offset=1), dep_graph_attention(view.contiguous(), k, v, q_offset=1))


def test_keep_mask_drops_and_rescales():
    """An all-kept mask at rate 0.5 doubles the probabilities; an all-dropped one gives zeros."""
    q, k, v, _, _ = inputs(1, False, seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ones = torch.ones((N, S - 1, S, H), dtype=torch.bool)
    base = dep_graph_attention(tq, tk, tv, q_offset=1)
    torch.testing.assert_close(dep_graph_attention(tq, tk, tv, 1, None, ones, 0.5), 2 * base, rtol=1e-6, atol=1e-6)
    assert not dep_graph_attention(tq, tk, tv, 1, None, ~ones, 0.5).any()


def test_graph_mask_matches_the_causal_window_rule():
    for (q_offset, window), Q in zip(GRID, (3, 4, 3, 4)):
        m = graph_mask(Q, S, q_offset, window)
        for qi in range(Q):
            for s in range(S):
                pos = qi + q_offset
                assert bool(m[qi, s]) == (s <= pos and (window is None or s > pos - window))


def test_wrapper_refuses_other_devices():
    q = torch.zeros((2, 3, H, D), device="meta")
    kv = torch.zeros((2, S, H, D), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        dep_graph_attention(q, kv, kv, q_offset=1)


def offset_view(shape, dtype, elements):
    """A contiguous ``shape`` view starting ``elements`` into a fresh buffer."""
    return torch.zeros(int(np.prod(shape)) + elements, dtype=dtype)[elements:].view(shape)


MISALIGNED = {
    "projection_view": (lambda: torch.zeros((5, 4, 2, 32), dtype=torch.bfloat16)[:, 1:], None),
    "fp32_16_bytes_in": (lambda: offset_view((5, 3, 2, 32), torch.float32, 4), None),
    "one_row_any_row_stride": (
        lambda: torch.zeros(3 * 72, dtype=torch.bfloat16).as_strided((1, 3, 2, 32), (9, 72, 32, 1)), None),
    "bf16_2_bytes_in": (lambda: offset_view((5, 3, 2, 32), torch.bfloat16, 1),
                        "the query starts 2 bytes past a 16-byte boundary"),
    "row_stride": (lambda: torch.zeros(5 * 196, dtype=torch.bfloat16).as_strided((5, 3, 2, 32), (196, 64, 32, 1)),
                   "the query's row stride of 392 bytes is not a multiple of 16"),
    "query_stride": (lambda: torch.zeros(5 * 208, dtype=torch.bfloat16).as_strided((5, 3, 2, 32), (208, 68, 32, 1)),
                     "the query's query stride of 136 bytes is not a multiple of 16"),
}  # fmt: skip


@pytest.mark.parametrize("case", sorted(MISALIGNED))
def test_misalignment_names_what_keeps_the_vector_loads_off(case):
    """The rule the wrapper holds CUDA tensors to before a launch: every
    tensor on a 16-byte boundary, the query's strides over axes longer than
    one multiples of 16 bytes."""
    make, want = MISALIGNED[case]
    q = make()
    kv = torch.zeros((q.shape[0], 4, 2, 32), dtype=q.dtype)
    assert misalignment(q, kv, kv) == want


@pytest.mark.parametrize("which", ["key", "value"])
def test_misalignment_names_a_misaligned_key_or_value(which):
    q = torch.zeros((5, 3, 2, 32))
    kv, off = torch.zeros((5, 4, 2, 32)), offset_view((5, 4, 2, 32), torch.float32, 2)
    args = (q, off, kv) if which == "key" else (q, kv, off)
    assert misalignment(*args) == f"the {which} starts 8 bytes past a 16-byte boundary"
