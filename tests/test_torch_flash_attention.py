"""The port's flash attention (kernels E and F) and band attention against the JAX package's, on the CPU.

The same numpy-seeded inputs (B=2, H=2, S=256, 2-4 packed segments a row and
``-1`` padding at each row's end) go through:

* the port's `flash_attention` on CPU tensors (its plain version; gradients
  through autograd) and JAX's Pallas ``flash_attention``, the TPU kernel E
  itself, run interpreted under ``pltpu.force_tpu_interpret_mode()`` with the
  block sizes ``models/transformer.py`` picks (256 at S=256), causal, with
  segment ids and ``sm_scale=1``;
* the port's windowed call (W=160: above 128 and not a divisor of S) and
  JAX's ``splash_attention`` with ``LocalMask((S, S), (W - 1, 0))``, the TPU
  kernel F, interpreted, vmapped over rows as ``models/transformer.py`` does;
* the port's `band_local_attention` and ``eventstreamgpt_tpu/ops/band_attention.py``'s.

Tolerances: in fp32 the outputs and the gradients of q, k and v within 1e-5
of each tensor's largest magnitude (the two differ only in the order of fp32
sums). In bf16 within 2e-2 of it: the TPU kernel rounds the unnormalised
probabilities ``exp(s - m)`` to bf16 before ``p @ v`` and keeps dP in fp32,
while the plain version rounds the normalised probabilities, as the einsum
path does, and its autograd rounds dP through the bf16 product; each
rounding is one bf16 ulp (2^-8 relative) of a term, and the gradients sum
hundreds of such terms.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes, SegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash
from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_kernel as splash_kernel
from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_mask as splash_mask

from eventstreamgpt_tpu.ops.band_attention import band_local_attention as jax_band
from eventstreamgpt_tpu_torch.ops.band_attention import band_local_attention
from eventstreamgpt_tpu_torch.ops.flash_attention import attention_mask, flash_attention, flash_attention_fwd

B, H, S = 2, 2, 256
BLOCK = 256  # models/transformer.py's ladder (512, 256, 128) for head_dim < 128 at S = 256
TOL = {"fp32": 1e-5, "bf16": 2e-2}
DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32), "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def packed_segments(rng, n_rows=B, S=S) -> np.ndarray:
    """2-4 segments a row, then 1-40 padding events as segment -1."""
    seg = np.zeros((n_rows, S), np.int32)
    for b in range(n_rows):
        pad = int(rng.integers(1, 41))
        cuts = np.sort(rng.choice(np.arange(8, S - pad - 8), size=int(rng.integers(1, 4)), replace=False))
        for i, c in enumerate(cuts):
            seg[b, c:] = i + 1
        seg[b, S - pad :] = -1
    return seg


def inputs(D, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(4))
    return q, k, v, g, packed_segments(rng)


def jax_reference(window, q, k, v, seg, jdt):
    """Kernel E (``window=None``) or F, interpreted: ``f(q, k, v)``."""
    if window is None:
        blocks = BlockSizes(
            block_q=BLOCK, block_k_major=BLOCK, block_k=BLOCK, block_b=1, block_q_major_dkv=BLOCK,
            block_k_major_dkv=BLOCK, block_k_dkv=BLOCK, block_q_dkv=BLOCK, block_k_major_dq=BLOCK,
            block_k_dq=BLOCK, block_q_dq=BLOCK,
        )  # fmt: skip

        def fn(q, k, v):
            return jax_flash(q, k, v, segment_ids=SegmentIds(q=seg, kv=seg), causal=True, sm_scale=1.0,
                             block_sizes=blocks)  # fmt: skip

        return fn
    mask = splash_mask.MultiHeadMask([splash_mask.LocalMask((S, S), (window - 1, 0), 0) for _ in range(H)])
    kernel = splash_kernel.make_splash_mha(mask, head_shards=1, q_seq_shards=1, interpret=True)
    def row(q, k, v, s):
        return kernel(q, k, v, segment_ids=splash_kernel.SegmentIds(q=s, kv=s))

    return lambda q, k, v: jax.vmap(row)(q, k, v, seg)


def jax_out_and_grads(fn, q, k, v, g, jdt, window):
    """Kernel E under ``force_tpu_interpret_mode``; splash (F) was built with ``interpret=True``."""
    args = [jnp.asarray(x, jdt) for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode() if window is None else contextlib.nullcontext():
        out, vjp = jax.vjp(fn, *args)
        grads = vjp(jnp.asarray(g, jdt))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def port_out_and_grads(fn, q, k, v, g, tdt):
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves)
    assert out.dtype == tdt
    out.backward(torch.from_numpy(g).to(tdt))
    return [x.detach().float().numpy() for x in (out, *(t.grad for t in leaves))]


def assert_close(got, want, tol):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        err, top = np.abs(a - b).max(), np.abs(b).max()
        assert err <= tol * top, (name, err, top)


@pytest.mark.parametrize(
    "dtype,D,window",
    [("fp32", 32, None), ("fp32", 64, None), ("fp32", 32, 160), ("fp32", 64, 160), ("bf16", 64, None),
     ("bf16", 64, 160)],
)  # fmt: skip
def test_flash_attention_matches_the_tpu_kernels(dtype, D, window):
    """Global: JAX's flash_attention (kernel E); windowed: splash with LocalMask (kernel F)."""
    q, k, v, g, seg = inputs(D, seed=D)
    _, jdt, tdt = DTYPES[dtype]
    want = jax_out_and_grads(jax_reference(window, q, k, v, jnp.asarray(seg), jdt), q, k, v, g, jdt, window)
    tseg = torch.from_numpy(seg)
    got = port_out_and_grads(lambda a, b, c: flash_attention(a, b, c, tseg, window), q, k, v, g, tdt)
    assert_close(got, want, TOL[dtype])


def test_padding_and_segments_isolate_queries():
    """A query's output depends only on keys of its own segment up to itself:
    changing every other key and value leaves it unchanged."""
    q, k, v, _, seg = inputs(32, seed=3)
    tseg = torch.from_numpy(seg)
    base = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), tseg)
    b, i = 1, int(np.flatnonzero(seg[1] == 1)[3])  # the fourth event of row 1's second segment
    others = ~((seg[b] == seg[b, i]) & (np.arange(S) <= i))
    k2, v2 = k.copy(), v.copy()
    k2[b, :, others] += 5.0
    v2[b, :, others] -= 3.0
    moved = flash_attention(torch.from_numpy(q), torch.from_numpy(k2), torch.from_numpy(v2), tseg)
    torch.testing.assert_close(moved[b, :, i], base[b, :, i], rtol=0, atol=0)
    assert not torch.equal(moved[b, :, -1], base[b, :, -1])  # the padding sees the changed padding keys


def test_window_mask_is_the_local_mask():
    seg = torch.from_numpy(packed_segments(np.random.default_rng(5)))
    want = splash_mask.LocalMask((S, S), (159, 0), 0)[:, :]
    got = attention_mask(torch.zeros_like(seg), window=160)[0, 0].numpy()
    np.testing.assert_array_equal(got, want)
    assert attention_mask(seg, 160)[:, 0].diagonal(dim1=1, dim2=2).all()  # every query sees itself


def test_cuda_entry_points_refuse_cpu_tensors():
    q = torch.zeros(1, 1, 64, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_fwd(q, q, q, torch.zeros(1, 64, dtype=torch.int32))


@pytest.mark.parametrize("window,chunk", [(32, None), (32, 64), (128, None)])
def test_band_local_attention_matches_jax(window, chunk):
    q, k, v, g, seg = inputs(32, seed=window)
    fn_j = lambda a, b, c: jax_band(a, b, c, jnp.asarray(seg), window, chunk)  # noqa: E731
    out_j, vjp = jax.vjp(fn_j, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(x) for x in (out_j, *vjp(jnp.asarray(g)))]
    tseg = torch.from_numpy(seg)
    got = port_out_and_grads(lambda a, b, c: band_local_attention(a, b, c, tseg, window, chunk), q, k, v, g,
                             torch.float32)  # fmt: skip
    assert_close(got, want, 1e-5)
    # And the band is the windowed full-mask function.
    full = port_out_and_grads(lambda a, b, c: flash_attention(a, b, c, tseg, window), q, k, v, g, torch.float32)
    assert_close(got, full, 1e-5)
