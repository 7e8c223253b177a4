"""Kernel A (fused categorical sampling) of the PyTorch port against the JAX kernel.

The JAX side runs its Pallas kernel in interpret mode (``_sample_2d(...,
interpret=True)``) with the Gumbel noise passed in; the port's side is the
plain PyTorch version the wrapper runs on CPU tensors. Same logits, noise
and keep mask, made with numpy: the indices agree exactly, in fp32 and
bf16, ties included. The CUDA kernel itself is checked on the card
(``tests/test_torch_kernels_cuda.py``).

The stream entry (`fused_categorical_stream`, the noise drawn inside the
kernel from a `RowStreams`) is specified here: a numpy ``uint32`` version of
the counter hash and of the uniforms, written in this file, equals
`RowStreams.uniform` bit for bit, and ``-log(-log(u))`` of those uniforms
(with ATen's fp32 log, the one operation the contract takes from the
library) equals ``gumbel(stream)`` bit for bit. The CUDA kernel is held to
that noise on the card.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.ops.fused_sampling import _sample_2d
from eventstreamgpt_tpu.ops.fused_sampling import fused_categorical as jax_fused_categorical
from eventstreamgpt_tpu.ops.fused_sampling import topk_topp_mask as jax_topk_topp_mask
from eventstreamgpt_tpu_torch.distributions import gumbel
from eventstreamgpt_tpu_torch.generation.sampling import RowStreams
from eventstreamgpt_tpu_torch.ops.fused_sampling import (
    fused_categorical,
    fused_categorical_reference,
    fused_categorical_stream,
    topk_topp_mask,
)

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def planes(rows, V, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:  # coarse integer logits and no noise on half the rows: many exact ties
        z = rng.integers(-2, 3, size=(rows, V)).astype(np.float32)
        g = rng.gumbel(size=(rows, V)).astype(np.float32)
        g[::2] = 0.0
    else:
        z = (rng.normal(size=(rows, V)) * 3).astype(np.float32)
        g = rng.gumbel(size=(rows, V)).astype(np.float32)
    keep = rng.random((rows, V)) < 0.6
    return z, g, keep


def both(arr, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(arr, jdt), torch.from_numpy(arr).to(tdt)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("with_keep", [False, True], ids=["no_keep", "keep"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_indices_match_pallas_kernel_exactly(dtype, with_keep, ties):
    z, g, keep = planes(37, 40, seed=3, ties=ties)
    jz, tz = both(z, dtype)
    jg, tg = both(g, dtype)
    jk = jnp.asarray(keep) if with_keep else None
    tk = torch.from_numpy(keep) if with_keep else None
    want = np.asarray(_sample_2d(jz, jg, jk, interpret=True))
    got = fused_categorical_reference(tz, tg, tk).numpy()
    np.testing.assert_array_equal(got, want)
    # The wrapper takes the plain version for CPU tensors.
    np.testing.assert_array_equal(fused_categorical(tz, tg, tk).numpy(), want)


def test_active_rows_take_fill():
    z, g, _ = planes(9, 40, seed=4)
    active = np.arange(9) % 3 != 0
    want = np.where(active, np.asarray(_sample_2d(jnp.asarray(z), jnp.asarray(g), None, interpret=True)), -7)
    got = fused_categorical(torch.from_numpy(z), torch.from_numpy(g), active=torch.from_numpy(active), fill=-7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_shape_is_kept():
    z, g, _ = planes(6, 11, seed=5)
    got = fused_categorical(torch.from_numpy(z).reshape(2, 3, 11), torch.from_numpy(g).reshape(2, 3, 11))
    want = np.asarray(_sample_2d(jnp.asarray(z), jnp.asarray(g), None, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want.reshape(2, 3))


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.7), (3, 0.9), (1, None), (None, 0.95)])
def test_topk_topp_mask_matches_jax(top_k, top_p):
    z, _, _ = planes(16, 40, seed=6)
    z[0, :4] = z[0, 4]  # a tie at the cutoff is kept (tie-inclusive)
    want = np.asarray(jax_topk_topp_mask(jnp.asarray(z), top_k, top_p))
    got = topk_topp_mask(torch.from_numpy(z), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_filters_off_and_bad_values():
    z = torch.zeros(2, 5)
    assert topk_topp_mask(z) is None
    with pytest.raises(ValueError):
        topk_topp_mask(z, top_k=0)
    with pytest.raises(ValueError):
        topk_topp_mask(z, top_p=1.5)



# ------------------------------------------------ the stream entry's noise
GOLDEN = np.uint32(0x9E3779B9)


def np_mix32(x):
    """lowbias32 on uint32 arrays (numpy wraps the products mod 2**32)."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def np_uniform(seeds, counters, salt, draw, n):
    """Draw ``draw`` of a stream salted ``salt``: ``(B, n)`` fp32 uniforms."""
    draw_salt = np.uint32((salt + draw * 0x9E3779B9) & 0xFFFFFFFF)
    low = np.uint64(0xFFFFFFFF)
    s32 = (seeds.astype(np.uint64) & low).astype(np.uint32)
    c32 = (counters.astype(np.uint64) & low).astype(np.uint32)
    key = np_mix32(np_mix32(np_mix32(s32) ^ c32) ^ draw_salt)
    bits = np_mix32(key[:, None] + np.arange(n, dtype=np.uint32)[None, :] * GOLDEN)
    return ((bits >> np.uint32(8)).astype(np.float32) + np.float32(0.5)) * np.float32(2.0**-24)


def stream_inputs(B, seed):
    """Seeds and counters over the whole int64 range (negative ones too) and a salt."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(-(2**62), 2**62, size=B, dtype=np.int64)
    counters = rng.integers(0, 2**40, size=B, dtype=np.int64)
    return seeds, counters, int(rng.integers(0, 2**32))


def make_stream(seeds, counters, salt):
    return RowStreams(torch.from_numpy(seeds), torch.from_numpy(counters), salt)


@pytest.mark.parametrize("shape", [(1, 1), (7, 40), (3, 5, 11), (33, 4057)], ids=str)
def test_uniform_and_gumbel_match_the_numpy_specification(shape):
    seeds, counters, salt = stream_inputs(shape[0], seed=len(shape) * 100 + shape[-1])
    n = int(np.prod(shape[1:]))
    stream = make_stream(seeds, counters, salt)
    for draw in range(3):  # each call is the stream's next draw
        want = np_uniform(seeds, counters, salt, draw, n).reshape(shape)
        got = stream.uniform(shape).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert (want > 0).all() and (want <= 1).all()
    stream = make_stream(seeds, counters, salt)
    u = np_uniform(seeds, counters, salt, 0, n).reshape(shape)
    want = -torch.log(-torch.log(torch.from_numpy(u)))
    got = gumbel(stream, shape, "cpu")
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
    # ATen's log stays within float rounding of the float64 function: the
    # inner log's rounding (relative 6e-8) reaches g as an absolute error.
    with np.errstate(divide="ignore"):
        exact = -np.log(-np.log(u.astype(np.float64)))
    finite = np.isfinite(exact)
    np.testing.assert_allclose(got.numpy()[finite], exact[finite], rtol=2e-6, atol=5e-7)


def test_named_streams_hash_their_names():
    seeds, counters, _ = stream_inputs(4, seed=9)
    named = make_stream(seeds, counters, 0).for_name("cls:event_type")
    want = np_uniform(seeds, counters, zlib.crc32(b"cls:event_type"), 0, 40)
    np.testing.assert_array_equal(named.uniform((4, 40)).numpy(), want)


@pytest.mark.parametrize("with_active", [False, True], ids=["all_active", "active"])
@pytest.mark.parametrize("with_keep", [False, True], ids=["no_keep", "keep"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stream_entry_matches_reference_and_pallas_kernel(dtype, with_keep, with_active):
    rows, V = 37, 40
    z, _, keep = planes(rows, V, seed=11)
    seeds, counters, salt = stream_inputs(rows, seed=12)
    active = np.arange(rows) % 4 != 1
    jdt, tdt = DTYPES[dtype]
    tz = torch.from_numpy(z).to(tdt)
    tk = torch.from_numpy(keep) if with_keep else None
    ta = torch.from_numpy(active) if with_active else None
    got = fused_categorical_stream(tz, make_stream(seeds, counters, salt), tk, ta, fill=-3)
    noise = gumbel(make_stream(seeds, counters, salt), (rows, V), "cpu").to(tdt)
    np.testing.assert_array_equal(got.numpy(), fused_categorical_reference(tz, noise, tk, ta, fill=-3).numpy())
    jg = jnp.asarray(noise.float().numpy(), jdt)
    want = np.asarray(_sample_2d(jnp.asarray(z, jdt), jg, jnp.asarray(keep) if with_keep else None, interpret=True))
    if with_active:
        want = np.where(active, want, -3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_stream_entry_advances_the_stream_as_uniform_does():
    rows, V = 6, 40
    z, _, _ = planes(rows, V, seed=13)
    seeds, counters, salt = stream_inputs(rows, seed=14)
    kernel_stream, plain_stream = make_stream(seeds, counters, salt), make_stream(seeds, counters, salt)
    tz = torch.from_numpy(z)
    for _ in range(2):  # two draws in a row
        got = fused_categorical_stream(tz, kernel_stream)
        want = fused_categorical_reference(tz, gumbel(plain_stream, (rows, V), "cpu"))
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert kernel_stream.next_draw_salt() == plain_stream.next_draw_salt()
    first, second = (make_stream(seeds, counters, salt).next_draw_salt() for _ in range(2))
    assert first == second == salt


def test_stream_entry_keeps_leading_shape_and_strided_rows():
    B, X, V = 4, 3, 40
    wide = torch.from_numpy(planes(B * X, 2 * V, seed=15)[0]).reshape(B, X, 2 * V)
    logits = wide[..., 5 : 5 + V]  # columns of a wider plane, as the heads slice theirs
    seeds, counters, salt = stream_inputs(B, seed=16)
    got = fused_categorical_stream(logits, make_stream(seeds, counters, salt))
    noise = gumbel(make_stream(seeds, counters, salt), (B, X, V), "cpu")
    assert got.shape == (B, X)
    np.testing.assert_array_equal(got.numpy(), fused_categorical_reference(logits, noise).numpy())


def test_stream_entry_refuses_a_stream_of_other_rows():
    seeds, counters, salt = stream_inputs(3, seed=17)
    with pytest.raises(ValueError, match="rows"):
        fused_categorical_stream(torch.zeros(4, 5), make_stream(seeds, counters, salt))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_edge_rows(dtype):
    """A NaN row gives V in the port and in the JAX kernel. An all--inf row
    gives 0 in the port and in JAX's ``impl="xla"`` draw (its argmax); JAX's
    Pallas kernel pads its lanes to 128 with the fp32 minimum, which stays
    finite in fp32 and wins the argmax there (V at V = 40), and rounds to
    -inf in bf16 (0). The port follows ``jax.random.categorical``'s
    contract, 0."""
    rows, V = 8, 40
    jdt, tdt = DTYPES[dtype]
    z, g, _ = planes(rows, V, seed=18)
    z[1, 7] = np.nan
    z[2, :] = -np.inf
    z[3, 9] = np.inf
    got = fused_categorical(torch.from_numpy(z).to(tdt), torch.from_numpy(g).to(tdt)).numpy()
    pallas = np.asarray(_sample_2d(jnp.asarray(z, jdt), jnp.asarray(g, jdt), None, interpret=True))
    assert got[1] == V and pallas[1] == V
    assert got[2] == 0 and pallas[2] == (V if dtype == "fp32" else 0)
    assert got[3] == 9 and pallas[3] == 9
    np.testing.assert_array_equal(np.delete(got, [1, 2]), np.delete(pallas, [1, 2]))
    xla = np.asarray(jax_fused_categorical(jnp.asarray(z, jdt), jax.random.PRNGKey(0), impl="xla"))
    assert xla[2] == 0 and xla[3] == 9
    seeds, counters, salt = stream_inputs(rows, seed=19)
    streamed = fused_categorical_stream(torch.from_numpy(z).to(tdt), make_stream(seeds, counters, salt)).numpy()
    assert (streamed[1], streamed[2], streamed[3]) == (V, 0, 9)
