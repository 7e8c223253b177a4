"""Kernel A (fused categorical sampling) of the PyTorch port against the JAX kernel.

The JAX side runs its Pallas kernel in interpret mode (``_sample_2d(...,
interpret=True)``) with the Gumbel noise passed in; the port's side is the
plain PyTorch version the wrapper runs on CPU tensors. Same logits, noise
and keep mask, made with numpy: the indices agree exactly, in fp32 and
bf16, ties included. The Triton kernel itself is checked on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.ops.fused_sampling import _sample_2d
from eventstreamgpt_tpu.ops.fused_sampling import topk_topp_mask as jax_topk_topp_mask
from eventstreamgpt_tpu_torch.ops.fused_sampling import (
    fused_categorical,
    fused_categorical_reference,
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

