"""Kernel C's plain version against the JAX kernel in interpret mode.

`eventstreamgpt_tpu_torch.ops.vocab_gather.vocab_gather` runs its plain
PyTorch version on CPU tensors (the CUDA kernel is held against that plain
version on the card, ``tests/test_torch_kernels_cuda.py``). Here it is held
against ``eventstreamgpt_tpu.ops.pallas_heads.vocab_gather(impl=
"pallas_interpret")``, the TPU kernel itself, on the same numpy-made inputs:

* forward bit-exact in fp32 and bf16 (each output is one plane element,
  upcast; an index outside ``[0, V)`` gives 0);
* backward through autograd within rtol 1e-6 in fp32 (atol 1e-6: the two
  sum duplicate indices' O(1) cotangents in different orders) and within
  one bf16 ulp in bf16 (both sum in fp32 and round once).

Shapes cover duplicate indices, negative and too-large indices, V and M
that are not multiples of 128 (nor M of 4), and 3-D leading shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.ops.pallas_heads import vocab_gather as jax_vocab_gather
from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather, vocab_gather_bwd, vocab_gather_fwd

SHAPES = {
    "2d_small": ((7,), 5, 3),
    "2d_odd": ((33,), 200, 48),
    "3d": ((2, 5), 130, 130),
    "3d_wide": ((3, 4), 1000, 20),
    "2d_m50": ((17,), 300, 50),  # M % 4 != 0: the CUDA forward's one-slot-a-thread path
}
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def inputs(lead, V, M, seed):
    """A plane, indices with many duplicates and out-of-range entries, a cotangent."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=lead + (V,)).astype(np.float32)
    ci = rng.integers(0, V, size=lead + (M,))
    ci[..., : max(M // 3, 1)] = rng.integers(0, 2, size=lead + (max(M // 3, 1),))  # duplicates of 0 and 1
    flat = ci.reshape(-1, M)
    flat[::3, -1] = -1
    flat[1::5, -1] = V + 3
    flat[2::4, 0] = -7
    g = rng.normal(size=lead + (M,)).astype(np.float32)
    return z, flat.reshape(ci.shape).astype(np.int32), g


def run_port(z, ci, g, dtype):
    zt = torch.from_numpy(z).to(dtype).requires_grad_(True)
    out = vocab_gather(zt, torch.from_numpy(ci))
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32 and zt.grad.dtype == dtype
    return out.detach().numpy(), zt.grad.float().numpy()


def run_jax(z, ci, g, dtype):
    out, vjp = jax.vjp(lambda zz: jax_vocab_gather(zz, jnp.asarray(ci), impl="pallas_interpret"), jnp.asarray(z, dtype))
    (dz,) = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dz.astype(jnp.float32))


def bf16_ulp(x):
    """One bf16 unit in the last place at each magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_matches_jax_kernel(shape, dtype):
    lead, V, M = SHAPES[shape]
    z, ci, g = inputs(lead, V, M, seed=V + M)
    tdt, jdt = DTYPES[dtype]
    got, got_dz = run_port(z, ci, g, tdt)
    want, want_dz = run_jax(z, ci, g, jdt)
    np.testing.assert_array_equal(got, want)  # bit-exact forward
    assert not got[ci < 0].any() and not got[ci >= V].any()
    if dtype == "fp32":
        np.testing.assert_allclose(got_dz, want_dz, rtol=1e-6, atol=1e-6)
    else:
        diff = np.abs(got_dz - want_dz)
        assert (diff <= bf16_ulp(np.maximum(np.abs(got_dz), np.abs(want_dz)))).all(), diff.max()


def test_backward_sums_duplicates_and_drops_out_of_range():
    z = torch.zeros(1, 4, requires_grad=True)
    ci = torch.tensor([[1, 1, -1, 4, 3, 1]], dtype=torch.int32)
    vocab_gather(z, ci).backward(torch.tensor([[1.0, 2.0, 100.0, 100.0, 5.0, 4.0]]))
    assert z.grad.tolist() == [[0.0, 7.0, 0.0, 5.0]]


def test_kernel_entry_points_refuse_cpu_and_other_devices():
    z, ci = torch.zeros(2, 8), torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        vocab_gather_fwd(z, ci)
    with pytest.raises(ValueError, match="CUDA"):
        vocab_gather_bwd(torch.zeros(2, 3), ci, 8, torch.float32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        vocab_gather(z.to("meta"), ci.to("meta"))
