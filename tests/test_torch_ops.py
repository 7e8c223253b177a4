"""The PyTorch port's tensor ops, distributions and random streams against JAX.

Same numpy inputs through ``eventstreamgpt_tpu`` and ``eventstreamgpt_tpu_torch``:
the sparse-feature ops, event selection, the time encoding, the data-element
compaction and every distribution's greedy statistic agree (integers and
selections exactly, floats within 1e-6). The port's counter-based streams
(`RowStreams`) are checked for what the engine relies on: values in (0, 1),
a row's draws independent of the other rows, and distinct draws per head
name, step and call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu import distributions as jd
from eventstreamgpt_tpu.data.types import EventStreamBatch as JaxBatch
from eventstreamgpt_tpu.generation.sampling import _greedy_draw
from eventstreamgpt_tpu.generation.sampling import compact_data_elements as jax_compact
from eventstreamgpt_tpu.models.transformer import TemporalPositionEncoding, time_from_deltas as jax_time
from eventstreamgpt_tpu.ops import tensor_ops as jops
from eventstreamgpt_tpu_torch import distributions as td
from eventstreamgpt_tpu_torch.data.types import EventStreamBatch
from eventstreamgpt_tpu_torch.generation.sampling import RowStreams, compact_data_elements, mix32
from eventstreamgpt_tpu_torch.models.transformer import temporal_position_encoding, time_from_deltas
from eventstreamgpt_tpu_torch.ops import tensor_ops as tops

TOL = dict(rtol=1e-6, atol=1e-6)
rng = np.random.default_rng(0)
T = torch.from_numpy


def close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def test_embedding_bags_match():
    table = rng.normal(size=(11, 5)).astype(np.float32)
    idx = rng.integers(0, 13, size=(3, 4, 6))  # 11, 12 are out of range: edge row, as JAX's clip
    w = rng.normal(size=(3, 4, 6)).astype(np.float32)
    gw = rng.normal(size=(3, 4, 2, 6)).astype(np.float32)
    close(tops.embedding_bag(T(table), T(idx), T(w)), jops.embedding_bag(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w)))
    close(tops.embedding_bag(T(table), T(idx)), jops.embedding_bag(jnp.asarray(table), jnp.asarray(idx)))
    close(
        tops.grouped_embedding_bag(T(table), T(idx), T(gw)),
        jops.grouped_embedding_bag(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(gw)),
    )


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_grouped_embedding_bag_gradient_matches(dtype):
    """Forward and table gradient against JAX, with most slots on padding index 0
    (the lookup is ``F.embedding(..., padding_idx=0)``; row 0's gradient is 0)."""
    table = rng.normal(size=(11, 5)).astype(np.float32)
    idx = rng.integers(0, 13, size=(3, 4, 9))
    idx[:, :, 3:] = 0  # padding duplicates, as a training batch has them
    gw = rng.normal(size=(3, 4, 3, 9)).astype(np.float32)
    cot = rng.normal(size=(3, 4, 3, 5)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jout, vjp = jax.vjp(lambda t: jops.grouped_embedding_bag(t, jnp.asarray(idx), jnp.asarray(gw)), jnp.asarray(table).astype(jdt))
    (jgrad,) = vjp(jnp.asarray(cot).astype(jdt))
    t = T(table).to(tdt).requires_grad_(True)
    out = tops.grouped_embedding_bag(t, T(idx), T(gw))
    out.backward(T(cot).to(tdt))
    tol = TOL if dtype == "fp32" else dict(rtol=2e-2, atol=2e-2)  # bf16: one rounding of each sum's terms
    close(out.detach().float(), jnp.asarray(jout, jnp.float32), **tol)
    close(t.grad.float(), jnp.asarray(jgrad, jnp.float32), **tol)
    assert not t.grad[0].any()


@pytest.mark.parametrize("grouped", [False, True], ids=["bag", "grouped"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_embedding_bag_gradient_credits_clipped_rows(dtype, grouped):
    """Negative indices read and credit row 0, indices >= V the last row, as
    JAX's clip gather does; index 0 (most slots, as padding) adds nothing.
    Forward and table gradient against ``jax.vjp``, row 0's gradient included."""
    table = rng.normal(size=(11, 5)).astype(np.float32)
    idx = rng.integers(-3, 15, size=(3, 4, 9))  # -3..-1 clip to row 0, 11..14 to row 10
    idx[:, :, 5:] = 0
    idx[0, 0, :3] = [-1, -2, 0]  # a bag whose only live slots are negative
    w = rng.normal(size=(3, 4, 3, 9) if grouped else (3, 4, 9)).astype(np.float32)
    cot = rng.normal(size=(3, 4, 3, 5) if grouped else (3, 4, 5)).astype(np.float32)
    jfn, tfn = (jops.grouped_embedding_bag, tops.grouped_embedding_bag) if grouped else (jops.embedding_bag, tops.embedding_bag)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jout, vjp = jax.vjp(lambda t: jfn(t, jnp.asarray(idx), jnp.asarray(w)), jnp.asarray(table).astype(jdt))
    (jgrad,) = vjp(jnp.asarray(cot).astype(jdt))
    t = T(table).to(tdt).requires_grad_(True)
    out = tfn(t, T(idx), T(w))
    out.backward(T(cot).to(tdt))
    tol = TOL if dtype == "fp32" else dict(rtol=2e-2, atol=2e-2)  # bf16: one rounding of each sum's terms
    close(out.detach().float(), jnp.asarray(jout, jnp.float32), **tol)
    close(t.grad.float(), jnp.asarray(jgrad, jnp.float32), **tol)
    close(t.grad[0].float(), jnp.asarray(jgrad, jnp.float32)[0], **tol)
    assert t.grad[0].abs().max() > 0.1  # row 0 is credited, not left at 0


def test_selection_ops_match():
    mi = rng.integers(0, 4, size=(5, 7))
    close(tops.measurement_index_normalization(T(mi)), jops.measurement_index_normalization(jnp.asarray(mi)))
    x = rng.normal(size=(4, 6, 3)).astype(np.float32)
    idx = np.array([0, 5, 2, 3])
    np.testing.assert_array_equal(tops.take_event(T(x), T(idx)).numpy(), np.asarray(jops.take_event(jnp.asarray(x), jnp.asarray(idx))))
    np.testing.assert_array_equal(tops.take_event(T(x), 4).numpy(), x[:, 4])
    plane, gi = rng.normal(size=(4, 9)).astype(np.float32), rng.integers(0, 9, size=(4, 3))
    np.testing.assert_array_equal(tops.gather_last(T(plane), T(gi)).numpy(), np.asarray(jops.gather_last(jnp.asarray(plane), jnp.asarray(gi))))
    seg = np.array([[0, 0, 1, 1, 1], [0, 1, 1, 2, 2]])
    np.testing.assert_array_equal(tops.segment_starts(T(seg)).numpy(), np.asarray(jops.segment_starts(jnp.asarray(seg))))


@pytest.mark.parametrize("packed", [False, True])
def test_time_and_temporal_encoding_match(packed):
    em = rng.random((3, 6)) < 0.8
    td_ = rng.uniform(0.5, 30.0, size=(3, 6)).astype(np.float32)
    seg = np.array([[0, 0, 0, 1, 1, 1], [0, 1, 1, 1, 2, 2], [0] * 6]) if packed else None
    jt = jax_time(JaxBatch(event_mask=jnp.asarray(em), time_delta=jnp.asarray(td_),
                           segment_ids=None if seg is None else jnp.asarray(seg)))  # fmt: skip
    tt = time_from_deltas(EventStreamBatch(event_mask=T(em), time_delta=T(td_), segment_ids=None if seg is None else T(seg)))
    close(tt, jt)
    for dim in (8, 7):
        want = TemporalPositionEncoding(embedding_dim=dim).apply({}, jnp.asarray(np.asarray(jt)))
        close(temporal_position_encoding(tt, dim), want, rtol=1e-5, atol=1e-5)


def test_compaction_matches():
    idx = rng.integers(0, 3, size=(4, 9)) * rng.integers(1, 20, size=(4, 9))
    meas = rng.integers(1, 4, size=(4, 9))
    vals = rng.normal(size=(4, 9)).astype(np.float32)
    vmask = rng.random((4, 9)) < 0.5
    for width in (5, 12):
        want = jax_compact(*(jnp.asarray(a) for a in (idx, meas, vals, vmask)), width)
        got = compact_data_elements(T(idx), T(meas), T(vals), T(vmask), width)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_greedy_statistics_match():
    logits = rng.normal(size=(5, 7)).astype(np.float32)
    loc, raw = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(5, 3)).astype(np.float32)
    pairs = [
        (jd.Categorical(jnp.asarray(logits)), td.Categorical(T(logits))),
        (jd.Bernoulli(jnp.asarray(logits)), td.Bernoulli(T(logits))),
        (jd.Normal(jnp.asarray(loc), jnp.exp(jnp.asarray(raw))), td.Normal(T(loc), torch.exp(T(raw)))),
        (jd.Exponential(jnp.exp(jnp.asarray(raw))), td.Exponential(torch.exp(T(raw)))),
        (
            jd.LogNormalMixture(jnp.asarray(loc), jnp.asarray(raw) * 0.3, jnp.asarray(logits[:, :3]), 1.5, 0.7),
            td.LogNormalMixture(T(loc), T(raw) * 0.3, T(logits[:, :3]), 1.5, 0.7),
        ),
    ]
    for j, t in pairs:
        close(t.greedy().float(), np.asarray(_greedy_draw(j), np.float32), rtol=1e-5, atol=1e-6)


def test_torch_generator_sampling_is_reproducible_and_calibrated():
    p = torch.full((4000,), 0.3)
    draws = [td.Bernoulli(torch.logit(p)).sample(torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert abs(draws[0].mean().item() - 0.3) < 0.03
    z = td.Normal(torch.zeros(4000), torch.ones(4000)).sample(torch.Generator().manual_seed(3))
    assert abs(z.mean().item()) < 0.06 and abs(z.std().item() - 1) < 0.06


def test_row_streams():
    assert mix32(0) == 0 and len({mix32(i) for i in range(1000)}) == 1000
    seeds, counters = torch.tensor([11, 12, 13]), torch.tensor([0, 5, 5])
    u = RowStreams(seeds, counters).for_name("cls:a").uniform((3, 1000))
    assert u.min() > 0 and u.max() < 1 and abs(u.mean().item() - 0.5) < 0.03
    # A row's numbers do not depend on the other rows or their order.
    alone = RowStreams(seeds[1:2], counters[1:2]).for_name("cls:a").uniform((1, 1000))
    assert torch.equal(alone[0], u[1])
    flipped = RowStreams(seeds.flip(0), counters.flip(0)).for_name("cls:a").uniform((3, 1000))
    assert torch.equal(flipped.flip(0), u)
    # Another head, step or call draws other numbers.
    s = RowStreams(seeds, counters).for_name("cls:a")
    first, second = s.uniform((3, 1000)), s.uniform((3, 1000))
    assert torch.equal(first, u) and not torch.equal(first, second)
    assert not torch.equal(RowStreams(seeds, counters).for_name("cls:b").uniform((3, 1000)), u)
    assert not torch.equal(RowStreams(seeds, counters + 1).for_name("cls:a").uniform((3, 1000)), u)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_grad_equals_the_embedding_backward(dtype):
    """`table_grad` (the port's embedding-table gradient on the card, summed
    in fp32 in one fixed order) against an fp64 sum of the same cotangents by
    index, with runs longer than a partial sum and a padding index: within
    one rounding of the output type (fp32: 1e-5), row 0 zero; and, in fp32,
    against ``aten.embedding_dense_backward`` on the CPU within 1e-5."""
    from eventstreamgpt_tpu_torch.ops.tensor_ops import table_grad

    g = torch.Generator().manual_seed(0)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=8e-3, atol=8e-3)
    for n, rows in ((7, 3), (3000, 5), (9000, 700)):
        idx = torch.randint(0, rows, (n,), generator=g)
        idx[torch.rand(n, generator=g) < 0.4] = 0
        cot = torch.randn(n, 16, generator=g).to(dtype)
        got = table_grad(idx, cot, rows).to(dtype)
        exact = torch.zeros(rows, 16, dtype=torch.float64).index_add_(0, idx, cot.double())
        exact[0] = 0
        torch.testing.assert_close(got.double(), exact.to(dtype).double(), **tol)
        assert not got[0].any()
        if dtype == torch.float32:
            torch.testing.assert_close(got, torch.ops.aten.embedding_dense_backward(cot, idx, rows, 0, False), **tol)
