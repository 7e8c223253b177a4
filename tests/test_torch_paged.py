"""The PyTorch port's paged copy-on-write KV cache and ``fork()`` against the JAX engine's, on the CPU.

At ``tests/test_paged_cache.py``'s sizes (8 positions, blocks of 4), with
`tests/test_torch_engine.py`'s models (JAX weights carried by
`load_jax_params`):

* one cached step through `PagedKVCache` (float, int8 and fp8 pools): the
  predictions and the pool as JAX's, the drop rule (a row on the zero block
  writes nothing), and bit for bit the port's monolithic per-row step;
* the greedy paged engine against the JAX paged engine on mixed and fork
  traffic: every integer and structure field exact, floats within 1e-4; the
  host block tables, every ``block_pool_*`` and fork counter and the
  ``paged`` capacity report equal to JAX's (int8 pools too);
* the paged engine equals the monolithic engine's unfused step
  (``decode_step_impl="xla"``) bit for bit, fp32, bf16, int8 and fp8;
* a sampled ``fork()`` equals independent submissions with
  ``derive_request_seed(session, j)`` (JAX's ``TestForkDeterminism``): one
  prefill, branches that diverge after the shared prompt, results invariant
  to co-residents, admission order and ``decode_chunk``; an unkeyed fork's
  session is branch 0's admission-index seed;
* results invariant to ``dispatch_depth``; block 0 all zero after every
  run; ``reset()`` frees the pool and keeps its high-water mark;
* the allocator's always-on guards raise `BlockLedgerError`;
* the captured path's control flow (a stand-in graph that reruns each
  program): one prefill replay a fork group, as for any group, results
  equal the eager engine's.
"""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.models.transformer import PagedKVCache as JaxPagedKVCache
from eventstreamgpt_tpu.ops import kv_quant as jkq
from eventstreamgpt_tpu.serving import GenerationEngine as JaxEngine
from eventstreamgpt_tpu.serving import Request as JaxRequest
from eventstreamgpt_tpu_torch.convert import load_jax_params
from eventstreamgpt_tpu_torch.generation.sampling import derive_request_seed
from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.models.transformer import KVCache, PagedKVCache, init_kv_caches
from eventstreamgpt_tpu_torch.serving import BlockLedgerError, GenerationEngine, Request
from eventstreamgpt_tpu_torch.utils.graphs import CapturedProgram, ProgramFamily

from .test_torch_engine import CLOSE, ENGINE, EXACT, MAX_LEN, assert_same_results, build, by_id, to_torch
from .test_torch_kv_quant import codes
from .test_torch_model import assert_preds_close, build_pair, jax_config
from .test_torch_prefill import RerunGraph

BLOCK = 4
PAGED = dict(paged_kv=True, block_size=BLOCK)
POOL_DTYPES = {None: torch.float32, "int8": torch.int8, "fp8": torch.float8_e4m3fn}
# The JAX paged report's keys that depend on the weights' bytes (the budget), not on the pool.
BUDGET_KEYS = ("pool_budget_bytes", "max_pool_blocks_in_budget")


def mixed_rows(prompt, n, start=0):
    """(id, row, budget) for n requests of 3 and 4 events over the prompt's rows."""
    out = []
    for i in range(start, start + n):
        Lp = 3 if i % 2 == 0 else 4
        out.append((i, prompt.slice((slice(i % 4, i % 4 + 1), slice(0, Lp))), MAX_LEN - Lp - (i % 3 == 2)))
    return out


def port_mixed(prompt, n, start=0, keyed=True):
    return [Request(prompt=to_torch(p), max_new_events=b, request_id=i, key=1000 + i if keyed else None)
            for i, p, b in mixed_rows(prompt, n, start)]  # fmt: skip


def fork_row(prompt, n_events=3):
    return prompt.slice((slice(0, 1), slice(0, n_events)))


def run_engine(eng, traffic) -> dict:
    """Submits ``traffic`` (requests, or ``("fork", row, branches, budget, session)``) in order and runs."""
    for item in traffic:
        if isinstance(item, tuple):
            _, row, n, budget, session = item
            eng.fork(row, n, budget, key=session, request_id="f")
        else:
            eng.submit(item)
    return by_id(eng.run())


def assert_match_jax(jres, tres):
    assert sorted(jres, key=str) == sorted(tres, key=str)
    for i, j in jres.items():
        t = tres[i]
        assert t.error is None and j.error is None
        for f in ("admission_index", "prompt_len", "n_events", "n_generated"):
            assert getattr(t, f) == getattr(j, f), (i, f)
        for f in EXACT:
            np.testing.assert_array_equal(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), err_msg=f)
        for f in CLOSE:
            np.testing.assert_allclose(
                getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), rtol=1e-4, atol=1e-4, err_msg=f
            )


def assert_same_pool_accounting(jeng, teng):
    """Host tables, block-pool and fork counters, and the paged report as the JAX engine's."""
    np.testing.assert_array_equal(teng._tables, jeng._tables)
    jrep, trep = jeng.scheduler.padding_report(), teng.scheduler.padding_report()
    keys = [k for k in jrep if k.startswith(("block_pool_", "fork_", "prefill_"))]
    assert len(keys) == 17 and {k: trep[k] for k in keys} == {k: jrep[k] for k in keys}
    jpaged, tpaged = (e.slots_report(hbm_gb=16.0)["paged"] for e in (jeng, teng))
    assert {k: v for k, v in tpaged.items() if k not in BUDGET_KEYS} == {
        k: v for k, v in jpaged.items() if k not in BUDGET_KEYS
    }


def assert_zero_block(eng):
    """Block 0 of every pool plane all zero (its scales, quantized, all one)."""
    assert eng.paged_kv and not eng.key_cache[:, 0].view(torch.uint8).any()
    assert not eng.value_cache[:, 0].view(torch.uint8).any()
    for scale in (eng.key_scale, eng.value_scale):
        assert scale is None or bool((scale[:, 0] == 1).all())


# ---------------------------------------------------------------- the cache
def _pool(planes, scales, tables, n_blocks):
    """Each row's blocks of monolithic ``planes`` (B, H, M, D) laid out in a pool at its ``tables`` row."""
    B, H, M, D = planes.shape
    pool = np.zeros((n_blocks, H, BLOCK, D), planes.dtype)
    spool = None if scales is None else np.ones((n_blocks, H, BLOCK), np.float32)
    for b in range(B):
        for j, phys in enumerate(tables[b]):
            if phys:
                pool[phys] = planes[b, :, j * BLOCK : (j + 1) * BLOCK]
                if spool is not None:
                    spool[phys] = scales[b, :, j * BLOCK : (j + 1) * BLOCK]
    return pool, spool


@pytest.mark.parametrize("name", sorted(POOL_DTYPES, key=str), ids=lambda n: str(n or "float"))
def test_paged_step_matches_jax_and_the_monolithic_step(name):
    """Four rows prefilled with 4 events; rows 0 and 1 hold both their
    blocks, row 2 only its first (its cursor's block is the zero block) and
    row 3 none (a row never admitted). One cached step through the pool:
    predictions within 1e-5 of JAX's and the pool's codes equal to JAX's;
    rows 2 and 3 write nothing (block 0 stays zero); rows 0 and 1 equal
    the port's monolithic per-row step bit for bit, their blocks the planes."""
    jcfg = jax_config()
    jmodel, params, tmodel, prompt = build_pair(jcfg)
    B, n_pre, n_blocks = prompt.batch_size, 4, 6
    head = prompt.slice((slice(None), slice(0, n_pre)))
    step = prompt.slice((slice(None), slice(n_pre, n_pre + 1)))
    step = step.replace(time=np.asarray(prompt.time_delta)[:, :n_pre].sum(-1, keepdims=True))
    with torch.no_grad():
        tpre = tmodel(to_torch(head), past=init_kv_caches(tmodel.config, B, MAX_LEN, "cpu", cache_dtype=name),
                      use_cache=True)  # fmt: skip
    tables = np.array([[1, 2], [3, 4], [5, 0], [0, 0]], np.int32)
    length = torch.full((B,), n_pre, dtype=torch.int32)

    def as_np(x):
        return None if x is None else codes(x) if x.dtype != torch.float32 else x.numpy()

    jpast, tpast, mono = [], [], []
    for c in tpre.past_key_values:
        pk, pks = _pool(as_np(c.key), as_np(c.key_scale), tables, n_blocks)
        pv, pvs = _pool(as_np(c.value), as_np(c.value_scale), tables, n_blocks)
        jdt = {None: np.float32, "int8": np.int8, "fp8": jkq.FP8_DTYPE}[name]
        jpast.append(JaxPagedKVCache(
            pool_key=jax.numpy.asarray(pk).view(jdt), pool_value=jax.numpy.asarray(pv).view(jdt),
            block_table=jax.numpy.asarray(tables), mask=jax.numpy.asarray(c.mask.numpy()),
            length=jax.numpy.full((B,), n_pre, jax.numpy.int32),
            pool_key_scale=None if pks is None else jax.numpy.asarray(pks),
            pool_value_scale=None if pvs is None else jax.numpy.asarray(pvs),
        ))  # fmt: skip
        tdt = POOL_DTYPES[name]
        tpast.append(PagedKVCache(
            torch.from_numpy(pk).view(tdt), torch.from_numpy(pv).view(tdt), torch.from_numpy(tables), c.mask,
            length, None if pks is None else torch.from_numpy(pks), None if pvs is None else torch.from_numpy(pvs),
        ))  # fmt: skip
        mono.append(KVCache(c.key, c.value, c.mask, length, c.key_scale, c.value_scale))
    jout = jmodel.apply(params, step, past=tuple(jpast), use_cache=True, is_generation=True)
    with torch.no_grad():
        tout = tmodel(to_torch(step), past=tuple(tpast), use_cache=True)
        mout = tmodel(to_torch(step), past=tuple(mono), use_cache=True)
    assert_preds_close(jout.preds, tout.preds)
    for jc, tc, mc in zip(jout.past_key_values, tout.past_key_values, mout.past_key_values):
        assert tc.pool_key is not None and torch.equal(tc.length, length + 1)
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
        for t, j in ((tc.pool_key, jc.pool_key), (tc.pool_value, jc.pool_value)):
            if name is None:
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(codes(t), codes(j))
            assert not codes(t)[0].any()
        if name is not None:
            for t, j in ((tc.pool_key_scale, jc.pool_key_scale), (tc.pool_value_scale, jc.pool_value_scale)):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=0)
        # Rows 0 and 1: the gathered view is the monolithic planes, bit for bit.
        for t, m in ((tc.pool_key, mc.key), (tc.pool_value, mc.value)):
            view = tc.gather(t)
            assert torch.equal(view[:2].view(torch.uint8), m[:2].view(torch.uint8))
    for f in ("classification", "regression"):
        for k, pair in (getattr(tout.preds, f) or {}).items():
            for a, b in zip(pair, getattr(mout.preds, f)[k]):
                for x, y in zip(vars(a).values(), vars(b).values()) if a is not None else ():
                    assert torch.equal(x[:2], y[:2]), (f, k)


@pytest.mark.parametrize("name", sorted(POOL_DTYPES, key=str), ids=lambda n: str(n or "float"))
def test_init_paged_kv_caches_and_block_bytes_match_jax(name):
    """`init_paged_kv_caches` lays out JAX's pools (zeros, unit scales, zero
    tables) and `paged_kv_bytes_per_block` counts JAX's bytes."""
    from eventstreamgpt_tpu.models.transformer import init_paged_kv_caches as jax_init_paged
    from eventstreamgpt_tpu.models.transformer import paged_kv_bytes_per_block as jax_block_bytes
    from eventstreamgpt_tpu_torch.models.transformer import init_paged_kv_caches, paged_kv_bytes_per_block

    jcfg = jax_config()
    tcfg = StructuredTransformerConfig.from_dict(jcfg.to_dict())
    jc = jax_init_paged(jcfg, 3, 7, BLOCK, max_len=MAX_LEN, cache_dtype=name)
    tc = init_paged_kv_caches(tcfg, 3, 7, BLOCK, "cpu", max_len=MAX_LEN, cache_dtype=name)
    assert len(tc) == len(jc) == tcfg.num_hidden_layers
    for t, j in zip(tc, jc):
        assert (t.num_blocks, t.block_size, t.max_len) == (j.num_blocks, j.block_size, j.max_len) == (7, BLOCK, MAX_LEN)
        assert t.pool_key.dtype == POOL_DTYPES[name] and t.quantized == (name is not None)
        for a, b in ((t.pool_key, j.pool_key), (t.block_table, j.block_table), (t.mask, j.mask), (t.length, j.length)):
            assert tuple(a.shape) == b.shape and not codes(a).any() and not np.asarray(b).any()
        if name is not None:
            assert tuple(t.pool_key_scale.shape) == j.pool_key_scale.shape and bool((t.pool_key_scale == 1).all())
    for dtype in ("bf16", "fp32", "int8", "fp8"):
        assert paged_kv_bytes_per_block(2, 4, 16, 64, dtype, torch.float32) == jax_block_bytes(
            2, 4, 16, 64, dtype, jax.numpy.float32
        )


# --------------------------------------------------------- against JAX
@functools.lru_cache(maxsize=None)
def _engine_pair(name, kv_cache_dtype):
    jcfg, jmodel, params, tcfg, tmodel, prompt = build(name)
    kw = dict(ENGINE, n_slots=4, greedy=True, kv_cache_dtype=kv_cache_dtype, **PAGED)
    jeng = JaxEngine(jmodel, params, jcfg, template=prompt, **kw)
    return jeng, GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **kw), prompt


def engine_pair(name, kv_cache_dtype=None):
    """The greedy paged engines of JAX and of the port at 4 slots, built once
    a (model, cache type) in this module, so the JAX engine's programs
    compile once, and ``reset()`` on both for each use. Both have served the
    same traffic before, so the lifetime counters a reset keeps agree too."""
    jeng, teng, prompt = _engine_pair(name, kv_cache_dtype)
    jeng.reset()
    teng.reset()
    return jeng, teng, prompt


@pytest.mark.parametrize("name", ["global_exponential", "local_lognormal"])
def test_greedy_paged_engine_matches_jax_paged_engine(name):
    """Mixed requests with a fork of three branches between them, through 4
    slots and blocks of 4: the port's results as JAX's, and its block
    tables, pool and fork counters and paged report equal to JAX's."""
    jeng, teng, prompt = engine_pair(name)
    row = fork_row(prompt)
    jtraffic = [JaxRequest(prompt=p, max_new_events=b, request_id=i) for i, p, b in mixed_rows(prompt, 3)]
    jtraffic += [("fork", row, 3, 4, jax.random.PRNGKey(7))]
    jtraffic += [JaxRequest(prompt=p, max_new_events=b, request_id=i) for i, p, b in mixed_rows(prompt, 3, 3)]
    ttraffic = port_mixed(prompt, 3, keyed=False) + [("fork", to_torch(row), 3, 4, 7)]
    ttraffic += port_mixed(prompt, 3, 3, keyed=False)
    jres, tres = run_engine(jeng, jtraffic), run_engine(teng, ttraffic)
    assert_match_jax(jres, tres)
    assert_same_pool_accounting(jeng, teng)
    s = teng.stats()
    assert s["fork_groups_admitted"] == 1 and s["fork_branches_admitted"] == 3
    assert s["decode_step_impl"] == "unfused"
    assert_zero_block(teng)


def test_int8_paged_engine_matches_jax_int8_paged_engine():
    """int8 pools on both sides (quantized at admission and at the cursor):
    the results as JAX's, within the tolerance of the float engines, and
    the pool accounting equal."""
    jeng, teng, prompt = engine_pair("local_lognormal", "int8")
    jres = run_engine(jeng, [JaxRequest(prompt=p, max_new_events=b, request_id=i)
                             for i, p, b in mixed_rows(prompt, 6)])  # fmt: skip
    tres = run_engine(teng, port_mixed(prompt, 6, keyed=False))
    assert_match_jax(jres, tres)
    assert_same_pool_accounting(jeng, teng)
    assert teng.key_cache.dtype == torch.int8 and teng.key_cache.shape[1] == teng._paged_num_blocks
    assert teng.stats()["kv_cache_bytes"] == 2 * teng.key_cache.numel() + 2 * 4 * teng.key_scale.numel()
    assert_zero_block(teng)


def test_groups_narrower_than_a_harvest_extract_as_in_jax(monkeypatch):
    """With every group width below the rows a boundary finishes (group
    sizes (2,) at 4 slots, budgets that end together), the harvest's
    extraction runs as wide as the rows, as the JAX engine's does; greedy
    results and pool accounting as JAX's."""
    jeng, teng, prompt = engine_pair("local_lognormal")
    widths, run_program = [], teng._run_program

    def spy(kind, key, *args, **kw):
        widths.extend([key] if kind == "extract" else [])
        return run_program(kind, key, *args, **kw)

    monkeypatch.setattr(teng, "_run_program", spy)
    sizes = teng.scheduler.group_sizes
    jeng.scheduler.group_sizes = teng.scheduler.group_sizes = (2,)
    rows = [(i, prompt.slice((slice(i % 4, i % 4 + 1), slice(0, 4))), 4) for i in range(6)]
    try:
        jres = run_engine(jeng, [JaxRequest(prompt=p, max_new_events=b, request_id=i) for i, p, b in rows])
        tres = run_engine(teng, [Request(prompt=to_torch(p), max_new_events=b, request_id=i) for i, p, b in rows])
    finally:
        jeng.scheduler.group_sizes = teng.scheduler.group_sizes = sizes
    assert_match_jax(jres, tres)
    assert_same_pool_accounting(jeng, teng)
    assert max(widths) > 2  # an extraction wider than any group


# ------------------------------------------------------ paged == monolithic
def port_pair(name: str, precision: str = "fp32"):
    """The port's model of ``build(name)`` at ``precision`` (JAX's weights)."""
    jcfg, _, params, _, _, prompt = build(name)
    tcfg = StructuredTransformerConfig.from_dict(dict(jcfg.to_dict(), precision=precision))
    tmodel = load_jax_params(CIPPTForGenerativeSequenceModeling(tcfg), jax.tree_util.tree_map(np.asarray, params))
    return tcfg, tmodel, prompt


@pytest.mark.parametrize(
    "precision,cache", [("fp32", None), ("bf16", None), ("fp32", "int8"), ("fp32", "fp8")],
    ids=["fp32", "bf16", "int8", "fp8"],
)  # fmt: skip
def test_paged_equals_monolithic_unfused_bitwise(precision, cache):
    """Sampled, six requests and a fork through 2 slots (refills into
    recycled blocks): the paged engine and the monolithic engine running
    the unfused step give every event, integer and float bit for bit."""
    tcfg, tmodel, prompt = port_pair("local_lognormal", precision)
    template = to_torch(prompt)
    runs = {}
    for label, kw in (("mono", dict(decode_step_impl="xla")), ("paged", PAGED)):
        eng = GenerationEngine(tmodel, tcfg, template=template, device="cpu", kv_cache_dtype=cache,
                               **dict(ENGINE, **kw))  # fmt: skip
        reqs = port_mixed(prompt, 6)
        reqs += [Request(prompt=to_torch(fork_row(prompt)), max_new_events=4, request_id=("f", j),
                         key=derive_request_seed(9, j)) for j in range(2)]  # fmt: skip
        runs[label] = eng.run(reqs)
        assert eng.stats()["decode_step_impl"] == "unfused"
    assert_same_results(runs["mono"], runs["paged"])
    assert all(r.error is None for r in runs["paged"])


# ------------------------------------------------------------------ fork
def fork_reference(prompt, session, n_branches, budget):
    return [Request(prompt=prompt, max_new_events=budget, request_id=("f", j), key=derive_request_seed(session, j))
            for j in range(n_branches)]  # fmt: skip


def test_fork_equals_independent_submissions():
    """Three branches of a 4-event prompt (the block-aligned edge: the
    shared prefix is exactly one block) and of a 3-event one (a partial
    prompt block each branch holds): one prefill each, and every branch
    equal bit for bit to an independent request with
    ``derive_request_seed(session, j)`` through the paged and the
    monolithic unfused engines; branches share the prompt and diverge."""
    _, _, _, tcfg, tmodel, prompt = build("local_lognormal")
    template = to_torch(prompt)
    kw = dict(ENGINE, n_slots=4)
    for n_events, session in ((4, 11), (3, 12)):
        row = to_torch(fork_row(prompt, n_events))
        eng = GenerationEngine(tmodel, tcfg, template=template, device="cpu", **dict(kw, **PAGED))
        branches = eng.fork(row, 3, 4, key=session, request_id="f")
        assert [r.branch_index for r in branches] == [0, 1, 2] and eng.scheduler.pending == 3
        forked = by_id(eng.run())
        rep = eng.scheduler.padding_report()
        assert (rep["prefill_dispatches"], rep["prefill_rows_computed"]) == (1, 1)
        assert (rep["fork_groups_admitted"], rep["fork_branches_admitted"]) == (1, 3)
        for ref_kw in (PAGED, dict(decode_step_impl="xla")):
            ref = GenerationEngine(tmodel, tcfg, template=template, device="cpu", **dict(kw, **ref_kw))
            assert_same_results(list(forked.values()), ref.run(fork_reference(row, session, 3, 4)))
        td0, td1 = (forked[("f", j)].batch.time_delta for j in (0, 1))
        # The prompt's last time_delta is each branch's first sampled gap.
        assert torch.equal(td0[:, : n_events - 1], td1[:, : n_events - 1]) and not torch.equal(td0, td1)
        assert_zero_block(eng)


def test_unkeyed_fork_session_is_branch_zero_admission_seed():
    """Without ``key`` the session seed is ``derive_request_seed(engine seed,
    branch 0's admission index)``: what an independent submission of branch
    0 would have bound."""
    _, _, _, tcfg, tmodel, prompt = build("local_lognormal")
    kw = dict(ENGINE, n_slots=4, seed=5, **PAGED)
    row = to_torch(fork_row(prompt))
    eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **kw)
    for r in port_mixed(prompt, 2):
        eng.submit(r)
    branches = eng.fork(row, 2, 4, request_ids=["a", "b"])
    assert [r.fork.session_admission_index for r in branches] == [2, 2]
    got = by_id(eng.run())
    session = derive_request_seed(5, 2)
    ref = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **kw)
    want = by_id(ref.run([Request(prompt=row, max_new_events=4, request_id=rid, key=derive_request_seed(session, j))
                          for j, rid in enumerate("ab")]))  # fmt: skip
    assert_same_results([got["a"], got["b"]], [want["a"], want["b"]])


def test_fork_invariant_to_coresidents_order_and_chunk():
    """A fork group's branches are the same bits alone, before and after
    background requests, and at decode chunks of 1, 2 and 3; the background
    requests keep their solo bits (no branch writes a neighbour's blocks)."""
    _, _, _, tcfg, tmodel, prompt = build("local_lognormal")
    template, row = to_torch(prompt), to_torch(fork_row(prompt))

    def engine(**kw):
        return GenerationEngine(tmodel, tcfg, template=template, device="cpu", **dict(ENGINE, n_slots=4, **PAGED, **kw))

    fork = ("fork", row, 2, 5, 13)
    solo = run_engine(engine(), [fork])
    bg_solo = run_engine(engine(), port_mixed(prompt, 2, 100))
    first = run_engine(engine(), [fork] + port_mixed(prompt, 2, 100))
    last = run_engine(engine(), port_mixed(prompt, 2, 100) + [fork])
    branches = [("f", j) for j in range(2)]
    for mixed in (first, last):
        assert_same_results([mixed[k] for k in branches], [solo[k] for k in branches])
        assert_same_results([mixed[i] for i in (100, 101)], [bg_solo[i] for i in (100, 101)])
    chunks = [run_engine(engine(decode_chunk=c), [("fork", row, 3, 5, 17)]) for c in (1, 2, 3)]
    for other in chunks[1:]:
        assert_same_results(list(chunks[0].values()), list(other.values()))


# ---------------------------------------------------- pipelining and reset
def test_paged_results_invariant_to_dispatch_depth_and_reset():
    """Sampled mixed and fork traffic through 2 slots at depths 1, 2 and 3:
    in-flight chunks still write into a finished row's blocks when its
    slot is re-admitted, and stream order keeps those writes ahead of the
    admission; every result bit for bit equal. ``reset()`` returns every
    block and keeps the high-water mark; the pass after it equals the first."""
    _, _, _, tcfg, tmodel, prompt = build("local_lognormal")
    row = to_torch(fork_row(prompt))
    runs = {}
    for depth in (1, 2, 3):
        eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu",
                               **dict(ENGINE, dispatch_depth=depth, **PAGED))  # fmt: skip
        traffic = port_mixed(prompt, 3) + [("fork", row, 2, 4, 21)] + port_mixed(prompt, 3, 3)
        runs[depth] = run_engine(eng, traffic)
        assert eng.inflight_chunks == 0 and len(runs[depth]) == 8
        assert_zero_block(eng)
        high = eng._block_alloc.high_water
        assert high > 0 and eng.stats()["block_pool_in_use"] > 0
        eng.reset()
        rep = eng.scheduler.padding_report()
        assert (rep["block_pool_in_use"], rep["block_pool_high_water"]) == (0, high)
        assert not eng._tables.any() and not eng.block_table.any()
        again = run_engine(eng, port_mixed(prompt, 3) + [("fork", row, 2, 4, 21)] + port_mixed(prompt, 3, 3))
        assert_same_results(list(runs[depth].values()), list(again.values()))
    assert all(r.error is None for r in runs[1].values())
    for depth in (2, 3):
        assert_same_results(list(runs[1].values()), list(runs[depth].values()))


@pytest.mark.parametrize("blocks,match", [([0], "zero block"), ("double", "double-free")])
def test_allocator_guards_raise_block_ledger_error(blocks, match):
    """The always-on ledger guards (JAX's ``BlockAllocator.decref``)."""
    _, _, _, tcfg, tmodel, prompt = build()
    eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **dict(ENGINE, **PAGED))
    alloc = eng._block_alloc
    if blocks == "double":
        blocks = alloc.alloc(1)
        alloc.decref(blocks)
    with pytest.raises(BlockLedgerError, match=match):
        alloc.decref(blocks)


def test_prefix_sharing_capacity():
    """JAX's capacity check: 8 branches of a 45-event prompt in 8 slots share
    11 whole blocks, so the measured ``effective_slots`` reaches 0.8 of 8
    times the slots while they are resident."""
    jcfg, _, params, _, _, _ = build()
    from .test_generation import make_prompt

    long_prompt = make_prompt(B=1, L=45)
    tcfg = StructuredTransformerConfig.from_dict(jcfg.to_dict())
    tmodel = load_jax_params(CIPPTForGenerativeSequenceModeling(tcfg), jax.tree_util.tree_map(np.asarray, params))
    eng = GenerationEngine(tmodel, tcfg, template=to_torch(long_prompt), n_slots=8, max_len=64, decode_chunk=1,
                           min_bucket=2, device="cpu", **PAGED)  # fmt: skip
    eng.fork(to_torch(long_prompt), 8, 3, key=29, request_id="f")
    assert eng.plan_and_dispatch() == 8
    paged = eng.slots_report(hbm_gb=16.0, branch_factor=8)["paged"]
    assert paged["resident_rows"] == 8 and paged["sharing_ratio"] > 3.0
    assert paged["effective_slots"] >= 0.8 * 8 * 8 and paged["bytes_per_block"] > 0
    assert eng.stats()["block_pool_shared_blocks"] == 11
    assert len(eng.run()) == 8
    assert_zero_block(eng)


def test_captured_flow_runs_one_fork_program_pair_a_group(monkeypatch):
    """The captured path on the CPU with `RerunGraph` (as
    ``tests/test_torch_prefill.py``): each prefill and extraction key warmed
    up and captured on inert rows that write nothing a request sees; a fork
    group runs as one replay of the prefill program of its (bucket, width),
    the key an ordinary group of that width shares; results equal the eager
    engine's, and again after ``reset()`` with nothing captured anew."""
    _, _, _, tcfg, tmodel, prompt = build("local_lognormal")
    replay = CapturedProgram.replay
    monkeypatch.setattr(CapturedProgram, "replay", lambda self: (self.fn(), replay(self))[1])
    row = to_torch(fork_row(prompt))

    def engine(captured):
        eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu",
                               **dict(ENGINE, n_slots=4, **PAGED))  # fmt: skip
        if captured:
            eng._families = {k: ProgramFamily(f"the {k} program", device="cpu", graph=RerunGraph,
                                              graph_context=lambda g, stream: contextlib.nullcontext())
                             for k in ("prefill", "extract")}  # fmt: skip
        return eng

    def traffic():
        return [("fork", row, 3, 4, 31)] + port_mixed(prompt, 4) + [("fork", row, 2, 3, 32)]

    want = run_engine(engine(False), traffic())
    captured = engine(True)
    got = run_engine(captured, traffic())
    assert_same_results(list(want.values()), list(got.values()))
    s = captured.stats()
    assert s["fork_groups_admitted"] == 2 and not any(k.startswith("fork_") and "_graph_" in k for k in s)
    assert s["prefill_graph_replays"] == s["prefill_dispatches"]
    assert s["prefill_graph_keys"] == s["prefill_graph_captures"] == s["prefill_graph_warmups"] >= 2
    captured.reset()
    again = run_engine(captured, traffic())
    assert_same_results(list(want.values()), list(again.values()))
    s2 = captured.stats()
    assert all(s2[f"{k}_graph_captures"] == s[f"{k}_graph_captures"] for k in ("prefill", "extract"))
    assert s2["prefill_graph_replays"] == 2 * s["prefill_graph_replays"]
    assert_zero_block(captured)
