"""The PyTorch port's prefill, admission and harvest programs against the JAX engine's, on the CPU.

The port runs each prefill group as one program of key (bucket, group
width), padded to the scheduler's group width with inert rows as JAX's
``_group_arrays`` pads it, and admits the real rows with a masked scatter;
the harvest extracts finished rows through one program per group width.
Held here, at small widths:

* greedy decoding with groups that the scheduler pads (``group_sizes``
  without 1 and 2, 8 slots, refills into recycled slots): every event and
  integer equal to the JAX engine's, floats within 1e-4 (as the engine
  parity tests);
* a padded group's dispatch leaves every slot outside the group bit for bit
  as it was (rows, KV planes and scales, mask, cursors, seeds, counters and
  flags), float and int8 caches, a slot holding NaNs included;
* ``reset()`` writes a fresh engine's state back into the same buffers, and
  the second pass gives the first pass's results bit for bit; the JAX
  engine's ``test_reset_determinism_and_accounting_harvest`` mirrored: under
  ``fetch_results=False`` every result has ``batch=None`` and the JAX
  engine's ``n_events`` and ``n_generated``;
* extraction at a padded group width equals the unpadded extraction and a
  plain gather of the rows;
* ``Scheduler(group_sizes=...)`` plans the JAX scheduler's groups;
* the captured path's control flow, with a stand-in graph that reruns the
  program: every key's warm-up and capture on inert rows write nothing a
  request sees, and the results equal the eager engine's;
* the index planes are int32 as the JAX package holds them: an int64-fed
  engine's row dtypes and ``slots_report()["row_bytes_per_slot"]`` equal
  the JAX engine's at ``serving_config()``; the synthetic data and the train
  step's static buffers hold int32.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.data.types import EventStreamBatch as JaxBatch
from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.serving import GenerationEngine as JaxEngine
from eventstreamgpt_tpu.serving import Request as JaxRequest
from eventstreamgpt_tpu.serving.scheduler import Scheduler as JaxScheduler
from eventstreamgpt_tpu_torch.convert import init_params_from_seed
from eventstreamgpt_tpu_torch.data.synthetic import (
    serving_config,
    synthetic_csr,
    synthetic_prompts,
    synthetic_training_batches,
    training_config,
)
from eventstreamgpt_tpu_torch.generation.generation_utils import _mask_through_cursor
from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request
from eventstreamgpt_tpu_torch.serving.scheduler import Scheduler
from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_train_step
from eventstreamgpt_tpu_torch.utils.graphs import CapturedProgram, ProgramFamily

from .test_torch_engine import CLOSE, EXACT, MAX_LEN, assert_same_results, build, by_id, to_torch

PADDED = dict(n_slots=8, max_len=MAX_LEN, decode_chunk=2, min_bucket=2)
GROUPS = (4, 8)  # no group of 1 or 2: three requests of a bucket run as a group of 4
INDEX_FIELDS = ("static_indices", "static_measurement_indices", "dynamic_indices", "dynamic_measurement_indices")
SMALL = dict(sizes=(5, 8, 6, 3), hidden_size=32, head_dim=8, intermediate_size=64, seq_window_size=4)


def rows_of(prompt, n):
    """(row, budget) for n requests of lengths 3, 4, 5 in turn over the prompt's 4 rows."""
    out = []
    for i in range(n):
        Lp = (3, 4, 5)[i % 3]
        out.append((prompt.slice((slice(i % 4, i % 4 + 1), slice(0, Lp))), MAX_LEN - Lp - (i % 2)))
    return out


def port_requests(prompt, n):
    return [Request(prompt=to_torch(p), max_new_events=b, request_id=i) for i, (p, b) in enumerate(rows_of(prompt, n))]


def jax_requests(prompt, n):
    return [JaxRequest(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(rows_of(prompt, n))]


def recording_groups(eng) -> list:
    """Records (requests, group width) of every group ``eng`` dispatches."""
    seen, dispatch = [], eng._dispatch_group

    def recorded(group):
        seen.append((len(group.requests), group.group_size))
        dispatch(group)

    eng._dispatch_group = recorded
    return seen


def assert_match_jax(jres, tres, ids):
    assert sorted(jres) == sorted(tres) == list(ids)
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


@pytest.mark.parametrize("name", ["global_exponential", "local_lognormal"])
def test_greedy_padded_groups_match_jax_engine(name):
    jcfg, jmodel, params, tcfg, tmodel, prompt = build(name)
    jeng = JaxEngine(jmodel, params, jcfg, template=prompt, greedy=True, **PADDED)
    teng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), greedy=True, device="cpu", **PADDED)
    jeng.scheduler.group_sizes = teng.scheduler.group_sizes = GROUPS
    groups = recording_groups(teng)
    jres = by_id(jeng.run(jax_requests(prompt, 12)))
    tres = by_id(teng.run(port_requests(prompt, 12)))
    assert_match_jax(jres, tres, range(12))
    assert any(g > n for n, g in groups) and all(g in GROUPS for _, g in groups), groups
    assert len(groups) > 2  # refills into recycled slots
    s, js = teng.stats(), jeng.stats()
    for k in ("prefill_dispatches", "prefill_rows_computed", "prompt_events", "padded_events"):
        assert s[k] == js[k], k


def state_bytes(eng) -> dict:
    """Every state buffer of the engine as bytes, per slot where it has a slot axis."""
    out = {f"big.{k}": v for k, v in vars(eng.big).items() if torch.is_tensor(v)}
    for k in ("cache_mask", "cache_len", "cursor", "base_len", "budget", "n_generated", "done", "live", "health",
              "seeds", "counters"):  # fmt: skip
        out[k] = getattr(eng, k)
    slotted = {k: v.contiguous().view(torch.uint8).reshape(v.shape[0], -1).clone() for k, v in out.items()}
    for k in ("key_cache", "value_cache", "key_scale", "value_scale"):  # slot axis 1
        v = getattr(eng, k)
        if v is not None:
            slotted[k] = v.transpose(0, 1).contiguous().view(torch.uint8).reshape(v.shape[1], -1).clone()
    return slotted


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_padded_dispatch_leaves_other_slots_bit_for_bit(kv_cache_dtype):
    _, _, _, tcfg, tmodel, prompt = build("local_lognormal")
    eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), kv_cache_dtype=kv_cache_dtype, device="cpu",
                           **PADDED)  # fmt: skip
    eng.scheduler.group_sizes = GROUPS
    groups = recording_groups(eng)
    reqs = port_requests(prompt, 6)
    for r in reqs[:4]:
        eng.submit(r)
    eng.plan_and_dispatch()
    eng.issue_chunk()
    eng.resolve_chunk(0.0)
    # Slot 0 (a pad row's target) holds NaNs: written back, they keep their bits.
    eng.big.time_delta[0, 2] = float("nan")
    (eng.key_cache if eng.key_scale is None else eng.key_scale)[:, 0, :, 1] = float("nan")
    before = state_bytes(eng)
    free = eng.free_slots()
    eng.submit(reqs[4])
    assert eng.plan_and_dispatch() == 1
    assert groups[-1] == (1, 4) and 0 not in free
    admitted = [s for s in free if eng._table[s] is not None]
    assert len(admitted) == 1
    after = state_bytes(eng)
    for k, rows in before.items():
        for s in range(eng.n_slots):
            if s not in admitted:
                assert torch.equal(after[k][s], rows[s]), (k, s)
    s = admitted[0]
    assert bool(eng.live[s]) and int(eng.base_len[s]) == reqs[4].prompt_len and int(eng.counters[s]) == 1


def fresh_state(eng) -> dict:
    return {k: v.clone() for k, v in state_bytes(eng).items()}


def addresses(eng) -> dict:
    out = {f"big.{k}": v.data_ptr() for k, v in vars(eng.big).items() if torch.is_tensor(v)}
    for k in ("key_cache", "value_cache", "key_scale", "value_scale", "cache_mask", "cache_len", "cursor", "base_len",
              "budget", "n_generated", "done", "live", "health", "seeds", "counters", "active_steps", "_boundary"):
        v = getattr(eng, k)
        if v is not None:
            out[k] = v.data_ptr()
    return out


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_reset_keeps_addresses_and_reproduces_the_first_pass(kv_cache_dtype):
    _, _, _, tcfg, tmodel, prompt = build("local_lognormal")

    def engine():
        eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), kv_cache_dtype=kv_cache_dtype, device="cpu",
                               **PADDED)  # fmt: skip
        eng.scheduler.group_sizes = GROUPS
        return eng

    eng, fresh = engine(), engine()
    ptrs, want = addresses(eng), state_bytes(fresh)
    first = eng.run(port_requests(prompt, 10))
    assert all(r.error is None for r in first) and eng.stats()["dispatched_chunks"] > 0
    eng.reset()
    assert addresses(eng) == ptrs
    got = state_bytes(eng)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(eng.active_steps) == 0 and eng.occupied == 0 and eng.scheduler.pending == 0
    s = eng.stats()
    assert (s["dispatched_chunks"], s["resolved_chunks"], s["prefill_dispatches"]) == (0, 0, 0)
    assert eng.scheduler.group_sizes == GROUPS and eng.scheduler.buckets == fresh.scheduler.buckets
    second = eng.run(port_requests(prompt, 10))
    assert addresses(eng) == ptrs
    assert_same_results(first, second)
    assert [r.admission_index for r in first] == [r.admission_index for r in second]


def test_reset_determinism_and_accounting_harvest_mirror_jax():
    """JAX's tests/test_engine.py::TestEngineRunModes::test_reset_determinism_and_accounting_harvest
    on both engines, greedy (the port's random streams are not JAX's)."""
    jcfg, jmodel, params, tcfg, tmodel, prompt = build("local_lognormal")
    kw = dict(n_slots=2, max_len=MAX_LEN, decode_chunk=2, min_bucket=2, greedy=True)
    jeng = JaxEngine(jmodel, params, jcfg, template=prompt, **kw)
    teng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **kw)

    def reqs(cls, convert):
        return [cls(prompt=convert(prompt.slice((slice(i, i + 1), slice(0, 4)))), max_new_events=3, request_id=i)
                for i in range(3)]  # fmt: skip

    jfirst = jeng.run(reqs(JaxRequest, lambda p: p), fetch_results=False)
    first = teng.run(reqs(Request, to_torch), fetch_results=False)
    assert all(r.batch is None for r in first) and all(r.batch is None for r in jfirst)
    assert all(r.n_events == 7 for r in first)
    for t, j in zip(first, jfirst):
        assert (t.request_id, t.n_events, t.prompt_len, t.n_generated) == (j.request_id, j.n_events, j.prompt_len,
                                                                            j.n_generated)  # fmt: skip
    teng.reset()
    assert teng.occupied == 0 and teng.scheduler.pending == 0
    second = teng.run(reqs(Request, to_torch), fetch_results=False)
    assert [r.n_generated for r in first] == [r.n_generated for r in second]
    fetched = teng.run(reqs(Request, to_torch))  # the same requests, rows fetched: the same accounting
    for a, b in zip(second, fetched):
        assert (a.n_events, a.prompt_len, a.n_generated) == (b.n_events, b.prompt_len, b.n_generated)
        assert b.batch is not None and b.batch.event_mask.shape == (1, b.n_events)


def test_extraction_at_a_padded_width_equals_the_unpadded_one():
    _, _, _, tcfg, tmodel, prompt = build("local_lognormal")
    eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **PADDED)
    for r in port_requests(prompt, 5):
        eng.submit(r)
    eng.plan_and_dispatch()
    while bool((eng.live & ~eng.done).any()):
        eng.issue_chunk()
    slots = [s for s in range(eng.n_slots) if eng._table[s] is not None][:3]
    assert len(slots) == 3
    eng.scheduler.group_sizes = (3, 8)
    exact = eng._fetch_rows(slots)
    eng.scheduler.group_sizes = (1, 2, 4, 8)  # three rows extracted at width 4, padded with slot 0
    padded = eng._fetch_rows(slots)
    assert sorted(k for kind, k in eng._statics if kind == "extract") == [3, 4]
    idx = torch.tensor(slots)
    plain = _mask_through_cursor(eng.big.map(lambda x: x[idx]), eng.cursor[idx])
    for i, s in enumerate(slots):
        n_events = int(eng.cursor[s])
        assert exact[1][s] == padded[1][s] == (n_events, int(eng.base_len[s]), int(eng.n_generated[s]))
        want = plain.slice((slice(i, i + 1), slice(0, n_events)))
        for k, t in vars(want).items():
            if torch.is_tensor(t):
                assert torch.equal(getattr(exact[0][s], k), t) and torch.equal(getattr(padded[0][s], k), t), k


@pytest.mark.parametrize("group_sizes", [None, (4, 8), (2, 3, 8), (8,)], ids=str)
def test_scheduler_group_sizes_plan_jax_groups(group_sizes):
    _, _, _, _, _, prompt = build()
    buckets = (2, 4, 7)
    rows = rows_of(prompt, 11)
    jsched = JaxScheduler(8, buckets, group_sizes=group_sizes, max_pending=20)
    tsched = Scheduler(8, buckets, group_sizes=group_sizes, max_pending=20)
    assert tsched.group_sizes == jsched.group_sizes
    for i, (p, b) in enumerate(rows):
        jsched.submit(JaxRequest(prompt=p, max_new_events=b, request_id=i))
        tsched.submit(Request(prompt=to_torch(p), max_new_events=b, request_id=i))
    for free in ([0, 1, 2, 3, 4, 5, 6, 7], [2, 5, 6], [0, 1, 3, 4, 7]):
        jg, tg = jsched.plan_admissions(free), tsched.plan_admissions(free)
        assert [(g.bucket_len, g.group_size, [r.request_id for r in g.requests], g.slots) for g in tg] == [
            (g.bucket_len, g.group_size, [r.request_id for r in g.requests], g.slots) for g in jg
        ]
    assert tsched.padding_report() == {k: v for k, v in jsched.padding_report().items() if k in tsched.padding_report()}


def to_int64(batch):
    return batch.map(lambda x: x.long() if x.dtype == torch.int32 else x)


def test_int64_fed_engine_holds_jax_row_dtypes_and_bytes():
    """At `serving_config()` (32 slots, ``max_len`` 256, 24 data elements):
    the rows' dtypes and the row bytes a slot equal the JAX engine's."""
    config = serving_config(precision="fp32")
    (p, _), = synthetic_prompts(np.random.default_rng(0), 1, config, (8, 8), (4, 4))
    template = to_int64(p)
    assert template.dynamic_indices.dtype == torch.int64 and template.static_indices.dtype == torch.int64
    kw = dict(n_slots=32, max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16)
    teng = GenerationEngine(init_params_from_seed(CIPPTForGenerativeSequenceModeling(config), seed=0), config,
                            template=template, device="cpu", **kw)  # fmt: skip
    jcfg = JaxConfig.from_dict(config.to_dict())
    jtemplate = JaxBatch(**{k: None if v is None else jnp.asarray(v.numpy()) for k, v in vars(template).items()})
    jmodel = JaxModel(jcfg)
    jeng = JaxEngine(jmodel, {}, jcfg, template=jtemplate, **kw)
    for k, v in vars(teng.big).items():
        jv = getattr(jeng._state.big, k)
        assert (v is None) == (jv is None), k
        if v is not None:
            assert str(v.dtype).removeprefix("torch.") == str(jv.dtype), (k, v.dtype, jv.dtype)
            assert tuple(v.shape) == tuple(jv.shape), k
    for k in INDEX_FIELDS:
        assert getattr(teng.big, k).dtype == torch.int32, k
    jrep, trep = jeng.slots_report(hbm_gb=85.0, params_bytes=0), teng.slots_report(hbm_gb=85.0)
    assert trep["row_bytes_per_slot"] == jrep["row_bytes_per_slot"] == 81_191
    for d in jrep["per_dtype"]:
        assert trep["per_dtype"][d]["kv_bytes_per_slot"] == jrep["per_dtype"][d]["kv_bytes_per_slot"], d
    assert teng.stats()["slots_report"]["row_bytes_per_slot"] == 81_191


def test_synthetic_data_and_train_step_buffers_are_int32():
    config = serving_config(**SMALL)
    prompts = synthetic_prompts(np.random.default_rng(0), 2, config, (4, 6), (2, 3))
    batch = next(synthetic_training_batches(np.random.default_rng(0), config, 4, 24))
    csr = synthetic_csr(np.random.default_rng(0), config, 3)
    for b in (prompts[0][0], batch):
        for k in INDEX_FIELDS:
            assert getattr(b, k).dtype == torch.int32, k
    for k in INDEX_FIELDS:
        assert getattr(csr, k).dtype == np.int32, k

    tconfig = training_config([batch], precision="fp32", **SMALL)
    oc = OptimizationConfig(init_lr=1e-3, lr_num_warmup_steps=1, lr_frac_warmup_steps=None, max_training_steps=4)
    losses = {}
    for name, b in (("int32", batch), ("int64", to_int64(batch))):
        model = init_params_from_seed(build_model(tconfig), seed=0)
        seen = []
        model.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
        step = make_train_step(model, *build_optimizer(model, oc), device="cpu")
        losses[name] = [float(step(b, 0)) for _ in range(2)]
        for k in INDEX_FIELDS:
            assert getattr(seen[0], k).dtype == torch.int32, (name, k)
        assert seen[0] is not b  # the step's static buffers, not the batch
    assert losses["int32"] == losses["int64"]


class RerunGraph:
    """A stand-in for a CUDA graph on the CPU: capture runs the program (on the
    inert inputs the engine staged for it), and `CapturedProgram.replay` is
    patched to run the program again on the inputs staged for the replay."""

    def register_generator_state(self, gen):
        pass

    def replay(self):
        pass


def test_lazy_capture_flow_equals_the_eager_engine(monkeypatch):
    """The engine's captured path, run on the CPU with `RerunGraph`: each
    prefill and extraction key's warm-up and capture run on inert rows and
    write nothing a request sees, each call uploads its inputs before its
    replay, and ``reset()`` keeps every program; results equal the eager
    engine's bit for bit, pass after pass."""
    _, _, _, tcfg, tmodel, prompt = build("local_lognormal")
    replay = CapturedProgram.replay
    monkeypatch.setattr(CapturedProgram, "replay", lambda self: (self.fn(), replay(self))[1])

    def engine(captured):
        eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **PADDED)
        eng.scheduler.group_sizes = GROUPS
        if captured:
            eng._families = {k: ProgramFamily(f"the {k} program", device="cpu", graph=RerunGraph,
                                              graph_context=lambda g, stream: contextlib.nullcontext())
                             for k in ("prefill", "extract")}  # fmt: skip
        return eng

    eager, captured = engine(False), engine(True)
    want = eager.run(port_requests(prompt, 12))
    got = captured.run(port_requests(prompt, 12))
    assert_same_results(want, got)
    s = captured.stats()
    assert s["prefill_graph_keys"] == s["prefill_graph_warmups"] == s["prefill_graph_captures"] > 1
    assert s["prefill_graph_replays"] == s["prefill_dispatches"]
    assert s["extract_graph_keys"] == s["extract_graph_captures"] > 0
    captured.reset()
    again = captured.run(port_requests(prompt, 12))
    assert_same_results(want, again)
    s2 = captured.stats()
    assert (s2["prefill_graph_captures"], s2["extract_graph_captures"]) == (s["prefill_graph_captures"],
                                                                            s["extract_graph_captures"])  # fmt: skip
    assert s2["prefill_graph_replays"] == s["prefill_graph_replays"] + s2["prefill_dispatches"]
