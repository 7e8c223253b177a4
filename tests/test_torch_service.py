"""The port's serving service, prefill stream and hot swap against the JAX package's, on the CPU.

Fixtures: ``tests/test_torch_engine.py``'s CI model (fp32, ``build`` with
JAX's init jitted; JAX weights carried over by `load_jax_params`; a second set of weights from
another seed for the swaps), ``ENGINE`` (2 slots, ``max_len`` 8, chunks of
2); five requests with prompts of 4 events. The port-only checks of the NA engine
and of the handoff use a small port model (`data.synthetic.serving_config`)
with numpy-seeded weights. Each JAX engine or service is built and run once,
in a module-scoped fixture.

1. The SLO lanes: JAX's ``tests/test_service.py`` cases (priority and FIFO,
   ``min_share`` under skew and at rounds of one slot, a bounded lane,
   validation, deadlines and the report's keys), each run on JAX's class
   and on the port's.
2. Hot swap: JAX's guards and messages; after ``load_shadow`` and ``flip`` a
   greedy run equals JAX's engine after its flip (events and integers
   exact, floats within 1e-4) and a fresh port engine on the new weights
   (bit for bit); a second flip rolls back; every parameter and stacked
   tensor keeps its address and kernel B's stacked weights are those of the
   new model; the captured flow (the ``RerunGraph`` stand-in) captures
   nothing after a flip; a NaN shadow fails the probe and leaves the live
   engine as it was; ``slots_report`` doubles the weights once (the paged
   pool's budget not again) and charges the flip's scratch buffer; a spec
   engine flips draft and target together, and a target-only promotion
   keeps the live draft bit for bit and drops a staged rollback draft.
3. The prefill stream: JAX's attach checks and messages; a handoff gives the
   slot state of a local prefill, bit for bit (CI and NA, float and int8
   caches); two groups of one program key computed before either is
   admitted; spec engines behind a spec prefill stream equal JAX's strict
   greedy spec engine.
4. The service: JAX's replica, submit, prefill-budget, rejection-parity and
   ``min_share`` tests; greedy, a two-replica service equals JAX's in every
   event and integer; sampled, a service with and without the stream equals
   a single port engine with the same seed (events and integers exact,
   floats within 1e-5, since group widths may differ); ``fork()`` through
   the service; deadlines, the stream pumped in a round that expired a
   request; a replay trace in the default lane without fetching rows.
"""

import contextlib
import copy
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.serving import GenerationEngine as JaxEngine
from eventstreamgpt_tpu.serving import LaneConfig as JaxLaneConfig
from eventstreamgpt_tpu.serving import LaneQueues as JaxLaneQueues
from eventstreamgpt_tpu.serving import Request as JaxRequest
from eventstreamgpt_tpu.serving import ServingService as JaxService
from eventstreamgpt_tpu_torch.convert import init_params_from_seed, load_jax_params
from eventstreamgpt_tpu_torch.data.synthetic import NA_OVERRIDES, serving_config, synthetic_prompts
from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.ops.decode_step import stack_layer_weights
from eventstreamgpt_tpu_torch.serving import (
    DeadlineExceeded,
    GenerationEngine,
    LaneConfig,
    LaneQueues,
    PrefillStream,
    Request,
    ServingService,
    SpecConfig,
    latency_quantiles,
    truncated_draft,
)
from eventstreamgpt_tpu_torch.training import build_model
from eventstreamgpt_tpu_torch.utils.graphs import CapturedProgram, ProgramFamily

from .test_generation import BASE_KWARGS, MEASUREMENT_CONFIGS, make_prompt
from .test_torch_engine import CLOSE, ENGINE, EXACT, assert_same_results, to_torch
from .test_torch_prefill import RerunGraph

GREEDY_FLOATS = dict(rtol=1e-4, atol=1e-4)  # the engine's greedy parity tolerance against JAX
STRICT = dict(k=2, value_rtol=0.0, value_atol=0.0)
SMALL = dict(precision="fp32", sizes=(5, 8, 6, 3), hidden_size=32, head_dim=8, intermediate_size=64)
SMALL_ENGINE = dict(n_slots=4, max_len=16, min_bucket=4, decode_chunk=2)


# ------------------------------------------------------------------ fixtures
@functools.cache
def build_ci():
    """`tests/test_torch_engine.py`'s ``build()`` with JAX's init jitted
    (several times faster on the CPU than flax's eager init; other values);
    built once a process (nothing here changes the models)."""
    jcfg = JaxConfig(measurement_configs=dict(MEASUREMENT_CONFIGS), **BASE_KWARGS)
    prompt = make_prompt(B=4, L=5)
    jmodel = JaxModel(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), prompt)
    tcfg = StructuredTransformerConfig.from_dict(jcfg.to_dict())
    tmodel = load_jax_params(CIPPTForGenerativeSequenceModeling(tcfg), jax.tree_util.tree_map(np.asarray, params))
    return jcfg, jmodel, params, tcfg, tmodel, prompt


@pytest.fixture(scope="module")
def ci():
    """The CI pair of `build_ci`, and a second set of weights (numpy seed 99 noise on the first) on both sides."""
    jcfg, jmodel, params, tcfg, tmodel, prompt = build_ci()
    rng = np.random.default_rng(99)  # no JAX program to compile for the second set
    params2 = jax.tree_util.tree_map(lambda x: np.asarray(x) + rng.normal(0.0, 0.05, x.shape).astype(np.float32), params)
    tmodel2 = load_jax_params(CIPPTForGenerativeSequenceModeling(tcfg), jax.tree_util.tree_map(np.asarray, params2))
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, params2=params2, tcfg=tcfg, tmodel=tmodel, tmodel2=tmodel2,
                prompt=prompt, template=to_torch(prompt))  # fmt: skip


def engine(ci, model=None, **kw):
    return GenerationEngine(model or ci["tmodel"], ci["tcfg"], template=ci["template"], device="cpu",
                            **dict(ENGINE, **kw))  # fmt: skip


def jax_engine(ci, params=None, **kw):
    return JaxEngine(ci["jmodel"], params or ci["params"], ci["jcfg"], template=ci["prompt"], **dict(ENGINE, **kw))


def rows(ci):
    """Five requests, prompts of 4 events (one bucket, so that each JAX
    engine compiles few programs) and budgets of 3 and 4."""
    prompt = ci["prompt"]
    return [(prompt.slice((slice(i % 4, i % 4 + 1), slice(0, 4))), 4 - i % 2) for i in range(5)]


def requests(ci, keys=False, seed=1000):
    return [Request(prompt=to_torch(p), max_new_events=b, request_id=i, key=(seed + i) if keys else None)
            for i, (p, b) in enumerate(rows(ci))]  # fmt: skip


def jax_requests(ci):
    return [JaxRequest(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(rows(ci))]


def assert_matches_jax(jres, tres, key=lambda r: r.request_id):
    """Every event and integer equal, floats within the greedy tolerance."""
    jres, tres = {key(r): r for r in jres}, {key(r): r for r in tres}
    assert sorted(jres) == sorted(tres) and jres
    for i, j in jres.items():
        t = tres[i]
        assert t.error is None and j.error is None
        assert (t.prompt_len, t.n_events, t.n_generated) == (j.prompt_len, j.n_events, j.n_generated), i
        for f in EXACT:
            np.testing.assert_array_equal(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), err_msg=f)
        for f in CLOSE:
            np.testing.assert_allclose(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), err_msg=f,
                                       **GREEDY_FLOATS)  # fmt: skip


def small(na=False, seed=0, n=6):
    """A small port-only model (CI or NA), its config and ``n`` prompts with budgets."""
    config = serving_config(**SMALL, **(NA_OVERRIDES if na else {}))
    model = init_params_from_seed(build_model(config), seed=seed)
    return model, config, synthetic_prompts(np.random.default_rng(seed), n, config, (5, 10), (3, 5))


# ------------------------------------------------------------ (1) SLO lanes
LANES = {"jax": (JaxLaneConfig, JaxLaneQueues), "port": (LaneConfig, LaneQueues)}
PACKAGES = pytest.mark.parametrize("pkg", sorted(LANES))


@PACKAGES
def test_lane_priority_and_fifo_order(pkg):
    Config, Queues = LANES[pkg]
    q = Queues((Config("interactive", priority=0), Config("batch", priority=1)))
    for i in range(3):
        q.offer(("b", i), "batch")
        q.offer(("i", i), "interactive")
    assert [p[1] for p in q.pick(4)] == [("i", 0), ("i", 1), ("i", 2), ("b", 0)]
    assert q.pending == 2


@PACKAGES
def test_lane_min_share_reserves_capacity_under_skew(pkg):
    Config, Queues = LANES[pkg]
    q = Queues((Config("interactive", priority=0), Config("batch", priority=1, min_share=0.25)))
    for i in range(8):
        q.offer(("i", i), "interactive")
    for i in range(4):
        q.offer(("b", i), "batch")
    picks = q.pick(8)
    lanes = [p[0] for p in picks]
    assert lanes.count("batch") == 2 and lanes.count("interactive") == 6
    assert [p[1] for p in picks if p[0] == "batch"] == [("b", 0), ("b", 1)]


@PACKAGES
def test_lane_min_share_credit_prevents_starvation_at_small_rounds(pkg):
    Config, Queues = LANES[pkg]
    q = Queues((Config("interactive", priority=0), Config("batch", priority=1, min_share=0.25)))
    q.offer(("b", 0), "batch")
    served = None
    for rnd in range(8):
        q.offer(("i", rnd), "interactive")
        picks = q.pick(1)
        assert len(picks) == 1
        if picks[0][0] == "batch":
            served = rnd
            break
    assert served is not None and served < 4
    q.pick(1)
    assert q._share_credit["batch"] == 0.0


@PACKAGES
def test_lane_bounded_rejects_new_and_counts(pkg):
    Config, Queues = LANES[pkg]
    q = Queues((Config("interactive", max_pending=2),))
    assert q.offer(1, "interactive") and q.offer(2, "interactive")
    assert not q.offer(3, "interactive")
    rep = q.report()
    assert rep["lanes"]["interactive"]["rejected"] == 1 and rep["lanes"]["interactive"]["queue_depth"] == 2
    assert rep["reject_frac"] == round(1 / 3, 4)
    assert [p[1] for p in q.pick(4)] == [1, 2]


@PACKAGES
def test_lane_validation(pkg):
    Config, Queues = LANES[pkg]
    with pytest.raises(KeyError, match="unknown lane"):
        Queues().offer(1, "nope")
    with pytest.raises(ValueError, match="min_share"):
        Config("x", min_share=1.5)
    with pytest.raises(ValueError, match="deadline_s"):
        Config("x", deadline_s=0)
    with pytest.raises(ValueError, match="duplicate"):
        Queues((Config("a"), Config("a")))


@dataclasses.dataclass
class Item:
    arrival_time: float


@PACKAGES
def test_lane_deadlines_and_report_keys(pkg):
    Config, Queues = LANES[pkg]
    q = Queues((Config("interactive", deadline_s=1.0), Config("batch", priority=1)))
    old, new, other = Item(0.0), Item(2.5), Item(0.0)
    q.offer(old, "interactive")
    q.offer(new, "interactive")
    q.offer(other, "batch")
    assert q.expire(3.0) == [("interactive", old)]
    rep = q.report()
    assert rep["expired_total"] == 1 and rep["lanes"]["interactive"]["expired"] == 1
    want = JaxLaneQueues((JaxLaneConfig("interactive"), JaxLaneConfig("batch", priority=1))).report()
    assert sorted(rep) == sorted(want) and sorted(rep["lanes"]["batch"]) == sorted(want["lanes"]["batch"])


# ------------------------------------------------------------- (2) hot swap
def test_hot_swap_flip_guards_in_jax_words(ci):
    """JAX's ``tests/test_fleet.py::test_hot_swap_flip_guards`` on the port,
    with JAX's messages (`jax_flipped_service` takes JAX's engines through
    the same load and flip)."""
    params2 = ci["tmodel2"].state_dict()
    eng = engine(ci, hot_swap=True)
    with pytest.raises(RuntimeError, match=r"no shadow checkpoint loaded \(call load_shadow first\)"):
        eng.flip()
    with pytest.raises(RuntimeError, match="no shadow checkpoint loaded"):
        eng.probe_shadow()
    with pytest.raises(RuntimeError, match="hot_swap is disabled for this engine; construct with hot_swap=True"):
        engine(ci).load_shadow(params2)
    eng.load_shadow(params2)
    assert eng.shadow_loaded
    eng.submit(requests(ci)[0])
    eng.plan_and_dispatch()
    with pytest.raises(RuntimeError, match="flip requires a drained engine: 1 resident slots, 0 in-flight"):
        eng.flip()
    eng.run()
    eng.flip()
    assert eng.weights_version == 1
    eng.drop_shadow()
    assert not eng.shadow_loaded
    tree = dict(ci["tmodel2"].state_dict())
    tree.pop("encoder.ln_f.bias")
    with pytest.raises(ValueError, match="parameter tree does not match the live weights"):
        engine(ci, hot_swap=True).load_shadow(tree)
    with pytest.raises(ValueError, match="new_draft_params on a non-speculative engine"):
        engine(ci, hot_swap=True).load_shadow(ci["tmodel2"].state_dict(), new_draft_params={})


def addresses(eng):
    return [t.data_ptr() for t in list(eng._model.parameters()) + list(eng._stacked.values())]


@pytest.fixture(scope="module")
def swapped(ci):
    """A greedy hot-swap engine: a run on the first weights, a flip to the
    second and a run, a flip back and a run, with the weights' addresses
    at each step."""
    eng = engine(ci, hot_swap=True, greedy=True)
    first_ptrs = addresses(eng)
    out = dict(engine=eng, first=eng.run(requests(ci)))
    eng.load_shadow(ci["tmodel2"].state_dict())
    eng.reset()
    eng.flip()
    out["stacked_after_flip"] = {k: v.clone() for k, v in eng._stacked.items()}
    out["ptrs"] = [first_ptrs, addresses(eng)]
    out["flipped"] = eng.run(requests(ci))
    eng.reset()
    eng.flip()
    out["ptrs"].append(addresses(eng))
    out["rolled_back"] = eng.run(requests(ci))
    return out


def lanes_of(reqs):
    return [(r, "batch" if i % 2 == 0 else "interactive") for i, r in enumerate(reqs)]


@pytest.fixture(scope="module")
def jax_flipped_service(ci):
    """JAX's greedy two-replica service over hot-swap engines flipped to the
    second weights, on the five requests, lanes alternating."""
    engines = [jax_engine(ci, hot_swap=True, greedy=True) for _ in range(2)]
    for e in engines:
        e.load_shadow(ci["params2"])
        e.flip()
    return JaxService(engines).run(lanes_of(jax_requests(ci)))


def test_flip_equals_jax_after_its_flip(swapped, jax_flipped_service):
    assert_matches_jax(jax_flipped_service, swapped["flipped"])


def test_flip_equals_a_fresh_engine_and_a_second_flip_rolls_back(ci, swapped):
    assert_same_results(engine(ci, ci["tmodel2"], greedy=True).run(requests(ci)), swapped["flipped"])
    assert_same_results(swapped["first"], swapped["rolled_back"])
    assert swapped["engine"].weights_version == 2
    assert not any(torch.equal(a.batch.time_delta, b.batch.time_delta)
                   for a, b in zip(swapped["first"], swapped["flipped"]) if a.n_events == b.n_events)  # fmt: skip


def test_flip_keeps_every_address_and_restacks_kernel_b_weights(ci, swapped):
    first, flipped, rolled = swapped["ptrs"]
    assert first == flipped == rolled
    cast = copy.deepcopy(ci["tmodel2"]).cast_to_compute_dtype()
    want = stack_layer_weights(cast.encoder.blocks(), ci["tcfg"].compute_dtype)
    assert sorted(want) == sorted(swapped["stacked_after_flip"])
    for k, v in want.items():
        assert torch.equal(swapped["stacked_after_flip"][k], v), k


def test_the_captured_flow_captures_nothing_after_a_flip(ci, monkeypatch):
    replay = CapturedProgram.replay
    monkeypatch.setattr(CapturedProgram, "replay", lambda self: (self.fn(), replay(self))[1])
    eng = engine(ci, hot_swap=True)
    eng._families = {k: ProgramFamily(f"the {k} program", device="cpu", graph=RerunGraph,
                                      graph_context=lambda g, stream: contextlib.nullcontext())
                     for k in ("prefill", "extract")}  # fmt: skip
    eng.run(requests(ci, keys=True))
    before = eng.program_stats()
    eng.load_shadow(ci["tmodel2"].state_dict())
    assert eng.probe_shadow() is None
    eng.flip()
    got = eng.run(requests(ci, keys=True))
    after = eng.program_stats()
    for k in ("prefill_graph_captures", "extract_graph_captures", "prefill_graph_keys"):
        assert after[k] == before[k] > 0, k
    assert after["prefill_graph_replays"] > before["prefill_graph_replays"]
    assert_same_results(engine(ci, ci["tmodel2"]).run(requests(ci, keys=True)), got)


def test_a_nan_shadow_fails_the_probe_and_leaves_the_engine_live(ci):
    eng = engine(ci, hot_swap=True)
    first = eng.run(requests(ci, keys=True))
    bad = ci["tmodel2"].state_dict()
    bad["encoder.h0.attn.attention.q_proj.weight"] = bad["encoder.h0.attn.attention.q_proj.weight"].clone()
    bad["encoder.h0.attn.attention.q_proj.weight"][0, 0] = float("nan")
    live = [t.clone() for t in eng._model.parameters()]
    eng.load_shadow(bad)
    reason = eng.probe_shadow()
    assert reason is not None and reason.startswith("staged shadow checkpoint produced non-finite")
    assert all(torch.equal(a, b) for a, b in zip(live, eng._model.parameters()))
    eng.reset()
    assert_same_results(first, eng.run(requests(ci, keys=True)))


@pytest.mark.parametrize("paged", [False, True], ids=["monolithic", "paged"])
def test_slots_report_doubles_the_weights_once(ci, paged):
    """JAX's ``test_slots_report_accounts_double_buffer`` and
    ``test_pool_budget_doubles_params_exactly_once_under_hot_swap``; the
    port also takes the flip's scratch buffer (the largest live tensor) off
    the budget."""
    kw = dict(paged_kv=True, block_size=4) if paged else {}
    hbm = 16.0
    plain, swap = engine(ci, **kw).slots_report(hbm_gb=hbm), engine(ci, hot_swap=True, **kw).slots_report(hbm_gb=hbm)
    assert not plain["hot_swap"] and swap["hot_swap"] and plain["swap_scratch_bytes"] == 0
    assert swap["params_bytes"] == 2 * plain["params_bytes"]
    eng = engine(ci, hot_swap=True, **kw)
    largest = max(t.numel() * t.element_size() for t in list(eng._model.parameters()) + list(eng._stacked.values()))
    assert swap["swap_scratch_bytes"] == largest > 0
    for dtype in plain["per_dtype"]:
        assert swap["per_dtype"][dtype]["max_slots"] <= plain["per_dtype"][dtype]["max_slots"]
    assert eng.slots_report(hbm_gb=hbm, params_bytes=1000)["params_bytes"] == 2000
    if paged:
        p_plain, p_swap = plain["paged"], swap["paged"]
        assert p_plain["pool_budget_bytes"] == int(hbm * 1e9) - plain["params_bytes"]
        assert p_swap["pool_budget_bytes"] == int(hbm * 1e9) - swap["params_bytes"] - swap["swap_scratch_bytes"]
        assert p_swap["max_pool_blocks_in_budget"] == p_swap["pool_budget_bytes"] // p_swap["bytes_per_block"]
        assert p_swap["pool_bytes"] == p_plain["pool_bytes"]


def spec_engine(ci, model, draft_model, **kw):
    dcfg, draft = truncated_draft(ci["tcfg"], draft_model, 1)
    return engine(ci, model, spec=SpecConfig(model=draft, config=dcfg, k=2), **kw), draft


def test_spec_engine_flips_draft_and_target_together(ci):
    eng, _ = spec_engine(ci, ci["tmodel"], ci["tmodel"], hot_swap=True)
    eng.run(requests(ci, keys=True))
    draft2 = truncated_draft(ci["tcfg"], ci["tmodel2"], 1)[1]
    eng.load_shadow(ci["tmodel2"].state_dict(), new_draft_params=draft2.state_dict())
    assert eng.probe_shadow() is None
    eng.reset()
    eng.flip()
    fresh, _ = spec_engine(ci, ci["tmodel2"], ci["tmodel2"])
    assert_same_results(fresh.run(requests(ci, keys=True)), eng.run(requests(ci, keys=True)))


def test_target_only_promotion_keeps_the_live_draft(ci):
    eng, _ = spec_engine(ci, ci["tmodel"], ci["tmodel"], hot_swap=True)
    draft_before = [t.clone() for t in eng._draft.parameters()]
    eng.load_shadow(ci["tmodel2"].state_dict())  # target only: the truncated draft shared its modules
    eng.flip()
    assert all(torch.equal(a, b) for a, b in zip(draft_before, eng._draft.parameters()))
    assert not torch.equal(next(eng._model.parameters()), next(iter(eng._shadow.parameters())))
    # A draft + target promotion, then a target-only one: the staged rollback draft is dropped.
    third = init_params_from_seed(copy.deepcopy(ci["tmodel"]), seed=7)
    eng.load_shadow(ci["tmodel"].state_dict(), new_draft_params=truncated_draft(ci["tcfg"], third, 1)[1].state_dict())
    eng.flip()
    live_draft = [t.clone() for t in eng._draft.parameters()]
    eng.load_shadow(ci["tmodel2"].state_dict())
    assert eng._shadow_draft is None
    eng.flip()
    assert all(torch.equal(a, b) for a, b in zip(live_draft, eng._draft.parameters()))


# --------------------------------------------------------- (3) prefill stream
def test_prefill_stream_constraints(ci):
    e = engine(ci)
    with pytest.raises(ValueError, match="dedicated"):
        ServingService([e], prefill_stream=PrefillStream(e))
    with pytest.raises(ValueError, match="max_len"):
        ServingService([engine(ci, max_len=ENGINE["max_len"] + 2)], prefill_stream=PrefillStream(engine(ci)))
    with pytest.raises(ValueError, match="prefill stream replaces"):
        ServingService([engine(ci)], prefill_stream=PrefillStream(engine(ci)), prefill_budget_events=4)
    with pytest.raises(ValueError, match="health_retries"):
        ServingService([engine(ci, health_retries=1)], prefill_stream=PrefillStream(engine(ci)))
    svc = ServingService([engine(ci)], prefill_stream=PrefillStream(engine(ci)))
    with pytest.raises(RuntimeError, match="already attached"):
        ServingService([engine(ci)], prefill_stream=svc.prefill_stream)
    with pytest.raises(ValueError, match="buckets"):
        ServingService([engine(ci, min_bucket=4)], prefill_stream=PrefillStream(engine(ci)))


def test_prefill_stream_checks_weights_and_sampling_filter(ci):
    with pytest.raises(ValueError, match="weights"):
        ServingService([engine(ci)], prefill_stream=PrefillStream(engine(ci, ci["tmodel2"])))
    # The same checkpoint loaded into another model attaches (the fingerprint path)...
    twin = load_jax_params(CIPPTForGenerativeSequenceModeling(ci["tcfg"]),
                           jax.tree_util.tree_map(np.asarray, ci["params"]))  # fmt: skip
    assert ServingService([engine(ci)], prefill_stream=PrefillStream(engine(ci, twin))).prefill_stream is not None
    # ...and check_weights=False is the opt-out.
    ServingService([engine(ci)], prefill_stream=PrefillStream(engine(ci, ci["tmodel2"]), check_weights=False))
    with pytest.raises(ValueError, match="sampling filter"):
        ServingService([engine(ci, top_k=5)], prefill_stream=PrefillStream(engine(ci)))
    with pytest.raises(ValueError, match="explicit request keys"):
        engine(ci).prefill_compute(requests(ci)[:1], 4, 1)
    paged = engine(ci, paged_kv=True, block_size=4)
    with pytest.raises(NotImplementedError, match="paged engines do not serve behind a dedicated prefill stream"):
        paged.prefill_compute(requests(ci, keys=True)[:1], 4, 1)
    with pytest.raises(NotImplementedError, match="paged engines do not take prefill-stream handoffs"):
        paged.admit_prefilled(engine(ci).prefill_compute(requests(ci, keys=True)[:1], 4, 1), [0])


def test_prefill_stream_rejects_mixed_spec_tiers(ci):
    """JAX's ``tests/test_spec.py::test_prefill_stream_rejects_mixed_spec_tiers``,
    and the handoff's own spec-mode check."""
    spec, _ = spec_engine(ci, ci["tmodel"], ci["tmodel"])
    with pytest.raises(ValueError, match="spec"):
        PrefillStream(engine(ci)).attach([spec])
    spec_pf, _ = spec_engine(ci, ci["tmodel"], ci["tmodel"])
    with pytest.raises(ValueError, match="spec"):
        PrefillStream(spec_pf).attach([engine(ci)])
    stream = PrefillStream(spec_pf)
    stream.attach([spec])
    assert stream._targets == [spec]
    with pytest.raises(ValueError, match="spec-mode mismatch"):
        engine(ci).admit_prefilled(spec_pf.prefill_compute(requests(ci, keys=True)[:1], 4, 1), [0])


def slot_state(eng) -> dict:
    out = {f"big.{k}": v for k, v in vars(eng.big).items() if torch.is_tensor(v)}
    for k in ("key_cache", "value_cache", "key_scale", "value_scale", "cache_mask", "cache_len", "cursor",
              "base_len", "budget", "n_generated", "done", "live", "health", "seeds", "counters", "dep_key",
              "dep_value", "dep_mask"):  # fmt: skip
        if getattr(eng, k) is not None:
            out[k] = getattr(eng, k)
    return {k: v.clone() for k, v in out.items()}


def assert_same_state(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8)), k


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("na", [False, True], ids=["ci", "na"])
def test_a_handoff_gives_the_local_prefill_state(na, kv):
    model, config, prompts = small(na, seed=1, n=5)
    kw = dict(SMALL_ENGINE, kv_cache_dtype=kv, device="cpu")
    make = lambda: GenerationEngine(model, config, template=prompts[0][0], **kw)  # noqa: E731
    reqs = [Request(prompt=p, max_new_events=b, request_id=i, key=50 + i) for i, (p, b) in enumerate(prompts)]
    local, decode, pf = make(), make(), make()
    groups = []  # the local engine's prefill groups, each handed off the same way
    dispatch = local._dispatch_group
    local._dispatch_group = lambda g: (groups.append(g), dispatch(g))
    for r in reqs[:3]:
        local.submit(copy.copy(r))
    local.plan_and_dispatch()
    assert sorted(len(g.requests) for g in groups) != [3]  # a group width of its own, or a padded group
    for g in groups:
        h = pf.prefill_compute([reqs[r.request_id] for r in g.requests], g.bucket_len, g.group_size)
        decode.admit_prefilled(h, list(g.slots))
    assert_same_state(slot_state(local), slot_state(decode))
    handed = len(groups)
    for r in reqs[3:]:  # the rest: local prefill on both, then decoding to the end
        local.submit(copy.copy(r))
        decode.submit(copy.copy(r))
    assert_same_results(local.run(), decode.run())
    assert decode.stats()["handoffs_admitted"] == handed == pf.stats()["prefill_computes"]
    assert pf.occupied == 0 and not pf.live.any()


def test_two_groups_of_one_key_before_either_is_admitted(ci):
    """Each handoff owns a copy of its outputs: the second call of the same
    program key does not overwrite the first handoff."""
    pf, local, decode = engine(ci), engine(ci), engine(ci)
    reqs = requests(ci, keys=True)[:2]
    bucket = pf.scheduler.bucket_for(4)
    first, second = (pf.prefill_compute([r], bucket, 1) for r in reqs)
    decode.admit_prefilled(second, [1])
    decode.admit_prefilled(first, [0])
    for r in reqs:
        local.submit(copy.copy(r))
    local.plan_and_dispatch()
    assert [t.request_id for t in local._table] == [r.request_id for r in reqs]
    assert_same_results(local.run(), decode.run())


@pytest.fixture(scope="module")
def jax_spec(ci):
    from eventstreamgpt_tpu.serving import SpecConfig as JaxSpecConfig
    from eventstreamgpt_tpu.serving import truncated_draft as jax_truncated_draft

    jdcfg, jdparams = jax_truncated_draft(ci["jcfg"], ci["params"], 1)
    spec = JaxSpecConfig(model=JaxModel(jdcfg), params=jdparams, config=jdcfg, **STRICT)
    return jax_engine(ci, greedy=True, spec=spec).run(jax_requests(ci))


def test_spec_engines_behind_a_spec_prefill_stream_match_jax(ci, jax_spec):
    """JAX's ``tests/test_composition.py::test_spec_x_prefill_stream_parity``
    (its stream equals its synchronous spec engine) against the port: strict
    greedy spec engines behind a spec prefill stream; the decode engine
    runs no prefill program."""
    def spec():
        dcfg, draft = truncated_draft(ci["tcfg"], ci["tmodel"], 1)
        return engine(ci, greedy=True, spec=SpecConfig(model=draft, config=dcfg, **STRICT))

    svc = ServingService([spec()], prefill_stream=PrefillStream(spec()))
    got = svc.run(requests(ci))
    assert_matches_jax(jax_spec, got, key=lambda r: getattr(r, "admission_index"))
    s = svc.stats()
    assert s["replicas"][0]["prefill_dispatches"] == 0 and s["replicas"][0]["handoffs_admitted"] > 0
    assert s["prefill_stream"]["prefilled_total"] == 5


# ---------------------------------------------------------------- (4) service
def test_replica_constraints(ci):
    e1 = engine(ci)
    with pytest.raises(ValueError, match="distinct engine"):
        ServingService([e1, e1])
    with pytest.raises(ValueError, match="share max_len"):
        ServingService([e1, engine(ci, max_len=ENGINE["max_len"] + 2)])
    with pytest.raises(ValueError, match="max_queue"):
        ServingService([engine(ci, max_queue=4)])
    with pytest.raises(ValueError, match="speculative-decoding configuration"):
        ServingService([engine(ci), spec_engine(ci, ci["tmodel"], ci["tmodel"])[0]])
    with pytest.raises(ValueError, match="draft weights differ"):
        ServingService([spec_engine(ci, ci["tmodel"], m)[0] for m in (ci["tmodel"], ci["tmodel2"])])
    with pytest.raises(ValueError, match="at least one engine replica"):
        ServingService([])


def test_submit_validation_and_reject_path(ci):
    svc = ServingService([engine(ci)], lanes=(LaneConfig("interactive", max_pending=1),))
    row = requests(ci)[1].prompt
    with pytest.raises(ValueError, match="exceeds max_len"):
        svc.submit(Request(prompt=row, max_new_events=ENGINE["max_len"]))
    with pytest.raises(KeyError, match="unknown lane"):
        svc.submit(Request(prompt=row, max_new_events=2), lane="batch")
    assert svc.submit(Request(prompt=row, max_new_events=2))
    assert not svc.submit(Request(prompt=row, max_new_events=2))  # the lane is full
    assert svc.stats()["lanes"]["interactive"]["rejected"] == 1
    assert svc._next_index == 1  # the rejected request bound no admission index


def test_prefill_budget_spreads_bursts(ci):
    base = engine(ci, n_slots=4, dispatch_depth=1).run(requests(ci))
    eng = engine(ci, n_slots=4)
    capped = eng.run(requests(ci), max_padded_events=4)
    assert_same_results(base, capped)
    assert eng.stats()["prefill_deferrals"] >= 1
    svc = ServingService([engine(ci, n_slots=4)], prefill_budget_events=4, seed=0)
    assert_same_results(base, [dataclasses.replace(r, request_id=r.admission_index) for r in svc.run(requests(ci))])
    assert svc.stats()["replicas"][0]["prefill_deferrals"] >= 1


def test_accepted_subset_parity_under_rejection(ci):
    svc = ServingService([engine(ci)], lanes=(LaneConfig("interactive", max_pending=2),), seed=13)
    reqs = requests(ci)
    accepted = [r for r in reqs if svc.submit(r)]
    assert len(accepted) == 2
    results = svc.run()
    ref = engine(ci, dispatch_depth=1, seed=13).run([dataclasses.replace(r, key=None) for r in accepted])
    assert_same_results(ref, results)


def test_min_share_keeps_batch_lane_moving(ci):
    svc = ServingService([engine(ci, n_slots=4)], seed=17,
                         lanes=(LaneConfig("interactive", priority=0), LaneConfig("batch", priority=1, min_share=0.25)))  # fmt: skip
    batch = Request(prompt=requests(ci)[0].prompt, max_new_events=2, request_id=99)
    results = svc.run([(r, "interactive") for r in requests(ci)] + [(batch, "batch")])
    assert any(r.request_id == 99 and r.lane == "batch" for r in results) and len(results) == 6
    q = latency_quantiles(results)
    assert set(q) == {"interactive", "batch", "overall"} and q["overall"]["p95_ms"] >= q["overall"]["p50_ms"] >= 0


@pytest.mark.parametrize("stream", [False, True], ids=["local", "stream"])
def test_greedy_two_replica_service_matches_jax(ci, jax_flipped_service, stream):
    """Both services over hot-swap replicas flipped to the second weights;
    the port's prefill engine is built on them directly (the weights check
    reads the flipped replicas' live tensors)."""
    replicas = [engine(ci, hot_swap=True, greedy=True) for _ in range(2)]
    for e in replicas:
        e.load_shadow(ci["tmodel2"].state_dict())
        e.flip()
    pf = PrefillStream(engine(ci, ci["tmodel2"], greedy=True)) if stream else None
    svc = ServingService(replicas, prefill_stream=pf)
    got = svc.run(lanes_of(requests(ci)))
    assert_matches_jax(jax_flipped_service, got, key=lambda r: r.admission_index)
    assert {r.replica for r in got} == {r.replica for r in jax_flipped_service} == {0, 1}
    assert [r.lane for r in got] == [r.lane for r in jax_flipped_service]


@pytest.mark.parametrize("stream", [False, True], ids=["local", "stream"])
def test_sampled_service_equals_a_single_engine(ci, stream):
    ref = engine(ci, n_slots=4, seed=5).run(requests(ci))
    pf = PrefillStream(engine(ci)) if stream else None
    svc = ServingService([engine(ci), engine(ci, decode_chunk=3)], seed=5, prefill_stream=pf)
    got = svc.run([(r, "batch" if i % 3 == 0 else "interactive") for i, r in enumerate(requests(ci))])
    assert [r.admission_index for r in got] == list(range(5)) and all(r.ok for r in got)
    assert_same_results(ref, [dataclasses.replace(r, request_id=r.admission_index) for r in got], float_tol=1e-5)
    s = svc.stats()
    assert s["accepted_total"] == 5 and len(s["replicas"]) == 2
    if stream:
        assert s["prefill_stream"]["prefilled_total"] == 5
        assert all(r["prefill_dispatches"] == 0 for r in s["replicas"])
        assert sum(r["handoffs_admitted"] for r in s["replicas"]) == s["prefill_stream"]["dispatches"]


def test_fork_through_the_service(ci):
    paged = dict(paged_kv=True, block_size=4)
    svc = ServingService([engine(ci, **paged), engine(ci, **paged)], seed=3)
    row = requests(ci)[1].prompt
    indices = svc.fork(row, 2, 3, request_id="f")
    assert indices == [1, 2]  # the session took index 0
    results = svc.run()
    assert [r.request_id for r in results] == [("f", 0), ("f", 1)] and {r.replica for r in results} == {0}
    from eventstreamgpt_tpu_torch.generation.sampling import derive_request_seed

    session = derive_request_seed(3, 0)
    ref = engine(ci, **paged).run([Request(prompt=row, max_new_events=3, request_id=("f", j),
                                           key=derive_request_seed(session, j)) for j in range(2)])  # fmt: skip
    assert_same_results(ref, results)
    with pytest.raises(ValueError, match="paged KV cache"):
        ServingService([engine(ci)]).fork(row, 2, 3)


def test_deadlines_expire_queued_requests(ci):
    svc = ServingService([engine(ci, n_slots=1)], lanes=(LaneConfig("interactive", deadline_s=1e-9),))
    svc.submit(Request(prompt=requests(ci)[0].prompt, max_new_events=2, arrival_time=-1.0))
    results = svc.step(lambda: 0.0)
    assert len(results) == 1 and isinstance(results[0].error, DeadlineExceeded) and results[0].replica == -1
    assert svc.pending() == 0 and not svc.busy()


def test_the_stream_is_pumped_in_a_round_with_an_expiry(ci):
    """A round that expires a queued request still pumps the prefill stream:
    the request placed in that round is admitted in it (JAX's ``step``
    skips the pump in such a round)."""
    lanes = (LaneConfig("interactive"), LaneConfig("batch", priority=1, deadline_s=1e-9))
    replica = engine(ci)
    svc = ServingService([replica], lanes=lanes, prefill_stream=PrefillStream(engine(ci)))
    row = requests(ci)[0].prompt
    svc.submit(Request(prompt=row, max_new_events=2, request_id="late", arrival_time=-1.0), lane="batch")
    svc.submit(Request(prompt=row, max_new_events=2, request_id="live"))
    results = svc.step(lambda: 0.0)
    assert [r.request_id for r in results] == ["late"] and isinstance(results[0].error, DeadlineExceeded)
    assert svc.stats()["prefill_stream"]["prefilled_total"] == 1 and svc.prefill_stream.pending == 0
    assert replica.stats()["handoffs_admitted"] == 1 and replica.occupied
    while svc.busy():
        results += svc.step(lambda: 0.0)
    assert [(r.request_id, r.ok, r.n_generated) for r in results] == [("late", False, 0), ("live", True, 2)]


def test_a_replay_trace_in_the_default_lane_without_fetching(ci):
    """``use_arrival_times`` offers each request when it arrives on the
    service's clock, ``default_lane`` takes the requests given without a
    lane, and ``fetch_results=False`` reads no rows: the counts equal those
    of the same requests submitted at once."""
    ref = ServingService([engine(ci)], seed=7).run(requests(ci))
    trace = [dataclasses.replace(r, arrival_time=0.002 * i) for i, r in enumerate(requests(ci))]
    svc = ServingService([engine(ci)], seed=7, default_lane="batch")
    got = svc.run(trace, use_arrival_times=True, fetch_results=False)
    assert [r.lane for r in got] == ["batch"] * 5 and all(r.ok and r.batch is None and r.latency >= 0 for r in got)
    assert [(r.admission_index, r.n_events, r.n_generated) for r in got] == [
        (r.admission_index, r.n_events, r.n_generated) for r in ref
    ]
    with pytest.raises(ValueError, match="default_lane"):
        ServingService([engine(ci)], default_lane="bulk")
