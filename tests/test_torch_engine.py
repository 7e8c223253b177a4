"""The PyTorch port's serving engine against the JAX engine, on the CPU.

* Greedy decoding: the JAX `GenerationEngine(greedy=True)` and the port's
  engine, same weights (carried by `load_jax_params`) and prompts, more
  requests than slots: every integer and structure field of every result is
  exact, floats within 1e-4.
* Sampled decoding: the port's results are identical when the slot count or
  the request order changes (a request's stream depends only on its seed);
  a one-slot engine's floats may differ in the last bits (one-row products).
* Device: with no ``device`` argument and no CUDA device, construction raises.
* Refusals: meshes (not ported yet); a hot-swap engine's flip with nothing
  staged; ``prefill_stream``, no keyword of either engine. Options the JAX
  engine refuses (the paged cache's sizes, the
  megakernel on a paged cache, speculative decoding on a paged cache,
  ``fork()``'s checks) raise in the port with the JAX engine's messages,
  checked against both engines.
"""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.serving import GenerationEngine as JaxEngine
from eventstreamgpt_tpu.serving import Request as JaxRequest
from eventstreamgpt_tpu.serving.engine import derive_request_key
from eventstreamgpt_tpu_torch.convert import load_jax_params
from eventstreamgpt_tpu_torch.data.types import EventStreamBatch
from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.serving import GenerationEngine, MalformedPromptRejected, Request, SlotHealthError

from .test_generation import BASE_KWARGS, MEASUREMENT_CONFIGS, make_prompt

MAX_LEN = 8
ENGINE = dict(n_slots=2, max_len=MAX_LEN, decode_chunk=2, min_bucket=2)
EXACT = ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask",
         "static_indices", "static_measurement_indices")  # fmt: skip
CLOSE = ("time_delta", "dynamic_values", "start_time")
CONFIGS = {
    "global_exponential": {},
    "local_lognormal": dict(
        seq_attention_types=["local", "global"],
        seq_window_size=2,
        TTE_generation_layer_type="log_normal_mixture",
        TTE_lognormal_generation_num_components=2,
        # A narrow log-time scale keeps an untrained head's greedy means (and
        # so the temporal encoding's inputs) moderate: at the default scale
        # they reach 1e7 minutes, where fp32 sin/cos of the cumulative time
        # turns last-ulp differences into different events.
        mean_log_inter_event_time_min=1.0,
        std_log_inter_event_time_min=0.1,
    ),
}


def to_torch(batch) -> EventStreamBatch:
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(EventStreamBatch)}
    return EventStreamBatch(**{k: None if v is None else torch.from_numpy(np.array(v)) for k, v in fields.items()})


def build(name="global_exponential"):
    jcfg = JaxConfig(measurement_configs=dict(MEASUREMENT_CONFIGS), **dict(BASE_KWARGS, **CONFIGS[name]))
    prompt = make_prompt(B=4, L=5)
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), prompt)
    tcfg = StructuredTransformerConfig.from_dict(jcfg.to_dict())
    tmodel = load_jax_params(CIPPTForGenerativeSequenceModeling(tcfg), jax.tree_util.tree_map(np.asarray, params))
    return jcfg, jmodel, params, tcfg, tmodel, prompt


def prompt_rows(prompt, n=5):
    """(row, prompt_len, budget) for n requests of mixed lengths and budgets."""
    out = []
    for i in range(n):
        Lp = (3, 4, 5)[i % 3]
        out.append((prompt.slice((slice(i % 4, i % 4 + 1), slice(0, Lp))), Lp, MAX_LEN - Lp - (i % 2)))
    return out


def port_requests(prompt, keys=False, order=None):
    rows = prompt_rows(prompt)
    order = range(len(rows)) if order is None else order
    return [
        Request(prompt=to_torch(rows[i][0]), max_new_events=rows[i][2], request_id=i, key=(1000 + i) if keys else None)
        for i in order
    ]


def by_id(results):
    return {r.request_id: r for r in results}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_engine_matches_jax_engine(name):
    jcfg, jmodel, params, tcfg, tmodel, prompt = build(name)
    jeng = JaxEngine(jmodel, params, jcfg, template=prompt, greedy=True, **ENGINE)
    jres = by_id(jeng.run([JaxRequest(prompt=p, max_new_events=b, request_id=i)
                           for i, (p, _, b) in enumerate(prompt_rows(prompt))]))  # fmt: skip
    teng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), greedy=True, device="cpu", **ENGINE)
    tres = by_id(teng.run(port_requests(prompt)))
    assert sorted(jres) == sorted(tres) == list(range(5))
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
    s = teng.stats()
    assert s["dispatched_chunks"] > 0
    assert s["slot_steps"] == s["dispatched_chunks"] * ENGINE["decode_chunk"] * ENGINE["n_slots"]
    assert s["prompt_events"] == jeng.stats()["prompt_events"]


def assert_same_results(a, b, float_tol=0.0):
    a, b = by_id(a), by_id(b)
    assert sorted(a, key=repr) == sorted(b, key=repr)
    for i in a:
        assert (a[i].n_events, a[i].n_generated, a[i].prompt_len) == (b[i].n_events, b[i].n_generated, b[i].prompt_len)
        for f in EXACT:
            torch.testing.assert_close(getattr(a[i].batch, f), getattr(b[i].batch, f), rtol=0, atol=0)
        for f in CLOSE:
            torch.testing.assert_close(getattr(a[i].batch, f), getattr(b[i].batch, f), rtol=float_tol, atol=float_tol)


def test_sampled_engine_is_invariant_to_slots_and_order():
    _, _, _, tcfg, tmodel, prompt = build("local_lognormal")
    template = to_torch(prompt)

    def run(n_slots, order=None, keys=True, **kw):
        eng = GenerationEngine(tmodel, tcfg, template=template, device="cpu",
                               **dict(ENGINE, n_slots=n_slots, **kw))  # fmt: skip
        return eng.run(port_requests(prompt, keys=keys, order=order))

    base = run(2)
    assert_same_results(base, run(3))
    assert_same_results(base, run(2, order=[4, 2, 0, 3, 1]))
    # A one-slot engine multiplies one-row matrices, which the CPU BLAS runs
    # down another code path: the same events, floats within the last bits.
    assert_same_results(run(1, keys=False), run(4, keys=False), float_tol=1e-6)
    # Filtering changes the categorical draws' support but keeps the invariance.
    assert_same_results(run(2, top_k=2), run(4, top_k=2, order=[3, 1, 4, 0, 2]))
    greedy = run(2, greedy=True)
    assert any(
        not torch.equal(a.batch.dynamic_indices, b.batch.dynamic_indices)
        for a, b in zip(sorted(base, key=lambda r: r.request_id), sorted(greedy, key=lambda r: r.request_id))
    )


def test_default_device_needs_cuda():
    _, _, _, tcfg, tmodel, prompt = build()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(tmodel, tcfg, template=to_torch(prompt), **ENGINE)


@pytest.mark.parametrize(
    "kw",
    [dict(prefill_stream=object()), dict(mesh=object()), dict(hot_swap=True)],
    ids=lambda kw: next(iter(kw)),
)  # fmt: skip
def test_features_outside_the_slice_raise(kw):
    """Meshes are not ported. Hot swap is: the engine builds and refuses a
    flip with nothing staged, in JAX's words. ``prefill_stream`` is no
    keyword of JAX's engine (the stream is the service's), so it is an
    unknown argument, as there."""
    _, _, _, tcfg, tmodel, prompt = build()
    make = lambda: GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **dict(ENGINE, **kw))  # noqa: E731
    if "hot_swap" in kw:
        with pytest.raises(RuntimeError, match=r"no shadow checkpoint loaded \(call load_shadow first\)"):
            make().flip()
    elif "prefill_stream" in kw:
        assert "prefill_stream" not in inspect.signature(JaxEngine.__init__).parameters
        with pytest.raises(TypeError, match="unexpected keyword argument 'prefill_stream'"):
            make()
    else:
        with pytest.raises(ValueError, match="not part of the PyTorch port"):
            make()


def test_paged_spec_raises_as_in_jax():
    """Speculative decoding is ported; with the paged cache it raises JAX's message in both engines."""
    from eventstreamgpt_tpu.serving import SpecConfig as JaxSpecConfig
    from eventstreamgpt_tpu.serving import truncated_draft as jax_truncated_draft
    from eventstreamgpt_tpu_torch.serving import SpecConfig, truncated_draft

    jcfg, jmodel, params, tcfg, tmodel, prompt = build()
    jdcfg, jdparams = jax_truncated_draft(jcfg, params, 1)
    tdcfg, tdraft = truncated_draft(tcfg, tmodel, 1)
    match = "paged KV cache does not compose with speculative decoding yet"
    with pytest.raises(ValueError, match=match):
        JaxEngine(jmodel, params, jcfg, template=prompt, paged_kv=True, block_size=4,
                  spec=JaxSpecConfig(model=JaxModel(jdcfg), params=jdparams, config=jdcfg), **ENGINE)  # fmt: skip
    with pytest.raises(ValueError, match=match):
        GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", paged_kv=True, block_size=4,
                         spec=SpecConfig(model=tdraft, config=tdcfg), **ENGINE)  # fmt: skip


@pytest.mark.parametrize(
    "kw,match",
    [(dict(kv_cache_dtype="int4"), "unknown kv_cache_dtype"), (dict(dispatch_depth=0), "dispatch_depth must be >= 1"),
     (dict(num_blocks=65), "num_blocks requires paged_kv=True"),
     (dict(paged_kv=True, block_size=3), r"block_size \(3\) must divide max_len \(8\)"),
     (dict(paged_kv=True, block_size=0), r"block_size \(0\) must divide max_len \(8\)"),
     (dict(paged_kv=True, block_size=4, num_blocks=2), r"num_blocks \(2\) must fit at least one full slot table \(2\)"),
     (dict(paged_kv=True, block_size=4, decode_step_impl="pallas"), "block-table indirection is not fused yet")],
    ids=lambda x: next(iter(x)) if isinstance(x, dict) else None,
)  # fmt: skip
def test_invalid_engine_options_raise_as_in_jax(kw, match):
    """The ported options refuse what the JAX engine refuses, with its messages."""
    _, jmodel, params, tcfg, tmodel, prompt = build()
    with pytest.raises(ValueError, match=match):
        JaxEngine(jmodel, params, JaxConfig.from_dict(tcfg.to_dict()), template=prompt, **dict(ENGINE, **kw))
    with pytest.raises(ValueError, match=match):
        GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **dict(ENGINE, **kw))


JAX_KNOB_REFUSALS = [
    (dict(sampling_impl="multi_op"), "sampling_impl='multi_op': .*kernel A"),
    (dict(sampling_impl="xla"), "sampling_impl='xla': .*kernel A"),
    (dict(sampling_impl="pallas_interpret"), "sampling_impl='pallas_interpret': .*interpret mode"),
    (dict(decode_step_impl="pallas_interpret"), "decode_step_impl='pallas_interpret': .*interpret mode"),
    (dict(base_key=object()), "base_key=.*not part of the PyTorch port"),
]


@pytest.mark.parametrize("kw,match", JAX_KNOB_REFUSALS, ids=[m.split(":")[0] for _, m in JAX_KNOB_REFUSALS])
def test_jax_engine_knobs_are_refused_with_value_error(kw, match):
    """Each is a keyword of the JAX engine; a value the port does not compute
    raises ``ValueError`` naming what is missing (never ``TypeError``)."""
    assert set(kw) <= set(inspect.signature(JaxEngine.__init__).parameters)
    _, _, _, tcfg, tmodel, prompt = build()
    with pytest.raises(ValueError, match=match):
        GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **dict(ENGINE, **kw))


def test_jax_engine_knobs_are_taken_at_what_the_port_computes():
    _, _, _, tcfg, tmodel, prompt = build()
    for kw in (dict(sampling_impl=None, decode_step_impl=None, block_size=16, num_blocks=None),
               dict(sampling_impl="auto", decode_step_impl="auto"),
               dict(sampling_impl="pallas", decode_step_impl="pallas")):  # fmt: skip
        eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **dict(ENGINE, **kw))
        assert eng.stats()["decode_step_impl"] == "decode_stack_step"
    for kw in (dict(decode_step_impl="xla"), dict(paged_kv=True, block_size=4),
               dict(paged_kv=True, block_size=4, decode_step_impl="auto")):  # fmt: skip
        eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **dict(ENGINE, **kw))
        assert eng.stats()["decode_step_impl"] == "unfused"


FORK_REFUSALS = {
    "monolithic": (dict(paged=False), dict(n_branches=2), ValueError, r"fork\(\) needs the paged KV cache"),
    "no_branches": ({}, dict(n_branches=0), ValueError, "n_branches must be >= 1"),
    "more_branches_than_slots": ({}, dict(n_branches=3), ValueError,
                                 r"n_branches \(3\) cannot exceed n_slots \(2\)"),
    "both_ids": ({}, dict(n_branches=2, request_id="f", request_ids=["a", "b"]), ValueError,
                 "pass request_id or request_ids, not both"),
    "short_ids": ({}, dict(n_branches=2, request_ids=["a"]), ValueError, "request_ids has 1 entries for 2 branches"),
    "queue_full": (dict(max_queue=1), dict(n_branches=2), RuntimeError,
                   "admission queue cannot hold a 2-branch fork group"),
}  # fmt: skip


@pytest.mark.parametrize("case", sorted(FORK_REFUSALS))
def test_fork_refusals_as_in_jax(case):
    """``fork()`` refuses what the JAX engine's refuses, with its messages;
    a refused group leaves the queue empty (the fork is atomic)."""
    engine_kw, fork_kw, error, match = FORK_REFUSALS[case]
    engine_kw = dict(engine_kw)
    paged = dict(paged_kv=True, block_size=4) if engine_kw.pop("paged", True) else {}
    jcfg, jmodel, params, tcfg, tmodel, prompt = build()
    row = prompt.slice((slice(0, 1), slice(0, 3)))
    jeng = JaxEngine(jmodel, params, jcfg, template=prompt, **dict(ENGINE, **paged, **engine_kw))
    teng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **dict(ENGINE, **paged, **engine_kw))
    with pytest.raises(error, match=match):
        jeng.fork(row, max_new_events=2, key=derive_request_key(jax.random.PRNGKey(0), 0), **fork_kw)
    with pytest.raises(error, match=match):
        teng.fork(to_torch(row), max_new_events=2, key=0, **fork_kw)
    assert teng.scheduler.pending == jeng.scheduler.pending == 0
    assert teng.scheduler.padding_report()["rejected_total"] == jeng.scheduler.padding_report()["rejected_total"]


def test_results_are_bitwise_invariant_to_dispatch_depth():
    """Sampled decoding at depths 1, 2 and 3: a stale boundary harvests a
    frozen row, and a slot admitted after a boundary was issued is never
    harvested from it, so every result is bit-identical."""
    _, _, _, tcfg, tmodel, prompt = build("local_lognormal")
    runs = {}
    for depth in (1, 2, 3):
        eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu",
                               **dict(ENGINE, dispatch_depth=depth))  # fmt: skip
        runs[depth] = eng.run(port_requests(prompt))
        s = eng.stats()
        assert s["dispatch_depth"] == depth and s["resolved_chunks"] == s["dispatched_chunks"]
        assert eng.inflight_chunks == 0
    assert all(r.error is None for r in runs[1])
    assert_same_results(runs[1], runs[2])
    assert_same_results(runs[1], runs[3])


def poisoned_engine(tcfg, tmodel, prompt, slot=0, chunk=1, **kw):
    """An engine whose ``slot`` gets a NaN ``time_delta`` behind its last
    committed event just before chunk ``chunk`` is issued (as the JAX
    engine's ``nan_slot`` fault does): the next forward goes non-finite."""
    eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **dict(ENGINE, **kw))
    issue = eng.issue_chunk

    def poisoning_issue():
        if eng._dispatched_chunks == chunk and eng._table[slot] is not None:
            col = max(int(eng.cursor[slot]) - 2, 0)
            eng.big.time_delta[slot, col] = float("nan")
        issue()

    eng.issue_chunk = poisoning_issue
    return eng


@pytest.mark.parametrize("depth", [1, 2])
def test_health_retry_reproduces_the_clean_run_bitwise(depth):
    """A NaN-poisoned slot with ``health_retries=1`` is requeued at the front
    with its seed fixed and reproduces the clean run bit for bit (co-residents
    untouched); with no budget the request fails with `SlotHealthError`
    (JAX: tests/test_serving_faults.py, the slot-quarantine suite)."""
    _, _, _, tcfg, tmodel, prompt = build("local_lognormal")
    clean = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu",
                             **dict(ENGINE, dispatch_depth=depth)).run(port_requests(prompt))  # fmt: skip
    eng = poisoned_engine(tcfg, tmodel, prompt, health_retries=1, dispatch_depth=depth)
    retried = eng.run(port_requests(prompt))
    assert_same_results(clean, retried)
    s = eng.stats()
    assert (s["health_retried_total"], s["health_quarantined_total"], s["health_failed_total"]) == (1, 1, 0)
    assert s["health_requeued_total"] == 1

    eng = poisoned_engine(tcfg, tmodel, prompt, dispatch_depth=depth)
    failed = by_id(eng.run(port_requests(prompt)))
    bad = [r for r in failed.values() if r.error is not None]
    assert len(bad) == 1 and isinstance(bad[0].error, SlotHealthError) and bad[0].batch is None
    assert bad[0].error.slot == 0
    ok = by_id([r for r in clean if r.request_id != bad[0].request_id])
    assert_same_results(list(ok.values()), [r for r in failed.values() if r.error is None])
    s = eng.stats()
    assert (s["health_retried_total"], s["health_failed_total"]) == (0, 1)


def test_malformed_prompt_rejected_and_nonfinite_slot_quarantined():
    _, _, _, tcfg, tmodel, prompt = build()
    eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **ENGINE)
    bad = port_requests(prompt)[0]
    bad.prompt.time_delta[0, 0] = float("nan")
    with pytest.raises(MalformedPromptRejected):
        eng.submit(bad)
    with torch.no_grad():
        tmodel.output_layer.ClassificationLayer.bias[1] = float("nan")  # an event_type logit
    eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **ENGINE)
    results = eng.run(port_requests(prompt))
    assert len(results) == 5 and all(isinstance(r.error, SlotHealthError) and r.batch is None for r in results)
    assert eng.stats()["health_failed_total"] == 5
