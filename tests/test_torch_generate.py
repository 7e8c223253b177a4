"""The PyTorch port's cohort ``generate()`` and the NA cached walk against the JAX package, on the CPU.

The fixtures are ``tests/test_generation.py``'s (``ci_config``, ``na_config``,
``make_prompt``: levels ``[[], ["event_type"], ["multi_lab", "lab_vals"]]``)
with a lognormal-mixture TTE head at a narrow log-time scale (as
``tests/test_torch_engine.py``'s ``local_lognormal``: an untrained head's
greedy times stay moderate, where fp32 sin/cos of the cumulative time does
not turn last-ulp differences into different events). Weights are JAX's,
carried over by `load_jax_params`; everything is fp32. Each JAX generation
is built once, in module-scoped fixtures.

Checked, each with its tolerance:

* the NA cached walk against JAX's, module by module (after JAX's
  ``tests/models/test_na_model.py:146``): the prefix's hidden states and
  `NAPast` (sequence caches, reset dep-graph caches), then two consecutive
  events' targets 1..G-1 and 0, within rtol 2e-5, atol 1e-6;
* the port's cached walk against its own uncached forward at the same
  slices (rtol 1e-4, atol 1e-5, JAX's test's tolerance), with the shared
  cursor and with per-row cursors (the decode-step program's form);
* greedy `generate()` against JAX's (both patched greedy through their
  module's ``sample_predictions``) for CI and NA, cached and uncached,
  ``max_new_events`` 3, ``num_return_sequences`` 2: events, indices and
  masks equal, ``time_delta`` and ``dynamic_values`` within rtol 1e-5,
  atol 1e-6;
* the port's versions of JAX's generation contracts
  (``tests/test_generation.py:131-390``): sampled cached against uncached
  (CI: indices exact, floats rtol 1e-3, atol 1e-4; NA: JAX's rtol 0.1, atol
  1e-3 on times, the first new event's type exact: later draws of the two
  paths may differ by design, see the test), seeds, ``num_return_sequences`` and
  ``split_repeated_batch``, ``max_length``, `MaxLengthCriteria` folding, a
  criterion met by the prompt, a custom criterion (its events a bit-for-bit
  prefix of the unstopped run), ``return_output``, the non-finite guard,
  ``mesh=`` and packed prompts;
* the program cache keyed on the config, as JAX keys it: a second config on
  one model builds its own programs and equals JAX's greedy ``generate()``
  with that config.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eventstreamgpt_tpu.generation.generation_utils as jgu
import eventstreamgpt_tpu_torch.generation.generation_utils as tgu
from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxCI
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.models.na_model import NAPPTForGenerativeSequenceModeling as JaxNA
from eventstreamgpt_tpu.models.transformer import NAPast as JaxNAPast
from eventstreamgpt_tpu.models.transformer import NestedAttentionPointProcessTransformer as JaxEncoder
from eventstreamgpt_tpu.models.transformer import init_kv_caches as jax_init_kv_caches
from eventstreamgpt_tpu.models.transformer import time_from_deltas as jax_time_from_deltas
from eventstreamgpt_tpu_torch.convert import load_jax_params
from eventstreamgpt_tpu_torch.data.types import EventStreamBatch
from eventstreamgpt_tpu_torch.generation import (
    GenerationOutput,
    MaxLengthCriteria,
    StoppingCriteria,
    StoppingCriteriaList,
    generate,
)
from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.models.na_model import NAPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.transformer import KVCache, NAPast, init_kv_caches, time_from_deltas

from .test_generation import ci_config, make_prompt, na_config

NARROW_TTE = dict(
    TTE_generation_layer_type="log_normal_mixture",
    TTE_lognormal_generation_num_components=2,
    mean_log_inter_event_time_min=1.0,
    std_log_inter_event_time_min=0.1,
)
WALK = dict(rtol=2e-5, atol=1e-6)  # the NA walk against JAX's
OWN_WALK = dict(rtol=1e-4, atol=1e-5)  # the port's walk against its own uncached forward
GREEDY_FLOATS = dict(rtol=1e-5, atol=1e-6)
EXACT = ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask")
FLOATS = ("time_delta", "dynamic_values")
CPU = dict(device="cpu")


def to_torch(batch) -> EventStreamBatch:
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(EventStreamBatch)}
    return EventStreamBatch(**{k: None if v is None else torch.from_numpy(np.array(v)) for k, v in fields.items()})


def build(na: bool):
    """(JAX config, JAX model, params, port config, port model) on one set of weights."""
    jcfg = JaxConfig.from_dict(dict((na_config() if na else ci_config()).to_dict(), **NARROW_TTE))
    jmodel = (JaxNA if na else JaxCI)(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), make_prompt())
    tcfg = StructuredTransformerConfig.from_dict(jcfg.to_dict())
    cls = NAPPTForGenerativeSequenceModeling if na else CIPPTForGenerativeSequenceModeling
    tmodel = load_jax_params(cls(tcfg), jax.tree_util.tree_map(np.asarray, params))
    return jcfg, jmodel, params, tcfg, tmodel


@pytest.fixture(scope="module")
def models():
    return {name: build(name == "na") for name in ("ci", "na")}


# ------------------------------------------------------------------ (1), (2) the NA walk
def jax_walk(jcfg, params, batch, n_decode=2):
    """JAX's prefix over all but ``n_decode`` events, then each remaining event's
    targets 1..G-1 and 0: [(label, hidden states, NAPast)]."""
    apply = jax.jit(JaxEncoder(jcfg).apply, static_argnames=("use_cache", "dep_graph_el_generation_target"))
    ep = {"params": params["params"]["encoder"]}
    B, L = batch.event_mask.shape
    out = apply(ep, batch.slice((slice(None), slice(0, L - n_decode))),
                    past=JaxNAPast(seq_past=jax_init_kv_caches(jcfg, B, max_len=L), dep_graph_past=None),
                    use_cache=True)  # fmt: skip
    steps = [("prefix", out.last_hidden_state, out.past_key_values)]
    t_full = jax_time_from_deltas(batch)
    G = len(jcfg.measurements_per_dep_graph_level)
    for ev in range(L - n_decode, L):
        trimmed = batch.slice((slice(None), slice(ev, ev + 1))).replace(time=t_full[:, ev : ev + 1])
        for target in list(range(1, G)) + [0]:
            out = apply(ep, trimmed, past=out.past_key_values, use_cache=True,
                            dep_graph_el_generation_target=target)  # fmt: skip
            steps.append((f"event {ev} target {target}", out.last_hidden_state, out.past_key_values))
    return steps


def port_walk(tmodel, tcfg, batch, n_decode=2, per_row=False):
    """`jax_walk` on the port's encoder; ``per_row``: the sequence caches'
    lengths as ``(B,)`` tensors (the decode-step program's form)."""
    enc = tmodel.encoder
    B, L = batch.event_mask.shape
    out = enc(batch.slice((slice(None), slice(0, L - n_decode))),
              past=NAPast(seq_past=init_kv_caches(tcfg, B, L, device="cpu"), dep_graph_past=None), use_cache=True)  # fmt: skip
    steps = [("prefix", out.last_hidden_state, out.past_key_values)]
    past = out.past_key_values

    def rowwise(caches):
        return tuple(c if torch.is_tensor(c.length) else
                     dataclasses.replace(c, length=torch.full((B,), c.length, dtype=torch.int32)) for c in caches)  # fmt: skip

    t_full = time_from_deltas(batch)
    G = len(tcfg.measurements_per_dep_graph_level)
    for ev in range(L - n_decode, L):
        trimmed = batch.slice((slice(None), slice(ev, ev + 1))).replace(time=t_full[:, ev : ev + 1])
        for target in list(range(1, G)) + [0]:
            if per_row:
                past = NAPast(seq_past=rowwise(past.seq_past), dep_graph_past=past.dep_graph_past)
            out = enc(trimmed, past=past, use_cache=True, dep_graph_el_generation_target=target)
            past = out.past_key_values
            steps.append((f"event {ev} target {target}", out.last_hidden_state, past))
    return steps


def assert_cache_close(t: KVCache, j, what):
    for f in ("key", "value"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f"{what} {f}", **WALK)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask), err_msg=f"{what} mask")
    assert int(t.length) == int(j.length), what


@pytest.fixture(scope="module")
def walk_batch():
    return make_prompt(B=2, L=5, seed=3)


def test_na_cached_walk_matches_jax_module_by_module(models, walk_batch):
    jcfg, _, params, tcfg, tmodel = models["na"]
    want = jax_walk(jcfg, params, walk_batch)
    with torch.no_grad():
        got = port_walk(tmodel, tcfg, to_torch(walk_batch))
    assert [w[0] for w in want] == [g[0] for g in got]
    for (label, jh, jpast), (_, th, tpast) in zip(want, got):
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), err_msg=f"{label} hidden", **WALK)
        for level in ("seq_past", "dep_graph_past"):
            for i, (tc, jc) in enumerate(zip(getattr(tpast, level), getattr(jpast, level))):
                assert_cache_close(tc, jc, f"{label} {level}[{i}]")


@pytest.mark.parametrize("per_row", [False, True], ids=["shared_cursor", "per_row_cursors"])
def test_na_cached_walk_matches_its_uncached_forward(models, walk_batch, per_row):
    """Each step's output equals the full forward's slice: the prefix's events,
    target t's element t - 1, target 0's whole-event element, over two events
    (the second reads the post-reset buffer)."""
    _, _, _, tcfg, tmodel = models["na"]
    batch = to_torch(walk_batch)
    G = len(tcfg.measurements_per_dep_graph_level)
    with torch.no_grad():
        full = tmodel.encoder(batch).last_hidden_state
        steps = port_walk(tmodel, tcfg, batch, per_row=per_row)
    L = batch.sequence_length
    np.testing.assert_allclose(steps[0][1].numpy(), full[:, : L - 2].numpy(), **OWN_WALK)
    for label, h, _ in steps[1:]:
        ev, target = int(label.split()[1]), int(label.split()[3])
        np.testing.assert_allclose(h[:, 0, 0].numpy(), full[:, ev, (target or G) - 1].numpy(), err_msg=label, **OWN_WALK)
    reset = steps[G][2].dep_graph_past[0]  # after the first event's target 0
    assert reset.length == 1 and reset.key.shape[2] == G + 1 and bool(reset.mask[:, 0].all()) and not bool(reset.mask[:, 1:].any())


def test_na_output_layer_generation_targets(models, walk_batch):
    """Target > 0 gives that level's heads only and no TTE head; target 0 the TTE head only."""
    _, _, _, tcfg, tmodel = models["na"]
    batch = to_torch(walk_batch)
    with torch.no_grad():
        enc = torch.zeros(2, 1, 1, tcfg.hidden_size)
        heads = {t: tmodel.output_layer(batch.slice((slice(None), slice(0, 1))), enc, is_generation=True,
                                        dep_graph_el_generation_target=t).preds for t in (0, 1, 2)}  # fmt: skip
        with pytest.raises(ValueError, match="is_generation"):
            tmodel.output_layer(batch, enc, is_generation=False, dep_graph_el_generation_target=1)
    assert heads[0].time_to_event is not None and not heads[0].classification
    assert set(heads[1].classification) == {"event_type"} and heads[1].time_to_event is None
    assert set(heads[2].classification) == {"multi_lab", "lab_vals"} and set(heads[2].regression) == {"lab_vals"}


# --------------------------------------------------------------- (3) greedy parity
GREEDY_CASES = [(m, c) for m in ("ci", "na") for c in (True, False)]


@pytest.fixture(scope="module")
def jax_greedy(models):
    """JAX's greedy generations: ``sample_predictions`` patched greedy, the step cache emptied."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgu, "sample_predictions", functools.partial(jgu.sample_predictions, greedy=True))
        mp.setattr(jgu, "_STEP_CACHE", {})
        for name, cached in GREEDY_CASES:
            jcfg, jmodel, params, _, _ = models[name]
            out[name, cached] = jax.tree_util.tree_map(np.asarray, jgu.generate(
                jmodel, params, make_prompt(), jcfg, jax.random.PRNGKey(1), max_new_events=3,
                num_return_sequences=2, use_cache=cached))  # fmt: skip
    return out


def assert_same_events(got: EventStreamBatch, want, floats=GREEDY_FLOATS, exact=EXACT):
    for f in exact:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f, **floats)


@pytest.mark.parametrize("name,cached", GREEDY_CASES, ids=[f"{m}-{'cached' if c else 'uncached'}" for m, c in GREEDY_CASES])
def test_greedy_generate_matches_jax(models, jax_greedy, monkeypatch, name, cached):
    _, _, _, tcfg, tmodel = models[name]
    monkeypatch.setattr(tgu, "sample_predictions", functools.partial(tgu.sample_predictions, greedy=True))
    got = generate(tmodel, to_torch(make_prompt()), tcfg, seed=1, max_new_events=3, num_return_sequences=2,
                   use_cache=cached, **CPU)  # fmt: skip
    assert got.sequence_length == 6 and got.batch_size == 4 and bool(got.event_mask.all())
    assert_same_events(got, jax_greedy[name, cached])


# ------------------------------------------------------------- (4) the contracts
def run(models, name, **kw):
    _, _, _, tcfg, tmodel = models[name]
    kw = {"max_new_events": 3, "seed": 7, **kw}
    return generate(tmodel, to_torch(kw.pop("prompt", make_prompt())), tcfg, **kw, **CPU)


@pytest.mark.parametrize("name", ["ci", "na"])
def test_sampled_cached_matches_uncached(models, name):
    cached, uncached = run(models, name, use_cache=True), run(models, name, use_cache=False)
    if name == "ci":
        assert_same_events(cached, uncached, floats=dict(rtol=1e-3, atol=1e-4))
    else:
        # The first new event's type (level 1, drawn before any of its content exists) is equal; later draws may
        # differ by design (as in the JAX package): the cached walk embedded each graph element of an event before
        # its later levels were written, and in the joint embedding mode every element sums the whole event's
        # tokens, which the full forward sees finished.
        n = make_prompt().sequence_length
        assert torch.equal(cached.dynamic_indices[:, : n + 1, 0], uncached.dynamic_indices[:, : n + 1, 0])
        np.testing.assert_allclose(cached.time_delta.numpy(), uncached.time_delta.numpy(), rtol=0.1, atol=1e-3)


@pytest.mark.parametrize("name", ["ci", "na"])
def test_seed_determinism(models, name):
    a, b, c = run(models, name), run(models, name), run(models, name, seed=8)
    assert_same_events(a, b, floats=dict(rtol=0, atol=0))
    assert not torch.equal(a.time_delta, c.time_delta)


def test_num_return_sequences_order_and_split(models):
    out = run(models, "ci", num_return_sequences=3)
    assert out.batch_size == 6
    assert torch.equal(out.dynamic_indices[0, :3], out.dynamic_indices[1, :3])
    assert not torch.equal(out.time_delta[0, 3:], out.time_delta[1, 3:])  # repeated rows draw their own streams
    splits = out.split_repeated_batch(3)
    assert len(splits) == 3 and splits[0].batch_size == 2
    assert torch.equal(splits[1].dynamic_indices[1], out.dynamic_indices[4])


def test_repeat_and_split_match_jax():
    prompt = make_prompt()
    want = prompt.repeat_batch_elements(3)
    got = to_torch(prompt).repeat_batch_elements(3)
    for f in dataclasses.fields(EventStreamBatch):
        w = getattr(want, f.name)
        if w is not None:
            np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(w), err_msg=f.name)
    for g, w in zip(got.split_repeated_batch(3), want.split_repeated_batch(3)):
        np.testing.assert_array_equal(g.dynamic_indices.numpy(), np.asarray(w.dynamic_indices))


def test_preallocate_matches_jax():
    prompt = make_prompt()
    want = jgu._preallocate(prompt, 4)
    got = tgu._preallocate(to_torch(prompt), 4)
    assert got.time is None
    for f in tgu._SEQ_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


def test_max_length_resolution(models):
    assert run(models, "ci", max_new_events=None, max_length=5).sequence_length == 5
    with pytest.raises(ValueError, match="must be positive"):
        run(models, "ci", max_new_events=None, max_length=3)
    assert run(models, "ci", max_new_events=None).sequence_length == models["ci"][3].max_seq_len


def test_max_length_criteria_fold_into_the_bound(models):
    out = run(models, "ci", max_new_events=5, stopping_criteria=StoppingCriteriaList([MaxLengthCriteria(5)]))
    assert out.sequence_length == 5
    out = run(models, "ci", max_new_events=None, max_length=5,
              stopping_criteria=StoppingCriteriaList([MaxLengthCriteria(8)]))  # fmt: skip
    assert out.sequence_length == 5
    crits = StoppingCriteriaList([MaxLengthCriteria(20), MaxLengthCriteria(8)])
    assert crits.max_length == 8 and crits(None, n_events=8) and not crits(None, n_events=7)


def test_criterion_met_by_the_prompt_returns_it(models):
    prompt = to_torch(make_prompt())
    out = run(models, "ci", prompt=make_prompt(), max_new_events=5,
              stopping_criteria=StoppingCriteriaList([MaxLengthCriteria(3)]), return_output=True)  # fmt: skip
    assert isinstance(out, GenerationOutput) and out.batch.sequence_length == 3
    assert torch.equal(out.batch.dynamic_indices, prompt.dynamic_indices) and out.n_generated.tolist() == [0, 0]


class StopAfter(StoppingCriteria):
    """Fires on its ``n``-th consultation (one before the loop, one a completed event)."""

    def __init__(self, n):
        self.n, self.calls = n, 0

    def __call__(self, batch, **kwargs) -> bool:
        self.calls += 1
        return self.calls >= self.n


@pytest.mark.parametrize("name", ["ci", "na"])
def test_custom_criterion_stops_on_a_prefix_of_the_full_run(models, name):
    full = run(models, name, max_new_events=5)
    stopped = run(models, name, max_new_events=5, stopping_criteria=StoppingCriteriaList([StopAfter(3)]))
    em = stopped.event_mask
    assert stopped.sequence_length == 8 and em.sum(dim=1).tolist() == [5, 5] and not bool(em[:, 5:].any())
    for f in EXACT + FLOATS:  # the last event's delta is the filler 1 until the next event is drawn
        n = 4 if f == "time_delta" else 5
        assert torch.equal(getattr(stopped, f)[:, :n], getattr(full, f)[:, :n]), f
    assert bool((stopped.time_delta[:, 4] == 1).all())


def test_return_output_counts(models):
    out = run(models, "na", return_output=True)
    assert out.input_len == 3 and out.n_generated.dtype == torch.int32
    assert out.n_generated.tolist() == out.batch.event_mask[:, 3:].sum(dim=1).tolist() == [3, 3]


def test_nonfinite_prompt_raises_unless_told_not_to(models):
    bad = make_prompt()
    bad = bad.replace(time_delta=bad.time_delta.at[0, 1].set(jnp.nan))
    with pytest.raises(ValueError, match="Non-finite"):
        run(models, "ci", prompt=bad, max_new_events=2)
    assert run(models, "ci", prompt=bad, max_new_events=2, do_validate_batch=False).sequence_length == 5


def test_refusals(models):
    with pytest.raises(ValueError, match="Queue 1 item 7"):
        run(models, "ci", mesh=object())
    packed = make_prompt()
    with pytest.raises(NotImplementedError, match="padded"):
        run(models, "ci", prompt=packed.replace(segment_ids=jnp.zeros((2, 3), jnp.int32)))
    _, _, _, tcfg, tmodel = models["ci"]
    with pytest.raises(ValueError, match="parameters are on cpu"):
        generate(tmodel, to_torch(make_prompt()), tcfg, max_new_events=2, device="meta")


def test_program_cache_reuses_a_key_and_holds_the_model_weakly(models):
    before = tgu.program_stats()["keys"]
    run(models, "ci", max_new_events=4)
    mid = tgu.program_stats()["keys"]
    run(models, "ci", max_new_events=4, seed=3)
    assert tgu.program_stats()["keys"] == mid <= before + 1
    _, _, _, tcfg, _ = models["ci"]
    throwaway = CIPPTForGenerativeSequenceModeling(tcfg)
    generate(throwaway, to_torch(make_prompt()), tcfg, max_new_events=2, **CPU)
    n = tgu.program_stats()["keys"]
    del throwaway
    run(models, "ci", max_new_events=4)
    assert tgu.program_stats()["keys"] == n - 1


def test_a_second_config_on_one_model_builds_its_own_programs(models, monkeypatch):
    """The program cache keys on the config, as JAX's does: a copy of the
    config whose ``multi_lab`` is dropped, on the same model, gets its own
    programs (two keys), equals a call on an emptied cache, and equals JAX's
    greedy ``generate()`` with that config."""
    jcfg, jmodel, params, tcfg, _ = models["ci"]
    d = copy.deepcopy(jcfg.to_dict())
    d["measurement_configs"]["multi_lab"]["modality"] = "dropped"
    jcfg2, tcfg2 = JaxConfig.from_dict(copy.deepcopy(d)), StructuredTransformerConfig.from_dict(copy.deepcopy(d))
    model = load_jax_params(CIPPTForGenerativeSequenceModeling(tcfg), jax.tree_util.tree_map(np.asarray, params))
    monkeypatch.setattr(tgu, "sample_predictions", functools.partial(tgu.sample_predictions, greedy=True))
    prompt = to_torch(make_prompt())

    def call(config):
        return generate(model, prompt, config, seed=1, max_new_events=3, **CPU)

    first, second = call(tcfg), call(tcfg2)
    assert tgu.program_stats(model)["keys"] == 2
    assert not torch.equal(first.dynamic_indices, second.dynamic_indices)
    monkeypatch.setattr(tgu, "_PROGRAMS", type(tgu._PROGRAMS)())
    assert_same_events(call(tcfg2), second, floats=dict(rtol=0, atol=0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgu, "sample_predictions", functools.partial(jgu.sample_predictions, greedy=True))
        mp.setattr(jgu, "_STEP_CACHE", {})
        mp.setattr(jgu, "_SIG_CACHE", {})
        want = jgu.generate(jmodel, params, make_prompt(), jcfg2, jax.random.PRNGKey(1), max_new_events=3)
    assert_same_events(second, want)


@pytest.mark.parametrize("mode", ["categorical_only", "numerical_only", "categorical_and_numerical"])
def test_split_level_fill_matches_jax(mode):
    """A split dep-graph level's fill (``(measurement, mode)`` entries) writes what JAX's writes, exactly."""
    from eventstreamgpt_tpu.generation.sampling import GenerativeSequenceModelSamples as JaxSamples
    from eventstreamgpt_tpu.generation.sampling import update_last_event_data as jax_fill
    from eventstreamgpt_tpu_torch.generation.sampling import GenerativeSequenceModelSamples, update_last_event_data

    jcfg = na_config()
    tcfg = StructuredTransformerConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(0)
    cls = (rng.random((2, 4)) < 0.5).astype(np.int32)
    reg = rng.normal(size=(2, 4)).astype(np.float32)
    reg[0, 1] = np.nan
    em = np.array([True, False])
    to_fill = {("lab_vals", mode), "event_type"}
    prompt, cursor = make_prompt(), np.array([3, 2], np.int32)
    et = np.array([1, 2], np.int32)
    want = jax_fill(prompt, JaxSamples(event_mask=jnp.asarray(em), classification={"lab_vals": jnp.asarray(cls),
                    "event_type": jnp.asarray(et)}, regression={"lab_vals": jnp.asarray(reg)}), jcfg,
                    jnp.asarray(cursor), measurements_to_fill=to_fill)  # fmt: skip
    got = to_torch(prompt)
    sample = GenerativeSequenceModelSamples(
        event_mask=torch.from_numpy(em),
        classification={"lab_vals": torch.from_numpy(cls), "event_type": torch.from_numpy(et)},
        regression={"lab_vals": torch.from_numpy(reg)},
    )
    update_last_event_data(got, sample, tcfg, torch.from_numpy(cursor), to_fill)
    for f in ("dynamic_indices", "dynamic_measurement_indices", "dynamic_values", "dynamic_values_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
