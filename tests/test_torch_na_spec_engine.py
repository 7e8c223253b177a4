"""The PyTorch port's NA speculative engine against its own sequential walk and NA engine, on the CPU.

The companion of ``tests/test_torch_na_spec.py`` (its fixtures: the NA
model of ``tests/test_torch_na_engine.py``, fp32, JAX's weights carried over
by `load_jax_params`, the one-layer truncated draft), for the checks that
need no JAX run, each with its tolerance:

1. the exactness contract: the verify window's per-level predictions,
   contextualized embeddings and cache writes equal the sequential cached
   walk's over the same events and history, rtol 1e-5, atol 1e-6; and the
   correction walk frozen below its break (drafts whose level-1 or level-2
   heads are perturbed) commits the sequential engine's events, integers
   exact, floats within 1e-5 (JAX's walk, which reads the breaking level's
   fill at the frozen levels, is printed beside it);
2. sampled runs are invariant to the slot count and the request order, and
   ``reset()`` repeats the first pass bit for bit, float and fp8 caches;
3. per-row budgets and dead-row stops as in JAX's
   ``test_per_row_budgets_and_dead_rows``;
4. the captured flow with the `RerunGraph` stand-in: one capture a key, one
   replay a chunk and a prefill group, results, proposals and acceptances
   equal the eager engine's, again after ``reset()``.

The laws of the committed events are ``tests/test_torch_na_spec_law.py``'s.
"""

import contextlib
import copy

import pytest
import torch

from eventstreamgpt_tpu_torch.models.transformer import NAPast, init_kv_caches, mask_batch_to_levels
from eventstreamgpt_tpu_torch.models.transformer import na_level_of_measurement, time_from_deltas
from eventstreamgpt_tpu_torch.serving import Request, SpecConfig
from eventstreamgpt_tpu_torch.serving import engine as engine_module
from eventstreamgpt_tpu_torch.utils.graphs import CapturedProgram, ProgramFamily

from .test_torch_engine import EXACT, MAX_LEN, assert_same_results, port_requests, to_torch
from .test_torch_na_engine import addresses, state
from .test_torch_na_spec import PLUMBING, assert_preds_close, drafts, na, port_engine, port_spec, rows4  # noqa: F401
from .test_torch_prefill import RerunGraph


# ------------------------------------------------- (1) the exactness contract
def sequential_walk(tmodel, tcfg, row, p, n):
    """The cached walk over events ``p .. p + n - 1`` of ``row`` after a
    prefix of ``p`` events, teacher-forced (each level's input masked to the
    levels below it, as the walk wrote the event), each event's levels then
    its target-0 forward: each event's per-level predictions (level 0 from
    the forward of the event before it), each target-0 forward's
    contextualized embeddings, the sequence cache and the prefix's
    contextualized embeddings of its last event."""
    G = len(tcfg.measurements_per_dep_graph_level)
    lvl = na_level_of_measurement(tcfg)
    pre = tmodel(row.slice((slice(None), slice(0, p))), use_cache=True, return_contextualized=True,
                 past=NAPast(seq_past=init_kv_caches(tcfg, row.batch_size, MAX_LEN, device="cpu")))  # fmt: skip
    past, level0 = pre.past_key_values, pre.preds.map(lambda x: x[:, p - 1])
    preds, ctx = {}, {}
    for e in range(p, p + n):
        ev = row.slice((slice(None), slice(e, e + 1)))
        preds[(e, 0)] = level0
        for level in range(1, G):
            out = tmodel(mask_batch_to_levels(ev, lvl, level - 1), past=past, use_cache=True,
                         dep_graph_el_generation_target=level)  # fmt: skip
            past, preds[(e, level)] = out.past_key_values, out.preds.map(lambda x: x[:, 0])
        out = tmodel(ev, past=past, use_cache=True, dep_graph_el_generation_target=0, return_contextualized=True)
        past, level0 = out.past_key_values, out.preds.map(lambda x: x[:, 0])
        ctx[e] = [c[:, 0] for c in out.contextualized]
    preds[(p + n, 0)] = level0
    return preds, ctx, past.seq_past, pre


def test_window_equals_the_sequential_walk(na):
    """The verify window over events ``p .. p + K`` (the last committed event
    and ``K`` proposals) on the cache of the ``p`` events before it, with the
    history head of event ``p - 1``: level 0 of event ``p + v + 1`` at window
    index ``v`` and levels >= 1 of event ``p + v`` at index ``v`` are the
    sequential walk's, its contextualized embedding at index ``v`` the one
    the walk's target-0 forward of event ``p + v`` gives (the history head
    the engine carries), and its cache writes the walk's."""
    _, _, _, tcfg, tmodel, _ = na
    from .test_generation import make_prompt

    row = to_torch(make_prompt(B=2, L=8, seed=7))
    row = row.replace(time=time_from_deltas(row))  # slices keep absolute times, as the engine's views do
    p, K = 2, 3
    G = len(tcfg.measurements_per_dep_graph_level)
    eng = port_engine(na, spec=SpecConfig(model=tmodel, config=tcfg, k=K))
    window = row.slice((slice(None), slice(p, p + K + 1)))
    with torch.no_grad():
        seq_preds, seq_ctx, seq_cache, pre = sequential_walk(tmodel, tcfg, row, p, K + 1)
        history = tuple(c[:, p - 1] for c in pre.contextualized)
        out = tmodel(window, past=NAPast(seq_past=pre.past_key_values.seq_past), use_cache=True,
                     partial_content_levels=True, history_head=history, return_contextualized=True)  # fmt: skip
        full = tmodel(window, past=NAPast(seq_past=pre.past_key_values.seq_past), use_cache=True,
                      history_head=history)  # fmt: skip
    for v in range(K + 1):
        for level in range(G):
            event = p + v + 1 if level == 0 else p + v
            got = eng._level_preds(out.preds.map(lambda x, s=v: x[:, s]), level)
            assert_preds_close(eng._level_preds(seq_preds[(event, level)], level), got, **PLUMBING)
        for layer, c in enumerate(out.contextualized):
            torch.testing.assert_close(c[:, v], seq_ctx[p + v][layer], **PLUMBING)
    for w_c, s_c in zip(out.past_key_values.seq_past, seq_cache):
        assert w_c.length == s_c.length == p + K + 1
        for w in ("key", "value"):
            torch.testing.assert_close(getattr(w_c, w), getattr(s_c, w), **PLUMBING)
    # Without partial content, a finished event's level-1 prediction reads its later levels: not the walk's.
    got = eng._level_preds(full.preds.map(lambda x: x[:, 0]), 1).classification["event_type"][1].logits
    want = eng._level_preds(seq_preds[(p, 1)], 1).classification["event_type"][1].logits
    assert not torch.allclose(got, want, **PLUMBING)


def perturbed_draft(tmodel, rows, scale, seed=0):
    """The target with noise on the classification head's rows ``rows`` (its TTE and encoder untouched)."""
    draft = copy.deepcopy(tmodel)
    with torch.no_grad():
        w = draft.output_layer.ClassificationLayer.weight
        w[rows].add_(scale * torch.randn(w[rows].shape, generator=torch.Generator().manual_seed(seed)))
    return draft


def test_correction_walk_below_the_break_equals_the_sequential_engine(na, monkeypatch):
    """A draft that agrees on the time and disagrees on ``event_type``
    (level 1) breaks rounds at level 1, and one that disagrees on the level-2
    heads breaks them at level 2: the events committed equal the greedy NA
    engine's, integers exact, floats within 1e-5 (the last ``time_delta``,
    the next event's time that a round may have drafted, excepted). JAX's
    correction walk reads the break level's fill at the frozen levels; the
    same walk unmasked moves the level-2 values (printed)."""
    _, _, _, tcfg, tmodel, prompt = na
    reqs = [Request(prompt=to_torch(p), max_new_events=11, request_id=i) for p, i in rows4(prompt)]
    base = port_engine(na, greedy=True, max_len=16).run(copy.deepcopy(reqs))

    def run(draft):
        eng = port_engine(na, greedy=True, spec=SpecConfig(model=draft, config=tcfg, k=3), max_len=16)
        return eng.run(copy.deepcopy(reqs)), eng.stats()["spec_acceptance_rate"]

    def max_value_diff(res):
        for a, b in zip(res, base):
            assert (a.n_events, a.n_generated) == (b.n_events, b.n_generated)
            for f in EXACT[:4]:
                assert torch.equal(getattr(a.batch, f), getattr(b.batch, f)), f
        return max(float((a.batch.dynamic_values - b.batch.dynamic_values).abs().max()) for a, b in zip(res, base))

    rates = {}
    for name, rows in (("level 1", slice(1, 4)), ("level 2", slice(4, None))):
        res, rates[name] = run(perturbed_draft(tmodel, rows, 1.0 if name == "level 1" else 0.05))
        assert max_value_diff(res) < 1e-5, name
        for a, b in zip(res, base):
            torch.testing.assert_close(a.batch.time_delta[:, :-1], b.batch.time_delta[:, :-1], rtol=1e-5, atol=1e-5)
    assert all(0.0 < r < 1.0 for r in rates.values()), rates
    walk = engine_module.GenerationEngine._walk

    def unmasked(self, model, big, cursor, dep, streams=None, write=None, **kw):
        if model is self._model and streams is not None:
            kw["mask_levels"] = False
        return walk(self, model, big, cursor, dep, streams, write, **kw)

    monkeypatch.setattr(engine_module.GenerationEngine, "_walk", unmasked)
    jax_like = max_value_diff(run(perturbed_draft(tmodel, slice(1, 4), 1.0))[0])
    print(f"acceptance {rates}; the correction walk unmasked (JAX's): level-2 values off by {jax_like:.3g}")


# ------------------------------------------------------ (2) sampled invariance
@pytest.mark.parametrize("kv_cache_dtype", [None, "fp8"], ids=["float", "fp8"])
def test_sampled_na_spec_runs_are_invariant_and_reset_repeats_them(na, drafts, kv_cache_dtype):
    prompt = na[5]
    sc = port_spec(drafts, value_rtol=1e-3, value_atol=1e-6)

    def run(n_slots, order=None, eng=None):
        if eng is None:
            eng = port_engine(na, n_slots=n_slots, kv_cache_dtype=kv_cache_dtype, spec=sc)
            eng.scheduler.group_sizes = (2,)  # as tests/test_torch_na_engine.py's invariance test
        return eng, eng.run(port_requests(prompt, keys=True, order=order))

    eng, base = run(2)
    assert all(r.error is None and r.n_events == r.prompt_len + r.n_generated for r in base)
    assert eng.stats()["spec_rounds"] > 0
    counts = [(r.spec_proposed, r.spec_accepted) for r in base]
    for n_slots, order in ((4, None), (2, [4, 2, 0, 3, 1]), (4, [3, 1, 4, 0, 2])):
        other = run(n_slots, order)[1]
        assert_same_results(base, other)
        assert [(r.spec_proposed, r.spec_accepted) for r in sorted(other, key=lambda r: r.request_id)] == counts
    greedy = port_engine(na, greedy=True, spec=sc).run(port_requests(prompt, keys=True))
    assert any(not torch.equal(a.batch.time_delta, b.batch.time_delta) for a, b in zip(base, greedy))

    extra = ("draft_dep_key", "draft_dep_value", "draft_dep_mask", "spec_history", "draft_key_cache",
             "draft_value_cache", "draft_cache_mask", "draft_cache_len")  # fmt: skip

    def spec_state(e):
        return {k: getattr(e, k).view(torch.uint8).clone() if getattr(e, k).dtype == torch.float8_e4m3fn
                else getattr(e, k).clone() for k in extra}  # fmt: skip

    ptrs = dict(addresses(eng), **{k: getattr(eng, k).data_ptr() for k in extra})
    fresh = port_engine(na, kv_cache_dtype=kv_cache_dtype, spec=sc)
    want = dict(state(fresh), **spec_state(fresh))
    eng.reset()
    assert dict(addresses(eng), **{k: getattr(eng, k).data_ptr() for k in extra}) == ptrs
    got = dict(state(eng), **spec_state(eng))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _, again = run(2, eng=eng)
    assert_same_results(base, again)
    assert [(r.spec_proposed, r.spec_accepted) for r in again] == counts


# ------------------------------------------------------- (3) budgets and dead rows
def test_per_row_budgets_and_dead_rows(na, drafts):
    sc = port_spec(drafts, k=3, value_rtol=1e-3, value_atol=1e-6)
    prompt = to_torch(na[5])
    reqs = [Request(prompt=prompt.slice((slice(i, i + 1), slice(0, 4))), max_new_events=b, key=30 + i, request_id=i)
            for i, b in enumerate((1, 2, 4))]  # fmt: skip
    results = port_engine(na, spec=sc).run(reqs)
    assert [r.n_events - r.prompt_len for r in results] == [1, 2, 4]
    assert all(0 <= r.spec_accepted <= r.n_events - r.prompt_len for r in results)
    dead = prompt.replace(event_mask=prompt.event_mask.clone())
    dead.event_mask[0, 2:] = False
    res = port_engine(na, spec=sc).run([Request(prompt=dead.slice((slice(0, 1), slice(0, 4))), max_new_events=4,
                                                key=5, request_id=0)])[0]  # fmt: skip
    assert res.n_generated == 0 and res.n_events < MAX_LEN


# ------------------------------------------------------------ (4) captured flow
def test_captured_na_spec_flow_equals_the_eager_engine(na, drafts, monkeypatch):
    replay = CapturedProgram.replay
    monkeypatch.setattr(CapturedProgram, "replay", lambda self: (self.fn(), replay(self))[1])
    stand_in = dict(device="cpu", graph=RerunGraph, graph_context=lambda g, stream: contextlib.nullcontext())
    sc = port_spec(drafts, value_rtol=1e-3, value_atol=1e-6)
    prompt = na[5]

    def engine(captured):
        eng = port_engine(na, spec=sc)
        eng.scheduler.group_sizes = (2,)
        if captured:
            eng._families = {k: ProgramFamily(f"the {k} program", **stand_in) for k in ("prefill", "extract")}
            eng._capture_chunk(CapturedProgram(eng._chunk, "the spec chunk", **stand_in))
        return eng

    eager, captured = engine(False), engine(True)
    want = eager.run(port_requests(prompt, keys=True))
    replays = prefills = 0
    for _ in range(2):
        got = captured.run(port_requests(prompt, keys=True))
        assert_same_results(want, got)
        assert [(r.spec_proposed, r.spec_accepted) for r in got] == [(r.spec_proposed, r.spec_accepted) for r in want]
        s, e = captured.stats(), eager.stats()
        assert s["graph_captures"] == 1 and s["graph_warmup_chunks"] == 1 and s["cuda_graph"]
        assert s["graph_replays"] - replays == s["dispatched_chunks"] > 0
        assert s["prefill_graph_replays"] - prefills == s["prefill_dispatches"] > 0
        assert s["prefill_graph_keys"] == s["prefill_graph_captures"] > 0
        assert (s["spec_rounds"], s["dispatched_chunks"], s["active_slot_steps"]) == (
            e["spec_rounds"], e["dispatched_chunks"], e["active_slot_steps"])
        replays, prefills = s["graph_replays"], s["prefill_graph_replays"]
        captured.reset()
