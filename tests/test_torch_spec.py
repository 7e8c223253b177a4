"""The PyTorch port's speculative decoding against the JAX engine's, on the CPU.

At ``tests/test_spec.py``'s geometry (``MAX_LEN`` 8, 2 slots, chunks of 2,
``k`` 2-3, a one-layer truncated draft) with `tests/test_torch_engine.py`'s
models (JAX weights carried by `load_jax_params`). Each JAX spec engine is
built and run once (module cache) and compared with many things:

* the multi-event window on per-row-cursor caches: the window's cache writes
  equal sequential one-event writes bit for bit (float, int8, fp8), window
  position 0 equals the one-event forward, and the window forward's
  predictions equal JAX's within 1e-5;
* `truncated_draft` cut from the loaded target equals `load_jax_params` of
  JAX's truncated tree, tensor for tensor;
* the accept rule's pieces against JAX's on the same inputs (1e-6), the
  greedy accept walk exactly, the sampled residual's law ``(p - q)^+``;
* the strict greedy spec engine (zero tolerances) against JAX's spec engine
  (every integer and structure field exact, floats within 1e-4, per-request
  proposals and acceptances equal) and against the port's non-spec unfused
  greedy engine; int8 caches: events and integers exact, floats within 2e-2;
* ``stats()``, ``padding_report()`` and ``slots_report()`` spec and draft
  keys as JAX's; a perfect draft accepts more than 0.9 over budgets of 11
  events, where JAX's stale draft cache entry (ROADMAP Queue 3) holds JAX's
  under 0.5;
* sampled runs bitwise invariant to ``decode_chunk``, admission order and
  ``dispatch_depth``; per-row budgets and dead rows as in JAX; the spec
  engine's per-head laws equal the baseline's by chi-square (96 requests of
  3 events each side) at a truncated and an adversarial draft;
* JAX's refusals with JAX's messages;
* the captured path's control flow with `RerunGraph`: one spec-chunk replay a
  dispatch and one prefill replay a group, results equal the eager engine's.
"""

import contextlib
import copy
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eventstreamgpt_tpu.serving.spec as jspec
import eventstreamgpt_tpu_torch.serving.spec as tspec
from eventstreamgpt_tpu.generation.sampling import sample_head_draws as jax_draws
from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.models.na_model import NAPPTForGenerativeSequenceModeling as JaxNA
from eventstreamgpt_tpu.serving import GenerationEngine as JaxEngine
from eventstreamgpt_tpu.serving import Request as JaxRequest
from eventstreamgpt_tpu.serving import SpecConfig as JaxSpecConfig
from eventstreamgpt_tpu_torch import distributions as tdist
from eventstreamgpt_tpu_torch.convert import init_params_from_seed, load_jax_params
from eventstreamgpt_tpu_torch.generation.sampling import RowStreams, sample_head_draws
from eventstreamgpt_tpu_torch.generation.stopping_criteria import MaxLengthCriteria
from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.config import StructuredEventProcessingMode
from eventstreamgpt_tpu_torch.models.model_output import GenerativeSequenceModelPredictions
from eventstreamgpt_tpu_torch.models.na_model import NAPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.transformer import KVCache
from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request, SpecConfig, truncated_draft
from eventstreamgpt_tpu_torch.serving.engine import _CHUNK_STATE
from eventstreamgpt_tpu_torch.utils.graphs import CapturedProgram, ProgramFamily

from .test_spec import assert_same_distribution, collect_head_samples
from .test_torch_engine import (
    CLOSE,
    ENGINE,
    EXACT,
    MAX_LEN,
    assert_same_results,
    build,
    by_id,
    port_requests,
    prompt_rows,
    to_torch,
)
from .test_torch_kv_quant import codes
from .test_torch_model import assert_preds_close
from .test_torch_na_engine import build as build_na
from .test_torch_prefill import RerunGraph

STRICT = dict(k=3, value_rtol=0.0, value_atol=0.0)
CACHE_DTYPES = {None: torch.float32, "int8": torch.int8, "fp8": torch.float8_e4m3fn}


@functools.cache
def models(name="global_exponential"):
    """The JAX target and its one-layer truncated draft, and the port's (cut from the loaded target)."""
    jcfg, jmodel, params, tcfg, tmodel, prompt = build(name)
    jdcfg, jdparams = jspec.truncated_draft(jcfg, params, 1)
    tdcfg, tdraft = truncated_draft(tcfg, tmodel, 1)
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, jdcfg=jdcfg, jdmodel=JaxModel(jdcfg), jdparams=jdparams,
                tcfg=tcfg, tmodel=tmodel, tdcfg=tdcfg, tdraft=tdraft, prompt=prompt)  # fmt: skip


def jax_spec_engine(m, **kw):
    spec = JaxSpecConfig(model=m["jdmodel"], params=m["jdparams"], config=m["jdcfg"], **STRICT)
    return JaxEngine(m["jmodel"], m["params"], m["jcfg"], template=m["prompt"], greedy=True, spec=spec,
                     **dict(ENGINE, **kw))  # fmt: skip


def port_engine(m, spec=None, **kw):
    return GenerationEngine(m["tmodel"], m["tcfg"], template=to_torch(m["prompt"]), device="cpu", spec=spec,
                            **dict(ENGINE, **kw))  # fmt: skip


def port_spec(m, **kw):
    return SpecConfig(model=m["tdraft"], config=m["tdcfg"], **dict(STRICT, **kw))


@functools.cache
def jax_strict_run(name, kv_cache_dtype=None):
    """The JAX strict greedy spec engine on `prompt_rows`' five requests, run once."""
    m = models(name)
    jeng = jax_spec_engine(m, kv_cache_dtype=kv_cache_dtype)
    reqs = [JaxRequest(prompt=p, max_new_events=b, request_id=i) for i, (p, _, b) in enumerate(prompt_rows(m["prompt"]))]
    return jeng, by_id(jeng.run(reqs))


def assert_match_jax(jres, tres, float_tol):
    assert sorted(jres) == sorted(tres) == list(range(5))
    for i, j in jres.items():
        t = tres[i]
        assert t.error is None and j.error is None
        for f in ("admission_index", "prompt_len", "n_events", "n_generated", "spec_proposed", "spec_accepted"):
            assert getattr(t, f) == getattr(j, f), (i, f)
        for f in EXACT:
            np.testing.assert_array_equal(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), err_msg=f)
        for f in CLOSE:
            np.testing.assert_allclose(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), rtol=float_tol,
                                       atol=float_tol, err_msg=f)  # fmt: skip


# ------------------------------------------------------ the verify window
def after_two_steps(eng, reqs):
    """Admits ``reqs`` and runs two one-event decode steps on the engine's
    buffers; returns the cache as it was before them (cloned) and the cursors."""
    for r in reqs:
        eng.submit(r)
    eng.plan_and_dispatch()
    c0 = eng.cursor.clone()
    planes = [None if t is None else t.clone() for t in (eng.key_cache, eng.value_cache, eng.key_scale,
                                                           eng.value_scale)]  # fmt: skip
    mask0, len0 = eng.cache_mask.clone(), eng.cache_len.clone()
    st = {k: getattr(eng, k) for k in _CHUNK_STATE}
    st["counters"] = eng.counters.long()
    with torch.inference_mode():
        st = eng._decode_step(eng._decode_step(st, eng.seeds.long()), eng.seeds.long())

    def caches0():
        scales = [(None, None)] * len(planes[0]) if planes[2] is None else list(zip(planes[2], planes[3]))
        return tuple(KVCache(k, v, mask0, len0, *sc) for k, v, sc in zip(planes[0], planes[1], scales))

    return caches0, c0


@pytest.mark.parametrize("kv", sorted(CACHE_DTYPES, key=str), ids=lambda kv: str(kv or "float"))
def test_window_writes_equal_sequential_writes_bitwise(kv):
    """The K + 1-event window from the last committed event writes the
    positions two sequential one-event steps wrote, bit for bit (codes and
    scales for int8 and fp8), and its position 0 predicts what the one-event
    forward predicts (JAX's ``TestVectorCacheMultiEvent``)."""
    m = models()
    eng = port_engine(m, greedy=True, decode_step_impl="xla", kv_cache_dtype=kv)
    caches0, c0 = after_two_steps(eng, port_requests(m["prompt"])[:2])
    with torch.inference_mode():
        out = eng._model(eng._window_view(c0 - 1, 3), past=caches0(), use_cache=True)
        one = eng._model(eng._window_view(c0 - 1, 1), past=caches0(), use_cache=True)
    for i, c in enumerate(out.past_key_values):
        assert c.key.dtype == CACHE_DTYPES[kv]
        pairs = [(c.key, eng.key_cache[i]), (c.value, eng.value_cache[i])]
        if kv is not None:
            pairs += [(c.key_scale, eng.key_scale[i]), (c.value_scale, eng.value_scale[i])]
        for got, want in pairs:
            for row in range(2):
                lo, hi = int(c0[row]) - 1, int(c0[row]) + 1
                np.testing.assert_array_equal(codes(got[row, :, lo:hi]), codes(want[row, :, lo:hi]))
        assert torch.equal(c.length, c0 + 2)
    # Position 0 as the one-event forward, to the last bit or two: the CPU's
    # GEMM takes other kernels for a 3-row and a 1-row query block.
    first = out.preds.map(lambda x: x[:, :1])
    for a, b in zip(flat(first), flat(one.preds)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def flat(preds):
    out = []
    preds.map(lambda x: out.append(x) or x)
    return out


def test_window_forward_matches_jax():
    """The window forward's predictions at every position, cache written
    from per-row cursors, against JAX's window forward on the same weights
    and state, within 1e-5."""
    m = models("local_lognormal")
    jeng = JaxEngine(m["jmodel"], m["params"], m["jcfg"], template=m["prompt"], greedy=True, **ENGINE)
    for i, (p, _, b) in enumerate(prompt_rows(m["prompt"])[:2]):
        jeng.submit(JaxRequest(prompt=p, max_new_events=b, request_id=i))
    jeng.plan_and_dispatch()
    st0 = jeng._state
    step = jax.jit(jeng._decode_step_ci)  # compiled: JAX's eager ops take longer here
    st2 = step(m["params"], step(m["params"], st0))
    window = jax.jit(lambda p, v, c: m["jmodel"].apply(p, v, past=c, use_cache=True, is_generation=True))
    jout = window(m["params"], jeng._window_view(st2.big, st0.cursor - 1, 3), st0.caches)
    eng = port_engine(m, greedy=True, decode_step_impl="xla")
    caches0, c0 = after_two_steps(eng, port_requests(m["prompt"])[:2])
    np.testing.assert_array_equal(c0.numpy(), np.asarray(st0.cursor))
    with torch.inference_mode():
        tout = eng._model(eng._window_view(c0 - 1, 3), past=caches0(), use_cache=True)
    assert_preds_close(jout.preds, tout.preds)
    for jc, tc in zip(jout.past_key_values, tout.past_key_values):
        np.testing.assert_allclose(tc.key.numpy(), np.asarray(jc.key), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_paged_cache_refuses_a_window():
    from eventstreamgpt_tpu_torch.models.transformer import PagedKVCache

    m = models()
    attn = m["tmodel"].encoder.h0.attn.attention
    past = PagedKVCache.init(2, 4, 5, 4, MAX_LEN, 4, device="cpu")
    with pytest.raises(ValueError, match="paged caches take one event per step"):
        attn(torch.zeros(2, 3, 16), layer_past=past, use_cache=True)


# ---------------------------------------------------------------- the draft
@pytest.mark.parametrize("kind", ["ci", "na"])
def test_truncated_draft_equals_jax_truncated_tree(kind):
    if kind == "ci":
        m = models()
        cls, first_layer = CIPPTForGenerativeSequenceModeling, "encoder.h1.attn.layer_norm.weight"
    else:
        jcfg, _, params, tcfg, tmodel, _ = build_na()
        jdcfg, jdparams = jspec.truncated_draft(jcfg, params, 1)
        tdcfg, tdraft = truncated_draft(tcfg, tmodel, 1)
        m = dict(tcfg=tcfg, tmodel=tmodel, jdcfg=jdcfg, jdparams=jdparams, tdcfg=tdcfg, tdraft=tdraft)
        cls, first_layer = NAPPTForGenerativeSequenceModeling, "encoder.h1.block.seq_attn.layer_norm.weight"
    want = load_jax_params(cls(m["tdcfg"]), jax.tree_util.tree_map(np.asarray, m["jdparams"])).state_dict()
    got = m["tdraft"].state_dict()
    assert first_layer in m["tmodel"].state_dict()
    assert sorted(got) == sorted(want) and first_layer not in got
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert m["tdcfg"].num_hidden_layers == 1 and m["tdcfg"].seq_attention_layers == m["jdcfg"].seq_attention_layers
    if kind == "na":
        assert m["tdcfg"].dep_graph_attention_layers == m["jdcfg"].dep_graph_attention_layers
    # Shared with the target, not copied (JAX's tree shares its leaves).
    assert m["tdraft"].output_layer is m["tmodel"].output_layer and m["tdraft"].encoder.h0 is m["tmodel"].encoder.h0
    for n in (0, 2):
        with pytest.raises(ValueError, match=r"num_layers must be in \[1, 2\)"):
            truncated_draft(m["tcfg"], m["tmodel"], n)


# --------------------------------------------------------- the accept rule
def test_logpmf_and_value_close_match_jax():
    rng = np.random.default_rng(0)
    cls, obs = rng.normal(size=(6, 5)).astype(np.float32), rng.normal(size=(6,)).astype(np.float32)
    for o in (obs, None):
        want = jax.vmap(jspec._combined_single_label_logpmf, in_axes=(None if o is None else 0, 0))(
            None if o is None else jnp.asarray(o), jnp.asarray(cls)
        )
        got = tspec._combined_single_label_logpmf(None if o is None else torch.from_numpy(o), torch.from_numpy(cls))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.exp(got.numpy()).sum(-1), 1.0, rtol=1e-5)
    x = rng.normal(size=(40,)).astype(np.float32)
    y = (x * (1 + rng.choice([0.0, 5e-4, 2e-3], size=40))).astype(np.float32)
    x[:3], y[:2] = np.nan, np.nan
    for tol in ((1e-3, 0.0), (0.0, 0.0), (1e-3, 1e-6)):
        want = np.asarray(jspec._value_close(jnp.asarray(x), jnp.asarray(y), *tol))
        np.testing.assert_array_equal(tspec._value_close(torch.from_numpy(x), torch.from_numpy(y), *tol).numpy(), want)
    np.testing.assert_array_equal(tspec._nan_eq(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                                  np.asarray(jspec._nan_eq(jnp.asarray(x), jnp.asarray(y))))  # fmt: skip


def port_preds(jpreds) -> GenerativeSequenceModelPredictions:
    """JAX predictions as the port's, the same numbers."""

    def conv(d):
        if d is None:
            return None
        cls = getattr(tdist, type(d).__name__)
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(d, f.name)
            kw[f.name] = torch.from_numpy(np.array(v)) if isinstance(v, (jax.Array, np.ndarray)) else v
        return cls(**kw)

    def pairs(group):
        return None if group is None else {k: tuple(conv(d) for d in v) for k, v in group.items()}

    return GenerativeSequenceModelPredictions(classification=pairs(jpreds.classification),
                                              regression=pairs(jpreds.regression),
                                              time_to_event=conv(jpreds.time_to_event))  # fmt: skip


@pytest.mark.parametrize("tol", [(0.0, 0.0), (1e-3, 1e-6), (0.5, 0.5)], ids=["strict", "default", "loose"])
def test_greedy_accept_walk_matches_jax_exactly(tol):
    """On the same predictions and draws (JAX's, carried over): the target
    and the truncated draft (every third row the target itself) at every
    position of four prompt rows, greedy."""
    m = models("local_lognormal")
    prompt = m["prompt"]
    tp = m["jmodel"].apply(m["params"], prompt, is_generation=True).preds
    dp = m["jdmodel"].apply(m["jdparams"], prompt, is_generation=True).preds
    rows = lambda t: jax.tree_util.tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), t)  # noqa: E731
    tp, dp = rows(tp), rows(dp)
    # Every third row's draft is the target itself (accepted at every tolerance).
    same = (np.arange(20) % 3 == 0)
    dp = jax.tree_util.tree_map(lambda t, d: jnp.where(same.reshape((-1,) + (1,) * (t.ndim - 1)), t, d), tp, dp)
    em = prompt.event_mask.reshape(-1)
    keys = jax.random.split(jax.random.PRNGKey(0), em.shape[0])
    jt = jax.vmap(lambda p, k: jax_draws(p, k, greedy=True))(tp, keys)
    jd = jax.vmap(lambda p, k: jax_draws(p, k, greedy=True))(dp, keys)
    acc_j, corr_j = jax.vmap(functools.partial(jspec.spec_accept_level, greedy=True, rtol=tol[0], atol=tol[1]))(
        tp, dp, jd, jt, keys, em
    )
    tpp, dpp = port_preds(tp), port_preds(dp)
    # The same draws: JAX's; the port's own greedy draws agree to the last bit or so.
    td, tt = ({k: torch.from_numpy(np.array(v)) for k, v in d.items()} for d in (jd, jt))
    for k, v in sample_head_draws(tpp, None, greedy=True).items():
        torch.testing.assert_close(v, tt[k], rtol=1e-6, atol=0)
    acc_t, corr_t = tspec.spec_accept_level(tpp, dpp, td, tt, None, torch.from_numpy(np.array(em)), greedy=True,
                                            rtol=tol[0], atol=tol[1])  # fmt: skip
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    assert bool(acc_t.any()) and (tol == (0.5, 0.5) or not bool(acc_t.all()))
    for f in ("classification", "regression"):
        for k, v in getattr(corr_j, f).items():
            np.testing.assert_array_equal(getattr(corr_t, f)[k].numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(corr_t.time_to_event.numpy(), np.asarray(corr_j.time_to_event))
    np.testing.assert_array_equal(corr_t.event_mask.numpy(), np.asarray(corr_j.event_mask))


def test_residual_draw_follows_p_minus_q():
    """The residual's law is ``(p - q)^+`` normalized (chi-square over 20,000
    rows of distinct seeds), a row with ``p == q`` falls back to ``p``, and
    the draw is kernel A's function (Gumbel argmax on the ``spec_res:`` stream)."""
    n = 20_000
    p = torch.tensor([0.5, 0.3, 0.15, 0.05])
    q = torch.tensor([0.2, 0.35, 0.05, 0.4])
    lp, lq = torch.log(p).expand(n, 4), torch.log(q).expand(n, 4)
    streams = RowStreams(torch.arange(n, dtype=torch.int64), torch.full((n,), 3, dtype=torch.int64))
    draws = tspec._residual_categorical(lp, lq, streams.for_name("spec_res:event_type"))
    counts = np.bincount(draws.numpy(), minlength=4)
    r = (p - q).clamp(min=0)
    want = (r / r.sum()).numpy() * n
    assert counts[1] == counts[3] == 0
    assert_same_distribution(counts[[0, 2]], want[[0, 2]].round().astype(int), "residual (p - q)^+")
    same = tspec._residual_categorical(lp[:2000], lp[:2000], RowStreams(streams.seeds[:2000], streams.counters[:2000]))
    assert_same_distribution(np.bincount(same.numpy(), minlength=4), (p.numpy() * 2000).round().astype(int),
                             "degenerate residual falls back to p")  # fmt: skip
    logits = tspec._residual_logits(lp[:8], lq[:8])
    assert torch.equal(logits[:, 1], torch.full((8,), -1e30)) and torch.equal(logits[:, 3], torch.full((8,), -1e30))


def test_select_candidate_is_a_gather():
    em = torch.tensor([True, False, True])
    cands = [tspec.GenerativeSequenceModelSamples(event_mask=em ^ (i == 1), time_to_event=torch.tensor([1.0, 2, 3]) + i,
                                                  classification={"a": torch.tensor([[0, 1], [1, 1], [2, 2]]) * i})
             for i in range(3)]  # fmt: skip
    got = tspec.select_candidate(cands, torch.tensor([2, 0, 1], dtype=torch.int32))
    assert got.event_mask.tolist() == [True, False, False]
    assert got.time_to_event.tolist() == [3.0, 2.0, 4.0]
    assert got.classification["a"].tolist() == [[0, 2], [0, 0], [2, 2]] and got.regression is None


# ------------------------------------------------------------- the engines
@pytest.mark.parametrize("name", ["global_exponential", "local_lognormal"])
def test_strict_greedy_spec_engine_matches_jax_and_the_unfused_engine(name):
    """Zero tolerances: the draft's TTE never equals the target's bit for bit,
    so each round commits the target's own greedy event off the window."""
    m = models(name)
    _, jres = jax_strict_run(name)
    teng = port_engine(m, greedy=True, spec=port_spec(m))
    tres = by_id(teng.run(port_requests(m["prompt"])))
    assert_match_jax(jres, tres, 1e-4)
    assert teng.stats()["decode_step_impl"] == "spec_draft_verify"
    base = by_id(port_engine(m, greedy=True, decode_step_impl="xla").run(port_requests(m["prompt"])))
    for i, b in base.items():
        t = tres[i]
        assert (t.n_events, t.n_generated) == (b.n_events, b.n_generated)
        for f in EXACT:
            torch.testing.assert_close(getattr(t.batch, f), getattr(b.batch, f), rtol=0, atol=0)
        for f in CLOSE:
            torch.testing.assert_close(getattr(t.batch, f), getattr(b.batch, f), rtol=1e-4, atol=1e-4)


def test_strict_greedy_int8_spec_engine_matches_jax():
    m = models()
    _, jres = jax_strict_run("global_exponential", "int8")
    teng = port_engine(m, greedy=True, spec=port_spec(m), kv_cache_dtype="int8")
    assert teng.draft_key_cache.dtype == torch.int8 and teng.draft_key_scale is not None
    assert_match_jax(jres, by_id(teng.run(port_requests(m["prompt"]))), 2e-2)


def test_accounting_keys_match_jax():
    m = models()
    jeng, jres = jax_strict_run("global_exponential")
    teng = port_engine(m, greedy=True, spec=port_spec(m))
    tres = teng.run(port_requests(m["prompt"]))
    js, ts = jeng.stats(), teng.stats()
    spec_keys = [k for k in js if k.startswith("spec_")]
    assert len(spec_keys) == 10 and {k: ts[k] for k in spec_keys} == {k: js[k] for k in spec_keys}
    assert ts["spec_committed_events"] == sum(r.n_events - r.prompt_len for r in tres)
    assert ts["spec_proposed_events"] == sum(r.spec_proposed for r in tres)
    jrep, trep = jeng.slots_report(hbm_gb=16.0), teng.slots_report(hbm_gb=16.0)
    for k in ("spec", "draft_params_bytes", "draft_kv_bytes_per_slot"):
        assert trep[k] == jrep[k], k
    plain = port_engine(m, greedy=True).slots_report(hbm_gb=16.0)
    assert plain["draft_params_bytes"] == plain["draft_kv_bytes_per_slot"] == 0 and not plain["spec"]
    assert trep["per_dtype"]["fp32"]["max_slots"] < plain["per_dtype"]["fp32"]["max_slots"]
    q = port_engine(m, greedy=True, spec=port_spec(m), kv_cache_dtype="int8").slots_report(hbm_gb=16.0)
    assert 0 < q["draft_kv_bytes_per_slot"] < trep["draft_kv_bytes_per_slot"]


def test_perfect_draft_accepts_where_the_jax_draft_cache_goes_stale():
    """A perfect draft (the target itself, default tolerances, greedy) on
    budgets of 11 events at ``max_len`` 16 accepts more than 0.9 of its
    proposals (0.95 here). JAX's engine, whose draft never reads the last
    proposal of a fully accepted round (its cache keeps a stale entry there),
    falls below 0.5 on the same requests (ROADMAP Queue 3); the port's draft
    re-reads the last two committed events each round."""
    m = models()
    rows = [(m["prompt"].slice((slice(i, i + 1), slice(0, 4))), i) for i in range(4)]
    jeng = JaxEngine(m["jmodel"], m["params"], m["jcfg"], template=m["prompt"], greedy=True,
                     spec=JaxSpecConfig(model=m["jmodel"], params=m["params"], config=m["jcfg"], k=3),
                     **dict(ENGINE, max_len=16))  # fmt: skip
    jeng.run([JaxRequest(prompt=p, max_new_events=11, request_id=i) for p, i in rows])
    teng = port_engine(m, greedy=True, spec=SpecConfig(model=m["tmodel"], config=m["tcfg"], k=3), max_len=16)
    teng.run([Request(prompt=to_torch(p), max_new_events=11, request_id=i) for p, i in rows])
    assert teng.stats()["spec_acceptance_rate"] > 0.95 and jeng.stats()["spec_acceptance_rate"] < 0.5


def sampled_run(m, spec, order=None, **kw):
    eng = port_engine(m, spec=spec, **kw)
    return eng.run(port_requests(m["prompt"], keys=True, order=order)), eng


def test_sampled_runs_are_bitwise_invariant():
    """Each event draws from its addressed stream: chunk size, admission order
    and dispatch depth change no bit (JAX's ``TestSpecDeterminism``)."""
    m = models("local_lognormal")
    sc = port_spec(m, k=2, value_rtol=1e-3, value_atol=1e-6)
    base, eng = sampled_run(m, sc)
    assert eng.stats()["spec_rounds"] > 0 and all(r.error is None for r in base)
    assert_same_results(base, sampled_run(m, sc, decode_chunk=1, order=[4, 3, 2, 1, 0])[0])
    assert_same_results(base, sampled_run(m, sc, dispatch_depth=1)[0])
    assert_same_results(base, sampled_run(m, sc, n_slots=3, top_k=None)[0])
    greedy, _ = sampled_run(m, sc, greedy=True)
    assert any(not torch.equal(a.batch.dynamic_indices, b.batch.dynamic_indices) for a, b in zip(base, greedy))


def test_per_row_budgets_and_dead_rows():
    """Budgets bind per row in committed events; a dead prompt row stops after
    one probe event, as in the baseline (JAX's ``test_per_row_budgets_and_dead_rows``)."""
    m = models()
    sc = port_spec(m, value_rtol=1e-3, value_atol=1e-6)
    prompt = to_torch(m["prompt"])
    reqs = [Request(prompt=prompt.slice((slice(i, i + 1), slice(0, 4))), max_new_events=b, key=30 + i, request_id=i)
            for i, b in enumerate((1, 2, 4))]  # fmt: skip
    results = port_engine(m, spec=sc).run(reqs)
    assert [r.n_events - r.prompt_len for r in results] == [1, 2, 4]
    assert all(0 <= r.spec_accepted <= r.n_events - r.prompt_len for r in results)
    dead = prompt.replace(event_mask=prompt.event_mask.clone())
    dead.event_mask[0, 2:] = False
    res = port_engine(m, spec=sc).run([Request(prompt=dead.slice((slice(0, 1), slice(0, 4))), max_new_events=4,
                                               key=5, request_id=0)])[0]  # fmt: skip
    assert res.n_generated == 0 and res.n_events < MAX_LEN


def many_requests(m, n=96, budget=3, seed=1000):
    prompt = to_torch(m["prompt"])
    return [Request(prompt=prompt.slice((slice(i % 4, i % 4 + 1), slice(0, 4))), max_new_events=budget,
                    key=seed + i, request_id=i) for i in range(n)]  # fmt: skip


def test_sampled_spec_law_equals_the_baseline_law():
    """Spec sampled against baseline sampled, per head (event type, multi-label
    indices, lab value indices, TTE and values in the baseline's quartile
    bins), 96 requests of 3 events each side, alpha 0.001 (``tests/test_spec.py``'s
    ``TestSpecDistribution``): at the truncated draft and at an adversarial
    one (another seed's random weights), whose acceptance collapses."""
    m = models()
    kw = dict(n_slots=4, decode_chunk=2)
    ref = collect_head_samples(port_engine(m, decode_step_impl="xla", **kw).run(many_requests(m)))
    bad = init_params_from_seed(CIPPTForGenerativeSequenceModeling(m["tcfg"]), seed=999)
    qualities = {"truncated": port_spec(m, value_rtol=1e-3, value_atol=1e-6),
                 "adversarial": SpecConfig(model=bad, config=m["tcfg"], k=3)}  # fmt: skip
    tte_edges = np.quantile(np.asarray(ref["tte"]), [0.25, 0.5, 0.75])
    val_edges = np.quantile(np.asarray(ref["values"]), [0.25, 0.5, 0.75])
    rates = {}
    for name, sc in qualities.items():
        eng = port_engine(m, spec=sc, **kw)
        got = collect_head_samples(eng.run(many_requests(m)))
        rates[name] = eng.stats()["spec_acceptance_rate"]
        for head, bins in (("event_type", np.arange(1, 5)), ("multi_lab", np.arange(4, 9)),
                           ("lab_vals_idx", np.arange(8, 13))):  # fmt: skip
            assert_same_distribution(np.histogram(ref[head], bins=bins)[0], np.histogram(got[head], bins=bins)[0],
                                     f"{name}: {head}")  # fmt: skip
        for head, edges in (("tte", tte_edges), ("values", val_edges)):
            assert_same_distribution(np.histogram(np.digitize(ref[head], edges), bins=np.arange(5))[0],
                                     np.histogram(np.digitize(got[head], edges), bins=np.arange(5))[0],
                                     f"{name}: {head} (quartile bins)")  # fmt: skip
    assert rates["adversarial"] < 0.2 and rates["truncated"] >= rates["adversarial"], rates


# -------------------------------------------------------------- refusals
def refusal_cases(m):
    jspec_cfg = JaxSpecConfig(model=m["jdmodel"], params=m["jdparams"], config=m["jdcfg"], k=2)
    return {
        "paged": (dict(paged_kv=True, block_size=4), "paged KV cache does not compose with speculative decoding yet: "
                  "the verify window re-reads freshly written positions through the draft/target cache pair"),
        "megakernel": (dict(decode_step_impl="pallas"), "speculative decoding replaces the decode step with the "
                       "draft-chunk/verify program pair, which the megakernel does not fuse yet"),
        "device_criteria": (dict(device_criteria=(MaxLengthCriteria(6),)), "custom device_criteria cannot be "
                            "re-evaluated per committed prefix inside the verify program"),
    }, jspec_cfg  # fmt: skip


@pytest.mark.parametrize("case", ["paged", "megakernel", "device_criteria"])
def test_refusals_raise_jax_messages(case):
    m = models()
    cases, jsc = refusal_cases(m)
    kw, match = cases[case]
    jkw = dict(kw)
    if case == "device_criteria":
        from eventstreamgpt_tpu.generation.stopping_criteria import MaxLengthCriteria as JaxMaxLength

        jkw = dict(device_criteria=(JaxMaxLength(6),))
    with pytest.raises(ValueError, match=match):
        JaxEngine(m["jmodel"], m["params"], m["jcfg"], template=m["prompt"], spec=jsc, **dict(ENGINE, **jkw))
    with pytest.raises(ValueError, match=match):
        port_engine(m, spec=port_spec(m, k=2), **kw)


def test_grammar_k_and_na_refusals():
    m = models()
    bad = copy.deepcopy(m["tcfg"])
    bad.measurements_idxmap = {"event_type": 1}
    jbad = JaxConfig.from_dict(bad.to_dict())
    match = "draft config disagrees with the target on `measurements_idxmap`.*measurement grammar"
    with pytest.raises(ValueError, match=match):
        JaxSpecConfig(model=m["jdmodel"], params=m["jdparams"], config=jbad).validate_against(m["jcfg"])
    with pytest.raises(ValueError, match=match):
        port_engine(m, spec=SpecConfig(model=m["tdraft"], config=bad))
    with pytest.raises(ValueError, match="SpecConfig.k must be >= 1, got 0"):
        port_engine(m, spec=port_spec(m, k=0))
    # NA models: spec engines build and serve; split-mode levels and the paged cache raise JAX's words.
    jcfg, jmodel, params, tcfg, tmodel, prompt = build_na()
    tdcfg, tdraft = truncated_draft(tcfg, tmodel, 1)
    eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", greedy=True,
                           spec=SpecConfig(model=tdraft, config=tdcfg, k=2), **ENGINE)  # fmt: skip
    assert all(r.error is None and r.n_generated > 0 for r in eng.run(port_requests(prompt)[:2]))
    assert tcfg.structured_event_processing_mode == StructuredEventProcessingMode.NESTED_ATTENTION
    jdcfg, jdparams = jspec.truncated_draft(jcfg, params, 1)
    levels = [[], ["event_type", ["lab_vals", "categorical_only"]], ["multi_lab", ["lab_vals", "numerical_only"]]]
    jsplit = JaxConfig.from_dict(dict(jcfg.to_dict(), measurements_per_dep_graph_level=levels))
    tsplit = type(tcfg).from_dict(jsplit.to_dict())
    for (jc, tc, kw), match in (((jcfg, tcfg, dict(paged_kv=True)), "paged KV cache does not support nested-attention"),
                                ((jsplit, tsplit, {}), "split-mode .* dep-graph levels are not supported")):  # fmt: skip
        with pytest.raises(ValueError, match=match) as jerr:
            JaxEngine(jmodel, params, jc, template=prompt, **ENGINE, **kw,
                      spec=JaxSpecConfig(model=JaxNA(jdcfg), params=jdparams, config=jc, k=2))  # fmt: skip
        with pytest.raises(ValueError, match=match) as terr:
            GenerationEngine(tmodel, tc, template=to_torch(prompt), device="cpu", **ENGINE, **kw,
                             spec=SpecConfig(model=tdraft, config=tc, k=2))  # fmt: skip
        assert str(terr.value) == re.sub(r" \(tracked as [^)]*\)", "", str(jerr.value))


# ------------------------------------------------------- captured control flow
def test_captured_spec_flow_equals_the_eager_engine(monkeypatch):
    """The captured path on the CPU with `RerunGraph`: the spec chunk warmed
    up and captured while every slot is inactive (its rounds not counted),
    one replay a dispatched chunk, one prefill replay a group; results,
    accounting and rounds equal the eager engine's, again after ``reset()``
    with nothing captured anew."""
    m = models("local_lognormal")
    replay = CapturedProgram.replay
    monkeypatch.setattr(CapturedProgram, "replay", lambda self: (self.fn(), replay(self))[1])
    sc = port_spec(m, k=2, value_rtol=1e-3, value_atol=1e-6)
    stand_in = dict(device="cpu", graph=RerunGraph, graph_context=lambda g, stream: contextlib.nullcontext())

    def engine(captured):
        eng = port_engine(m, spec=sc)
        if captured:
            eng._families = {k: ProgramFamily(f"the {k} program", **stand_in) for k in ("prefill", "extract")}
            eng._capture_chunk(CapturedProgram(eng._chunk, "the spec chunk", **stand_in))
        return eng

    eager, captured = engine(False), engine(True)
    want = eager.run(port_requests(m["prompt"], keys=True))
    replays = prefills = 0
    for _ in range(2):
        got = captured.run(port_requests(m["prompt"], keys=True))
        assert_same_results(want, got)
        assert [(r.spec_proposed, r.spec_accepted) for r in got] == [(r.spec_proposed, r.spec_accepted) for r in want]
        s, e = captured.stats(), eager.stats()
        assert s["graph_captures"] == 1 and s["graph_warmup_chunks"] == 1 and s["cuda_graph"]
        assert s["graph_replays"] - replays == s["dispatched_chunks"]
        assert s["prefill_graph_replays"] - prefills == s["prefill_dispatches"]
        assert s["prefill_graph_keys"] == s["prefill_graph_captures"] > 0
        assert (s["spec_rounds"], s["dispatched_chunks"], s["active_slot_steps"]) == (
            e["spec_rounds"], e["dispatched_chunks"], e["active_slot_steps"])
        replays, prefills = s["graph_replays"], s["prefill_graph_replays"]
        captured.reset()
