"""The PyTorch port's nested-attention (NA) serving engine against the JAX NA engine, on the CPU.

The fixtures are ``tests/test_generation.py``'s (``na_config``: levels
``[[], ["event_type"], ["multi_lab", "lab_vals"]]``, ``make_prompt``) with a
lognormal-mixture TTE head at the narrow log-time scale of
``tests/test_torch_engine.py``'s ``local_lognormal`` (an untrained head's
greedy times stay moderate), and that file's ``ENGINE`` (2 slots,
``max_len`` 8, chunks of 2, buckets from 2: prompts of 3 and 5 events run
bucket-padded), ``prompt_rows`` and ``to_torch``. Weights are JAX's, carried
over by `load_jax_params`; everything is fp32. Each JAX engine is built and
run once, in a module-scoped fixture.

Checked, each with its tolerance:

1. greedy decoding against the JAX NA engine, float and int8 sequence
   caches: every request's accounting and every event and integer equal,
   ``time_delta``, ``dynamic_values`` and ``start_time`` within rtol and atol
   1e-4 (as the CI engine's parity test), ``stats()``'s ``prompt_events``
   equal to JAX's;
2. a bucket-padded prompt under a local window (after JAX's
   ``tests/test_engine.py::TestLocalAttentionParity``): the dep-graph
   history that ``last_event_index`` seeds equals JAX's and the unpadded
   forward's reset, rtol 2e-5, atol 1e-6;
3. the level walk reads no sequence-cache length (JAX's
   ``test_na_walk_scalar_vs_vector_lengths_bitwise``): targets 0, 1 and 2
   give the same predictions and caches, bit for bit, with scalar and
   per-row sequence-cache lengths, and targets 1 and 2 with no sequence
   cache at all;
4. sampled decoding (float and fp8 caches) is invariant to the slot count
   and the request order (prefill groups 2 rows wide; 2 and 4 slots bit for
   bit, 3 slots events and integers, floats within 1e-6: see the test), and
   ``reset()`` writes a fresh engine's state back
   into the same buffers (the dep-graph planes among them) and reproduces
   the first pass, bit for bit;
5. the captured flow on the CPU (a stand-in graph that reruns the program):
   one capture a key, one replay a chunk and a prefill group (groups padded
   to 2 rows), results equal to the eager engine's, again after ``reset()``
   with nothing captured anew;
6. ``slots_report`` equals JAX's per-dtype cache bytes and row bytes (the
   float dep-graph caches counted) and takes JAX's ``config``, ``max_len``
   and ``params_bytes`` overrides;
7. the refusals: NA with ``paged_kv`` and with the megakernel raise JAX's
   messages in both engines, as do NA ``spec=`` with ``paged_kv`` and with
   split-mode dep-graph levels; NA with ``spec=`` builds and serves
   (``tests/test_torch_na_spec.py`` holds it against JAX's NA spec engine).
"""

import contextlib
import re

import jax
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.models.na_model import NAPPTForGenerativeSequenceModeling as JaxNA
from eventstreamgpt_tpu.models.transformer import NAPast as JaxNAPast
from eventstreamgpt_tpu.models.transformer import NestedAttentionPointProcessTransformer as JaxEncoder
from eventstreamgpt_tpu.models.transformer import init_kv_caches as jax_init_kv_caches
from eventstreamgpt_tpu.serving import GenerationEngine as JaxEngine
from eventstreamgpt_tpu.serving import Request as JaxRequest
from eventstreamgpt_tpu.serving import SpecConfig as JaxSpecConfig
from eventstreamgpt_tpu_torch.convert import load_jax_params
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.models.na_model import NAPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.transformer import NAPast, init_kv_caches
from eventstreamgpt_tpu_torch.serving import GenerationEngine, SpecConfig
from eventstreamgpt_tpu_torch.utils.graphs import CapturedProgram, ProgramFamily

from .test_generation import make_prompt, na_config
from .test_torch_engine import CLOSE, ENGINE, EXACT, assert_same_results, by_id, port_requests, prompt_rows, to_torch
from .test_torch_prefill import RerunGraph

NARROW_TTE = dict(
    TTE_generation_layer_type="log_normal_mixture",
    TTE_lognormal_generation_num_components=2,
    mean_log_inter_event_time_min=1.0,
    std_log_inter_event_time_min=0.1,
)
LOCAL = dict(seq_attention_types=["local", "global"], seq_window_size=2)
GREEDY_FLOATS = dict(rtol=1e-4, atol=1e-4)  # the CI engine's parity tolerance
WALK = dict(rtol=2e-5, atol=1e-6)  # the NA walk against JAX's (tests/test_torch_generate.py)
KV_DTYPES = [None, "int8"]


def build(**over):
    """(JAX config, JAX model, params, port config, port model, prompt) on one set of weights."""
    jcfg = JaxConfig.from_dict(dict(na_config().to_dict(), **NARROW_TTE, **over))
    prompt = make_prompt(B=4, L=5)
    jmodel = JaxNA(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), prompt)
    tcfg = StructuredTransformerConfig.from_dict(jcfg.to_dict())
    tmodel = load_jax_params(NAPPTForGenerativeSequenceModeling(tcfg), jax.tree_util.tree_map(np.asarray, params))
    return jcfg, jmodel, params, tcfg, tmodel, prompt


@pytest.fixture(scope="module")
def na():
    return build()


@pytest.fixture(scope="module")
def jax_engines(na):
    """Each cache dtype's greedy JAX NA engine, run once on ``prompt_rows``: (engine, results by id)."""
    jcfg, jmodel, params, _, _, prompt = na
    out = {}
    for kv in KV_DTYPES:
        eng = JaxEngine(jmodel, params, jcfg, template=prompt, greedy=True, kv_cache_dtype=kv, **ENGINE)
        out[kv] = eng, by_id(eng.run([JaxRequest(prompt=p, max_new_events=b, request_id=i)
                                      for i, (p, _, b) in enumerate(prompt_rows(prompt))]))  # fmt: skip
    return out


def port_engine(na, **kw):
    _, _, _, tcfg, tmodel, prompt = na
    return GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **dict(ENGINE, **kw))


# --------------------------------------------------------------- (1) greedy parity
@pytest.mark.parametrize("kv_cache_dtype", KV_DTYPES, ids=["float", "int8"])
def test_greedy_na_engine_matches_jax_engine(na, jax_engines, kv_cache_dtype):
    jeng, jres = jax_engines[kv_cache_dtype]
    teng = port_engine(na, greedy=True, kv_cache_dtype=kv_cache_dtype)
    tres = by_id(teng.run(port_requests(na[5])))
    assert sorted(jres) == sorted(tres) == list(range(5))
    for i, j in jres.items():
        t = tres[i]
        assert t.error is None and j.error is None
        for f in ("admission_index", "prompt_len", "n_events", "n_generated"):
            assert getattr(t, f) == getattr(j, f), (i, f)
        for f in EXACT:
            np.testing.assert_array_equal(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), err_msg=f)
        for f in CLOSE:
            np.testing.assert_allclose(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), err_msg=f,
                                       **GREEDY_FLOATS)  # fmt: skip
    s = teng.stats()
    assert s["prompt_events"] == jeng.stats()["prompt_events"]
    assert s["decode_step_impl"] == "unfused" and s["kv_cache_dtype"] == (kv_cache_dtype or "fp32")
    assert teng.dep_key.dtype == torch.float32  # the dep-graph caches stay float under every cache dtype


# ------------------------------------------------- (2) the bucket-padded prefill's reset
def test_bucket_padded_reset_matches_jax_and_the_unpadded_forward():
    jcfg, _, params, tcfg, tmodel, _ = build(**LOCAL)
    plen, bucket = np.array([3, 4]), 5
    batch = make_prompt(B=2, L=bucket, seed=5)
    real = np.arange(bucket)[None, :] < plen[:, None]
    # Bucket padding as the engine stages it: no events and zero content after each prompt.
    fields = {}
    for f in ("event_mask", "time_delta", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values",
              "dynamic_values_mask"):  # fmt: skip
        x = np.array(getattr(batch, f))
        keep = real.reshape(real.shape + (1,) * (x.ndim - 2))
        fields[f] = np.where(keep, x, np.zeros_like(x))
    padded = batch.replace(**{k: jax.numpy.asarray(v) for k, v in fields.items()})
    last = plen - 1

    apply = jax.jit(JaxEncoder(jcfg).apply, static_argnames=("use_cache",))
    jout = apply(
        {"params": params["params"]["encoder"]}, padded,
        past=JaxNAPast(seq_past=jax_init_kv_caches(jcfg, 2, max_len=8), dep_graph_past=None), use_cache=True,
        last_event_index=jax.numpy.asarray(last, jax.numpy.int32),
    ).past_key_values.dep_graph_past  # fmt: skip
    tb = to_torch(padded)
    with torch.no_grad():
        tout = tmodel.encoder(tb, past=NAPast(seq_past=init_kv_caches(tcfg, 2, 8, device="cpu")), use_cache=True,
                              last_event_index=torch.from_numpy(last)).past_key_values.dep_graph_past  # fmt: skip
        # Each row alone, unpadded: its reset seeds from its last (real) event.
        alone = [tmodel.encoder(tb.slice((slice(b, b + 1), slice(0, int(n)))), use_cache=True,
                                past=NAPast(seq_past=init_kv_caches(tcfg, 1, 8, device="cpu"))).past_key_values
                 for b, n in enumerate(plen)]  # fmt: skip
    assert len(tout) == len(jout) == tcfg.num_hidden_layers
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert t.length == int(j.length) == 1 and t.key.shape[2] == len(tcfg.measurements_per_dep_graph_level) + 1
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
        for w in ("key", "value"):
            np.testing.assert_allclose(getattr(t, w).numpy(), np.asarray(getattr(j, w)), err_msg=f"layer {i} {w}",
                                       **WALK)  # fmt: skip
            for b, a in enumerate(alone):
                np.testing.assert_allclose(getattr(t, w)[b].numpy(), getattr(a.dep_graph_past[i], w)[0].numpy(),
                                           err_msg=f"row {b} layer {i} {w} unpadded", **WALK)  # fmt: skip
    # Without ``last_event_index`` the seed is the padded tail, which differs from row 0's last real event.
    with torch.no_grad():
        tail = tmodel.encoder(tb, past=NAPast(seq_past=init_kv_caches(tcfg, 2, 8, device="cpu")),
                              use_cache=True).past_key_values.dep_graph_past  # fmt: skip
    assert not torch.allclose(tail[0].key[0, :, 0], tout[0].key[0, :, 0])


# ------------------------------------------------ (3) the walk reads no sequence length
def pred_leaves(preds) -> list:
    out = []
    preds.map(lambda x: out.append(x) or x)
    return out


def test_na_walk_scalar_vs_per_row_lengths_bitwise(na):
    """The port's `test_na_walk_scalar_vs_vector_lengths_bitwise`: a prefix of
    four events and one event's level walk, then targets 0, 1 and 2 from that
    state with the sequence caches' lengths as a Python int and as a ``(1,)``
    tensor: predictions and new caches bit for bit; targets 1 and 2 also
    without any sequence cache."""
    _, _, _, tcfg, tmodel, prompt = na
    row = to_torch(prompt).slice((slice(0, 1), slice(None)))
    G = len(tcfg.measurements_per_dep_graph_level)
    with torch.no_grad():
        out = tmodel(row.slice((slice(None), slice(0, 4))), past=NAPast(seq_past=init_kv_caches(tcfg, 1, 8, device="cpu")),
                     use_cache=True)  # fmt: skip
        past, ev = out.past_key_values, row.slice((slice(None), slice(4, 5)))
        for level in range(1, G):
            past = tmodel(ev, past=past, use_cache=True, dep_graph_el_generation_target=level).past_key_values
        per_row = NAPast(
            seq_past=tuple(type(c)(c.key, c.value, c.mask, torch.full((1,), c.length, dtype=torch.int32))
                           for c in past.seq_past),
            dep_graph_past=past.dep_graph_past,
        )  # fmt: skip
        pasts = {"scalar": past, "per_row": per_row, "none": NAPast(dep_graph_past=past.dep_graph_past)}
        for target in range(G):
            names = ("scalar", "per_row") if target == 0 else ("scalar", "per_row", "none")
            outs = {n: tmodel(ev, past=pasts[n], use_cache=True, dep_graph_el_generation_target=target) for n in names}
            ref = outs["scalar"]
            for n in names[1:]:
                leaves, other = pred_leaves(ref.preds), pred_leaves(outs[n].preds)
                assert len(leaves) == len(other) > 0
                for x, y in zip(leaves, other):
                    assert torch.equal(x, y), (target, n)
                for x, y in zip(ref.past_key_values.dep_graph_past, outs[n].past_key_values.dep_graph_past):
                    assert torch.equal(x.key, y.key) and torch.equal(x.value, y.value) and torch.equal(x.mask, y.mask)
                    assert x.length == y.length
            if target == 0:  # the per-row write lands where the scalar one does
                for x, y in zip(ref.past_key_values.seq_past, outs["per_row"].past_key_values.seq_past):
                    assert torch.equal(x.key, y.key) and torch.equal(x.value, y.value)


# ------------------------------------------------------- (4) sampled invariances
def addresses(eng) -> dict:
    out = {f"big.{k}": v.data_ptr() for k, v in vars(eng.big).items() if torch.is_tensor(v)}
    for k in ("key_cache", "value_cache", "key_scale", "value_scale", "dep_key", "dep_value", "dep_mask",
              "cache_mask", "cache_len", "cursor", "base_len", "budget", "n_generated", "done", "live", "health",
              "seeds", "counters", "active_steps", "_boundary"):  # fmt: skip
        v = getattr(eng, k)
        if v is not None:
            out[k] = v.data_ptr()
    return out


def state(eng) -> dict:
    out = {f"big.{k}": v.clone() for k, v in vars(eng.big).items() if torch.is_tensor(v)}
    for k in ("key_cache", "value_cache", "key_scale", "value_scale", "dep_key", "dep_value", "dep_mask",
              "cache_mask", "cache_len", "cursor", "base_len", "budget", "n_generated", "done", "live", "health",
              "seeds", "counters", "active_steps"):  # fmt: skip
        v = getattr(eng, k)
        if v is not None:
            out[k] = v.view(torch.uint8).clone() if v.dtype == torch.float8_e4m3fn else v.clone()
    return out


@pytest.mark.parametrize("kv_cache_dtype", [None, "fp8"], ids=["float", "fp8"])
def test_sampled_na_engine_is_invariant_and_reset_repeats_it(na, kv_cache_dtype):
    prompt = na[5]

    def run(n_slots, order=None, eng=None):
        if eng is None:
            eng = port_engine(na, n_slots=n_slots, kv_cache_dtype=kv_cache_dtype)
            # Every prefill group 2 rows wide: the CPU's matrix products give a
            # row other float bits as a one-row product (a matrix-vector
            # product) and as the odd last row of a 3-row one (measured on
            # the dep-graph block's MLP: rows equal in, one float32 ulp apart
            # out), so a group's width and a slot count of 3 move floats.
            eng.scheduler.group_sizes = (2,)
        return eng, eng.run(port_requests(prompt, keys=True, order=order))

    eng, base = run(2)
    assert all(r.error is None and r.n_events == r.prompt_len + r.n_generated for r in base)
    assert_same_results(base, run(4)[1])
    assert_same_results(base, run(2, order=[4, 2, 0, 3, 1])[1])
    assert_same_results(base, run(4, order=[3, 1, 4, 0, 2])[1])
    # 3 slots: the decode step's products are 3 rows; events and integers
    # equal, floats within a few float32 ulps.
    assert_same_results(base, run(3)[1], float_tol=1e-6)
    greedy = port_engine(na, greedy=True, kv_cache_dtype=kv_cache_dtype).run(port_requests(prompt, keys=True))
    assert any(not torch.equal(a.batch.time_delta, b.batch.time_delta) for a, b in zip(base, greedy))

    ptrs, want = addresses(eng), state(port_engine(na, kv_cache_dtype=kv_cache_dtype))
    eng.reset()
    assert addresses(eng) == ptrs
    got = state(eng)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _, again = run(2, eng=eng)
    assert addresses(eng) == ptrs
    assert_same_results(base, again)


# --------------------------------------------------------- (5) the captured flow
def test_captured_na_flow_equals_the_eager_engine(na, monkeypatch):
    replay = CapturedProgram.replay
    monkeypatch.setattr(CapturedProgram, "replay", lambda self: (self.fn(), replay(self))[1])
    stand_in = dict(device="cpu", graph=RerunGraph, graph_context=lambda g, stream: contextlib.nullcontext())
    prompt = na[5]

    def engine(captured):
        eng = port_engine(na)
        eng.scheduler.group_sizes = (2,)  # a group of one request runs padded to 2 rows
        if captured:
            eng._families = {k: ProgramFamily(f"the {k} program", **stand_in) for k in ("prefill", "extract")}
            eng._capture_chunk(CapturedProgram(eng._chunk, "the decode chunk", **stand_in))
        return eng

    eager, captured = engine(False), engine(True)
    want = eager.run(port_requests(prompt, keys=True))
    got = captured.run(port_requests(prompt, keys=True))
    assert_same_results(want, got)
    s = captured.stats()
    assert (s["graph_captures"], s["graph_warmup_chunks"], s["graph_replays"]) == (1, 1, s["dispatched_chunks"])
    assert s["prefill_graph_keys"] == s["prefill_graph_warmups"] == s["prefill_graph_captures"] > 1
    assert s["prefill_graph_replays"] == s["prefill_dispatches"] > 0
    assert s["extract_graph_keys"] == s["extract_graph_captures"] > 0
    assert s["active_slot_steps"] == eager.stats()["active_slot_steps"]  # the warm-up chunk was not counted
    captured.reset()
    again = captured.run(port_requests(prompt, keys=True))
    assert_same_results(want, again)
    s2 = captured.stats()
    for k in ("graph_captures", "prefill_graph_captures", "extract_graph_captures"):
        assert s2[k] == s[k], k
    assert s2["graph_replays"] == s["graph_replays"] + s2["dispatched_chunks"]
    assert s2["prefill_graph_replays"] == s["prefill_graph_replays"] + s2["prefill_dispatches"]


# ------------------------------------------------------------- (6) slots_report
def test_slots_report_matches_jax_and_takes_the_overrides(na, jax_engines):
    jcfg = na[0]
    jeng = jax_engines[None][0]
    teng = port_engine(na, greedy=True)
    wide = dict(jcfg.to_dict(), hidden_size=64, head_dim=16, num_hidden_layers=3)
    cases = [
        ({}, {}),
        (dict(config=JaxConfig.from_dict(wide), max_len=16, params_bytes=12345),
         dict(config=StructuredTransformerConfig.from_dict(wide), max_len=16, params_bytes=12345)),
    ]  # fmt: skip
    reports = []
    for jkw, tkw in cases:
        jrep = jeng.slots_report(hbm_gb=0.01, **dict(dict(params_bytes=0), **jkw))
        trep = teng.slots_report(hbm_gb=0.01, **dict(dict(params_bytes=0), **tkw))
        assert trep["row_bytes_per_slot"] == jrep["row_bytes_per_slot"]
        assert trep["per_dtype"] == jrep["per_dtype"]
        assert trep["slots_per_chip_ratio_vs_bf16"] == jrep["slots_per_chip_ratio_vs_bf16"]
        reports.append(trep)
    base, over = reports
    assert over["per_dtype"]["bf16"]["kv_bytes_per_slot"] > base["per_dtype"]["bf16"]["kv_bytes_per_slot"]
    assert over["row_bytes_per_slot"] == int(base["row_bytes_per_slot"] * 2)
    assert over["params_bytes"] == 12345
    # The dep-graph planes count in the row: a CI-like row without them is smaller.
    dep = teng.dep_key.numel() * teng.dep_key.element_size() * 2 // ENGINE["n_slots"]
    assert base["row_bytes_per_slot"] > dep > 0


# ----------------------------------------------------------------- (7) refusals
def test_na_refusals_match_jax(na):
    jcfg, jmodel, params, _, _, prompt = na
    for kw, match in ((dict(paged_kv=True), "paged KV cache does not support nested-attention models"),
                      (dict(decode_step_impl="pallas"), "the decode megakernel fuses the CI one-event step only")):  # fmt: skip
        with pytest.raises(ValueError) as jerr:
            JaxEngine(jmodel, params, jcfg, template=prompt, **dict(ENGINE, **kw))
        with pytest.raises(ValueError) as terr:
            port_engine(na, **kw)
        assert match in str(jerr.value)
        # The port's message is JAX's without its tracking note.
        assert str(terr.value) == re.sub(r" \(tracked as [^)]*\)", "", str(jerr.value))
    tmodel, tcfg = na[4], na[3]
    spec = SpecConfig(model=tmodel, config=tcfg, k=2)
    eng = port_engine(na, spec=spec, greedy=True)
    res = eng.run(port_requests(prompt)[:2])
    assert [r.error for r in res] == [None, None] and all(r.n_generated > 0 for r in res)
    assert eng.stats()["decode_step_impl"] == "spec_draft_verify"
    jspec = JaxSpecConfig(model=jmodel, params=params, config=jcfg, k=2)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jmodel, params, jcfg, template=prompt, spec=jspec, paged_kv=True, **ENGINE)
    with pytest.raises(ValueError) as terr:
        port_engine(na, spec=spec, paged_kv=True)
    assert str(terr.value) == re.sub(r" \(tracked as [^)]*\)", "", str(jerr.value))
    levels = [[], ["event_type", ["lab_vals", "categorical_only"]], ["multi_lab", ["lab_vals", "numerical_only"]]]
    jsplit = JaxConfig.from_dict(dict(jcfg.to_dict(), measurements_per_dep_graph_level=levels))
    tsplit = StructuredTransformerConfig.from_dict(jsplit.to_dict())
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jmodel, params, jsplit, template=prompt, spec=JaxSpecConfig(model=jmodel, params=params,
                                                                             config=jsplit, k=2), **ENGINE)  # fmt: skip
    with pytest.raises(ValueError) as terr:
        GenerationEngine(tmodel, tsplit, template=to_torch(prompt), device="cpu",
                         spec=SpecConfig(model=tmodel, config=tsplit, k=2), **ENGINE)  # fmt: skip
    assert "split-mode" in str(jerr.value) and str(terr.value) == str(jerr.value)
    for impl in (None, "auto", "xla"):
        assert port_engine(na, decode_step_impl=impl).decode_step_impl == "unfused"
