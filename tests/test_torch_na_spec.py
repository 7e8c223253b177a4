"""The PyTorch port's speculative decoding on nested-attention (NA) models against JAX's, on the CPU.

The fixtures are ``tests/test_torch_na_engine.py``'s (``na_config``: levels
``[[], ["event_type"], ["multi_lab", "lab_vals"]]``, the narrow lognormal
TTE, ``ENGINE``: 2 slots, ``max_len`` 8, chunks of 2, buckets from 2), fp32
throughout, JAX's weights carried over by `load_jax_params`; the draft is the
one-layer truncated target. The JAX strict-greedy NA spec engines (float and
int8 caches, ``k`` 2) are built and run once, in a module-scoped fixture.

Checked, each with its tolerance (the checks that need no JAX run are in
``tests/test_torch_na_spec_engine.py``):

1. `na_level_of_measurement` and `mask_batch_to_levels` equal JAX's exactly;
   a split-mode level raises JAX's message in both packages, from the
   function and from an NA spec engine's construction;
2. the NA model's forward with ``partial_content_levels``, ``history_head``
   and ``return_contextualized`` equals JAX's on the same inputs
   (predictions, contextualized embeddings, sequence and dep-graph caches),
   rtol 1e-5, atol 1e-6;
3. the strict-greedy NA spec engine (``k`` 2, zero tolerances), float and
   int8 caches, against JAX's NA spec engine and the port's NA engine:
   every event and integer equal, floats within 1e-4, accounting equal;
4. ``slots_report()`` equals JAX's for an NA spec engine (the refusals of
   NA spec engines are ``tests/test_torch_na_engine.py``'s and
   ``tests/test_torch_spec.py``'s).

The perfect draft is ``tests/test_torch_na_spec_law.py``'s.
"""


import jax
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.models.na_model import NAPPTForGenerativeSequenceModeling as JaxNA
from eventstreamgpt_tpu.models.transformer import NAPast as JaxNAPast
from eventstreamgpt_tpu.models.transformer import init_kv_caches as jax_init_kv_caches
from eventstreamgpt_tpu.models.transformer import mask_batch_to_levels as jax_mask_batch_to_levels
from eventstreamgpt_tpu.models.transformer import na_level_of_measurement as jax_level_of_measurement
from eventstreamgpt_tpu.serving import GenerationEngine as JaxEngine
from eventstreamgpt_tpu.serving import Request as JaxRequest
from eventstreamgpt_tpu.serving import SpecConfig as JaxSpecConfig
from eventstreamgpt_tpu.serving.spec import truncated_draft as jax_truncated_draft
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.models.transformer import NAPast, init_kv_caches, mask_batch_to_levels
from eventstreamgpt_tpu_torch.models.transformer import na_level_of_measurement
from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request, SpecConfig, truncated_draft

from .test_torch_engine import CLOSE, ENGINE, EXACT, MAX_LEN, by_id, port_requests, prompt_rows
from .test_torch_engine import to_torch
from .test_torch_model import flat_preds
from .test_torch_na_engine import build

STRICT = dict(k=2, value_rtol=0.0, value_atol=0.0)
KV_DTYPES = [None, "int8"]
PLUMBING = dict(rtol=1e-5, atol=1e-6)


def assert_preds_close(want, got, **tol):
    """Every distribution parameter of two predictions (JAX's or the port's) within ``tol``."""
    a, b = flat_preds(want), flat_preds(got)
    assert sorted(a) == sorted(b) and a
    for k in a:
        np.testing.assert_allclose(b[k], a[k], err_msg=k, **tol)


@pytest.fixture(scope="module")
def na():
    return build()


@pytest.fixture(scope="module")
def drafts(na):
    """The one-layer truncated draft of each package, cut from the same weights."""
    jcfg, _, params, tcfg, tmodel, _ = na
    jdcfg, jdparams = jax_truncated_draft(jcfg, params, 1)
    tdcfg, tdraft = truncated_draft(tcfg, tmodel, 1)
    return dict(jdcfg=jdcfg, jdmodel=JaxNA(jdcfg), jdparams=jdparams, tdcfg=tdcfg, tdraft=tdraft)


@pytest.fixture(scope="module")
def jax_runs(na, drafts):
    """Each cache dtype's strict-greedy JAX NA spec engine, run once on ``prompt_rows``: (engine, results by id)."""
    jcfg, jmodel, params, _, _, prompt = na
    out = {}
    for kv in KV_DTYPES:
        spec = JaxSpecConfig(model=drafts["jdmodel"], params=drafts["jdparams"], config=drafts["jdcfg"], **STRICT)
        eng = JaxEngine(jmodel, params, jcfg, template=prompt, greedy=True, kv_cache_dtype=kv, spec=spec, **ENGINE)
        out[kv] = eng, by_id(eng.run([JaxRequest(prompt=p, max_new_events=b, request_id=i)
                                      for i, (p, _, b) in enumerate(prompt_rows(prompt))]))  # fmt: skip
    return out


def port_engine(na, **kw):
    _, _, _, tcfg, tmodel, prompt = na
    return GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **dict(ENGINE, **kw))


def port_spec(drafts, **kw):
    return SpecConfig(model=drafts["tdraft"], config=drafts["tdcfg"], **dict(STRICT, **kw))


def rows4(prompt, n_events=4):
    return [(prompt.slice((slice(i, i + 1), slice(0, n_events))), i) for i in range(4)]


def split_config():
    """``na_config`` with ``lab_vals`` split over two levels (categorical at 1, numerical at 2)."""
    d = JaxConfig.from_dict(build()[0].to_dict()).to_dict()
    d["measurements_per_dep_graph_level"] = [[], ["event_type", ["lab_vals", "categorical_only"]],
                                             ["multi_lab", ["lab_vals", "numerical_only"]]]  # fmt: skip
    return d


# ---------------------------------------------------------- (1) the level map
def test_level_map_and_level_mask_match_jax(na, drafts):
    jcfg, jmodel, params, tcfg, _, prompt = na
    jlvl = np.asarray(jax_level_of_measurement(jcfg))
    tlvl = na_level_of_measurement(tcfg)
    assert tlvl.dtype == torch.int32
    np.testing.assert_array_equal(tlvl.numpy(), jlvl)
    assert tlvl.tolist() == [0, 1, 2, 2]
    tb = to_torch(prompt)
    for level in range(3):
        want = jax_mask_batch_to_levels(prompt, jax.numpy.asarray(jlvl), level)
        got = mask_batch_to_levels(tb, tlvl, level)
        for f in ("dynamic_indices", "dynamic_measurement_indices", "dynamic_values", "dynamic_values_mask"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f"{level} {f}")
    # A per-row level masks each row at its own level.
    per_row = mask_batch_to_levels(tb, tlvl, torch.tensor([0, 1, 2, 1]))
    for b, level in enumerate((0, 1, 2, 1)):
        ref = mask_batch_to_levels(tb, tlvl, level)
        assert torch.equal(per_row.dynamic_indices[b], ref.dynamic_indices[b])
    # Split-mode levels: JAX's message from the function and from an NA spec engine, in both packages.
    split = split_config()
    jsplit, tsplit = JaxConfig.from_dict(split), StructuredTransformerConfig.from_dict(split)
    match = "split-mode .* dep-graph levels are not supported by per-level content masking"
    with pytest.raises(ValueError, match=match) as jerr:
        jax_level_of_measurement(jsplit)
    with pytest.raises(ValueError, match=match) as terr:
        na_level_of_measurement(tsplit)
    assert str(terr.value) == str(jerr.value)
    jspec = JaxSpecConfig(model=jmodel, params=params, config=jsplit, k=2)
    with pytest.raises(ValueError, match=match) as jerr:
        JaxEngine(jmodel, params, jsplit, template=prompt, spec=jspec, **ENGINE)
    with pytest.raises(ValueError, match=match) as terr:
        GenerationEngine(na[4], tsplit, template=tb, device="cpu", spec=SpecConfig(model=na[4], config=tsplit, k=2),
                         **ENGINE)  # fmt: skip
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------ (2) the model plumbing
def test_forward_plumbing_matches_jax(na):
    """A 3-event window on a 2-event cache with a history head, partial
    content levels and the contextualized embeddings returned, in both
    packages on the same weights and inputs."""
    jcfg, jmodel, params, tcfg, tmodel, prompt = na
    B, H = prompt.batch_size, tcfg.hidden_size
    head = np.random.default_rng(3).normal(size=(tcfg.num_hidden_layers, B, H)).astype(np.float32)
    prefix = prompt.slice((slice(None), slice(0, 2)))
    window = prompt.slice((slice(None), slice(2, 5)))

    def jax_fn(p, pre, win, hist):
        out = jmodel.apply(p, pre, past=JaxNAPast(seq_past=jax_init_kv_caches(jcfg, B, max_len=MAX_LEN)),
                           use_cache=True, is_generation=True)  # fmt: skip
        seq = out.past_key_values.seq_past
        return jmodel.apply(p, win, past=JaxNAPast(seq_past=seq), use_cache=True, is_generation=True,
                            partial_content_levels=True, history_head=tuple(hist), return_contextualized=True)  # fmt: skip

    jout = jax.jit(jax_fn)(params, prefix, window, head)
    with torch.no_grad():
        pre = tmodel(to_torch(prefix), past=NAPast(seq_past=init_kv_caches(tcfg, B, MAX_LEN, device="cpu")),
                     use_cache=True)  # fmt: skip
        tout = tmodel(to_torch(window), past=NAPast(seq_past=pre.past_key_values.seq_past), use_cache=True,
                      partial_content_levels=True, history_head=tuple(torch.from_numpy(head)),
                      return_contextualized=True)  # fmt: skip
    assert_preds_close(jout.preds, tout.preds, **PLUMBING)
    assert len(tout.contextualized) == len(jout.contextualized) == tcfg.num_hidden_layers
    for j, t in zip(jout.contextualized, tout.contextualized):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **PLUMBING)
    for name in ("seq_past", "dep_graph_past"):
        for j, t in zip(getattr(jout.past_key_values, name), getattr(tout.past_key_values, name)):
            for w in ("key", "value"):
                np.testing.assert_allclose(getattr(t, w).numpy(), np.asarray(getattr(j, w)), err_msg=f"{name} {w}",
                                           **PLUMBING)  # fmt: skip
            np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
            assert int(t.length) == int(j.length)
    # A zero history head is the default zero history, bit for bit; a real one moves the predictions.
    with torch.no_grad():
        run = lambda h: tmodel(to_torch(window), past=NAPast(seq_past=pre.past_key_values.seq_past), use_cache=True,
                               partial_content_levels=True, history_head=h)  # noqa: E731
        zero, none = run(tuple(torch.zeros(tcfg.num_hidden_layers, B, H))), run(None)
    assert all(torch.equal(a, b) for a, b in zip(leaves(zero.preds), leaves(none.preds)))
    assert not all(torch.equal(a, b) for a, b in zip(leaves(zero.preds), leaves(tout.preds)))


def leaves(preds) -> list:
    out = []
    preds.map(lambda x: out.append(x) or x)
    return out


# -------------------------------------------------------- (3) strict greedy
@pytest.mark.parametrize("kv_cache_dtype", KV_DTYPES, ids=["float", "int8"])
def test_strict_greedy_na_spec_engine_matches_jax_and_the_na_engine(na, drafts, jax_runs, kv_cache_dtype):
    jeng, jres = jax_runs[kv_cache_dtype]
    teng = port_engine(na, greedy=True, kv_cache_dtype=kv_cache_dtype, spec=port_spec(drafts))
    tres = by_id(teng.run(port_requests(na[5])))
    assert sorted(jres) == sorted(tres) == list(range(5))
    for i, j in jres.items():
        t = tres[i]
        assert t.error is None and j.error is None
        for f in ("admission_index", "prompt_len", "n_events", "n_generated", "spec_proposed", "spec_accepted"):
            assert getattr(t, f) == getattr(j, f), (i, f)
        for f in EXACT:
            np.testing.assert_array_equal(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), err_msg=f)
        for f in CLOSE:
            np.testing.assert_allclose(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), rtol=1e-4,
                                       atol=1e-4, err_msg=f)  # fmt: skip
    js, ts = jeng.stats(), teng.stats()
    spec_keys = [k for k in js if k.startswith("spec_")]
    assert len(spec_keys) == 10 and {k: ts[k] for k in spec_keys} == {k: js[k] for k in spec_keys}
    assert ts["prompt_events"] == js["prompt_events"] and ts["decode_step_impl"] == "spec_draft_verify"
    assert teng.draft_dep_key.dtype == teng.dep_key.dtype == torch.float32  # float under every cache dtype
    if kv_cache_dtype is not None:
        assert teng.draft_key_cache.dtype == torch.int8 and teng.draft_key_scale is not None
    base = by_id(port_engine(na, greedy=True, kv_cache_dtype=kv_cache_dtype).run(port_requests(na[5])))
    for i, b in base.items():
        t = tres[i]
        assert (t.n_events, t.n_generated) == (b.n_events, b.n_generated)
        for f in EXACT:
            torch.testing.assert_close(getattr(t.batch, f), getattr(b.batch, f), rtol=0, atol=0)
        for f in CLOSE:
            torch.testing.assert_close(getattr(t.batch, f), getattr(b.batch, f), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- (5) slots_report
def test_slots_report_matches_jax(na, drafts, jax_runs):
    jeng = jax_runs[None][0]
    teng = port_engine(na, greedy=True, spec=port_spec(drafts))
    for kw in (dict(hbm_gb=16.0), dict(hbm_gb=0.01, params_bytes=0)):
        jrep, trep = jeng.slots_report(**kw), teng.slots_report(**kw)
        for k in ("spec", "params_bytes", "draft_params_bytes", "draft_kv_bytes_per_slot", "row_bytes_per_slot",
                  "per_dtype", "slots_per_chip_ratio_vs_bf16", "kv_cache_dtype"):  # fmt: skip
            assert trep[k] == jrep[k], k
    assert trep["spec"] and trep["draft_kv_bytes_per_slot"] > 0
    plain = port_engine(na, greedy=True).slots_report(hbm_gb=16.0)
    assert plain["row_bytes_per_slot"] == trep["row_bytes_per_slot"]  # the draft's planes are charged as JAX's
