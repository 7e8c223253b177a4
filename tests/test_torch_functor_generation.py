"""Functional-time-dependent measurements in the port's generation against the JAX package, on the CPU.

The configuration is `tests/test_torch_functors.py`'s `functor_configs`:
the JAX generation suite's toy measurements plus ``age`` (an `AgeFunctor`
reading the sample cohort's fitted ``age.csv``) and ``tod`` (a four-value
`TimeOfDayFunctor`), a narrow lognormal TTE head, fp32, JAX's weights carried
over by `load_jax_params`. Prompts (`functor_prompt`) start in 2010 a few
minutes before a time-of-day edge, one row aged past ``age.csv``'s upper
outlier threshold. Greedy runs on both sides:

* cohort `generate()`, CI and NA, cached: every event, index, measurement
  index and mask equal to JAX's, ``time_delta`` and ``dynamic_values``
  within rtol 1e-4, atol 1e-5; each generated event holds one age and one
  time-of-day element, the bucket that of its time recomputed in fp64;
* the CI engine (2 slots, four requests of mixed prompt lengths and budgets
  in one prefill bucket) and the paged CI engine with a three-branch `fork`
  between requests: every integer and
  structure field equal to JAX's, floats within 1e-4 (the engine tests'
  tolerance); a fork's branches keep their prompt's ``start_time``.

Speculative decoding and the NA engine with functors are
``tests/test_torch_functor_spec.py``'s.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import eventstreamgpt_tpu.generation.generation_utils as jgu
import eventstreamgpt_tpu_torch.generation.generation_utils as tgu
from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxCI
from eventstreamgpt_tpu.models.na_model import NAPPTForGenerativeSequenceModeling as JaxNA
from eventstreamgpt_tpu.serving import GenerationEngine as JaxEngine
from eventstreamgpt_tpu.serving import Request as JaxRequest
from eventstreamgpt_tpu_torch.convert import load_jax_params
from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request
from eventstreamgpt_tpu_torch.training import build_model

from .test_torch_engine import CLOSE, EXACT, by_id, to_torch
from .test_torch_functors import assert_functor_elements, functor_configs, functor_prompt

# Six new events: a regressed value drifts by up to 3e-5 relative through the NA walk (fp32 order of operations).
GREEDY_FLOATS = dict(rtol=1e-4, atol=1e-5)
SEQ_EXACT = ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask")
MAX_LEN = 12
# One prefill bucket for every prompt (each JAX program key costs a compile), the rows' lengths still mixed.
ENGINE = dict(n_slots=2, max_len=MAX_LEN, decode_chunk=2, min_bucket=8)


def build(na: bool = False):
    """(JAX config, JAX model, params, port config, port model, prompt) on one set of weights."""
    jcfg, tcfg = functor_configs(na)
    prompt = functor_prompt()
    jmodel = (JaxNA if na else JaxCI)(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), prompt)
    tmodel = load_jax_params(build_model(tcfg), jax.tree_util.tree_map(np.asarray, params))
    return jcfg, jmodel, params, tcfg, tmodel, prompt


@pytest.fixture(scope="module")
def models():
    return {name: build(name == "na") for name in ("ci", "na")}


def request_rows(prompt, n=4):
    """(row, budget) for ``n`` requests of 3-5 prompt events over the prompt's rows."""
    out = []
    for i in range(n):
        Lp = (3, 5, 4, 5)[i % 4]
        out.append((prompt.slice((slice(i % 4, i % 4 + 1), slice(0, Lp))), MAX_LEN - Lp - (i % 2)))
    return out


def assert_match_jax(jres, tres):
    assert sorted(jres, key=str) == sorted(tres, key=str)
    for i, j in jres.items():
        t = tres[i]
        assert t.error is None and j.error is None
        for f in ("prompt_len", "n_events", "n_generated"):
            assert getattr(t, f) == getattr(j, f), (i, f)
        for f in EXACT:
            np.testing.assert_array_equal(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)),
                                          err_msg=f"{i} {f}")  # fmt: skip
        for f in CLOSE:
            np.testing.assert_allclose(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{i} {f}")  # fmt: skip


def port_run(m, rows, **kw):
    """The port's greedy engine over ``m``'s model on ``rows``: (results by id, engine)."""
    _, _, _, tcfg, tmodel, prompt = m
    eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), greedy=True, device="cpu", **dict(ENGINE, **kw))
    res = by_id(eng.run([Request(prompt=to_torch(p), max_new_events=b, request_id=i) for i, (p, b) in enumerate(rows)]))
    return res, eng


def jax_run(m, rows, **kw):
    """JAX's greedy engine over ``m``'s model on ``rows``: results by id."""
    jcfg, jmodel, params, _, _, prompt = m
    eng = JaxEngine(jmodel, params, jcfg, template=prompt, greedy=True, **dict(ENGINE, **kw))
    return by_id(eng.run([JaxRequest(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(rows)]))


def strict_specs(m, k):
    """JAX's and the port's one-layer truncated drafts at zero tolerances."""
    from eventstreamgpt_tpu.serving import SpecConfig as JaxSpecConfig
    from eventstreamgpt_tpu.serving.spec import truncated_draft as jax_truncated_draft
    from eventstreamgpt_tpu_torch.serving import SpecConfig, truncated_draft

    jcfg, jmodel, params, tcfg, tmodel, _ = m
    jdcfg, jdparams = jax_truncated_draft(jcfg, params, 1)
    tdcfg, tdraft = truncated_draft(tcfg, tmodel, 1)
    strict = dict(k=k, value_rtol=0.0, value_atol=0.0)
    return (JaxSpecConfig(model=type(jmodel)(jdcfg), params=jdparams, config=jdcfg, **strict),
            SpecConfig(model=tdraft, config=tdcfg, **strict))  # fmt: skip


def assert_elements(res, tcfg):
    for r in res.values():
        assert_functor_elements(r.batch, r.prompt_len, tcfg)


@pytest.mark.parametrize("name", ["ci", "na"])
def test_greedy_generate_with_functors_matches_jax(models, monkeypatch, name):
    jcfg, jmodel, params, tcfg, tmodel, prompt = models[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgu, "sample_predictions", functools.partial(jgu.sample_predictions, greedy=True))
        mp.setattr(jgu, "_STEP_CACHE", {})
        want = jax.tree_util.tree_map(np.asarray, jgu.generate(jmodel, params, prompt, jcfg, jax.random.PRNGKey(1),
                                                               max_new_events=6, num_return_sequences=2))  # fmt: skip
    monkeypatch.setattr(tgu, "sample_predictions", functools.partial(tgu.sample_predictions, greedy=True))
    got = tgu.generate(tmodel, to_torch(prompt), tcfg, seed=1, max_new_events=6, num_return_sequences=2, device="cpu")
    assert got.sequence_length == 11 and bool(got.event_mask.all())
    for f in SEQ_EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    for f in ("time_delta", "dynamic_values"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f), err_msg=f, **GREEDY_FLOATS)
    assert_functor_elements(got, 5, tcfg)
    # Prompt row 2 (rows 4 and 5 expanded) is aged past the upper threshold: its
    # first new age is value-masked, the next one reads the mean back in.
    age = got.dynamic_measurement_indices == 4
    vmask = got.dynamic_values_mask
    assert not bool(vmask[4, 5][age[4, 5]].any()) and bool(vmask[4, 6][age[4, 6]].all())


def test_greedy_engine_with_functors_matches_jax(models):
    m = models["ci"]
    rows = request_rows(m[5])
    tres, _ = port_run(m, rows)
    assert_match_jax(jax_run(m, rows), tres)
    assert_elements(tres, m[3])


def test_greedy_paged_fork_with_functors_matches_jax(models):
    """Two requests, a fork of three branches of row 3 (23:30 at its first
    event: its branches cross midnight), two more requests, through 4 slots
    and blocks of 4."""
    jcfg, jmodel, params, tcfg, tmodel, prompt = models["ci"]
    kw = dict(ENGINE, n_slots=4, greedy=True, paged_kv=True, block_size=4)
    rows = request_rows(prompt, 4)
    fork_row = prompt.slice((slice(3, 4), slice(0, 5)))
    jeng = JaxEngine(jmodel, params, jcfg, template=prompt, **kw)
    teng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), device="cpu", **kw)
    for i, (p, b) in enumerate(rows[:2]):
        jeng.submit(JaxRequest(prompt=p, max_new_events=b, request_id=i))
        teng.submit(Request(prompt=to_torch(p), max_new_events=b, request_id=i))
    jeng.fork(fork_row, 3, 6, key=jax.random.PRNGKey(7), request_id="f")
    teng.fork(to_torch(fork_row), 3, 6, key=7, request_id="f")
    for i, (p, b) in enumerate(rows[2:], start=2):
        jeng.submit(JaxRequest(prompt=p, max_new_events=b, request_id=i))
        teng.submit(Request(prompt=to_torch(p), max_new_events=b, request_id=i))
    jres, tres = by_id(jeng.run()), by_id(teng.run())
    assert_match_jax(jres, tres)
    assert teng.stats()["fork_branches_admitted"] == 3
    for j in range(3):
        branch = tres[("f", j)]
        assert torch.equal(branch.batch.start_time, to_torch(fork_row).start_time)
        assert_functor_elements(branch.batch, branch.prompt_len, tcfg)
    tods = {int(x) for j in range(3) for x in tres[("f", j)].batch.dynamic_indices[0, 5:][
        tres[("f", j)].batch.dynamic_measurement_indices[0, 5:] == 5]}  # fmt: skip
    assert len(tods) == 2  # LATE_PM, then EARLY_AM after midnight
