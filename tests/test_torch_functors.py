"""The port's vocabulary, functors and fitted-metadata read against the JAX package, on the CPU.

* `Vocabulary` (``data/vocabulary.py``): construction, ``idxmap``, lookups,
  ``filter``, ``extend_with_counts``, ``describe`` and equality, equal to
  JAX's on the same inputs.
* The functors' generation half (``data/time_dependent_functor.py``): each
  update equals JAX's, jitted as JAX's generation programs run it, on the
  same numpy inputs, bit for bit: ``AgeFunctor`` with ages inside, at and
  past both thresholds and with NaN and None thresholds,
  ``TimeOfDayFunctor`` at times on both sides of each bucket edge. (Eager
  JAX divides where the jitted update multiplies by the fp32 reciprocal and
  fuses multiply-adds; at 2010 dates that moves a time of day across an
  edge.) ``to_dict`` / ``from_dict`` give JAX's dicts;
  ``compute`` (ETL) raises naming ROADMAP Queue 1 item 10.
* ``MeasurementConfig.measurement_metadata`` of the sample cohort's
  ``age.csv``, ``HR.csv`` and ``temp.csv`` (read with ``csv`` and ``ast``)
  equals JAX's pandas read, and the configs' ``to_dict`` is what
  ``from_dict`` was given.

The module also holds the functor configuration the generation tests share
(`functor_configs`, `functor_prompt`): the JAX generation suite's toy
measurements plus ``age`` (an `AgeFunctor` with the sample cohort's fitted
``age.csv``) and ``tod`` (a four-value `TimeOfDayFunctor`).
"""

import io
import json
import math
from datetime import datetime
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.data.config import MeasurementConfig as JaxMeasurementConfig
from eventstreamgpt_tpu.data.time_dependent_functor import AgeFunctor as JaxAge
from eventstreamgpt_tpu.data.time_dependent_functor import TimeOfDayFunctor as JaxTimeOfDay
from eventstreamgpt_tpu.data.types import EventStreamBatch as JaxBatch
from eventstreamgpt_tpu.data.vocabulary import Vocabulary as JaxVocabulary
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu_torch.data.config import MeasurementConfig
from eventstreamgpt_tpu_torch.data.time_dependent_functor import (
    MINUTES_PER_YEAR,
    AgeFunctor,
    TimeOfDayFunctor,
    functor_from_dict,
)
from eventstreamgpt_tpu_torch.data.vocabulary import Vocabulary
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig

from .test_generation import BASE_KWARGS, MEASUREMENT_CONFIGS

SAMPLE = Path(__file__).resolve().parents[1] / "sample_data" / "processed" / "sample"
AGE_CSV = SAMPLE / "inferred_measurement_metadata" / "age.csv"
TOD_VOCAB = (["EARLY_AM", "AM", "PM", "LATE_PM"], [0.3, 0.3, 0.25, 0.15])
# The toy vocabulary (event_type [1, 4), multi_lab [4, 8), lab_vals [8, 12)) plus age 12 and tod [13, 18).
FUNCTOR_KWARGS = dict(
    BASE_KWARGS,
    vocab_sizes_by_measurement=dict(BASE_KWARGS["vocab_sizes_by_measurement"], age=1, tod=5),
    vocab_offsets_by_measurement=dict(BASE_KWARGS["vocab_offsets_by_measurement"], age=12, tod=13),
    measurements_idxmap=dict(BASE_KWARGS["measurements_idxmap"], age=4, tod=5),
    max_seq_len=16,
)
NARROW_TTE = dict(
    TTE_generation_layer_type="log_normal_mixture",
    TTE_lognormal_generation_num_components=2,
    mean_log_inter_event_time_min=1.0,
    std_log_inter_event_time_min=0.1,
)
NA_KWARGS = dict(
    structured_event_processing_mode="nested_attention",
    measurements_per_dep_graph_level=[[], ["event_type"], ["multi_lab", "lab_vals"]],
    dep_graph_attention_types="global",
    do_full_block_in_seq_attention=False,
    do_full_block_in_dep_graph_attention=True,
)
# Local midnight of 2010-01-01 in minutes since the epoch: the sample cohort's dates.
MIDNIGHT_2010 = datetime(2010, 1, 1).timestamp() / 60


def jax_functor_measurements() -> dict:
    return dict(
        MEASUREMENT_CONFIGS,
        age=JaxMeasurementConfig(name="age", temporality="functional_time_dependent", functor=JaxAge(dob_col="dob"),
                                 _measurement_metadata=str(AGE_CSV)),  # fmt: skip
        tod=JaxMeasurementConfig(name="tod", temporality="functional_time_dependent", functor=JaxTimeOfDay(),
                                 vocabulary=JaxVocabulary(*TOD_VOCAB)),  # fmt: skip
    )


def functor_configs(na: bool = False, **overrides) -> tuple:
    """(JAX config, port config) of the toy measurements with both functors."""
    jcfg = JaxConfig(measurement_configs=jax_functor_measurements(),
                     **dict(FUNCTOR_KWARGS, **NARROW_TTE, **(NA_KWARGS if na else {}), **overrides))  # fmt: skip
    return jcfg, StructuredTransformerConfig.from_dict(jcfg.to_dict())


def functor_prompt(B=4, L=5, M=8, seed=0, ages=(30.0, 134.7, 200.0, 61.5)):
    """The toy prompt's events (`test_generation.make_prompt`'s layout) each
    with an age element (row ``b`` aged ``ages[b]`` years at its first
    event, normalized with ``age.csv``; 200 lies past its upper threshold)
    and a time-of-day element, starting in 2010 at local 05:50, 11:52, 20:55
    and 23:30 (rows cycle): a few minutes from a bucket edge each."""
    rng = np.random.default_rng(seed)
    age_mm = MeasurementConfig(name="age", modality="univariate_regression", _measurement_metadata=AGE_CSV).measurement_metadata
    mean, std = age_mm["normalizer"]["mean_"], age_mm["normalizer"]["std_"]
    start = np.asarray([MIDNIGHT_2010 + m for m in (350, 712, 1255, 1410)] * B, np.float64)[:B].astype(np.float32)
    td = rng.uniform(0.5, 10.0, size=(B, L)).astype(np.float32)
    meas = np.zeros((B, L, M), np.int64)
    idx = np.zeros((B, L, M), np.int64)
    vals = np.zeros((B, L, M), np.float32)
    vmask = np.zeros((B, L, M), bool)
    tod_vocab = Vocabulary(*TOD_VOCAB)
    for b in range(B):
        t = float(start[b])
        for e in range(L):
            meas[b, e, :5] = (1, 2, 3, 4, 5)
            hour = ((t - MIDNIGHT_2010) / 60) % 24
            bucket = "EARLY_AM" if hour < 6 else "AM" if hour < 12 else "PM" if hour < 21 else "LATE_PM"
            idx[b, e, :5] = (rng.integers(1, 4), rng.integers(4, 8), rng.integers(8, 12), 12, 13 + tod_vocab[bucket])
            age = ages[b % len(ages)] + (t - float(start[b])) / MINUTES_PER_YEAR
            vals[b, e, 2], vals[b, e, 3] = rng.normal(), (age - mean) / std
            vmask[b, e, 2:4] = True
            t += float(td[b, e])
    return JaxBatch(
        event_mask=jnp.ones((B, L), dtype=bool),
        time_delta=jnp.asarray(td),
        start_time=jnp.asarray(start),
        static_indices=jnp.asarray(rng.integers(1, 12, size=(B, 2))),
        static_measurement_indices=jnp.asarray(np.ones((B, 2), dtype=np.int64)),
        dynamic_indices=jnp.asarray(idx),
        dynamic_measurement_indices=jnp.asarray(meas),
        dynamic_values=jnp.asarray(vals),
        dynamic_values_mask=jnp.asarray(vmask),
    )


def assert_functor_elements(batch, input_len: int, tcfg) -> None:
    """Each generated real event holds one age element and one time-of-day
    element whose bucket matches the event's absolute time, recomputed in
    fp64 from the batch. An element within 4 minutes of a bucket edge is not
    checked: at 2010 dates the fp32 time's ulp is 2 minutes and its hour's
    1.875, and either may round across the edge."""
    di, dm = np.asarray(batch.dynamic_indices), np.asarray(batch.dynamic_measurement_indices)
    em, td = np.asarray(batch.event_mask), np.asarray(batch.time_delta, np.float64)
    start = np.asarray(batch.start_time, np.float64)
    vocab = tcfg.measurement_configs["tod"].vocabulary_object
    for b in range(em.shape[0]):
        for e in range(input_len, em.shape[1]):
            if not em[b, e]:
                continue
            assert (dm[b, e] == 4).sum() == 1 and (dm[b, e] == 5).sum() == 1, (b, e, dm[b, e])
            t = start[b] + td[b, :e][em[b, :e]].sum()
            hour = ((t - MIDNIGHT_2010) / 60) % 24
            edge = min(abs(hour * 60 - h * 60) for h in (0, 6, 12, 21, 24))
            bucket = "EARLY_AM" if hour < 6 else "AM" if hour < 12 else "PM" if hour < 21 else "LATE_PM"
            if edge > 4.0:
                assert di[b, e][dm[b, e] == 5][0] == 13 + vocab[bucket], (b, e, hour)


# ------------------------------------------------------------------ Vocabulary
VOCAB_CASES = [
    (["apple", "banana", "UNK"], [3, 5, 2]),
    (["b", "a", "c", "d"], [1, 1, 1, 1]),
    (["x", "y", "z", "w", "v", "u", "t"], [0.1, 0.3, 0.05, 0.2, 0.15, 0.1, 0.1]),
]


@pytest.mark.parametrize("case", range(len(VOCAB_CASES)))
def test_vocabulary_equals_jax(case):
    els, freqs = VOCAB_CASES[case]
    v, j = Vocabulary(list(els), list(freqs)), JaxVocabulary(list(els), list(freqs))
    assert v.vocabulary == j.vocabulary and v.obs_frequencies == j.obs_frequencies and v.idxmap == j.idxmap
    assert [v[i] for i in range(len(v))] == [j[i] for i in range(len(j))]
    assert [v[e] for e in els + ["nope"]] == [j[e] for e in els + ["nope"]]
    for kw in (dict(n_head=1, n_tail=1, wrap_lines=False), dict(line_width=20)):
        a, b = io.StringIO(), io.StringIO()
        v.describe(stream=a, **kw)
        j.describe(stream=b, **kw)
        assert a.getvalue() == b.getvalue()
    assert v.extend_with_counts({"new": 3, els[0]: 2}, prior_total=10) == j.extend_with_counts({"new": 3, els[0]: 2}, 10)
    assert v.vocabulary == j.vocabulary and v.obs_frequencies == j.obs_frequencies
    v.filter(total_observations=20, min_valid_element_freq=0.12)
    j.filter(total_observations=20, min_valid_element_freq=0.12)
    assert v.vocabulary == j.vocabulary and v.obs_frequencies == j.obs_frequencies and v.idxmap == j.idxmap
    assert (v == Vocabulary(list(v.vocabulary), list(v.obs_frequencies))) == (
        j == JaxVocabulary(list(j.vocabulary), list(j.obs_frequencies)))
    with pytest.raises(TypeError):
        v[3.5]


def test_vocabulary_refusals_equal_jax():
    for args in (([], []), (["a", "b"], [1.0]), (["a", "a"], [1, 2]), (["a", 3], [1, 2])):
        with pytest.raises(ValueError) as want:
            JaxVocabulary(*args)
        with pytest.raises(ValueError) as got:
            Vocabulary(*args)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ functors
AGE_MM = {"normalizer": {"mean_": 44.86987756885948, "std_": 22.466428791445924},
          "outlier_model": {"thresh_large_": 134.73559273464318, "thresh_small_": -44.99583759692422}}  # fmt: skip


@pytest.mark.parametrize("thresholds", ["fitted", "nan", "none", "upper_only"])
def test_age_update_equals_jax(thresholds):
    """Ages inside, at and past both thresholds; NaN and None thresholds mean no bound."""
    import pandas as pd

    large, small = AGE_MM["outlier_model"]["thresh_large_"], AGE_MM["outlier_model"]["thresh_small_"]
    outlier = {"fitted": (large, small), "nan": (math.nan, math.nan), "none": (None, None),
               "upper_only": (large, float("nan"))}[thresholds]  # fmt: skip
    mm = {"normalizer": AGE_MM["normalizer"], "outlier_model": dict(zip(("thresh_large_", "thresh_small_"), outlier))}
    rng = np.random.default_rng(0)
    ages = np.concatenate([rng.uniform(-60, 160, 64), [large, small, large - 1e-5, small + 1e-5, 44.0]])
    mean, std = mm["normalizer"]["mean_"], mm["normalizer"]["std_"]
    prior = ((ages - mean) / std).astype(np.float32)
    delta = rng.uniform(0, 2 * MINUTES_PER_YEAR, len(ages)).astype(np.float32)
    delta[-5:] = (0.0, 0.0, 30 * MINUTES_PER_YEAR, 0.0, 1.0)
    idx = np.zeros(len(ages), np.int64)
    update = jax.jit(lambda i, p, d: JaxAge("dob").update_from_prior_timepoint(i, p, d, None, None, pd.Series(mm)))
    ji, jv = update(jnp.asarray(idx), jnp.asarray(prior), jnp.asarray(delta))
    ti, tv = AgeFunctor("dob").update_from_prior_timepoint(torch.from_numpy(idx), torch.from_numpy(prior),
                                                           torch.from_numpy(delta), None, None, mm)  # fmt: skip
    jv = np.asarray(jv)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(np.isnan(tv.numpy()), np.isnan(jv))
    if thresholds in ("nan", "none"):
        assert not np.isnan(jv).any()
    else:
        assert np.isnan(jv).sum() > 5
    np.testing.assert_array_equal(tv.numpy(), jv)


def test_time_of_day_update_equals_jax():
    """Times a fraction of a minute either side of every bucket edge, on 2010 dates and near the epoch."""
    edges = np.asarray([0, 6, 12, 21], np.float64) * 60
    offsets = np.asarray([-2.5, -0.75, 0.0, 0.75, 2.5])
    days = np.asarray([0, 1, 17, 365 * 40 + 3], np.float64) * 1440
    t = (datetime(1970, 1, 1).timestamp() / 60 + days[:, None, None] + edges[None, :, None] + offsets).ravel()
    t = np.concatenate([t, np.random.default_rng(1).uniform(2.0e7, 2.2e7, 200)]).astype(np.float32)
    for vocab_els in (TOD_VOCAB, (["PM", "AM"], [0.6, 0.4])):
        jv, tv = JaxVocabulary(*vocab_els), Vocabulary(*vocab_els)
        prior = np.zeros(len(t), np.int64)
        update = jax.jit(lambda p, t, jv=jv: JaxTimeOfDay().update_from_prior_timepoint(p, jnp.zeros(len(t)), None, t,
                                                                                        jv, None))  # fmt: skip
        ji, jvals = update(jnp.asarray(prior), jnp.asarray(t))
        ti, tvals = TimeOfDayFunctor().update_from_prior_timepoint(torch.from_numpy(prior), torch.zeros(len(t)), None,
                                                                   torch.from_numpy(t), tv, None)  # fmt: skip
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti.dtype == torch.int64 and bool(tvals.isnan().all()) and np.isnan(np.asarray(jvals)).all()
    assert len(np.unique(ti.numpy())) == 3  # PM, AM and 0 for the buckets the vocabulary lacks


def test_functor_serialization_equals_jax():
    for jf, tf in ((JaxAge("dob"), AgeFunctor("dob")), (JaxTimeOfDay(), TimeOfDayFunctor())):
        assert tf.to_dict() == jf.to_dict()
        back = functor_from_dict(jf.to_dict())
        assert type(back) is type(tf) and back == tf and back.to_dict() == jf.to_dict()
        assert tf.OUTPUT_MODALITY.value == jf.OUTPUT_MODALITY.value
    assert AgeFunctor("dob").link_static_cols == ["dob"]
    with pytest.raises(ValueError, match="Queue 1 item 10"):
        AgeFunctor("dob").compute(None, None)


# ------------------------------------------------------------------ metadata
@pytest.mark.parametrize("name", ["age", "HR", "temp"])
def test_metadata_read_equals_jax(name):
    configs = json.loads((SAMPLE / "inferred_measurement_configs.json").read_text())
    jcfg = JaxMeasurementConfig.from_dict(configs[name], base_dir=SAMPLE)
    tcfg = MeasurementConfig.from_dict(configs[name], base_dir=SAMPLE)
    want = jcfg.measurement_metadata.to_dict()
    got = tcfg.measurement_metadata
    assert got == want and list(got) == list(want)
    assert json.dumps(MeasurementConfig.from_dict(configs[name]).to_dict()) == json.dumps(configs[name])
    if name == "age":
        assert tcfg.functor_object == AgeFunctor("dob") and tcfg.vocabulary_object is None


def test_metadata_cells_read_without_eval(tmp_path):
    """A NaN threshold (pandas writes ``nan``) reads as None, both "no
    bound" to `AgeFunctor`; a cell that is not a literal stays text:
    nothing is evaluated."""
    fp = tmp_path / "m.csv"
    fp.write_text(',m\nvalue_type,float\noutlier_model,"{\'thresh_large_\': nan, \'thresh_small_\': -4.5}"\n'
                  'normalizer,"__import__(\'os\').getcwd()"\n')  # fmt: skip
    mm = MeasurementConfig(name="m", modality="univariate_regression", _measurement_metadata=fp).measurement_metadata
    assert mm["outlier_model"] == {"thresh_large_": None, "thresh_small_": -4.5}
    assert mm["normalizer"] == "__import__('os').getcwd()"
    assert MeasurementConfig(name="m", modality="univariate_regression",
                             _measurement_metadata={"x": 1}).measurement_metadata == {"x": 1}  # fmt: skip


def test_functor_config_round_trips_and_vocabulary():
    jcfg, tcfg = functor_configs()
    assert json.dumps(tcfg.to_dict(), sort_keys=True, default=str) == json.dumps(jcfg.to_dict(), sort_keys=True,
                                                                                 default=str)  # fmt: skip
    tod = tcfg.measurement_configs["tod"]
    assert tod.vocabulary_object.vocabulary == jcfg.measurement_configs["tod"].vocabulary.vocabulary
    assert tcfg.measurement_configs["age"].measurement_metadata == jcfg.measurement_configs["age"].measurement_metadata.to_dict()
