"""The port's metrics against JAX's, on the CPU.

* every metric class of `training.metrics` against JAX's on the same random
  inputs (the numpy code is shared, so the values are equal);
* `GenerativeMetrics` with every category on, over the port's and JAX's
  outputs of the same weights (`load_jax_params`, fp32, no dropout) on
  ``sample_data`` (univariate regression) and a synthetic cache
  (multivariate regression): the loss, its parts and the classification
  metrics within 1e-5; the sampled TTE and regression metrics with the same
  draws handed to both sides (JAX's draws follow threefry, the port's a
  ``torch.Generator``), also within 1e-5.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.data import JaxDataset, PytorchDatasetConfig
from eventstreamgpt_tpu.data.synthetic import write_synthetic_dataset
from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu.models.config import MetricsConfig as JaxMetricsConfig
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.training import generative_metrics as jax_gm
from eventstreamgpt_tpu.training import metrics as jax_metrics
from eventstreamgpt_tpu_torch.models.config import MetricsConfig
from eventstreamgpt_tpu_torch.training import generative_metrics as port_gm
from eventstreamgpt_tpu_torch.training import metrics as port_metrics

from .test_torch_train import PROCESSED, SMALL, port_model, to_torch

CASES = ("sample_data", "synthetic_dl")
EVERYTHING = {
    split: {"loss_parts": True, "TTE": True, "classification": True, "regression": True}
    for split in ("tuning", "held_out")
}
METRICS = {
    "MeanSquaredError": ((), "regression"),
    "MeanSquaredLogError": ((), "positive"),
    "ExplainedVariance": ((), "regression"),
    "ExplainedVariance_weighted": ((), "regression2d"),
    "MulticlassAccuracy": ((6,), "multiclass"),
    "MulticlassAUROC": ((6,), "multiclass"),
    "MulticlassAveragePrecision": ((6,), "multiclass"),
    "MultilabelAccuracy": ((5,), "multilabel"),
    "MultilabelAUROC": ((5,), "multilabel"),
    "MultilabelAveragePrecision": ((5,), "multilabel"),
    "BinaryAccuracy": ((), "binary"),
    "BinaryAUROC": ((), "binary"),
    "BinaryAveragePrecision": ((), "binary"),
}


def inputs(kind: str, rng: np.random.Generator):
    n = 64
    if kind == "regression":
        y = rng.normal(size=n)
        return y + 0.3 * rng.normal(size=n), y
    if kind == "regression2d":
        y = rng.normal(size=(n, 3))
        return y + 0.3 * rng.normal(size=(n, 3)), y
    if kind == "positive":
        y = rng.uniform(0.1, 5.0, size=n)
        return y * rng.uniform(0.5, 1.5, size=n), y
    if kind == "multiclass":
        return rng.normal(size=(n, 6)), rng.integers(0, 6, size=n)
    if kind == "multilabel":
        return rng.normal(size=(n, 5)), (rng.random((n, 5)) < 0.4).astype(np.int64)
    return rng.normal(size=n), (rng.random(n) < 0.5).astype(np.int64)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name):
    args, kind = METRICS[name]
    cls, kw = name, {}
    if name.endswith("_weighted"):
        cls, kw = name.split("_")[0], dict(multioutput="variance_weighted")
    averages = [None] if not args else ["macro", "weighted", "micro"] if "label" in cls else ["macro", "weighted"]
    for average in averages:
        extra = {} if average is None else dict(average=average)
        j = getattr(jax_metrics, cls)(*args, **kw, **extra)
        p = getattr(port_metrics, cls)(*args, **kw, **extra)
        rng = np.random.default_rng(0)
        for _ in range(3):
            preds, labels = inputs(kind, rng)
            j.update(preds, labels)
            p.update(preds, labels)
        assert p.compute() == j.compute() or (np.isnan(p.compute()) and np.isnan(j.compute())), (name, average)


class Fixed:
    """A distribution stand-in whose every draw is ``value``."""

    def __init__(self, value):
        self.value = value

    def sample(self, *_):
        return self.value


def draw_shape(dist) -> tuple:
    field = "locs" if hasattr(dist, "locs") else "loc" if hasattr(dist, "loc") else "rate"
    shape = tuple(np.shape(getattr(dist, field)))
    return shape[:-1] if field == "locs" else shape


def with_draws(jout, tout, rng):
    """Both outputs with the same draws in place of their TTE and regression distributions."""
    tte = rng.uniform(1.0, 500.0, size=draw_shape(jout.preds.time_to_event)).astype(np.float32)
    jreg, treg = {}, {}
    for m, (jobs, jdist) in jout.preds.regression.items():
        value = rng.normal(size=draw_shape(jdist)).astype(np.float32)
        jreg[m] = (jobs, Fixed(value))
        treg[m] = (tout.preds.regression[m][0], Fixed(torch.from_numpy(value)))
    jout = jout.replace(preds=jout.preds.replace(time_to_event=Fixed(tte), regression=jreg))
    tout = dataclasses.replace(
        tout, preds=dataclasses.replace(tout.preds, time_to_event=Fixed(torch.from_numpy(tte)), regression=treg)
    )
    return jout, tout


@pytest.mark.parametrize("case", CASES)
def test_generative_metrics_match_jax(cases, case):
    config, jmodel, params, ds = cases[case]
    tmodel = port_model(config, params)
    forward = jax.jit(lambda p, b: jmodel.apply(p, b))
    rng = np.random.default_rng(0)
    for split in ("tuning", "held_out"):
        jm = jax_gm.GenerativeMetrics(config, JaxMetricsConfig(include_metrics=EVERYTHING), split=split)
        tm = port_gm.GenerativeMetrics(config, MetricsConfig(include_metrics=EVERYTHING), split=split)
        # A last short batch: the fill rows' loss re-weighting runs too.
        for jbatch in ds.batches(3, shuffle=False, drop_last=False, seed=0):
            n_valid = int(np.asarray(jbatch.valid_mask).sum())
            with torch.no_grad():
                tout = tmodel(to_torch(jbatch), is_generation=False)
            jout, tout = with_draws(forward(params, jbatch), tout, rng)
            jm.update(jout, key=jax.random.PRNGKey(0), n_valid=n_valid)
            tm.update(tout, n_valid=n_valid)
        want, got = jm.compute(), tm.compute()
        assert sorted(got) == sorted(want)
        assert any("AUROC" in k for k in want) and any("TTE_MSE" in k for k in want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{case: (jax config, jax model, flax params, JaxDataset)}: test_torch_train's
    ``sample_data`` and ``synthetic_dl`` setups."""
    sample = tmp_path_factory.mktemp("metrics_sample") / "sample"
    shutil.copytree(PROCESSED, sample)
    synth = tmp_path_factory.mktemp("metrics_synthetic")
    write_synthetic_dataset(
        synth, {"train": 8, "tuning": 4, "held_out": 4}, n_event_types=6, n_labs=40, n_meds=8,
        mean_seq_len=10, max_seq_len=24, seed=0,
    )  # fmt: skip
    out = {}
    for name, save_dir in (("sample_data", sample), ("synthetic_dl", synth)):
        ds = JaxDataset(PytorchDatasetConfig(save_dir=save_dir, max_seq_len=16, min_seq_len=2), "train")
        config = JaxConfig(**SMALL)
        config.set_to_dataset(ds)
        jmodel = JaxModel(config)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), next(ds.batches(4, shuffle=False)))
        out[name] = (config, jmodel, params, ds)
    return out


@pytest.mark.parametrize("name", ["MeanSquaredError", "ExplainedVariance"])
def test_indexed_update_equals_the_dense_expansion(name):
    """``update_indexed`` scores the dense ``(rows, vocabulary)`` planes JAX builds, without building them."""
    rng = np.random.default_rng(1)
    dense, indexed = getattr(jax_metrics, name)(), getattr(port_metrics, name)()
    for _ in range(3):
        n, V = 50, 7
        p_idx = rng.integers(0, V, n)
        l_idx = np.where(rng.random(n) < 0.8, p_idx, rng.integers(0, V, n))
        preds, labels = rng.normal(size=n), rng.normal(size=n)
        pd_, ld = np.zeros((n, V)), np.zeros((n, V))
        np.put_along_axis(pd_, p_idx[:, None], preds[:, None], axis=-1)
        np.put_along_axis(ld, l_idx[:, None], labels[:, None], axis=-1)
        dense.update(pd_, ld)
        indexed.update_indexed(preds, p_idx, labels, l_idx, V)
    np.testing.assert_allclose(indexed.compute(), dense.compute(), rtol=1e-12)


def test_binned_curves_count_as_jax_at_the_thresholds():
    """Probabilities on, just below and just above the threshold grid, and
    NaN: the port's batched binning gives JAX's per-series counts exactly,
    and the sum of its labels' counts JAX's micro series."""
    rng = np.random.default_rng(2)
    grid = np.linspace(0, 1, 50)
    p = rng.random((300, 7))
    p[:, 0] = rng.choice(grid, 300)
    p[:, 1] = np.nextafter(rng.choice(grid, 300), -1)
    p[:, 2] = np.nextafter(rng.choice(grid, 300), 2)
    p[rng.random(p.shape) < 0.05] = np.nan
    labels = rng.random((300, 7)) < 0.3
    a, b = port_metrics.MultilabelAUROC(7, 50), jax_metrics.MultilabelAUROC(7, 50)
    a.update(p, labels)
    b.update(p, labels)
    for f in ("tp", "fp", "pos", "neg"):
        # JAX keeps the micro curve as an eighth series; the port sums the labels' counts.
        assert np.array_equal(getattr(a, f), getattr(b, f)[:7]), f
        assert np.array_equal(getattr(a, f).sum(axis=0), getattr(b, f)[7]), f
