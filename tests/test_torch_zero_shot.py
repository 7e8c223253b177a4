"""Task data and zero-shot evaluation in the port against the JAX package, on the CPU.

The data is the in-repo sample cohort: ``sample_data/processed/sample`` (the
JAX side's parquet cache and its ``high_utilization`` task) and
``sample_data/converted/sample`` (the committed `convert_dl_cache` of it,
which the port reads; the card's machine has no pandas).

* Task windows: ``TorchDataset`` with ``task_df_name`` equals
  ``JaxDataset``'s on every split: subjects, the CSR event arrays,
  ``start_time`` of each window, the task's type and vocabulary,
  ``stream_labels`` and the collated batches (host and device collation);
* the committed conversion equals a fresh one: the same files, every npz
  array (name, dtype, values) and every other file byte for byte;
* ``_aggregate_predictions`` equals JAX's on the same labels;
* greedy ``get_generative_predictions`` (cohort ``generate()``) equals JAX's
  on converted weights (a small CI model with the cohort's ``AgeFunctor``):
  every generated event and integer, floats within rtol 2e-2, atol 1e-3
  (the prompts' event times are ~1e5 minutes: see ``FLOATS``), and the
  predictions, labels and unpredictable fractions;
* a sampled paged-engine pass (one `fork` a subject) equals per-(subject,
  sample) requests with seeds ``derive_request_seed(derive_request_seed(seed,
  s), j)`` bit for bit;
* ``zero_shot_evaluation`` runs from a directory the port's ``train(cfg)``
  wrote, through the paged engine and through ``generate()``, and writes
  ``zero_shot_{tuning,held_out}_metrics.json``;
* a labeler that imports the JAX package is refused, with the way out named.
"""

import filecmp
import functools
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import eventstreamgpt_tpu.generation.generation_utils as jgu
import eventstreamgpt_tpu.training.zero_shot_evaluator as jzs
import eventstreamgpt_tpu_torch.generation.generation_utils as tgu
import eventstreamgpt_tpu_torch.training.zero_shot_evaluator as tzs
from eventstreamgpt_tpu.data.config import PytorchDatasetConfig as JaxDatasetConfig
from eventstreamgpt_tpu.data.jax_dataset import JaxDataset
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.training import build_model as jax_build_model
from eventstreamgpt_tpu_torch.convert import load_jax_params
from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig
from eventstreamgpt_tpu_torch.data.device_dataset import DeviceDataset
from eventstreamgpt_tpu_torch.data.dl_cache import convert_dl_cache, port_labeler_source
from eventstreamgpt_tpu_torch.data.torch_dataset import TorchDataset
from eventstreamgpt_tpu_torch.generation.sampling import derive_request_seed
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request
from eventstreamgpt_tpu_torch.training import build_model
from eventstreamgpt_tpu_torch.training.fine_tuning import FinetuneConfig, StreamClassificationMetrics
from eventstreamgpt_tpu_torch.training.pretrain import PretrainConfig
from eventstreamgpt_tpu_torch.training.pretrain import train as pretrain

from .test_torch_engine import by_id
from .test_torch_train import SMALL

ROOT = Path(__file__).resolve().parents[1]
PROCESSED = ROOT / "sample_data" / "processed" / "sample"
CONVERTED = ROOT / "sample_data" / "converted" / "sample"
TASK = "high_utilization"
DATA = dict(max_seq_len=16, min_seq_len=2, seq_padding_side="left", task_df_name=TASK, do_include_start_time_min=True,
            do_include_subject_id=True)  # fmt: skip
# The cohort's prompts span ~1e5 minutes, where an event time's fp32 ulp (JAX's fp32 cumsum against
# the port's fp64 one rounded once) moves the sinusoidal time encoding by ~1e-2: generated floats
# agree within this envelope (3.4e-3 relative seen), events and integers exactly.
FLOATS = dict(rtol=2e-2, atol=1e-3)


# ------------------------------------------------------------------ task data
@pytest.mark.parametrize("split", ["train", "tuning", "held_out"])
def test_task_windows_and_labels_equal_jax(split):
    j = JaxDataset(JaxDatasetConfig(save_dir=PROCESSED, **DATA), split)
    t = TorchDataset(PytorchDatasetConfig(save_dir=CONVERTED, **DATA), split)
    assert t.has_task and (t.tasks, t.task_types, t.task_vocabs) == (j.tasks, j.task_types, j.task_vocabs)
    assert t.subject_ids == j.subject_ids and len(t) == len(j)
    for f in ("subject_event_offsets", "time_delta", "event_data_offsets", "dynamic_indices",
              "dynamic_measurement_indices", "dynamic_values", "static_indices", "start_time_min"):  # fmt: skip
        np.testing.assert_array_equal(np.asarray(getattr(t.data, f)), np.asarray(getattr(j.data, f)), err_msg=f)
    np.testing.assert_array_equal(t.stream_labels[TASK], j.stream_labels[TASK])
    assert (t.mean_log_inter_event_time_min, t.std_log_inter_event_time_min) == (
        j.mean_log_inter_event_time_min, j.std_log_inter_event_time_min)  # fmt: skip
    want = list(j.batches(5, shuffle=True, seed=3))
    for got in (list(t.batches(5, shuffle=True, seed=3)), list(DeviceDataset(t, device="cpu").batches(5, seed=3))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for f in ("event_mask", "time_delta", "dynamic_indices", "dynamic_values", "start_time", "valid_mask"):
                np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)), err_msg=f)
            assert g.stream_labels[TASK].dtype == torch.float32
            np.testing.assert_array_equal(g.stream_labels[TASK].numpy(), np.asarray(w.stream_labels[TASK]))
    item = t.__getitem__(0, seed=1)
    assert item[TASK] == j[0][TASK]
    np.testing.assert_array_equal(t.collate([item]).stream_labels[TASK].numpy(), [item[TASK]])


def test_committed_conversion_equals_a_fresh_one(tmp_path):
    fresh = convert_dl_cache(PROCESSED, tmp_path / "sample")
    files = sorted(p.relative_to(CONVERTED) for p in CONVERTED.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(fresh) for p in fresh.rglob("*") if p.is_file())
    assert Path("task_dfs/high_utilization.npz") in files and Path("task_dfs/high_utilization_labeler.py") in files
    for rel in files:
        if rel.suffix == ".npz":
            with np.load(CONVERTED / rel) as a, np.load(fresh / rel) as b:
                assert sorted(a.files) == sorted(b.files), rel
                for k in a.files:
                    assert a[k].dtype == b[k].dtype, (rel, k)
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{rel} {k}")
        else:
            assert filecmp.cmp(CONVERTED / rel, fresh / rel, shallow=False), rel
    labeler = (CONVERTED / "task_dfs" / "high_utilization_labeler.py").read_text()
    assert "eventstreamgpt_tpu_torch.models.zero_shot_labeler" in labeler and "eventstreamgpt_tpu." not in labeler


def test_a_labeler_that_imports_the_jax_package_is_refused(tmp_path):
    with pytest.raises(ValueError, match="convert_dl_cache"):
        tzs.import_class_from_file(PROCESSED / "task_dfs" / "high_utilization_labeler.py", "TaskLabeler")
    cls = tzs.import_class_from_file(CONVERTED / "task_dfs" / "high_utilization_labeler.py", "TaskLabeler")
    assert cls.__mro__[1].__module__ == "eventstreamgpt_tpu_torch.models.zero_shot_labeler"
    with pytest.raises(ValueError, match="eventstreamgpt_tpu.data.types"):
        port_labeler_source("import numpy\nfrom eventstreamgpt_tpu.data.types import EventStreamBatch\n")
    src = tmp_path / "task_dfs"
    shutil.copytree(PROCESSED, tmp_path / "p", ignore=shutil.ignore_patterns("*.parquet"))
    (tmp_path / "p" / "DL_reps").mkdir(exist_ok=True)
    shutil.copy(PROCESSED / "DL_reps" / "tuning_0.parquet", tmp_path / "p" / "DL_reps")
    (tmp_path / "p" / "task_dfs" / "bad_labeler.py").write_text("import eventstreamgpt_tpu.training\n")
    with pytest.raises(ValueError, match="eventstreamgpt_tpu.training"):
        convert_dl_cache(tmp_path / "p", src)


# ------------------------------------------------------------------ predictions
def test_aggregate_predictions_equals_jax():
    rng = np.random.default_rng(0)
    B, S = 6, 4
    labels = np.eye(2)[rng.integers(0, 2, B * S)]
    unpred = rng.random(B * S) < 0.3
    unpred[:S] = True  # subject 0: no predictable sample
    valid = np.ones(B, bool)
    valid[-1] = False
    stream = rng.integers(0, 2, B).astype(np.float32)

    class Fixed:
        def __call__(self, batch, input_seq_len):
            return labels, unpred

    config = SimpleNamespace(num_labels=2, finetuning_task=TASK, id2label={0: False, 1: True})
    jb = SimpleNamespace(batch_size=B, sequence_length=5, valid_mask=valid, stream_labels={TASK: stream})
    tb = SimpleNamespace(batch_size=B, sequence_length=5, valid_mask=torch.from_numpy(valid),
                         stream_labels={TASK: torch.from_numpy(stream)})  # fmt: skip
    want, wfrac = jzs._aggregate_predictions(None, jb, config, Fixed(), S)
    got, gfrac = tzs._aggregate_predictions(None, tb, config, Fixed(), S)
    np.testing.assert_array_equal(got.preds, want.preds)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(gfrac, wfrac)
    assert got.labels.dtype == np.int64 and len(got.labels) == 4


@pytest.fixture(scope="module")
def cohort_models():
    """A small CI model set to the tuning split of the task (JAX and port,
    one set of weights), ``max_seq_len`` 24: 8 new events after 16. The
    lognormal TTE head gets a narrow log-time scale (the cohort's own lets
    an untrained head's greedy times reach 1e22 minutes, where the two
    packages' last-bit differences become different events)."""
    jds = JaxDataset(JaxDatasetConfig(save_dir=PROCESSED, **DATA), "tuning")
    tds = TorchDataset(PytorchDatasetConfig(save_dir=CONVERTED, **DATA), "tuning")
    jcfg = JaxConfig(**SMALL)
    jcfg.set_to_dataset(jds)
    jcfg.max_seq_len, jcfg.mean_log_inter_event_time_min, jcfg.std_log_inter_event_time_min = 24, 1.0, 0.1
    jmodel = jax_build_model(jcfg)
    jbatch = next(jds.batches(4, shuffle=False, seed=0))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    tcfg = StructuredTransformerConfig(**SMALL)
    tcfg.set_to_dataset(tds)
    tcfg.max_seq_len, tcfg.mean_log_inter_event_time_min, tcfg.std_log_inter_event_time_min = 24, 1.0, 0.1
    tmodel = load_jax_params(build_model(tcfg), jax.tree_util.tree_map(np.asarray, params))
    return jcfg, jmodel, params, jbatch, tcfg, tmodel, tds


def test_greedy_generative_predictions_equal_jax(cohort_models, monkeypatch):
    jcfg, jmodel, params, jbatch, tcfg, tmodel, tds = cohort_models
    tbatch = next(tds.batches(4, shuffle=False, seed=0))
    jlab = jzs.import_class_from_file(PROCESSED / "task_dfs" / f"{TASK}_labeler.py", "TaskLabeler")(config=jcfg)
    tlab = tzs.import_class_from_file(CONVERTED / "task_dfs" / f"{TASK}_labeler.py", "TaskLabeler")(config=tcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgu, "sample_predictions", functools.partial(jgu.sample_predictions, greedy=True))
        mp.setattr(jgu, "_STEP_CACHE", {})
        want, wfrac, wgen = jzs.get_generative_predictions(jmodel, params, jcfg, jlab, jbatch, jax.random.PRNGKey(3),
                                                           num_samples=2, max_new_events=8, return_generated=True)  # fmt: skip
    monkeypatch.setattr(tgu, "sample_predictions", functools.partial(tgu.sample_predictions, greedy=True))
    got, gfrac, ggen = tzs.get_generative_predictions(tmodel, tcfg, tlab, tbatch, 3, num_samples=2, max_new_events=8,
                                                      return_generated=True, device="cpu")  # fmt: skip
    for f in ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask"):
        np.testing.assert_array_equal(getattr(ggen, f).numpy(), np.asarray(getattr(wgen, f)), err_msg=f)
    for f in ("time_delta", "dynamic_values"):
        np.testing.assert_allclose(getattr(ggen, f).numpy(), np.asarray(getattr(wgen, f)), err_msg=f, **FLOATS)
    np.testing.assert_array_equal(got.preds, np.asarray(want.preds))
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    np.testing.assert_array_equal(gfrac, np.asarray(wfrac))
    age = tcfg.measurements_idxmap["age"]
    assert bool((ggen.dynamic_measurement_indices[:, 16:] == age).any(-1)[ggen.event_mask[:, 16:]].all())


def test_fork_equals_per_request_seeds(cohort_models):
    """The paged engine's pass (one fork a subject, sampled) against the same
    rows submitted one request a (subject, sample), seeded as the fork
    seeds its branches, on a paged engine whose groups are as wide."""
    *_, tcfg, tmodel, tds = cohort_models
    batch = next(tds.batches(3, shuffle=False, seed=0))
    kw = dict(template=batch, n_slots=6, max_len=24, max_prompt_len=16, paged_kv=True, block_size=8, device="cpu")
    forked = tzs._generate_via_engine(GenerationEngine(tmodel, tcfg, **kw), batch, 5, 2, 8)
    ref = GenerationEngine(tmodel, tcfg, **kw)
    ref.scheduler.group_sizes = (2,)
    reqs = [Request(prompt=batch.slice((slice(s, s + 1), slice(None))), max_new_events=8, request_id=(s, j),
                    key=derive_request_seed(derive_request_seed(5, s), j)) for s in range(3) for j in range(2)]  # fmt: skip
    res = by_id(ref.run(reqs))
    for s in range(3):
        for j in range(2):
            r = res[(s, j)]
            for f in ("event_mask", "time_delta", "dynamic_indices", "dynamic_values", "dynamic_values_mask"):
                assert torch.equal(getattr(forked, f)[2 * s + j, : r.n_events], getattr(r.batch, f)[0]), (s, j, f)
    assert not torch.equal(forked.time_delta[0], forked.time_delta[1])  # the branches draw their own samples


# ------------------------------------------------------------------ end to end
@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A model directory written by the port's ``train(cfg)`` on the converted cohort (one epoch)."""
    save = tmp_path_factory.mktemp("zs_pretrained")
    pretrain(PretrainConfig(
        config=dict(SMALL), seed=1, save_dir=str(save),
        optimization_config=dict(init_lr=1e-3, batch_size=8, validation_batch_size=8, max_epochs=1,
                                 lr_frac_warmup_steps=0.1),
        data_config=dict(save_dir=str(CONVERTED), max_seq_len=16, min_seq_len=2),
        trainer_config={"log_every_n_steps": 4, "checkpoint_every_n_steps": 100},
    ), device="cpu")  # fmt: skip
    return save


@pytest.mark.parametrize("use_engine", [True, False], ids=["paged_engine", "generate"])
def test_zero_shot_evaluation_runs_end_to_end(pretrained, tmp_path, use_engine):
    cfg = FinetuneConfig(load_from_model_dir=pretrained, task_df_name=TASK, save_dir=tmp_path / "zs",
                         data_config_overrides={"seq_padding_side": "left", "subsequence_sampling_strategy": "to_end"},
                         config_overrides={"max_seq_len": 24}, task_specific_params={"num_samples": 2},
                         optimization_config={"validation_batch_size": 5})  # fmt: skip
    assert cfg.data_config.task_df_name == TASK and cfg.data_config.save_dir == CONVERTED
    tuning, held_out = tzs.zero_shot_evaluation(cfg, device="cpu")
    for split, result in (("tuning", tuning), ("held_out", held_out)):
        written = json.loads((tmp_path / "zs" / f"zero_shot_{split}_metrics.json").read_text())
        assert written == result and f"{split}_frac_unpredictable" in result and f"{split}_loss" not in result
        assert 0.0 <= result[f"{split}_frac_unpredictable"] <= 1.0
    assert "tuning_accuracy" in tuning


def test_binary_task_metric_set():
    config = StructuredTransformerConfig(problem_type="single_label_classification", num_labels=2)
    assert set(StreamClassificationMetrics(config, "tuning").metrics) == {"AUROC", "accuracy", "AUPRC"}
