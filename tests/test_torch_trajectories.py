"""Trajectory generation and the MCF evaluation in the port against the JAX package, on the CPU.

* `EventStreamBatch.convert_to_DL` of fixed seeded batches equals JAX's
  ``convert_to_DL_DF`` column for column (`DLReps.to_columns`), and
  `dl_reps_to_parquet` writes the parquet frame JAX writes;
* `GenerateConfig` resolves a pretraining save_dir as JAX's does (the data
  and model configs, the implied ``max_new_events``, the save_dir of a task,
  the refusals);
* `generate_trajectories` runs end to end on the committed converted sample
  cohort with a tiny model the port's ``train(cfg)`` wrote: one file a
  sample and split, one row a subject, read back by `read_dl_reps`, each
  row's prompt events equal to its input row's, every generated time finite
  and later than the prompt's last; it refuses to overwrite and ``mesh=``.
  JAX's `generate_trajectories` is not run (its generation is a compile
  per shape); the conversion and the config resolution above hold it;
* every MCF function equals JAX's bit for bit on seeded inputs (and the
  doctests' values run in the module's own doctests), the port's frames
  being column dicts where JAX takes DataFrames.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import eventstreamgpt_tpu.evaluation as jev
from eventstreamgpt_tpu.data.types import EventStreamBatch as JaxBatch
from eventstreamgpt_tpu.evaluation.general_generative_evaluation import GenerateConfig as JaxGenerateConfig
from eventstreamgpt_tpu_torch import evaluation as tev
from eventstreamgpt_tpu_torch.data.dl_cache import dl_reps_to_parquet, read_dl_reps
from eventstreamgpt_tpu_torch.data.torch_dataset import TorchDataset
from eventstreamgpt_tpu_torch.data.types import EventStreamBatch
from eventstreamgpt_tpu_torch.evaluation import GenerateConfig, generate_trajectories
from eventstreamgpt_tpu_torch.training.pretrain import PretrainConfig
from eventstreamgpt_tpu_torch.training.pretrain import train as pretrain

from .test_torch_train import SMALL

CONVERTED = Path(__file__).resolve().parents[1] / "sample_data" / "converted" / "sample"


# ------------------------------------------------------------------ the DL conversion
def seeded_batch(seed: int, static: bool = True, time: bool = False, scalars: bool = True) -> dict:
    """numpy fields of a padded batch: left padding, zero indices among the
    data elements, unobserved values, zero static indices."""
    rng = np.random.default_rng(seed)
    B, L, M = 3, 7, 5
    lengths = rng.integers(1, L + 1, size=B)
    event_mask = np.arange(L)[None] >= (L - lengths)[:, None]
    idx = np.where(rng.random((B, L, M)) < 0.7, rng.integers(1, 40, size=(B, L, M)), 0) * event_mask[..., None]
    out = dict(
        event_mask=event_mask,
        time_delta=np.where(event_mask, rng.uniform(0.5, 90.0, size=(B, L)), 0.0).astype(np.float32),
        dynamic_indices=idx.astype(np.int64),
        dynamic_measurement_indices=np.where(idx > 0, rng.integers(1, 4, size=idx.shape), 0).astype(np.int64),
        dynamic_values=rng.normal(size=idx.shape).astype(np.float32),
        dynamic_values_mask=(rng.random(idx.shape) < 0.5) & (idx > 0),
    )
    if static:
        out["static_indices"] = np.where(rng.random((B, 3)) < 0.7, rng.integers(1, 40, size=(B, 3)), 0)
        out["static_measurement_indices"] = np.where(out["static_indices"] > 0, 5, 0)
    if time:
        out["time"] = np.cumsum(out["time_delta"], axis=1, dtype=np.float32)
    if scalars:
        out.update(start_time=rng.uniform(1e6, 2e7, size=B).astype(np.float32), subject_id=np.arange(B) * 7 + 1,
                   start_idx=rng.integers(0, 9, size=B).astype(np.int32),
                   end_idx=rng.integers(9, 20, size=B).astype(np.int32))  # fmt: skip
    return out


def jax_frame(fields: dict) -> pd.DataFrame:
    return JaxBatch(**{k: jnp.asarray(v) for k, v in fields.items()}).convert_to_DL_DF()


CONVERSIONS = [dict(seed=0), dict(seed=1, static=False), dict(seed=2, time=True), dict(seed=3, scalars=False)]


@pytest.mark.parametrize("case", CONVERSIONS, ids=["all", "no_static", "with_time", "no_scalars"])
def test_convert_to_dl_equals_jax_column_for_column(case):
    fields = seeded_batch(**case)
    want = jax_frame(fields)
    reps = EventStreamBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()}).convert_to_DL()
    got = reps.to_columns()
    assert list(got) == list(want.columns)
    for col in want.columns:
        assert got[col] == want[col].tolist(), col
    assert reps.n_rows == len(want)


def test_parquet_export_equals_jax_frame(tmp_path):
    fields = seeded_batch(0)
    jax_frame(fields).to_parquet(tmp_path / "jax.parquet")
    reps = EventStreamBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()}).convert_to_DL()
    dl_reps_to_parquet(reps, tmp_path / "port.parquet")
    want, got = (pd.read_parquet(tmp_path / f"{n}.parquet") for n in ("jax", "port"))
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for col in want.columns:
        for a, b in zip(got[col], want[col]):
            assert type(a) is type(b), col
            if isinstance(b, np.ndarray):  # lists, of arrays for the nested columns; NaN where JAX wrote None
                a, b = ([x.tolist() if isinstance(x, np.ndarray) else x for x in y] for y in (a, b))
            np.testing.assert_equal(a, b, err_msg=col)


# ------------------------------------------------------------------ the config and the generation run
@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A save_dir the port's ``train(cfg)`` wrote: a tiny fp32 CI model, one epoch on the sample cohort."""
    save = tmp_path_factory.mktemp("pretrained") / "run"
    pretrain(PretrainConfig(
        config=dict(SMALL), seed=1, save_dir=str(save),
        optimization_config=dict(init_lr=1e-3, batch_size=8, validation_batch_size=8, max_epochs=1,
                                 lr_frac_warmup_steps=0.1),
        data_config=dict(save_dir=str(CONVERTED), max_seq_len=16, min_seq_len=2),
        trainer_config={"log_every_n_steps": 4, "checkpoint_every_n_steps": 100},
    ), device="cpu")  # fmt: skip
    return save


def close(a, b, path=""):
    """Equal JSON values, floats within 1e-12 relative."""
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, f"{path}[{i}]")
    elif isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12, abs=0.0), path
    else:
        assert a == b, path


RESOLUTIONS = [
    dict(task_specific_params={"num_samples": 3, "max_new_events": 6}),
    dict(task_specific_params={"num_samples": 2, "max_new_events": None}, config_overrides={"max_seq_len": 20}),
    dict(task_specific_params={"num_samples": 2, "max_new_events": 4}, task_df_name="high_utilization",
         data_config_overrides={"seq_padding_side": "left", "max_seq_len": 10}, config_overrides={"max_seq_len": 14}),
]


@pytest.mark.parametrize("kw", RESOLUTIONS, ids=["max_new_events", "implied", "task"])
def test_generate_config_resolves_as_jax(pretrained, kw):
    jcfg, tcfg = JaxGenerateConfig(load_from_model_dir=pretrained, **kw), GenerateConfig(load_from_model_dir=pretrained,
                                                                                         **kw)  # fmt: skip
    assert (tcfg.save_dir, tcfg.pretrained_weights_fp) == (jcfg.save_dir, jcfg.pretrained_weights_fp)
    # The vocabularies' observed frequencies are renormalized on each load, in
    # each package's own order of operations: equal within ulps.
    close(json.loads(json.dumps(tcfg.config.to_dict())), json.loads(json.dumps(jcfg.config.to_dict())))
    jd, td = jcfg.data_config.to_dict(), tcfg.data_config.to_dict()
    for k in sorted(set(jd) & set(td)):
        assert str(td[k]) == str(jd[k]), k
    assert tcfg.config.task_specific_params == jcfg.config.task_specific_params
    assert tcfg.config.max_seq_len - tcfg.data_config.max_seq_len == tcfg.config.task_specific_params["max_new_events"]


def test_generate_config_refuses_as_jax(pretrained):
    kw = dict(task_specific_params={"num_samples": 2, "max_new_events": None})
    for cls in (JaxGenerateConfig, GenerateConfig):
        with pytest.raises(ValueError, match="Implied to not be generating any new events"):
            cls(load_from_model_dir=pretrained, **kw)
        with pytest.raises(ValueError, match="Must specify num samples"):
            cls(load_from_model_dir=pretrained, task_specific_params=None)
    assert GenerateConfig().config is None


def test_generate_trajectories_end_to_end(pretrained, tmp_path):
    cfg = GenerateConfig(load_from_model_dir=pretrained, save_dir=tmp_path / "gen",
                         task_specific_params={"num_samples": 2, "max_new_events": 5},
                         optimization_config={"validation_batch_size": 5})  # fmt: skip
    stats: dict = {}
    out = generate_trajectories(cfg, device="cpu", stats=stats)
    assert out == tmp_path / "gen" / "generated_trajectories"
    for split in ("tuning", "held_out"):
        assert sorted(p.name for p in (out / split).iterdir()) == [f"sample_{i}_local_rank_0.npz" for i in range(2)]
        ds = TorchDataset(cfg.data_config, split=split)
        prompts = [b.convert_to_DL() for b in ds.batches(5, shuffle=False, drop_last=False, seed=0)]
        prompt_rows = {k: sum((p.to_columns()[k] for p in prompts), [])
                       for k in ("subject_id", "dynamic_indices", "dynamic_values", "time_delta")}  # fmt: skip
        n = len(ds)
        assert len(prompt_rows["subject_id"]) >= n
        for i in range(2):
            reps = read_dl_reps(out / split / f"sample_{i}_local_rank_0.npz")
            rows = reps.to_columns()
            assert reps.n_rows == n and rows["subject_id"] == prompt_rows["subject_id"][:n]
            frame = tev.dl_frame(reps)
            for r in range(n):
                k = len(prompt_rows["dynamic_indices"][r])
                assert rows["dynamic_indices"][r][:k] == prompt_rows["dynamic_indices"][r]
                assert rows["dynamic_values"][r][:k] == prompt_rows["dynamic_values"][r]
                assert rows["time_delta"][r][: k - 1] == prompt_rows["time_delta"][r][: k - 1]
                times = np.asarray(frame["time"][r])
                assert len(times) > k and np.isfinite(times).all() and (times[k:] > times[k - 1]).all()
        assert sum(n_new for n_new, _ in stats[split]) > 0
    with pytest.raises(FileExistsError, match="do_overwrite"):
        generate_trajectories(cfg, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 7"):
        generate_trajectories(cfg, device="cpu", mesh=object())


# ------------------------------------------------------------------ MCF
def seeded_frame(rng, n_subj=6, ids=None) -> dict:
    """A frame of ``n_subj`` subjects: times with repeats, indices 1-5, values with None."""
    frame = {"subject_id": list(ids if ids is not None else rng.permutation(n_subj) * 3), "time": [],
             "dynamic_indices": [], "dynamic_values": []}  # fmt: skip
    for _ in range(n_subj):
        n = int(rng.integers(1, 9))
        frame["time"].append(np.round(np.sort(rng.uniform(0, 50, size=n)), 0).tolist())
        idx, vals = [], []
        for _ in range(n):
            m = int(rng.integers(0, 4))
            idx.append(rng.integers(1, 6, size=m).tolist())
            vals.append([None if rng.random() < 0.3 else float(rng.normal()) for _ in range(m)])
        frame["dynamic_indices"].append(idx)
        frame["dynamic_values"].append(vals)
    return frame


PREDICATES = {1: True, 2: (0.0, None), 3: ((-0.5, True), (0.5, False)), 4: (None, 1.0)}


def same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
    return a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crps_and_eval_range_equal_jax(seed):
    rng = np.random.default_rng(seed)
    samples = rng.normal(size=(7, 5, 3))
    samples[rng.random(samples.shape) < 0.2] = np.nan
    true = rng.normal(size=(5, 3))
    true[0, 0] = np.nan
    assert same(tev.crps(samples, true), jev.crps(samples, true))
    assert same(tev.crps(samples[:1], true), jev.crps(samples[:1], true))
    vals = np.where(rng.random(20) < 0.2, np.nan, rng.normal(size=20))
    for rng_spec in (True, False, (None, None), *PREDICATES.values(), ((0.1, False), (0.9, True))):
        assert same(tev.eval_range(rng_spec, vals), jev.eval_range(rng_spec, vals)), rng_spec


@pytest.mark.parametrize("seed", [0, 1])
def test_align_and_mcf_equal_jax(seed):
    rng = np.random.default_rng(seed)
    frame = seeded_frame(rng)
    frame["align_time"] = rng.uniform(0, 20, size=len(frame["subject_id"])).tolist()
    got = tev.align_time_and_eval_predicates(frame, PREDICATES)
    want = jev.align_time_and_eval_predicates(pd.DataFrame(frame), PREDICATES)
    assert list(got) == list(want.columns)
    for col in want.columns:
        assert list(np.asarray(got[col]).tolist() if col == "subject_id" else got[col]) == want[col].tolist(), col

    others = [tev.align_time_and_eval_predicates(dict(seeded_frame(rng), align_time=[0.0] * 6), PREDICATES)
              for _ in range(2)]  # fmt: skip
    Ts = [f["time"] for f in [got, *others]]
    np.random.seed(seed)
    want_ts = jev.get_aligned_timestamps(*Ts, n_timestamps=9)
    got_ts = tev.get_aligned_timestamps(*Ts, n_timestamps=9, rng=np.random.RandomState(seed))
    assert got_ts == want_ts and len(got_ts) == 9
    assert tev.get_aligned_timestamps(*Ts) == jev.get_aligned_timestamps(*Ts)
    with pytest.raises(ValueError, match="explicit rng"):
        tev.get_aligned_timestamps(*Ts, n_timestamps=2)

    cols = [f"pred_{i}" for i in PREDICATES]
    got_mcf = tev.get_MCF(got_ts, cols, got, *others)
    want_mcf = jev.get_MCF(want_ts, cols, want, *(pd.DataFrame(o) for o in others))
    for g, w in zip(got_mcf, want_mcf):
        assert same(g, w)


@pytest.mark.parametrize("n_timestamps", [None, 12])
def test_mcf_coordinates_equal_jax(n_timestamps):
    rng = np.random.default_rng(5)
    control = seeded_frame(rng, ids=[4, 1, 9, 2, 7, 3])
    control["control_align_idx"] = [int(rng.integers(0, len(t))) for t in control["time"]]
    samples = [seeded_frame(rng, ids=[1, 2, 3, 4, 9, 11]) for _ in range(3)]
    np.random.seed(11)
    want = jev.get_MCF_coordinates(pd.DataFrame(control), [pd.DataFrame(s) for s in samples], PREDICATES,
                                   n_timestamps=n_timestamps)  # fmt: skip
    got = tev.get_MCF_coordinates(control, samples, PREDICATES, n_timestamps=n_timestamps,
                                  rng=np.random.RandomState(11))  # fmt: skip
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert same(np.asarray(g) if isinstance(w, np.ndarray) else g, w)


def test_dl_frame_times_from_deltas():
    reps = EventStreamBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in seeded_batch(0).items()}).convert_to_DL()
    frame = tev.dl_frame(reps)
    for start, deltas, times in zip(frame["start_time"], frame["time_delta"], frame["time"]):
        want = float(start) + np.concatenate([[0.0], np.cumsum(np.asarray(deltas, np.float64))[:-1]])
        assert times == want.tolist()
