"""The port's DL-cache reader against ``JaxDataset``, on the CPU.

``sample_data/processed/sample`` and a small ``write_synthetic_dataset``
cache are converted with `convert_dl_cache`; `TorchDataset` over the
conversion must equal ``JaxDataset`` over the parquet cache:

* every split and setting: the subject ids, every CSR array (values and
  dtypes) and ``start_time_min`` bit for bit, the log inter-event-time
  statistics, ``max_n_dynamic`` and ``max_n_static``;
* every field of ``batches(B, shuffle=True, seed)`` for both padding sides
  and the three subsequence strategies (with the light fields on), the eval
  stream with its blanked fill rows, ``__getitem__`` / ``collate``;
* a cache with one non-positive delta: the same subjects quarantined;
* a split in eleven chunks: read in numeric order;
* ``packed_batch_count`` and ``packed_batches``;
* `write_synthetic_cache` equals the conversion of JAX's writer, array for
  array; reading needs neither pandas nor pyarrow.
"""

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from eventstreamgpt_tpu.data import JaxDataset
from eventstreamgpt_tpu.data import PytorchDatasetConfig as JaxDatasetConfig
from eventstreamgpt_tpu.data.synthetic import write_synthetic_dataset
from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig, VocabularyConfig
from eventstreamgpt_tpu_torch.data.dl_cache import convert_dl_cache
from eventstreamgpt_tpu_torch.data.synthetic import write_synthetic_cache
from eventstreamgpt_tpu_torch.data.torch_dataset import CSRData, TorchDataset, minutes_to_ns

REPO = Path(__file__).resolve().parents[1]
PROCESSED = REPO / "sample_data" / "processed" / "sample"
SPLITS = ("train", "tuning", "held_out")
SYNTH = dict(
    n_subjects_per_split={"train": 12, "tuning": 4, "held_out": 4}, n_event_types=6, n_labs=30, n_meds=8,
    mean_seq_len=12, max_seq_len=40, seed=3,
)  # fmt: skip
SETTINGS = {
    "default": {},
    "short": dict(max_seq_len=8, min_seq_len=4),
    "subset_int": dict(train_subset_size=20, train_subset_seed=3),
    "subset_float": dict(train_subset_size=0.3, train_subset_seed=5),
}


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """{name: (parquet dir, converted dir)} for the sample data and a synthetic cache."""
    root = tmp_path_factory.mktemp("dl_cache")
    synth = write_synthetic_dataset(root / "synthetic", **SYNTH)
    return {
        "sample": (PROCESSED, convert_dl_cache(PROCESSED, root / "sample_npz")),
        "synthetic": (synth, convert_dl_cache(synth, root / "synthetic_npz")),
    }


def pair(src, conv, split, **kw):
    return (
        JaxDataset(JaxDatasetConfig(save_dir=src, **kw), split),
        TorchDataset(PytorchDatasetConfig(save_dir=conv, **kw), split),
    )


def assert_same_data(jds, tds):
    assert tds.subject_ids == jds.subject_ids
    for f in dataclasses.fields(CSRData):
        a, b = getattr(jds.data, f.name), getattr(tds.data, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    assert tds.mean_log_inter_event_time_min == jds.mean_log_inter_event_time_min
    assert tds.std_log_inter_event_time_min == jds.std_log_inter_event_time_min
    assert (tds.max_n_dynamic, tds.max_n_static) == (jds.max_n_dynamic, jds.max_n_static)
    assert tds.do_produce_static_data == jds.do_produce_static_data


def assert_same_batch(jb, tb):
    for f in dataclasses.fields(jb):
        a, b = getattr(jb, f.name), getattr(tb, f.name)
        if a is None:
            assert b is None, f.name
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("source", ["sample", "synthetic"])
def test_dataset_matches_jax(caches, source, split, setting):
    jds, tds = pair(*caches[source], split, **SETTINGS[setting])
    assert_same_data(jds, tds)
    assert tds.vocabulary_config.to_dict() == jds.vocabulary_config.to_dict()
    assert measurements(tds) == measurements(jds)


def measurements(ds) -> dict:
    """The measurement configs; a vocabulary as its set of elements (JAX's
    ``Vocabulary`` re-sorts and re-normalizes the frequencies it reads, the
    port keeps them as serialized)."""
    out = {}
    for k, v in ds.measurement_configs.items():
        d = v.to_dict()
        d["vocabulary"] = None if d["vocabulary"] is None else sorted(d["vocabulary"]["vocabulary"])
        out[k] = d
    return out


@pytest.mark.parametrize("strategy", ["random", "to_end", "from_start"])
@pytest.mark.parametrize("side", ["right", "left"])
def test_batches_match_jax(caches, side, strategy):
    kw = dict(max_seq_len=8, seq_padding_side=side, subsequence_sampling_strategy=strategy,
              do_include_start_time_min=True, do_include_subsequence_indices=True, do_include_subject_id=True)  # fmt: skip
    for source in ("sample", "synthetic"):
        jds, tds = pair(*caches[source], "train", **kw)
        for shuffle, drop_last, skip in ((True, None, 0), (True, None, 1), (False, False, 0)):
            stream = dict(shuffle=shuffle, seed=11, drop_last=drop_last, skip_batches=skip)
            jb, tb = list(jds.batches(5, **stream)), list(tds.batches(5, **stream))
            assert len(jb) == len(tb) > 0
            for a, b in zip(jb, tb):
                assert_same_batch(a, b)
        items = [jds._seeded_getitem(i, seed=7 + i) for i in range(3)]
        np.testing.assert_equal([tds.__getitem__(i, seed=7 + i) for i in range(3)], items)  # NaN == NaN
        assert_same_batch(jds.collate(items), tds.collate(items))


def test_non_positive_delta_is_quarantined(caches, tmp_path):
    src = tmp_path / "bad"
    shutil.copytree(PROCESSED, src)
    fp = src / "DL_reps" / "train_0.parquet"
    df = pd.read_parquet(fp)
    t = np.array(df.at[3, "time"], dtype=np.float64)
    t[2] = t[1]  # a zero inter-event time
    df.at[3, "time"] = t
    df.to_parquet(fp)
    conv = convert_dl_cache(src, tmp_path / "bad_npz")
    jds, tds = pair(src, conv, "train")
    assert_same_data(jds, tds)
    assert int(df.at[3, "subject_id"]) not in tds.subject_ids
    assert (conv / "malformed_data_train.npz").exists()


def test_eleven_chunks_read_in_numeric_order(tmp_path):
    src = tmp_path / "chunked"
    shutil.copytree(PROCESSED, src)
    df = pd.read_parquet(src / "DL_reps" / "train_0.parquet")
    (src / "DL_reps" / "train_0.parquet").unlink()
    for k, part in enumerate(np.array_split(np.arange(len(df)), 11)):
        df.iloc[part].to_parquet(src / "DL_reps" / f"train_{k}.parquet")
    conv = convert_dl_cache(src, tmp_path / "chunked_npz")
    jds, tds = pair(src, conv, "train")
    assert_same_data(jds, tds)
    assert tds.subject_ids == df["subject_id"].tolist()


@pytest.mark.parametrize("source", ["sample", "synthetic"])
def test_packing_matches_jax(caches, source):
    jds, tds = pair(*caches[source], "train", max_seq_len=8)
    for seq_len in (16, 32):
        assert tds.packed_batch_count(4, seq_len=seq_len, seed=2) == jds.packed_batch_count(4, seq_len=seq_len, seed=2)
        jb, tb = list(jds.packed_batches(4, seq_len=seq_len, seed=2)), list(tds.packed_batches(4, seq_len=seq_len, seed=2))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            for f in ("event_mask", "time_delta", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values",
                      "dynamic_values_mask", "segment_ids", "valid_mask"):  # fmt: skip
                assert np.array_equal(np.asarray(getattr(a, f)), getattr(b, f).numpy()), f


def test_synthetic_cache_equals_the_converted_jax_writer(caches, tmp_path):
    conv = caches["synthetic"][1]
    mine = write_synthetic_cache(tmp_path / "mine", **SYNTH)
    for name in ("vocabulary_config.json", "inferred_measurement_configs.json"):
        assert json.loads((mine / name).read_text()) == json.loads((conv / name).read_text())
    for split in SPLITS:
        with np.load(conv / "DL_reps" / f"{split}_0.npz") as a, np.load(mine / "DL_reps" / f"{split}_0.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                x, y = a[k], b[k]
                assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), (split, k)
    assert_same_data(*pair(caches["synthetic"][0], mine, "train"))


def test_minutes_to_ns_is_pandas():
    minutes = np.concatenate([[0.0, 0.5, 2 / 3, 1e-9, 17.123456789012, 123456.789],
                              np.random.default_rng(0).uniform(0, 1e6, 200)])  # fmt: skip
    want = pd.to_timedelta(pd.Series(minutes), unit="m").to_numpy().astype("timedelta64[ns]").astype(np.int64)
    assert np.array_equal(minutes_to_ns(minutes), want)


def test_reading_needs_neither_pandas_nor_pyarrow(caches):
    conv = caches["synthetic"][1]
    code = (
        "import sys\n"
        "for name in ('pandas', 'pyarrow', 'jax', 'eventstreamgpt_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig\n"
        "from eventstreamgpt_tpu_torch.data.torch_dataset import TorchDataset\n"
        f"ds = TorchDataset(PytorchDatasetConfig(save_dir={str(conv)!r}, max_seq_len=8), 'train')\n"
        "b = next(ds.batches(4, seed=0))\n"
        "print(len(ds), tuple(b.dynamic_indices.shape))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == str(SYNTH["n_subjects_per_split"]["train"])


def test_configs_round_trip_through_both_packages(caches):
    jc = JaxDatasetConfig(save_dir=caches["sample"][0], max_seq_len=8, train_subset_size=3, train_subset_seed=1)
    tc = PytorchDatasetConfig.from_dict(jc.to_dict())
    assert tc.to_dict() == jc.to_dict()
    assert JaxDatasetConfig.from_dict(tc.to_dict()).to_dict() == jc.to_dict()
    vc = json.loads((PROCESSED / "vocabulary_config.json").read_text())
    assert VocabularyConfig(**vc).total_vocab_size == 27
