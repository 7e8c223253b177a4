"""The PyTorch port's resident feed against the JAX package's, on the CPU.

The JAX side is a `JaxDataset` over a copy of the in-repo
``sample_data/processed/sample`` or over a small DL cache written by
``write_synthetic_dataset``, and its `DeviceDataset` on the CPU; the port's
side is a `CSRDataset` over that ``JaxDataset``'s ``data``, handed across
as numpy arrays, and the port's `DeviceDataset` on the CPU. Held bit for
bit, dtypes included:

* ``plan_batches``: shuffle on and off, ``drop_last``, ``skip_batches``,
  each `SubsequenceSamplingStrategy`, ``do_include_start_time_min``;
* the dense tables, ``max_n_dynamic`` capped below the data's widest event
  included, and their size (``nbytes``, ``estimate_nbytes``);
* the padded collate: right and left padding, static data on and off, fill
  rows, the light fields;
* the packed collate;
* ``plan_chunks`` and ``packed_plan_chunks`` with their event counts.

Beside them: the refusals (sharded layouts, int64 arrays, non-finite
values) and the CUDA default.
"""

import dataclasses
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.data import DeviceDataset as JaxDeviceDataset
from eventstreamgpt_tpu.data import JaxDataset, PytorchDatasetConfig
from eventstreamgpt_tpu.data.synthetic import write_synthetic_dataset
from eventstreamgpt_tpu_torch.data.device_dataset import DeviceDataset
from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig as PortDatasetConfig
from eventstreamgpt_tpu_torch.data.torch_dataset import CSRData, CSRDataset
from eventstreamgpt_tpu_torch.utils.enums import SubsequenceSamplingStrategy

PROCESSED = Path(__file__).resolve().parent.parent / "sample_data" / "processed" / "sample"
SOURCES = ("sample", "synthetic")
STRATEGIES = tuple(SubsequenceSamplingStrategy.values())


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    sample = tmp_path_factory.mktemp("sample_data_copy") / "sample"
    shutil.copytree(PROCESSED, sample)
    synth = tmp_path_factory.mktemp("synthetic_dl")
    write_synthetic_dataset(
        synth, {"train": 21, "tuning": 4, "held_out": 4}, n_event_types=6, n_labs=40, n_meds=8,
        mean_seq_len=12, max_seq_len=40, seed=0,
    )  # fmt: skip
    return {"sample": sample, "synthetic": synth}


@pytest.fixture(scope="module")
def datasets(dirs):
    """``get(source, **config) -> (JaxDataset, CSRDataset)``, built once each."""
    cache = {}

    def get(source, static=True, **kw):
        key = (source, static, tuple(sorted(kw.items())))
        if key not in cache:
            kw = dict(dict(max_seq_len=8, min_seq_len=2), **kw)
            jds = JaxDataset(PytorchDatasetConfig(save_dir=dirs[source], **kw), "train")
            jds.do_produce_static_data = jds.do_produce_static_data and static
            cache[key] = (jds, port_dataset(jds))
        return cache[key]

    return get


def port_dataset(jds) -> CSRDataset:
    data = CSRData(**{f.name: np.asarray(getattr(jds.data, f.name)) for f in dataclasses.fields(CSRData)})
    c = jds.config
    config = PortDatasetConfig.from_dict(c.to_dict())
    return CSRDataset(data, config, do_produce_static_data=jds.do_produce_static_data, subject_ids=jds.subject_ids)


def assert_same(port, jax_value, what):
    """Equal values and dtypes; ``port`` a tensor (or None), ``jax_value`` a JAX or numpy array."""
    if jax_value is None:
        assert port is None, what
        return
    want = np.asarray(jax_value)
    got = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_same_batch(port, jax_batch):
    for f in dataclasses.fields(jax_batch):
        want = getattr(jax_batch, f.name)
        assert not isinstance(want, dict), f.name  # no task labels on either side
        assert_same(getattr(port, f.name), want, f.name)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize(
    "shuffle,drop_last,skip", [(True, None, 0), (False, False, 1), (True, False, 2), (False, True, 0)],
    ids=["shuffled", "in-order-fill-skip1", "shuffled-fill-skip2", "in-order-drop"],
)  # fmt: skip
@pytest.mark.parametrize("start_time", [False, True], ids=["", "start_time"])
def test_plan_batches_match_jax(datasets, strategy, shuffle, drop_last, skip, start_time):
    jds, ds = datasets("sample", subsequence_sampling_strategy=strategy, do_include_start_time_min=start_time)
    kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last, skip_batches=skip)
    want, got = list(jds.plan_batches(10, **kw)), list(ds.plan_batches(10, **kw))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        for f in ("subject_indices", "starts", "kept", "valid_mask", "start_time"):
            assert_same(getattr(g, f), getattr(w, f), f)
        assert g.n_events == w.n_events
    if strategy == "random":
        assert any(p.starts.any() for p in got)  # crops are drawn


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("max_n_dynamic", [None, 3])
@pytest.mark.parametrize("static", [True, False], ids=["static", "no-static"])
def test_dense_tables_match_jax(datasets, source, max_n_dynamic, static):
    jds, ds = datasets(source, static, max_n_dynamic=max_n_dynamic)
    if max_n_dynamic is not None:
        assert int(np.diff(jds.data.event_data_offsets).max()) > max_n_dynamic  # the cap clips
    jdd, dd = JaxDeviceDataset(jds), DeviceDataset(ds, device="cpu")
    assert sorted(dd.arrays) == sorted(jdd.arrays)
    for k, v in jdd.arrays.items():
        assert dd.arrays[k].device.type == "cpu"
        assert_same(dd.arrays[k], v, k)
    assert dd.nbytes == jdd.nbytes
    assert DeviceDataset.estimate_nbytes(ds) == JaxDeviceDataset.estimate_nbytes(jds)
    assert (ds.max_n_dynamic, ds.max_n_static, ds.data.subject_event_offsets.dtype) == (
        jds.max_n_dynamic, jds.max_n_static, jds.data.subject_event_offsets.dtype)  # fmt: skip


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "no-static"])
def test_padded_collate_matches_jax(datasets, source, side, static):
    """Fill rows (an in-order epoch whose last batch is filled) and the light fields included."""
    light = dict(do_include_start_time_min=True, do_include_subsequence_indices=True, do_include_subject_id=True)
    jds, ds = datasets(source, static, seq_padding_side=side, max_seq_len=16, **light)
    jdd, dd = JaxDeviceDataset(jds), DeviceDataset(ds, device="cpu")
    for shuffle in (False, True):
        kw = dict(shuffle=shuffle, seed=5, drop_last=False, with_counts=True)
        want, got = list(jdd.batches(10, **kw)), list(dd.batches(10, **kw))
        assert len(got) == len(want) > 1
        assert not np.asarray(want[-1][0].valid_mask).all()  # fill rows
        for (g, gn), (w, wn) in zip(got, want):
            assert gn == wn
            assert_same_batch(g, w)
            assert (g.static_indices is not None) == static


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_packed_collate_matches_jax(datasets, source, strategy):
    jds, ds = datasets(source, max_seq_len=32, subsequence_sampling_strategy=strategy)
    jdd, dd = JaxDeviceDataset(jds), DeviceDataset(ds, device="cpu")
    kw = dict(seq_len=32, seed=2, with_counts=True)
    want, got = list(jdd.packed_batches(3, **kw)), list(dd.packed_batches(3, **kw))
    assert len(got) == len(want) > 1
    for (g, gn), (w, wn) in zip(got, want):
        assert gn == wn
        assert_same_batch(g, w)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("chunk,skip", [(3, 0), (4, 1)])
def test_plan_chunks_match_jax(datasets, source, chunk, skip):
    jds, ds = datasets(source)
    jdd, dd = JaxDeviceDataset(jds), DeviceDataset(ds, device="cpu")
    kw = dict(shuffle=True, seed=4, drop_last=False, skip_batches=skip)
    want, got = list(jdd.plan_chunks(4, chunk, **kw)), list(dd.plan_chunks(4, chunk, **kw))
    n = -(-len(ds) // 4) - skip
    assert [len(p["starts"]) for p, _ in got] == [chunk] * (n // chunk) + [n % chunk] * (n % chunk > 0)
    assert len(got) == len(want) > 1
    for (g, gn), (w, wn) in zip(got, want):
        assert gn == wn and sorted(g) == sorted(w)
        for k in w:
            assert_same(g[k], w[k], k)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("drop_short,skip,chunk", [(True, 0, 2), (False, 1, 1)])
def test_packed_plan_chunks_match_jax(datasets, source, drop_short, skip, chunk):
    """A short batch kept (``drop_short=False``) stacks in a chunk of one step."""
    jds, ds = datasets(source, max_seq_len=24)
    jdd, dd = JaxDeviceDataset(jds), DeviceDataset(ds, device="cpu")
    kw = dict(seq_len=24, seed=6, skip_batches=skip, drop_short=drop_short)
    want, got = list(jdd.packed_plan_chunks(3, chunk, **kw)), list(dd.packed_plan_chunks(3, chunk, **kw))
    assert len(got) == len(want) > 1
    for (g, gn), (w, wn) in zip(got, want):
        assert gn == wn and sorted(g) == sorted(w)
        for k in w:
            assert_same(g[k], w[k], k)


def test_sharded_layouts_and_wide_arrays_are_refused(datasets):
    _, ds = datasets("synthetic")
    with pytest.raises(ValueError, match="Queue 1 item 7"):
        next(ds.plan_batches(4, n_shards=2))
    for kw in (dict(data_shards=2), dict(mesh=object()), dict(context_parallel=True)):
        with pytest.raises(ValueError, match="Queue 1 item 7"):
            DeviceDataset(ds, device="cpu", **kw)
    wide = CSRDataset(ds.data, ds.config)
    wide.data = dataclasses.replace(wide.data, dynamic_indices=wide.data.dynamic_indices.astype(np.int64) + 2**31)
    with pytest.raises(ValueError, match="did not narrow to int32"):
        DeviceDataset(wide, device="cpu")


@pytest.mark.parametrize("field", ["time_delta", "dynamic_values"])
def test_poisoned_cache_fails_at_build(datasets, field):
    _, ds = datasets("synthetic")
    bad = CSRDataset(ds.data, ds.config)
    values = getattr(bad.data, field).copy()
    values[3] = np.nan
    bad.data = dataclasses.replace(bad.data, **{field: values})
    with pytest.raises(ValueError, match="non-finite"):
        DeviceDataset(bad, device="cpu")


def test_device_dataset_defaults_to_cuda(datasets):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where no CUDA device is available")
    _, ds = datasets("synthetic")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceDataset(ds)
