"""The port's packing (``data/torch_dataset.py``) against ``JaxDataset``'s, on the CPU.

A small DL cache written by the JAX package's ``write_synthetic_dataset`` is
opened with `JaxDataset`; its flattened arrays (``jax_ds.data``) go to the
port's `packed_batches` with the same seed and subsequence-sampling strategy.
Every field of every batch must equal ``jax_ds.packed_batches(...)``'s
exactly: segment ids, the trailing-padding rule and the crops of subjects
longer than a row included. The port's `synthetic_csr` is checked against
the distribution it claims and packed in ``bench.py``'s shape.
"""

import dataclasses

import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.data import JaxDataset, PytorchDatasetConfig
from eventstreamgpt_tpu.data.synthetic import write_synthetic_dataset
from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_csr
from eventstreamgpt_tpu_torch.data.torch_dataset import CSRData, packed_batches, packed_rows_dealt
from eventstreamgpt_tpu_torch.utils.enums import SubsequenceSamplingStrategy

SEQ_LEN = 16
FIELDS = (
    "event_mask", "time_delta", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values",
    "dynamic_values_mask", "segment_ids", "valid_mask",
)  # fmt: skip


@pytest.fixture(scope="module")
def save_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("packing_dl")
    write_synthetic_dataset(
        path, {"train": 24, "tuning": 4, "held_out": 4}, n_event_types=6, n_labs=40, n_meds=8,
        mean_seq_len=8, max_seq_len=40, seed=0,
    )  # fmt: skip
    return path


def jax_dataset(save_dir, strategy) -> JaxDataset:
    config = PytorchDatasetConfig(
        save_dir=save_dir, max_seq_len=SEQ_LEN, min_seq_len=2, subsequence_sampling_strategy=strategy
    )
    return JaxDataset(config, "train")


def port_csr(ds: JaxDataset) -> CSRData:
    return CSRData(**{f.name: getattr(ds.data, f.name) for f in dataclasses.fields(ds.data)})


@pytest.mark.parametrize("shuffle,seed", [(True, 1), (True, 7), (False, 5)])
@pytest.mark.parametrize("strategy", ["random", "to_end", "from_start"])
def test_packed_batches_equal_jax(save_dir, strategy, shuffle, seed):
    ds = jax_dataset(save_dir, strategy)
    lengths = np.diff(ds.data.subject_event_offsets)
    assert (lengths > SEQ_LEN).any() and (lengths < SEQ_LEN).any()  # crops and sharing rows both happen
    want = list(ds.packed_batches(4, seq_len=SEQ_LEN, shuffle=shuffle, seed=seed))
    got = list(packed_batches(port_csr(ds), 4, SEQ_LEN, shuffle=shuffle, seed=seed, strategy=strategy,
                              max_n_dynamic=ds.max_n_dynamic))  # fmt: skip
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)), err_msg=f)
        for f in ("static_indices", "static_measurement_indices", "stream_labels", "start_time"):
            assert getattr(g, f) is None and getattr(w, f) is None
    # Trailing padding shares the row's last segment id.
    for g in got:
        for mask, seg in zip(g.event_mask, g.segment_ids):
            n = int(mask.sum())
            if n < SEQ_LEN:
                assert (seg[n:] == seg[n - 1]).all()


def test_crops_follow_the_strategy(save_dir):
    """The longest subject, cropped to a row: its last events under TO_END,
    its first under FROM_START, a random window under RANDOM (as JAX draws it)."""
    ds = jax_dataset(save_dir, "to_end")
    csr = port_csr(ds)
    lengths = np.diff(csr.subject_event_offsets)
    s = int(np.argmax(lengths))
    starts = {}
    for strategy in SubsequenceSamplingStrategy:
        rows = packed_rows_dealt(csr, 4, SEQ_LEN, shuffle=True, seed=3, strategy=strategy)
        (start,) = [st for row in rows for subj, st, n in row if subj == s]
        starts[strategy] = start
        want_rows = jax_dataset(save_dir, str(strategy)).packed_rows_dealt(4, seq_len=SEQ_LEN, shuffle=True, seed=3)
        assert rows == want_rows
    assert starts[SubsequenceSamplingStrategy.TO_END] == lengths[s] - SEQ_LEN
    assert starts[SubsequenceSamplingStrategy.FROM_START] == 0
    assert 0 <= starts[SubsequenceSamplingStrategy.RANDOM] <= lengths[s] - SEQ_LEN


def test_sharded_packing_is_not_ported(save_dir):
    with pytest.raises(ValueError, match="Queue 1 item 7"):
        packed_rows_dealt(port_csr(jax_dataset(save_dir, "random")), 4, SEQ_LEN, n_shards=2)


def test_synthetic_csr_packs_like_the_benchmark():
    """``synthetic_csr`` follows `synthetic_training_batches`' subject recipe,
    and packs into nearly full rows."""
    config = serving_config(sizes=(5, 40, 6, 3))
    csr = synthetic_csr(np.random.default_rng(0), config, 48, mean_seq_len=40)
    lengths = np.diff(csr.subject_event_offsets)
    assert csr.n_subjects == 48 and lengths.min() >= 4 and lengths.max() <= 512
    assert len(csr.time_delta) == lengths.sum() == len(csr.event_data_offsets) - 1
    last = csr.subject_event_offsets[1:] - 1
    np.testing.assert_array_equal(csr.time_delta[last], 1.0)
    others = np.setdiff1d(np.arange(len(csr.time_delta)), last)
    assert ((csr.time_delta[others] >= 1.0) & (csr.time_delta[others] <= 240.0)).all()
    first = csr.event_data_offsets[:-1]
    np.testing.assert_array_equal(csr.dynamic_measurement_indices[first], 1)  # an event type first
    assert csr.max_n_dynamic <= 24
    np.testing.assert_array_equal(csr.dynamic_values_observed, csr.dynamic_measurement_indices == 2)
    batch = next(packed_batches(csr, 4, 128, seed=1))
    assert batch.event_mask.shape == (4, 128) and batch.dynamic_indices.shape == (4, 128, csr.max_n_dynamic)
    assert batch.event_mask.float().mean() > 0.8
    assert batch.segment_ids.dtype == torch.int64 and int(batch.segment_ids.max()) >= 1
