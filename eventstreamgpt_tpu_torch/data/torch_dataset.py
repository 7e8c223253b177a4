"""The dataset: CSR event data read from a converted DL cache, batch plans, host collation and packing.

Counterpart: ``eventstreamgpt_tpu/data/jax_dataset.py``:

* the `_CSRData` layout (`CSRData`) and a view of it with the settings the
  plan stream and the collates read (`CSRDataset`, under ``JaxDataset``'s
  attribute names);
* `TorchDataset`, the ``JaxDataset`` of a DL cache: its constructor (time
  deltas, the ``min_seq_len`` filter, the inter-event statistics, the
  quarantine of malformed subjects, ``train_subset_size``) over a cache in
  the numpy format of `data.dl_cache` (``convert_dl_cache`` writes it from
  the parquet one where pandas is installed), so the card's machine reads a
  cohort without pandas;
* the padded plan stream: `BatchPlan`, ``_draw_starts`` and
  ``plan_batches`` (subject order, subsequence crop starts and fill-row
  validity, with the same random stream), and host collation of those
  plans (``batches``, ``collate_indices``, ``__getitem__`` / ``collate``);
* the packing of ``JaxDataset`` (``_pack_rows``, ``packed_rows_dealt``,
  ``packed_row_plan``, ``packed_batches``), step for step and with the same
  random stream.

* task data (``PytorchDatasetConfig.task_df_name``): ``normalize_task``,
  ``_load_task_data`` and ``_build_task_cached_df`` over the converted
  task dataframe (`data.dl_cache.read_task_df`), each subject's events
  restricted to its task windows with numpy; batches carry
  ``stream_labels``. JAX caches the restricted rows as parquet under
  ``DL_reps/for_task``; the port computes them when the dataset is built.

Packing first-fit places whole subject sequences into rows of ``seq_len``
events, with ``segment_ids`` marking where one subject ends and the next
begins; a subject longer than a row is cropped by the
`SubsequenceSamplingStrategy`. Packed batches carry no static data and no
stream labels, as in the JAX package. Batches are CPU tensors of the numpy
arrays the JAX dataset yields (same dtypes).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..utils.enums import SeqPaddingSide, SubsequenceSamplingStrategy
from .config import MeasurementConfig, PytorchDatasetConfig, VocabularyConfig
from .dl_cache import (
    DLReps,
    RaggedColumn,
    concat_dl_reps,
    concat_ranges,
    read_dl_cache,
    read_dl_reps,
    read_task_df,
    write_dl_reps,
)
from .types import EventStreamBatch

__all__ = [
    "BatchPlan",
    "CSRData",
    "CSRDataset",
    "TorchDataset",
    "pack_rows",
    "packed_batches",
    "packed_row_plan",
    "packed_rows_dealt",
]

# Where multi-shard feeds wait (their ValueErrors name it).
SHARDED_FEEDS = "ROADMAP Queue 1 item 7: multi-GPU data feeds"
# The columns of a task dataframe that are not labels.
_TASK_KEYS = ("subject_id", "start_time", "end_time")

MAX_OPEN_ROWS = 64


@dataclasses.dataclass
class CSRData:
    """Flattened ragged event data for one split (the fields of ``_CSRData``).

    ``event_*`` arrays are indexed by global event id; ``data_*`` by global
    data-element id. ``subject_event_offsets[i] : subject_event_offsets[i+1]``
    is subject ``i``'s event range. Values are stored NaN-cleaned (0 where
    unobserved) beside a separate observed mask.
    """

    subject_event_offsets: np.ndarray  # (n_subjects + 1,) int
    time_delta: np.ndarray  # (n_events,) float32
    event_data_offsets: np.ndarray  # (n_events + 1,) int
    dynamic_indices: np.ndarray  # (n_data,) int
    dynamic_measurement_indices: np.ndarray  # (n_data,) int
    dynamic_values: np.ndarray  # (n_data,) float32, 0 where unobserved
    dynamic_values_observed: np.ndarray  # (n_data,) bool
    static_offsets: np.ndarray  # (n_subjects + 1,) int
    static_indices: np.ndarray  # (n_static,) int
    static_measurement_indices: np.ndarray  # (n_static,) int
    start_time_min: np.ndarray  # (n_subjects,) float64 (minutes since epoch)

    @property
    def n_subjects(self) -> int:
        return len(self.subject_event_offsets) - 1

    @property
    def max_n_dynamic(self) -> int:
        """The widest event's data-element count (at least 1)."""
        lens = np.diff(self.event_data_offsets)
        return max(int(lens.max()) if len(lens) else 1, 1)

    @property
    def max_n_static(self) -> int:
        """The most static data elements a subject has (at least 1)."""
        lens = np.diff(self.static_offsets)
        return max(int(lens.max()) if len(lens) else 1, 1)


def _shrink(x: np.ndarray) -> np.ndarray:
    """int64 to int32 when the values fit (``JaxDataset._flatten``'s ``shrink``)."""
    if x.size == 0 or (x.min() >= np.iinfo(np.int32).min and x.max() <= np.iinfo(np.int32).max):
        return x.astype(np.int32)
    return x


# The offset and index arrays `CSRDataset` narrows, as ``_flatten`` does.
_INDEX_FIELDS = (
    "subject_event_offsets",
    "event_data_offsets",
    "dynamic_indices",
    "dynamic_measurement_indices",
    "static_offsets",
    "static_indices",
    "static_measurement_indices",
)


@dataclasses.dataclass
class BatchPlan:
    """The host-decided, rng-dependent part of one padded batch (~100 bytes).

    Produced by `CSRDataset.plan_batches`; consumed by the device collate
    (`data.device_dataset.DeviceDataset`).
    """

    subject_indices: np.ndarray  # (B,) int32
    starts: np.ndarray  # (B,) int32: subsequence crop start a subject
    kept: np.ndarray  # (B,) int32: events kept (min(seq_len, L))
    valid_mask: np.ndarray  # (B,) bool: False for cyclic fill rows
    n_events: int  # real (non-fill, non-pad) events in the batch
    start_time: np.ndarray | None = None  # (B,) float32, when configured


class CSRDataset:
    """A `CSRData` split with the settings that batch it: the in-memory half
    of ``JaxDataset``, under its attribute names (``data``,
    ``max_seq_len``, ``max_n_dynamic``, ``max_n_static``,
    ``seq_padding_side``, ``do_produce_static_data``, ``config``).

    The offset and index arrays are narrowed to int32 wherever the values
    fit, as ``JaxDataset._flatten`` stores them; ``max_n_dynamic`` and
    ``max_n_static`` are the config's, else the data's widest, at least 1.

    Args:
        data: the split's flattened events.
        config: the plan and collate settings (`PytorchDatasetConfig`;
            ``save_dir``, ``min_seq_len`` and the subset settings are the
            reader's, which `TorchDataset` applies).
        do_produce_static_data: whether batches carry static data (the JAX
            dataset's is whether its DL cache has a static column).
        subject_ids: each subject's id, for ``do_include_subject_id``
            (default: the subject's index).

    Examples:
        >>> import numpy as np
        >>> o = np.array([0, 3, 5])
        >>> csr = CSRData(o, np.ones(5, np.float32), np.arange(6), np.ones(5), np.ones(5), np.ones(5, np.float32),
        ...               np.ones(5, bool), np.zeros(3), np.zeros(0), np.zeros(0), np.zeros(2))
        >>> ds = CSRDataset(csr, PytorchDatasetConfig(max_seq_len=2, subsequence_sampling_strategy="to_end"))
        >>> ds.data.subject_event_offsets.dtype, ds.max_n_dynamic, len(ds)
        (dtype('int32'), 1, 2)
        >>> [(p.subject_indices.tolist(), p.starts.tolist(), p.n_events) for p in ds.plan_batches(2, shuffle=False)]
        [([0, 1], [1, 0], 4)]
    """

    def __init__(
        self,
        data: CSRData,
        config: PytorchDatasetConfig | None = None,
        *,
        do_produce_static_data: bool = True,
        subject_ids=None,
    ):
        self.config = config or PytorchDatasetConfig()
        self.data = dataclasses.replace(data, **{k: _shrink(np.asarray(getattr(data, k))) for k in _INDEX_FIELDS})
        self.max_seq_len = int(self.config.max_seq_len)
        self.seq_padding_side = self.config.seq_padding_side
        self.do_produce_static_data = bool(do_produce_static_data)
        self.max_n_dynamic = self.config.max_n_dynamic or self.data.max_n_dynamic
        self.max_n_static = self.config.max_n_static or self.data.max_n_static
        self.subject_ids = list(range(self.data.n_subjects)) if subject_ids is None else list(subject_ids)
        self.has_task = False
        self.tasks = self.task_vocabs = self.stream_labels = None
        self.task_types: dict = {}

    def __len__(self) -> int:
        return self.data.n_subjects

    def _draw_starts(self, subject_indices: np.ndarray, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        """Subsequence crop starts for the given subjects, and the events each
        keeps (``min(seq_len, L)``): the one place the plan stream consumes
        randomness. RANDOM draws from ``[0, seq_len - L)``, an exclusive high
        bound, as the JAX dataset (and the reference) draw."""
        d = self.data
        idx = np.asarray(subject_indices)
        L = self.max_seq_len
        seq_lens = d.subject_event_offsets[idx + 1] - d.subject_event_offsets[idx]
        starts = np.zeros(len(idx), dtype=np.int32)
        over = seq_lens > L
        strategy = self.config.subsequence_sampling_strategy
        if strategy == SubsequenceSamplingStrategy.RANDOM:
            starts[over] = rng.integers(0, seq_lens[over] - L)
        elif strategy == SubsequenceSamplingStrategy.TO_END:
            starts[over] = seq_lens[over] - L
        elif strategy != SubsequenceSamplingStrategy.FROM_START:
            raise ValueError(f"Invalid sampling strategy: {strategy}!")
        return starts, np.minimum(seq_lens, L)

    def plan_batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int | None = None,
        drop_last: bool | None = None,
        skip_batches: int = 0,
        n_shards: int = 1,
    ):
        """Yields `BatchPlan`s of exactly ``batch_size`` subjects.

        One permutation of the subjects (when ``shuffle``), then each
        batch's crop starts, from one ``default_rng(seed)``. With
        ``drop_last`` (default: ``shuffle``) the remainder is dropped;
        otherwise the last batch is filled by cyclically repeating the
        epoch's first subjects, each fill row marked invalid in
        ``valid_mask``. ``skip_batches`` advances the stream past the first
        batches without yielding them, so batch N+1 on is the uninterrupted
        epoch's. ``n_shards > 1`` (the dealt stream of sharded tables)
        raises."""
        if n_shards != 1:
            raise ValueError(f"plan_batches with n_shards > 1 is not part of the PyTorch port yet ({SHARDED_FEEDS})")
        if drop_last is None:
            drop_last = shuffle
        rng = np.random.default_rng(seed)
        n = self.data.n_subjects
        order = rng.permutation(n) if shuffle else np.arange(n)
        n_batches = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
        for i in range(n_batches):
            idx = order[i * batch_size : (i + 1) * batch_size]
            n_real = len(idx)
            if n_real < batch_size:
                # np.resize repeats cyclically, so this stays full even when
                # the split is smaller than a batch.
                idx = np.concatenate([idx, np.resize(order, batch_size - n_real)])
            valid_mask = np.arange(batch_size) < n_real
            starts, kept = self._draw_starts(idx, rng)
            if i < skip_batches:
                continue
            start_time = None
            if self.config.do_include_start_time_min:
                d = self.data
                ev_lo = d.subject_event_offsets[idx]
                prior = np.zeros(batch_size, dtype=np.float64)
                for b, (elo, s) in enumerate(zip(ev_lo, starts)):
                    prior[b] = d.time_delta[elo : elo + s].sum()
                start_time = (d.start_time_min[idx] + prior).astype(np.float32)
            yield BatchPlan(
                subject_indices=np.asarray(idx, dtype=np.int32),
                starts=starts.astype(np.int32),
                kept=kept.astype(np.int32),
                valid_mask=valid_mask,
                n_events=int(kept[valid_mask].sum()),
                start_time=start_time,
            )

    def labels_of(self, subject_indices: np.ndarray) -> dict | None:
        """``stream_labels`` of the given subjects (JAX's dtypes: int64 for a
        multi-class task, else float32), or None without task data."""
        if not self.has_task:
            return None
        idx = np.asarray(subject_indices)
        return {
            t: np.asarray(self.stream_labels[t][idx],
                          dtype=np.int64 if self.task_types[t] == "multi_class_classification" else np.float32)
            for t in self.tasks
        }  # fmt: skip

    # ------------------------------------------------------- host collation
    def collate_indices(self, subject_indices: np.ndarray, rng: np.random.Generator | None = None) -> EventStreamBatch:
        """The static-shape batch of the given subjects, crops drawn from ``rng``."""
        rng = rng or np.random.default_rng()
        starts, kept = self._draw_starts(subject_indices, rng)
        return self._collate_with_starts(subject_indices, starts, kept)

    def _collate_with_starts(
        self, subject_indices: np.ndarray, starts: np.ndarray, kept: np.ndarray, start_time: np.ndarray | None = None
    ) -> EventStreamBatch:
        """Host collation with the crop starts drawn: ``(B, L)`` and ``(B, L,
        M)`` gathers over the CSR arrays, JAX's ``_collate_with_starts``."""
        d = self.data
        subject_indices = np.asarray(subject_indices)
        B, L, M, S = len(subject_indices), self.max_seq_len, self.max_n_dynamic, self.max_n_static
        ev_lo = d.subject_event_offsets[subject_indices]

        pos = np.arange(L, dtype=np.int32)[None, :]
        if self.seq_padding_side == SeqPaddingSide.RIGHT:
            event_ids = ev_lo[:, None] + starts[:, None] + pos
            event_mask = pos < kept[:, None]
        else:
            pad = (L - kept)[:, None]
            event_ids = ev_lo[:, None] + starts[:, None] + (pos - pad)
            event_mask = pos >= pad
        event_ids = np.where(event_mask, event_ids, 0)
        time_delta = np.where(event_mask, d.time_delta[event_ids], 0.0).astype(np.float32)

        data_lo = d.event_data_offsets[event_ids]
        data_n = d.event_data_offsets[event_ids + 1] - data_lo
        mpos = np.arange(M, dtype=np.int32)[None, None, :]
        data_ids = data_lo[..., None] + mpos
        data_valid = (mpos < data_n[..., None]) & event_mask[..., None]
        data_ids = np.where(data_valid, data_ids, 0)
        values_mask = data_valid & d.dynamic_values_observed[data_ids]
        batch = dict(
            event_mask=event_mask,
            time_delta=time_delta,
            dynamic_indices=np.where(data_valid, d.dynamic_indices[data_ids], 0),
            dynamic_measurement_indices=np.where(data_valid, d.dynamic_measurement_indices[data_ids], 0),
            dynamic_values=np.where(values_mask, d.dynamic_values[data_ids], 0.0),
            dynamic_values_mask=values_mask,
        )
        if self.do_produce_static_data:
            st_lo = d.static_offsets[subject_indices]
            st_n = d.static_offsets[subject_indices + 1] - st_lo
            spos = np.arange(S)[None, :]
            st_valid = spos < st_n[:, None]
            st_ids = np.where(st_valid, st_lo[:, None] + spos, 0)
            batch["static_indices"] = np.where(st_valid, d.static_indices[st_ids], 0)
            batch["static_measurement_indices"] = np.where(st_valid, d.static_measurement_indices[st_ids], 0)
        if self.config.do_include_start_time_min:
            if start_time is None:
                prior = np.zeros(B, dtype=np.float64)
                for b, (lo, s) in enumerate(zip(ev_lo, starts)):
                    prior[b] = d.time_delta[lo : lo + s].sum()
                start_time = (d.start_time_min[subject_indices] + prior).astype(np.float32)
            batch["start_time"] = start_time
        if self.config.do_include_subsequence_indices:
            batch["start_idx"] = starts
            batch["end_idx"] = starts + kept
        if self.config.do_include_subject_id:
            batch["subject_id"] = np.asarray([self.subject_ids[i] for i in subject_indices], dtype=np.int64)
        return _to_batch(batch, self.labels_of(subject_indices))

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int | None = None,
        drop_last: bool | None = None,
        skip_batches: int = 0,
        n_shards: int = 1,
    ):
        """Host-collated batches of `plan_batches`' stream (CPU tensors).

        Fill rows of a last short batch (``drop_last=False``, the default
        when not shuffling) are blanked: ``event_mask`` and
        ``dynamic_values_mask`` all False, ``valid_mask`` False.
        ``skip_batches`` advances the stream without collating, so batch
        N+1 on equals the uninterrupted epoch's."""
        for plan in self.plan_batches(
            batch_size, shuffle=shuffle, seed=seed, drop_last=drop_last, skip_batches=skip_batches, n_shards=n_shards
        ):
            b = self._collate_with_starts(plan.subject_indices, plan.starts, plan.kept, start_time=plan.start_time)
            valid = torch.from_numpy(plan.valid_mask)
            if not plan.valid_mask.all():
                b = b.replace(
                    event_mask=b.event_mask & valid[:, None],
                    dynamic_values_mask=b.dynamic_values_mask & valid[:, None, None],
                )
            yield b.replace(valid_mask=valid)

    def __getitem__(self, idx: int, seed: int | None = None) -> dict:
        """One subject as ragged lists (the reference ``__getitem__``): the
        crop start drawn from numpy's global generator, reseeded from
        ``seed`` (None: fresh entropy), as JAX's seeded ``__getitem__``."""
        np.random.seed(int(np.random.SeedSequence().entropy % (2**31)) if seed is None else seed)
        d = self.data
        rng = np.random.default_rng(np.random.randint(0, 2**31))
        ev_lo, ev_hi = int(d.subject_event_offsets[idx]), int(d.subject_event_offsets[idx + 1])
        seq_len = ev_hi - ev_lo
        start_idx = 0
        if seq_len > self.max_seq_len:
            strategy = self.config.subsequence_sampling_strategy
            if strategy == SubsequenceSamplingStrategy.RANDOM:
                start_idx = int(rng.integers(0, seq_len - self.max_seq_len))
            elif strategy == SubsequenceSamplingStrategy.TO_END:
                start_idx = seq_len - self.max_seq_len
        end_idx = min(start_idx + self.max_seq_len, seq_len)
        events = np.arange(ev_lo + start_idx, ev_lo + end_idx)

        def sl(e):
            return slice(d.event_data_offsets[e], d.event_data_offsets[e + 1])

        out = {
            "time_delta": d.time_delta[events].tolist(),
            "dynamic_indices": [d.dynamic_indices[sl(e)].tolist() for e in events],
            "dynamic_measurement_indices": [d.dynamic_measurement_indices[sl(e)].tolist() for e in events],
            "dynamic_values": [
                np.where(d.dynamic_values_observed[sl(e)], d.dynamic_values[sl(e)], np.nan).tolist() for e in events
            ],
        }
        if self.do_produce_static_data:
            st = slice(d.static_offsets[idx], d.static_offsets[idx + 1])
            out["static_indices"] = d.static_indices[st].tolist()
            out["static_measurement_indices"] = d.static_measurement_indices[st].tolist()
        if self.config.do_include_subject_id:
            out["subject_id"] = self.subject_ids[idx]
        if self.config.do_include_start_time_min:
            out["start_time"] = float(d.start_time_min[idx] + d.time_delta[ev_lo : ev_lo + start_idx].sum())
        if self.config.do_include_subsequence_indices:
            out["start_idx"] = start_idx
            out["end_idx"] = end_idx
        if self.has_task:
            for t in self.tasks:
                out[t] = self.stream_labels[t][idx]
        return out

    def collate(self, batch: list[dict]) -> EventStreamBatch:
        """Collates `__getitem__` dicts into the static shapes of `batches`."""
        B = len(batch)
        L, M, S = self.max_seq_len, self.max_n_dynamic, self.max_n_static
        event_mask = np.zeros((B, L), dtype=bool)
        time_delta = np.zeros((B, L), dtype=np.float32)
        dynamic_indices = np.zeros((B, L, M), dtype=np.int64)
        dynamic_meas = np.zeros((B, L, M), dtype=np.int64)
        dynamic_values = np.zeros((B, L, M), dtype=np.float32)
        values_mask = np.zeros((B, L, M), dtype=bool)
        for b, e in enumerate(batch):
            n = len(e["time_delta"])
            offset = 0 if self.seq_padding_side == SeqPaddingSide.RIGHT else L - n
            event_mask[b, offset : offset + n] = True
            time_delta[b, offset : offset + n] = e["time_delta"]
            for j in range(n):
                row_i = e["dynamic_indices"][j] or []
                k = len(row_i)
                dynamic_indices[b, offset + j, :k] = row_i
                dynamic_meas[b, offset + j, :k] = e["dynamic_measurement_indices"][j] or []
                vals = np.asarray([np.nan if v is None else v for v in e["dynamic_values"][j] or []], np.float32)
                dynamic_values[b, offset + j, :k] = np.nan_to_num(vals, nan=0.0)
                values_mask[b, offset + j, :k] = ~np.isnan(vals)
        out = dict(
            event_mask=event_mask,
            time_delta=time_delta,
            dynamic_indices=dynamic_indices,
            dynamic_measurement_indices=dynamic_meas,
            dynamic_values=dynamic_values,
            dynamic_values_mask=values_mask,
        )
        if self.do_produce_static_data:
            out["static_indices"] = np.zeros((B, S), dtype=np.int64)
            out["static_measurement_indices"] = np.zeros((B, S), dtype=np.int64)
            for b, e in enumerate(batch):
                k = len(e["static_indices"])
                out["static_indices"][b, :k] = e["static_indices"]
                out["static_measurement_indices"][b, :k] = e["static_measurement_indices"]
        if self.config.do_include_start_time_min:
            out["start_time"] = np.asarray([e["start_time"] for e in batch], dtype=np.float32)
        if self.config.do_include_subsequence_indices:
            out["start_idx"] = np.asarray([e["start_idx"] for e in batch], dtype=np.int64)
            out["end_idx"] = np.asarray([e["end_idx"] for e in batch], dtype=np.int64)
        if self.config.do_include_subject_id:
            out["subject_id"] = np.asarray([e["subject_id"] for e in batch], dtype=np.int64)
        labels = None
        if self.has_task:
            labels = {
                t: np.asarray([e[t] for e in batch],
                              dtype=np.int64 if self.task_types[t] == "multi_class_classification" else np.float32)
                for t in self.tasks
            }  # fmt: skip
        return _to_batch(out, labels)

    # ------------------------------------------------------------- packing
    def packed_rows_dealt(
        self, batch_size: int, seq_len: int | None = None, shuffle: bool = True, seed: int | None = None,
        n_shards: int = 1,
    ) -> list:  # fmt: skip
        """The epoch's packed rows in batch order (`packed_rows_dealt`)."""
        return packed_rows_dealt(
            self.data, batch_size, seq_len or self.max_seq_len, shuffle=shuffle, seed=seed,
            strategy=self.config.subsequence_sampling_strategy, n_shards=n_shards,
        )  # fmt: skip

    def packed_row_plan(self, rows_chunk: list, L: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        return packed_row_plan(self.data, rows_chunk, L)

    def packed_batch_count(
        self, batch_size: int, seq_len: int | None = None, shuffle: bool = True, seed: int | None = None,
        n_shards: int = 1,
    ) -> int:  # fmt: skip
        """The number of full batches `packed_batches` yields (packing only)."""
        return len(self.packed_rows_dealt(batch_size, seq_len, shuffle=shuffle, seed=seed, n_shards=n_shards)) // batch_size

    def packed_batches(
        self, batch_size: int, seq_len: int | None = None, shuffle: bool = True, seed: int | None = None,
        n_shards: int = 1,
    ):  # fmt: skip
        """Packed ``(B, seq_len)`` batches (`packed_batches`), the last possibly short."""
        if n_shards != 1:
            raise ValueError(f"packing for n_shards > 1 is not part of the PyTorch port yet ({SHARDED_FEEDS})")
        return packed_batches(
            self.data, batch_size, seq_len or self.max_seq_len, shuffle=shuffle, seed=seed,
            strategy=self.config.subsequence_sampling_strategy, max_n_dynamic=self.max_n_dynamic,
        )  # fmt: skip


def _to_batch(fields: dict, stream_labels: dict | None = None) -> EventStreamBatch:
    batch = EventStreamBatch(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fields.items()})
    if stream_labels is not None:
        batch = batch.replace(stream_labels={k: torch.from_numpy(v) for k, v in stream_labels.items()})
    return batch


def pack_rows(csr: CSRData, L: int, rng: np.random.Generator, order: np.ndarray, strategy) -> list:
    """First-fit packs subject (sub)sequences into rows of ``L`` events.

    Returns ``[(subject, start, n_events), ...]`` per row. Deterministic given
    the rng state and order. The open rows are bounded: a row closes once it
    cannot fit the smallest subject, or when more than 64 are open.
    """
    d = csr
    strategy = SubsequenceSamplingStrategy(strategy)
    min_len = int(
        min(
            (min(int(d.subject_event_offsets[s + 1] - d.subject_event_offsets[s]), L) for s in order),
            default=1,
        )
    )
    rows: list[list[tuple[int, int, int]]] = []  # [(subject, start, n_events)]
    row_fill: list[int] = []
    open_rows: list[int] = []
    for subj in order:
        lo, hi = d.subject_event_offsets[subj], d.subject_event_offsets[subj + 1]
        n_ev = int(hi - lo)
        start = 0
        if n_ev > L:
            if strategy == SubsequenceSamplingStrategy.RANDOM:
                start = int(rng.integers(0, n_ev - L + 1))
            elif strategy == SubsequenceSamplingStrategy.TO_END:
                start = n_ev - L
            n_ev = L
        placed = False
        for r in open_rows:
            if row_fill[r] + n_ev <= L:
                rows[r].append((int(subj), start, n_ev))
                row_fill[r] += n_ev
                placed = True
                break
        if not placed:
            rows.append([(int(subj), start, n_ev)])
            row_fill.append(n_ev)
            open_rows.append(len(rows) - 1)
        open_rows = [r for r in open_rows if row_fill[r] + min_len <= L]
        if len(open_rows) > MAX_OPEN_ROWS:
            open_rows = open_rows[-MAX_OPEN_ROWS:]
    return rows


def packed_rows_dealt(
    csr: CSRData,
    batch_size: int,
    seq_len: int,
    shuffle: bool = True,
    seed: int | None = None,
    strategy=SubsequenceSamplingStrategy.RANDOM,
    n_shards: int = 1,
) -> list:
    """The epoch's packed rows in batch order: one permutation of the
    subjects (when ``shuffle``), then one `pack_rows` pass on the same
    generator. The trailing short batch, if any, is left to the caller."""
    if n_shards != 1:
        raise ValueError(f"packing for n_shards > 1 is not part of the PyTorch port yet ({SHARDED_FEEDS})")
    rng = np.random.default_rng(seed)
    n = csr.n_subjects
    order = rng.permutation(n) if shuffle else np.arange(n)
    return pack_rows(csr, seq_len, rng, order, strategy)


def packed_row_plan(csr: CSRData, rows_chunk: list, L: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Materialises packed rows into a ``(B, L)`` event-id and segment plan.

    Trailing padding shares the row's last segment id, so it never creates a
    phantom segment boundary. Returns ``(event_ids, segment_ids, event_mask, n_events)``.
    """
    d = csr
    B = len(rows_chunk)
    event_ids = np.zeros((B, L), dtype=np.int64)
    seg = np.zeros((B, L), dtype=np.int64)
    mask = np.zeros((B, L), dtype=bool)
    n_events = 0
    for b, placements in enumerate(rows_chunk):
        pos = 0
        for s_idx, (subj, start, n_ev) in enumerate(placements):
            lo = d.subject_event_offsets[subj] + start
            event_ids[b, pos : pos + n_ev] = np.arange(lo, lo + n_ev)
            seg[b, pos : pos + n_ev] = s_idx
            mask[b, pos : pos + n_ev] = True
            pos += n_ev
        if placements and pos < L:
            seg[b, pos:] = seg[b, pos - 1]
        n_events += pos
    return event_ids, seg, mask, n_events


def packed_batches(
    csr: CSRData,
    batch_size: int,
    seq_len: int,
    shuffle: bool = True,
    seed: int | None = None,
    strategy=SubsequenceSamplingStrategy.RANDOM,
    max_n_dynamic: int | None = None,
):
    """Yields packed ``(B, seq_len)`` batches with per-event ``segment_ids``
    (CPU tensors), ``max_n_dynamic`` data elements an event (default: the
    widest event's count), the last batch possibly short."""
    L = seq_len
    M = max_n_dynamic or csr.max_n_dynamic
    d = csr
    rows = packed_rows_dealt(csr, batch_size, seq_len=L, shuffle=shuffle, seed=seed, strategy=strategy)

    for lo_idx in range(0, len(rows), batch_size):
        chunk = rows[lo_idx : lo_idx + batch_size]
        B = len(chunk)
        event_ids, segment_ids, event_mask, _ = packed_row_plan(csr, chunk, L)

        time_delta = np.where(event_mask, d.time_delta[event_ids], 0.0).astype(np.float32)

        data_lo = d.event_data_offsets[event_ids]
        data_n = d.event_data_offsets[event_ids + 1] - data_lo
        mpos = np.arange(M, dtype=np.int32)[None, None, :]
        data_ids = data_lo[..., None] + mpos
        data_valid = (mpos < data_n[..., None]) & event_mask[..., None]
        data_ids = np.where(data_valid, data_ids, 0)

        dynamic_indices = np.where(data_valid, d.dynamic_indices[data_ids], 0)
        dynamic_meas = np.where(data_valid, d.dynamic_measurement_indices[data_ids], 0)
        values_mask = data_valid & d.dynamic_values_observed[data_ids]
        dynamic_values = np.where(values_mask, d.dynamic_values[data_ids], 0.0)

        yield EventStreamBatch(
            event_mask=torch.from_numpy(event_mask),
            time_delta=torch.from_numpy(time_delta),
            dynamic_indices=torch.from_numpy(dynamic_indices),
            dynamic_measurement_indices=torch.from_numpy(dynamic_meas),
            dynamic_values=torch.from_numpy(dynamic_values),
            dynamic_values_mask=torch.from_numpy(values_mask),
            segment_ids=torch.from_numpy(segment_ids),
            valid_mask=torch.from_numpy(np.ones(B, dtype=bool)),
        )


# ------------------------------------------------------------------ the reader
_MINUTE_NS = 60_000_000_000


def minutes_to_ns(minutes: np.ndarray) -> np.ndarray:
    """Float minutes as int64 nanoseconds, as ``pd.to_timedelta(x, unit="m")``
    converts them: the whole minutes and the fraction (rounded to 10 decimal
    places) multiplied separately, the fraction's product truncated."""
    minutes = np.asarray(minutes, np.float64)
    base = minutes.astype(np.int64)
    frac = np.round(minutes - base, 10)
    return base * _MINUTE_NS + (frac * _MINUTE_NS).astype(np.int64)


def ns_to_minutes(ns: np.ndarray) -> np.ndarray:
    """Minutes since the epoch of int64 nanosecond times, as pandas'
    ``Timestamp.timestamp() / 60`` gives them: the exact quotient of the
    nanoseconds by 1e9, correctly rounded, then rounded to 6 places."""
    return np.asarray([round(int(t) / 10**9, 6) / 60.0 for t in np.asarray(ns)], dtype=np.float64)


def _time_deltas(reps: DLReps) -> DLReps:
    """``time`` (absolute minutes) to ``time_delta`` (minutes to the next
    event, the last filled with 1), ``start_time`` advanced to the first
    event: JAX's ``_to_time_deltas``. A cache with ``time_delta`` already is
    left as it is."""
    if "time_delta" in reps.lists:
        return reps
    t = reps.lists["time"]
    times = np.asarray(t.values, np.float64)
    off = t.offsets.astype(np.int64)
    deltas = np.empty(len(times), np.float32)
    deltas[:-1] = (times[1:] - times[:-1]).astype(np.float32)
    lens = np.diff(off)
    deltas[off[1:][lens > 0] - 1] = 1.0
    lists = {k: v for k, v in reps.lists.items() if k != "time"}
    lists["time_delta"] = RaggedColumn(deltas, off)
    scalars = dict(reps.scalars)
    if "start_time" in scalars:
        first = np.zeros(len(lens), np.float64)
        first[lens > 0] = times[off[:-1][lens > 0]]
        scalars["start_time"] = scalars["start_time"].astype(np.int64) + minutes_to_ns(first)
    return DLReps(scalars, lists)


def _per_row(col: RaggedColumn, fn) -> np.ndarray:
    """``fn`` of each row's values (a row of a list column)."""
    return np.asarray([fn(col.values[col.offsets[i] : col.offsets[i + 1]]) for i in range(len(col.offsets) - 1)])


def _flatten(reps: DLReps, do_static: bool) -> CSRData:
    """A split's rows as `CSRData` (JAX's ``_flatten``): event counts from
    ``time_delta``, data elements from ``dynamic_indices`` (integers
    truncated from the cache's floats), values with nulls and NaN as
    unobserved, a null value list read as all unobserved."""
    td = reps.lists["time_delta"]
    n_subjects = len(td.offsets) - 1
    di = reps.lists["dynamic_indices"]
    dm = reps.lists["dynamic_measurement_indices"]
    dv = reps.lists["dynamic_values"]
    counts = np.diff(di.offsets2.astype(np.int64))
    event_data_offsets = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=event_data_offsets[1:])
    raw = np.full(int(event_data_offsets[-1]), np.nan, np.float32)
    live = np.ones(len(counts), bool) if dv.nulls2 is None else ~dv.nulls2
    v_off = dv.offsets2.astype(np.int64)
    if not np.array_equal(np.diff(v_off)[live], counts[live]):
        raise ValueError("dynamic_values and dynamic_indices differ in length inside an event")
    dst = concat_ranges(event_data_offsets[:-1][live], event_data_offsets[1:][live])
    raw[dst] = np.asarray(dv.values, np.float64)[concat_ranges(v_off[:-1][live], v_off[1:][live])].astype(np.float32)
    observed = ~np.isnan(raw)

    if do_static:
        st_i, st_m = reps.lists["static_indices"], reps.lists["static_measurement_indices"]
        static_offsets = st_i.offsets.astype(np.int64)
        static_indices, static_meas = st_i.values.astype(np.int64), st_m.values.astype(np.int64)
    else:
        static_offsets = np.zeros(n_subjects + 1, np.int64)
        static_indices = static_meas = np.zeros(0, np.int64)
    if "start_time" in reps.scalars:
        start_time_min = ns_to_minutes(reps.scalars["start_time"])
    else:
        start_time_min = np.zeros(n_subjects, np.float64)
    return CSRData(
        subject_event_offsets=td.offsets.astype(np.int64),
        time_delta=np.asarray(td.values, np.float32),
        event_data_offsets=event_data_offsets,
        dynamic_indices=np.asarray(di.values).astype(np.int64),
        dynamic_measurement_indices=np.asarray(dm.values).astype(np.int64),
        dynamic_values=np.where(observed, raw, 0.0).astype(np.float32),
        dynamic_values_observed=observed,
        static_offsets=static_offsets,
        static_indices=static_indices,
        static_measurement_indices=static_meas,
        start_time_min=start_time_min,
    )


class TorchDataset(CSRDataset):
    """The dataset of one split of a converted DL cache (JAX's ``JaxDataset``).

    Reads ``config.save_dir``: ``vocabulary_config.json``,
    ``inferred_measurement_configs.json`` (``measurement_configs`` keeps the
    measurements that are not dropped) and ``DL_reps/{split}_{k}.npz``
    (`data.dl_cache`). Then, in JAX's order: times become deltas (the last
    filled with 1, ``start_time`` advanced to the first event), subjects
    with fewer than ``min_seq_len`` events go, the log inter-event-time
    statistics are taken over every real delta (a subject's last is the
    filler), subjects with a delta <= 0 are quarantined (written to
    ``save_dir/malformed_data_{split}.npz`` in the converted format and
    dropped), and on the train split ``train_subset_size`` subjects are
    drawn as ``DataFrame.sample(n, random_state=train_subset_seed)`` draws
    them. The result is the `CSRDataset` of those subjects, in that order.

    With ``config.task_df_name`` the rows are task windows
    (`_load_task_data`): each row of ``task_dfs/{name}.npz`` whose subject
    the split holds, its events restricted to the window, its labels kept as
    ``stream_labels`` (``tasks``, ``task_types``, ``task_vocabs``, as JAX's).
    """

    @staticmethod
    def normalize_task(col: np.ndarray) -> tuple[str, np.ndarray, list | None]:
        """A label column's task type, normalized labels and vocabulary (JAX's
        ``normalize_task`` on a numpy column): booleans are a binary task
        (float32 labels), integers multi-class over ``0..max``, floats a
        regression, strings multi-class over their sorted distinct values."""
        col = np.asarray(col)
        if col.dtype == bool:
            return "binary_classification", col.astype(np.float32), [False, True]
        if np.issubdtype(col.dtype, np.integer):
            return "multi_class_classification", col, list(range(int(col.max()) + 1))
        if np.issubdtype(col.dtype, np.floating):
            return "regression", col, None
        if col.dtype.kind in "UO":
            vocab = sorted({v for v in col.tolist() if v is not None})
            mapping = {v: i for i, v in enumerate(vocab)}
            return "multi_class_classification", np.asarray([mapping[v] for v in col.tolist()], np.int64), vocab
        raise TypeError(f"Can't process label of {col.dtype} type!")

    def _load_task_data(self, save_dir: Path, task_df_name: str, split: str) -> DLReps:
        """The split's task windows (JAX's ``_load_task_data``): the task
        dataframe's labels normalized, then each of the split's chunks
        restricted to its task rows (`_build_task_reps`), the chunks in the
        lexicographic order JAX's task cache lists them."""
        task = read_task_df(save_dir, task_df_name)
        self.tasks = sorted(c for c in task if c not in _TASK_KEYS)
        self.task_types, self.task_vocabs = {}, {}
        for t in self.tasks:
            task_type, task[t], vocab = self.normalize_task(task[t])
            self.task_types[t] = task_type
            if vocab is not None:
                self.task_vocabs[t] = vocab
        files = sorted((save_dir / "DL_reps").glob(f"{split}*.npz"))
        if not files:
            raise FileNotFoundError(f"No converted DL_reps chunks for split {split} in {save_dir / 'DL_reps'}")
        return concat_dl_reps([self._build_task_reps(task, self.tasks, read_dl_reps(fp)) for fp in files])

    @staticmethod
    def _build_task_reps(task: dict, tasks: list, cached: DLReps) -> DLReps:
        """One chunk's rows restricted to the task windows (JAX's
        ``_build_task_cached_df``): for each task row whose subject the chunk
        holds, in the task's order, the subject's events with times (minutes
        from its start) in ``[start, end]`` by ``searchsorted``, times shifted
        to start at 0, ``start_time`` advanced to the first (pandas'
        ``Timestamp + Timedelta(minutes=t)``: ``int(t * 60 * 1e9)`` ns), the
        static lists copied and the labels kept; empty windows dropped."""
        sids = cached.scalars["subject_id"]
        pos = {int(sid): i for i, sid in enumerate(sids.tolist())}
        task_rows = np.asarray([i for i, sid in enumerate(task["subject_id"].tolist()) if int(sid) in pos], np.int64)
        rows = np.asarray([pos[int(task["subject_id"][i])] for i in task_rows], np.int64)
        base_start = cached.scalars["start_time"][rows].astype(np.int64)
        start_min = (task["start_time"][task_rows].astype(np.int64) - base_start).astype(np.float64) / 60e9
        end_min = (task["end_time"][task_rows].astype(np.int64) - base_start).astype(np.float64) / 60e9
        times = cached.lists["time"]
        t_off = times.offsets.astype(np.int64)
        t_vals = np.asarray(times.values, np.float64)
        keep, lo, hi = [], [], []
        for i, (r, a, b) in enumerate(zip(rows, start_min, end_min)):
            t = t_vals[t_off[r] : t_off[r + 1]]
            w_lo, w_hi = int(np.searchsorted(t, a, side="left")), int(np.searchsorted(t, b, side="right"))
            if w_hi > w_lo:
                keep.append(i)
                lo.append(w_lo)
                hi.append(w_hi)
        keep, lo, hi = (np.asarray(x, np.int64) for x in (keep, lo, hi))
        rows, task_rows = rows[keep], task_rows[keep]
        first = t_vals[t_off[rows] + lo] if len(rows) else np.zeros(0)
        scalars = {
            "subject_id": task["subject_id"][task_rows],
            "start_time": base_start[keep] + (first * 60 * 1e9).astype(np.int64),
            **{t: task[t][task_rows] for t in tasks},
        }
        lists = {}
        for name, col in cached.lists.items():
            if name == "time":
                sliced = col.slice_rows(rows, lo, hi)
                lists[name] = RaggedColumn(
                    np.asarray(sliced.values, np.float64) - np.repeat(first, hi - lo), sliced.offsets
                )
            elif name.startswith("static_"):
                lists[name] = col.take(rows)
            else:
                lists[name] = col.slice_rows(rows, lo, hi)
        return DLReps(scalars, lists)

    def __init__(self, config: PytorchDatasetConfig, split: str):
        self.split = split
        save_dir = Path(config.save_dir)
        self.vocabulary_config = VocabularyConfig.from_json_file(save_dir / "vocabulary_config.json")
        with open(save_dir / "inferred_measurement_configs.json") as f:
            inferred = {k: MeasurementConfig.from_dict(v, base_dir=save_dir) for k, v in json.load(f).items()}
        self.measurement_configs = {k: v for k, v in inferred.items() if not v.is_dropped}
        self.tasks = self.task_vocabs = None
        self.task_types: dict = {}

        if config.task_df_name is not None:
            reps = self._load_task_data(save_dir, config.task_df_name, split)
        else:
            reps = read_dl_cache(save_dir, split)
        reps = _time_deltas(reps)
        do_static = "static_indices" in reps.lists
        lens = np.diff(reps.lists["time_delta"].offsets.astype(np.int64))
        reps = reps.take(np.flatnonzero(lens >= config.min_seq_len))

        td = reps.lists["time_delta"]
        real = self._real_deltas(td)
        min_delta = float(real.min()) if len(real) else 1.0
        if min_delta <= 0:
            bad = _per_row(td, lambda r: len(r) > 1 and float(np.min(r[:-1])) <= 0).astype(bool)
            ids = reps.scalars["subject_id"][bad] if "subject_id" in reps.scalars else np.flatnonzero(bad)
            print(
                f"WARNING: Observed inter-event times <= 0 for {int(bad.sum())} subjects!\n"
                f"ESD Subject IDs: {', '.join(str(x) for x in ids.tolist())}\n"
                f"Global min: {min_delta}"
            )
            fp = save_dir / f"malformed_data_{split}.npz"
            write_dl_reps(fp, reps.take(np.flatnonzero(bad)))
            print(f"Wrote malformed data records to {fp}")
            print("Removing malformed subjects")
            reps = reps.take(np.flatnonzero(~bad))
            real = self._real_deltas(reps.lists["time_delta"])
        with np.errstate(divide="ignore", invalid="ignore"):
            logs = np.log(real[real > 0])
        self.mean_log_inter_event_time_min = float(logs.mean()) if len(logs) else 0.0
        self.std_log_inter_event_time_min = float(logs.std(ddof=1)) if len(logs) > 1 else 1.0

        size = config.train_subset_size
        if size not in (None, "FULL") and split == "train":
            n_rows = reps.n_rows
            if isinstance(size, int) and size > 0:
                n = min(size, n_rows)
            elif isinstance(size, float) and 0 < size < 1:
                n = int(round(size * n_rows))
            else:
                raise TypeError(f"Can't process subset size of {type(size)}, {size}")
            # DataFrame.sample(n, random_state=seed): RandomState(seed).choice without replacement.
            reps = reps.take(np.random.RandomState(config.train_subset_seed).choice(n_rows, size=n, replace=False))

        subject_ids = reps.scalars["subject_id"].tolist() if "subject_id" in reps.scalars else None
        tasks, task_types, task_vocabs = self.tasks, self.task_types, self.task_vocabs
        super().__init__(_flatten(reps, do_static), config, do_produce_static_data=do_static, subject_ids=subject_ids)
        if config.task_df_name is not None:
            self.has_task, self.tasks, self.task_types, self.task_vocabs = True, tasks, task_types, task_vocabs
            self.stream_labels = {t: np.asarray(reps.scalars[t]) for t in tasks}

    @staticmethod
    def _real_deltas(td: RaggedColumn) -> np.ndarray:
        """Every subject's deltas but its last (the filler), in order; ``[1.0]`` when there are none."""
        off = td.offsets.astype(np.int64)
        keep = np.ones(len(td.values), bool)
        lens = np.diff(off)
        keep[off[1:][lens > 0] - 1] = False
        real = np.asarray(td.values, np.float32)[keep]
        return real if len(real) else np.asarray([1.0])
