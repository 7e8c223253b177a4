"""The in-memory half of ``JaxDataset``: CSR event data, batch plans and packing.

Counterpart: the pandas-free half of ``eventstreamgpt_tpu/data/jax_dataset.py``:

* the `_CSRData` layout (`CSRData`) and a view of it with the settings the
  plan stream and the device collate read (`CSRDataset`, under
  ``JaxDataset``'s attribute names);
* the padded plan stream: `BatchPlan`, ``_draw_starts`` and
  ``plan_batches`` (subject order, subsequence crop starts and fill-row
  validity, with the same random stream);
* the packing of ``JaxDataset`` (``_pack_rows``, ``packed_rows_dealt``,
  ``packed_row_plan``, ``packed_batches``), step for step and with the same
  random stream, as functions of a `CSRData`.

Reading the DL-cache parquet files into a `CSRData`, host collation of
padded batches and task labels are not ported (they need pandas; ROADMAP
Queue 1 item 8): a `CSRData` comes from `data.synthetic.synthetic_csr` or
from a ``JaxDataset``'s ``data`` handed across as numpy arrays.

Packing first-fit places whole subject sequences into rows of ``seq_len``
events, with ``segment_ids`` marking where one subject ends and the next
begins; a subject longer than a row is cropped by the
`SubsequenceSamplingStrategy`. Packed batches carry no static data and no
stream labels, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.enums import SeqPaddingSide, SubsequenceSamplingStrategy
from .types import EventStreamBatch

__all__ = [
    "BatchPlan",
    "CSRData",
    "CSRDataset",
    "CSRDatasetConfig",
    "pack_rows",
    "packed_batches",
    "packed_row_plan",
    "packed_rows_dealt",
]

# Where multi-shard feeds wait (their ValueErrors name it).
SHARDED_FEEDS = "ROADMAP Queue 1 item 7: multi-GPU data feeds"

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


@dataclasses.dataclass(frozen=True)
class CSRDatasetConfig:
    """The settings of ``PytorchDatasetConfig`` that the plan stream and the
    collate read, under its names. ``max_n_dynamic`` / ``max_n_static``
    None: the data's widest event / subject."""

    max_seq_len: int = 256
    max_n_dynamic: int | None = None
    max_n_static: int | None = None
    seq_padding_side: SeqPaddingSide = SeqPaddingSide.RIGHT
    subsequence_sampling_strategy: SubsequenceSamplingStrategy = SubsequenceSamplingStrategy.RANDOM
    do_include_start_time_min: bool = False
    do_include_subsequence_indices: bool = False
    do_include_subject_id: bool = False

    def __post_init__(self):
        object.__setattr__(self, "seq_padding_side", SeqPaddingSide(self.seq_padding_side))
        strategy = SubsequenceSamplingStrategy(self.subsequence_sampling_strategy)
        object.__setattr__(self, "subsequence_sampling_strategy", strategy)


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
        config: the plan and collate settings.
        do_produce_static_data: whether batches carry static data (the JAX
            dataset's is whether its DL cache has a static column).
        subject_ids: each subject's id, for ``do_include_subject_id``
            (default: the subject's index).

    Examples:
        >>> import numpy as np
        >>> o = np.array([0, 3, 5])
        >>> csr = CSRData(o, np.ones(5, np.float32), np.arange(6), np.ones(5), np.ones(5), np.ones(5, np.float32),
        ...               np.ones(5, bool), np.zeros(3), np.zeros(0), np.zeros(0), np.zeros(2))
        >>> ds = CSRDataset(csr, CSRDatasetConfig(max_seq_len=2, subsequence_sampling_strategy="to_end"))
        >>> ds.data.subject_event_offsets.dtype, ds.max_n_dynamic, len(ds)
        (dtype('int32'), 1, 2)
        >>> [(p.subject_indices.tolist(), p.starts.tolist(), p.n_events) for p in ds.plan_batches(2, shuffle=False)]
        [([0, 1], [1, 0], 4)]
    """

    def __init__(
        self,
        data: CSRData,
        config: CSRDatasetConfig | None = None,
        *,
        do_produce_static_data: bool = True,
        subject_ids=None,
    ):
        self.config = config or CSRDatasetConfig()
        self.data = dataclasses.replace(data, **{k: _shrink(np.asarray(getattr(data, k))) for k in _INDEX_FIELDS})
        self.max_seq_len = int(self.config.max_seq_len)
        self.seq_padding_side = self.config.seq_padding_side
        self.do_produce_static_data = bool(do_produce_static_data)
        self.max_n_dynamic = self.config.max_n_dynamic or self.data.max_n_dynamic
        self.max_n_static = self.config.max_n_static or self.data.max_n_static
        self.subject_ids = list(range(self.data.n_subjects)) if subject_ids is None else list(subject_ids)
        self.has_task = False

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
