"""Packed long-context batches over flattened (CSR) event data.

Counterpart: the pandas-free half of ``eventstreamgpt_tpu/data/jax_dataset.py``:
the `_CSRData` layout and the packing of ``JaxDataset`` (``_pack_rows``,
``packed_rows_dealt``, ``packed_row_plan``, ``packed_batches``), step for step
and with the same random stream, as functions of a `CSRData`. Reading the
DL-cache parquet files into a `CSRData` is not ported (it needs pandas).

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

from ..utils.enums import SubsequenceSamplingStrategy
from .types import EventStreamBatch

__all__ = ["CSRData", "pack_rows", "packed_batches", "packed_row_plan", "packed_rows_dealt"]

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
        raise ValueError(
            "packing for n_shards > 1 is not part of the PyTorch port yet "
            "(ROADMAP Queue 1 item 7: multi-GPU data feeds)"
        )
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
