"""Device-resident dataset: dense per-event tables on the card, batches collated there.

Counterpart: ``eventstreamgpt_tpu/data/device_dataset.py`` (single-device,
replicated layout). `DeviceDataset` turns a `CSRDataset`'s CSR arrays into
dense per-event tables once, uploads them to one device, and from then on
rebuilds every batch on that device from a `BatchPlan`: subject indices,
crop starts and the fill-row validity mask, about 100 bytes. A train step's
host-to-device traffic is the plan, not the ~MB batch.

The collate is plain PyTorch index arithmetic: row gathers over the dense
tables (each padded row is a contiguous range of the event axis; each
packed position one row) with ``torch.where`` zeroing. It uses no
``nonzero``, no boolean-mask indexing, no ``.item()`` and no shape that
depends on the data, so a CUDA graph can capture it and replay it many
times (`training.pretrain.make_chunked_train_step` collates K batches
inside one graph). In the JAX package it is ``jnp`` gathers, not a Pallas
kernel, and here it stays PyTorch.

Light per-subject fields (``start_time``, subsequence bounds,
``subject_id``, ``stream_labels``, ``valid_mask``) stay on the host as CPU
tensors, computed from the plan, as the JAX collate leaves them host arrays.

Sharded tables over several devices (``data_shards > 1``, ``mesh``,
``context_parallel``) are not ported (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from functools import partial
from typing import Iterator

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.enums import SeqPaddingSide
from .torch_dataset import SHARDED_FEEDS, BatchPlan, CSRDataset, packed_row_plan, packed_rows_dealt
from .types import EventStreamBatch

__all__ = ["DeviceDataset", "packed_collate_kernel", "padded_collate_kernel"]

# Dense per-event tables held on the device, in kernel argument order.
_RESIDENT_FIELDS = (
    "subject_event_offsets",  # (n_subjects + 1,) int32
    "time_delta",  # (L + n_events + L,) float32, zero-padded both sides
    "dynamic_indices",  # (L + n_events + L, M) int32, 0 in empty slots
    "dynamic_measurement_indices",  # same layout
    "dynamic_values",  # same layout, float32, 0 where unobserved
    "dynamic_values_obs",  # same layout, bool: slot filled AND observed
    "static_indices",  # (n_subjects, S) int32, 0 in empty slots
    "static_measurement_indices",  # (n_subjects, S) int32
)


def padded_collate_kernel(
    arrays: dict, subject_indices, starts, valid, *, L: int, M: int, S: int, pad_right: bool, do_static: bool
) -> dict:
    """The padded batch of a plan, from the dense tables.

    Every padded row is a contiguous range of the event axis (``ev_lo +
    start + pos``), so the collate is one row gather a table at ``(B, L)``
    row indices. The tables carry ``L`` zero rows on both ends, so slice
    starts stay in range for left padding (a start can reach ``ev_lo - L``)
    and slice ends for short subjects (an overrun reads zeros, which the
    event mask zeroes anyway). ``valid`` blanks only the two masks: a fill
    row's payload stays in place, as the host collation leaves it.
    """
    offsets = arrays["subject_event_offsets"]
    ev_lo = offsets[subject_indices]
    seq_lens = offsets[subject_indices + 1] - ev_lo
    kept = torch.clamp(seq_lens, max=L)

    pos = torch.arange(L, dtype=torch.int32, device=offsets.device)[None, :]
    if pad_right:
        event_mask = pos < kept[:, None]
        slice_starts = L + ev_lo + starts
    else:
        pad = L - kept
        event_mask = pos >= pad[:, None]
        slice_starts = L + ev_lo + starts - pad
    out = _slice_event_payload(arrays, slice_starts[:, None] + pos, event_mask)
    out["event_mask"] = event_mask & valid[:, None]
    out["dynamic_values_mask"] = out["dynamic_values_mask"] & valid[:, None, None]

    if do_static:
        # (B, S) row gathers over the small per-subject tables.
        out["static_indices"] = arrays["static_indices"][subject_indices]
        out["static_measurement_indices"] = arrays["static_measurement_indices"][subject_indices]
    return out


def _gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` for a ``(B, L)`` plane of row indices: one row gather."""
    return table.index_select(0, rows.reshape(-1)).view(*rows.shape, *table.shape[1:])


def _slice_event_payload(arrays: dict, rows, event_mask) -> dict:
    """The event tables' rows at ``rows``, with the host path's masking."""
    names = ("time_delta", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values", "dynamic_values_obs")
    td, di, dm, dv, dobs = (_gather_rows(arrays[k], rows) for k in names)
    return _mask_event_payload(td, di, dm, dv, dobs, event_mask)


def _mask_event_payload(td, di, dm, dv, dobs, event_mask) -> dict:
    """The host path's zeroing: positions outside the event mask are zero in
    every payload field (empty slots inside real events are zero in the
    dense tables already)."""
    m3 = event_mask[..., None]
    return {
        "time_delta": torch.where(event_mask, td, 0.0),
        "dynamic_indices": torch.where(m3, di, 0),
        "dynamic_measurement_indices": torch.where(m3, dm, 0),
        "dynamic_values": torch.where(m3, dv, 0.0),
        "dynamic_values_mask": dobs & m3,
    }


def packed_collate_kernel(arrays: dict, event_ids, event_mask, *, L_PAD: int, M: int) -> dict:
    """The payload of packed rows, from the dense tables.

    A packed row interleaves several subjects, so each ``(b, l)`` position
    gathers one ``M``-wide row of the tables. ``L_PAD`` is the tables'
    front zero-pad (the dataset's ``max_seq_len``); masked positions carry
    event id 0, which lands on a real row after the offset and is zeroed by
    the mask, as on the host.
    """
    out = _slice_event_payload(arrays, event_ids + L_PAD, event_mask)
    out["event_mask"] = event_mask
    return out


def _dense_pre_sliced(src, rows, cols, keep, n_rows: int, M: int, dtype) -> np.ndarray:
    """Dense-table scatter for a source array already sliced to the range."""
    t = np.zeros((n_rows, M), dtype)
    t[rows, cols] = np.asarray(src)[keep]
    return t


class DeviceDataset:
    """A `CSRDataset`'s dense tables held on one device, with collation there.

    Args:
        dataset: the host dataset to mirror. Its CSR index arrays must be
            int32 (`CSRDataset` narrows them whenever the values fit).
        device: ``None`` (the CUDA device, raising without one) or an
            explicit device such as ``"cpu"``; the tables are uploaded there
            once.
        mesh, context_parallel, data_shards: the JAX dataset's multi-device
            layouts; anything but their single-device values raises.
    """

    def __init__(
        self, dataset: CSRDataset, device=None, mesh=None, context_parallel: bool = False, data_shards: int = 1
    ):
        if mesh is not None or context_parallel or int(data_shards) != 1:
            raise ValueError(
                "DeviceDataset's mesh, context-parallel and sharded (data_shards > 1) layouts are not part of "
                f"the PyTorch port yet ({SHARDED_FEEDS})"
            )
        self.dataset = dataset
        self.device = resolve_device(device, "DeviceDataset")
        self.data_shards = 1
        d = dataset.data
        for name in ("subject_event_offsets", "event_data_offsets", "dynamic_indices"):
            if getattr(d, name).dtype == np.int64:
                raise ValueError(
                    f"CSRDataset.data.{name} did not narrow to int32 (>2^31 elements); such a cohort cannot be "
                    "device-resident."
                )
        # One host-side finiteness pass over the CSR arrays (values are
        # stored observed-masked, so any non-finite value is an observed one):
        # resident batches skip per-batch NaN checks on the strength of it.
        if not np.isfinite(d.time_delta).all():
            raise ValueError(
                "non-finite time_delta in the DL cache; refusing to build device-resident tables (resident "
                "batches skip per-batch NaN validation on the strength of this check)."
            )
        if not np.isfinite(d.dynamic_values).all():
            raise ValueError(
                "non-finite observed dynamic_values in the DL cache; refusing to build device-resident tables "
                "(resident batches skip per-batch NaN validation on the strength of this check)."
            )
        host = self._dense_tables_for_subjects(0, d.n_subjects)
        self.nbytes = sum(a.nbytes for a in host.values())
        self.arrays = {k: torch.from_numpy(host[k]).to(self.device) for k in _RESIDENT_FIELDS}

    # The auto-residency budget of `try_create`: a tenth of an H100's 80 GB,
    # leaving the rest to the parameters, the optimizer state and the
    # activations. (JAX's 2 GiB is its figure for a 16 GB TPU chip.)
    DEFAULT_BUDGET_BYTES = 8 * 1024**3

    @classmethod
    def try_create(cls, dataset: CSRDataset, device=None, max_bytes: int | None = None) -> "DeviceDataset | None":
        """A `DeviceDataset` when residency is eligible, else None: the
        estimated tables within ``max_bytes`` (default
        `DEFAULT_BUDGET_BYTES`), the CSR arrays narrowed to int32, the values
        finite. Callers fall back to host collation on None."""
        if cls.estimate_nbytes(dataset) > (max_bytes or cls.DEFAULT_BUDGET_BYTES):
            return None
        try:
            return cls(dataset, device=device)
        except ValueError:
            return None

    @staticmethod
    def estimate_nbytes(dataset: CSRDataset) -> int:
        """The tables' device footprint, without building anything."""
        n_rows = len(dataset.data.time_delta) + 2 * dataset.max_seq_len
        per_row = 4 + dataset.max_n_dynamic * (4 + 4 + 4 + 1)
        static = 2 * 4 * dataset.max_n_static * max(dataset.data.n_subjects, 1)
        return n_rows * per_row + static + dataset.data.subject_event_offsets.nbytes

    def _dense_tables_for_subjects(self, s_lo: int, s_hi: int) -> dict:
        """Dense tables (numpy) for the subjects ``[s_lo, s_hi)``, with every
        offset local to the range (event row 0 is the range's first event)."""
        ds = self.dataset
        d = ds.data
        L = ds.max_seq_len
        M = ds.max_n_dynamic
        ev_lo = int(d.subject_event_offsets[s_lo])
        ev_hi = int(d.subject_event_offsets[s_hi])
        n_events = ev_hi - ev_lo
        n_rows = n_events + 2 * L

        off = np.asarray(d.event_data_offsets[ev_lo : ev_hi + 1], np.int64)
        counts = np.diff(off)
        el_lo, el_hi = int(off[0]), int(off[-1])
        # Slots beyond M are clipped (a config's max_n_dynamic can cap below
        # the data's widest event; the host collation drops them the same way).
        slot = np.arange(el_hi - el_lo, dtype=np.int64) - np.repeat(off[:-1] - el_lo, counts)
        keep = slot < M
        rows = np.repeat(np.arange(n_events), counts)[keep] + L
        cols = slot[keep]

        def dense(src, dtype):
            return _dense_pre_sliced(src[el_lo:el_hi], rows, cols, keep, n_rows, M, dtype)

        td = np.zeros(n_rows, np.float32)
        td[L : L + n_events] = d.time_delta[ev_lo:ev_hi]

        S = ds.max_n_static
        n_subjects = s_hi - s_lo
        n_subj_rows = max(n_subjects, 1)
        st_idx = np.zeros((n_subj_rows, S), np.int32)
        st_meas = np.zeros((n_subj_rows, S), np.int32)
        if ds.do_produce_static_data and n_subjects:
            st_off = np.asarray(d.static_offsets[s_lo : s_hi + 1], np.int64)
            st_counts = np.diff(st_off)
            st_el_lo, st_el_hi = int(st_off[0]), int(st_off[-1])
            st_slot = np.arange(st_el_hi - st_el_lo, dtype=np.int64) - np.repeat(st_off[:-1] - st_el_lo, st_counts)
            st_keep = st_slot < S
            st_rows = np.repeat(np.arange(n_subjects), st_counts)[st_keep]
            st_idx[st_rows, st_slot[st_keep]] = np.asarray(d.static_indices[st_el_lo:st_el_hi])[st_keep]
            st_meas[st_rows, st_slot[st_keep]] = np.asarray(d.static_measurement_indices[st_el_lo:st_el_hi])[st_keep]

        offsets = np.asarray(d.subject_event_offsets[s_lo : s_hi + 1], np.int64) - ev_lo
        vals = np.where(d.dynamic_values_observed[el_lo:el_hi], d.dynamic_values[el_lo:el_hi], 0.0)
        return {
            "subject_event_offsets": offsets.astype(np.int32),
            "time_delta": td,
            "dynamic_indices": dense(d.dynamic_indices, np.int32),
            "dynamic_measurement_indices": dense(d.dynamic_measurement_indices, np.int32),
            "dynamic_values": _dense_pre_sliced(vals, rows, cols, keep, n_rows, M, np.float32),
            "dynamic_values_obs": dense(d.dynamic_values_observed, bool),
            "static_indices": st_idx,
            "static_measurement_indices": st_meas,
        }

    def padded_kernel(self):
        """The padded collate bound to this dataset's shapes:
        ``kernel(arrays, subject_indices, starts, valid) -> fields``."""
        ds = self.dataset
        return partial(
            padded_collate_kernel,
            L=ds.max_seq_len,
            M=ds.max_n_dynamic,
            S=ds.max_n_static,
            pad_right=ds.seq_padding_side == SeqPaddingSide.RIGHT,
            do_static=ds.do_produce_static_data,
        )

    def packed_kernel(self):
        """The packed collate bound to this dataset:
        ``kernel(arrays, event_ids, event_mask) -> fields``."""
        return partial(packed_collate_kernel, L_PAD=self.dataset.max_seq_len, M=self.dataset.max_n_dynamic)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ----------------------------------------------------------- collation
    def collate(self, plan: BatchPlan) -> EventStreamBatch:
        """The static-shape batch of one `BatchPlan`: the ``(B, L[, M])``
        fields collated on the device, the light per-subject fields as CPU
        tensors."""
        ds = self.dataset
        fields = self.padded_kernel()(
            self.arrays,
            self._to_device(plan.subject_indices),
            self._to_device(plan.starts),
            self._to_device(plan.valid_mask),
        )
        if ds.config.do_include_start_time_min:
            if plan.start_time is None:
                raise ValueError(
                    "do_include_start_time_min is set but the plan carries no start_time; regenerate plans "
                    "from this config."
                )
            fields["start_time"] = torch.from_numpy(plan.start_time)
        if ds.config.do_include_subsequence_indices:
            fields["start_idx"] = torch.from_numpy(plan.starts)
            fields["end_idx"] = torch.from_numpy(plan.starts + plan.kept)
        if ds.config.do_include_subject_id:
            fields["subject_id"] = torch.from_numpy(
                np.asarray([ds.subject_ids[i] for i in plan.subject_indices], dtype=np.int64)
            )
        labels = ds.labels_of(plan.subject_indices)
        if labels is not None:
            fields["stream_labels"] = {t: torch.from_numpy(v) for t, v in labels.items()}
        fields["valid_mask"] = torch.from_numpy(plan.valid_mask)
        return EventStreamBatch(**fields)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int | None = None,
        drop_last: bool | None = None,
        skip_batches: int = 0,
        with_counts: bool = False,
    ) -> Iterator:
        """Device-collated batches of `CSRDataset.plan_batches`' stream; with
        ``with_counts`` ``(batch, n_events)``, the count from the plan (no
        device readback)."""
        for plan in self.dataset.plan_batches(
            batch_size, shuffle=shuffle, seed=seed, drop_last=drop_last, skip_batches=skip_batches
        ):
            b = self.collate(plan)
            yield (b, plan.n_events) if with_counts else b

    def _packed_rows(self, batch_size: int, L: int, shuffle: bool, seed: int | None) -> list:
        strategy = self.dataset.config.subsequence_sampling_strategy
        return packed_rows_dealt(self.dataset.data, batch_size, L, shuffle=shuffle, seed=seed, strategy=strategy)

    def packed_batches(
        self,
        batch_size: int,
        seq_len: int | None = None,
        shuffle: bool = True,
        seed: int | None = None,
        with_counts: bool = False,
    ) -> Iterator:
        """Device-collated packed batches: the rows and their order of
        `data.torch_dataset.packed_batches` (same packing, same rng); the
        host sends the ``(B, L)`` event-id plan and the device gathers the
        ``(B, L, M)`` payload. The last batch may be short."""
        L = seq_len or self.dataset.max_seq_len
        rows = self._packed_rows(batch_size, L, shuffle, seed)
        kernel = self.packed_kernel()
        for lo_idx in range(0, len(rows), batch_size):
            chunk = rows[lo_idx : lo_idx + batch_size]
            event_ids, seg, mask, n_events = packed_row_plan(self.dataset.data, chunk, L)
            fields = kernel(self.arrays, self._to_device(event_ids.astype(np.int32)), self._to_device(mask))
            batch = EventStreamBatch(
                segment_ids=torch.from_numpy(seg), valid_mask=torch.ones(len(chunk), dtype=torch.bool), **fields
            )
            yield (batch, n_events) if with_counts else batch

    # ------------------------------------------------------- chunked plans
    def plan_chunks(
        self,
        batch_size: int,
        chunk_steps: int,
        shuffle: bool = True,
        seed: int | None = None,
        drop_last: bool | None = None,
        skip_batches: int = 0,
    ) -> Iterator[tuple[dict, int]]:
        """Yields ``(plans, n_events)`` with ``chunk_steps`` stacked plans:
        ``plans`` maps each plan field to a ``(k, B)`` numpy array, what
        `training.pretrain.make_chunked_train_step` runs ``k`` collate and
        train steps over in one program. The last chunk may be shorter (one
        more captured program for it)."""
        buf: list[BatchPlan] = []
        for plan in self.dataset.plan_batches(
            batch_size, shuffle=shuffle, seed=seed, drop_last=drop_last, skip_batches=skip_batches
        ):
            buf.append(plan)
            if len(buf) == chunk_steps:
                yield self._stack_plans(buf)
                buf = []
        if buf:
            yield self._stack_plans(buf)

    @staticmethod
    def _stack_plans(plans: list[BatchPlan]) -> tuple[dict, int]:
        return (
            {
                "subject_indices": np.stack([p.subject_indices for p in plans]),
                "starts": np.stack([p.starts for p in plans]),
                "valid_mask": np.stack([p.valid_mask for p in plans]),
            },
            sum(p.n_events for p in plans),
        )

    def packed_plan_chunks(
        self,
        batch_size: int,
        chunk_steps: int,
        seq_len: int | None = None,
        shuffle: bool = True,
        seed: int | None = None,
        skip_batches: int = 0,
        drop_short: bool = True,
    ) -> Iterator[tuple[dict, int]]:
        """The packed analogue of `plan_chunks`: ``(k, B, L)`` event-id,
        segment-id and mask plans. ``drop_short`` skips a last under-filled
        batch (it would need another program)."""
        L = seq_len or self.dataset.max_seq_len
        rows = self._packed_rows(batch_size, L, shuffle, seed)
        buf: list[tuple] = []
        n_ev_buf = 0
        n_seen = 0
        for lo_idx in range(0, len(rows), batch_size):
            chunk = rows[lo_idx : lo_idx + batch_size]
            if drop_short and len(chunk) < batch_size:
                continue
            n_seen += 1
            if n_seen <= skip_batches:
                continue
            event_ids, seg, mask, n_events = packed_row_plan(self.dataset.data, chunk, L)
            buf.append((event_ids.astype(np.int32), seg.astype(np.int32), mask))
            n_ev_buf += n_events
            if len(buf) == chunk_steps:
                yield self._stack_packed(buf), n_ev_buf
                buf, n_ev_buf = [], 0
        if buf:
            yield self._stack_packed(buf), n_ev_buf

    @staticmethod
    def _stack_packed(buf: list[tuple]) -> dict:
        return {
            "event_ids": np.stack([e for e, _, _ in buf]),
            "segment_ids": np.stack([s for _, s, _ in buf]),
            "event_mask": np.stack([m for _, _, m in buf]),
        }
