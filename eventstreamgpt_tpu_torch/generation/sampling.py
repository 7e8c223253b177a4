"""Sampling from model predictions and in-place updates of the slot buffers.

Counterpart: ``eventstreamgpt_tpu/generation/sampling.py``
(`sample_head_draws`, `assemble_event_sample`, `compact_data_elements`,
`append_new_event`, `update_last_event_data`). The generation buffer is
preallocated; sampled content is written at fixed layouts and compacted by a
stable sort on ``index == 0``, as in the JAX code.

Randomness: `RowStreams` is a counter-based generator. Row ``b``'s numbers
are a hash of ``(seed[b], counter[b], head name, draw, element)`` and of
nothing else, so a request's trajectory depends only on its seed, never on
its slot, its co-residents or the order of refills; every head draws from
the stream named after it (``cls:<m>``, ``cls_obs:<m>``, ``reg:<m>``,
``reg_obs:<m>``, ``tte``, as the JAX code's named keys), so the order of
heads never changes a value. Threefry (the JAX generator) is not
reproduced: the port's sampled trajectories are its own.

The buffer writers work IN PLACE on the slot buffers and take an ``active``
row mask: inactive rows keep their contents (the JAX engine computes new
buffers and merges them with ``where(active)``).
"""

from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Optional

import torch

from ..data.types import DataModality, EventStreamBatch, TemporalityType
from ..distributions import Bernoulli, Categorical
from ..models.config import StructuredTransformerConfig
from ..models.model_output import GenerativeSequenceModelPredictions
from ..ops.tensor_ops import gather_last

# The per-event data planes, in the order every writer takes them.
_DATA_FIELDS = ("dynamic_indices", "dynamic_measurement_indices", "dynamic_values", "dynamic_values_mask")

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mulmod32(x, m: int):
    """``(x * m) mod 2**32`` for ``x`` in ``[0, 2**32)`` without int64 overflow."""
    return ((x & 0xFFFF) * m + (((x >> 16) * m) & 0xFFFF) * 65536) & M32


def mix32(x):
    """A 32-bit integer hash (lowbias32): a bijection on ``[0, 2**32)``.

    Works on python ints and int64 tensors alike.

    Examples:
        >>> mix32(0), mix32(1)
        (0, 1753845952)
    """
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def derive_request_seed(engine_seed: int, admission_index: int) -> int:
    """A request's seed from the engine seed and its admission index
    (the port's ``derive_request_key``)."""
    return mix32(mix32(mix32(int(engine_seed) & M32) ^ (int(admission_index) & M32)) ^ _GOLDEN)


class RowStreams:
    """Per-row counter-based uniform streams.

    ``seeds`` and ``counters`` are ``(B,)`` int64 tensors; ``for_name`` binds
    a head name; each ``uniform`` call on a named stream is its next draw.
    """

    def __init__(self, seeds: torch.Tensor, counters: torch.Tensor, salt: int = 0):
        self.seeds = seeds
        self.counters = counters
        self.salt = salt
        self._draws = 0

    def for_name(self, name: str) -> "RowStreams":
        return RowStreams(self.seeds, self.counters, zlib.crc32(name.encode()) & M32)

    def next_draw_salt(self) -> int:
        """The salt of this stream's next draw; advances the draw count. Every
        draw takes its salt here (`uniform`, and kernel A drawing its noise
        inside the kernel: `ops.fused_sampling.fused_categorical_stream`)."""
        draw_salt = (self.salt + self._draws * _GOLDEN) & M32
        self._draws += 1
        return draw_salt

    def uniform(self, shape) -> torch.Tensor:
        """fp32 uniforms in (0, 1) of ``shape`` (``shape[0]`` is the row axis)."""
        B = shape[0]
        if B != self.seeds.shape[0]:
            raise ValueError(f"stream has {self.seeds.shape[0]} rows, asked for {B}")
        n = 1
        for s in shape[1:]:
            n *= int(s)
        draw_salt = self.next_draw_salt()
        row_key = mix32(mix32(mix32(self.seeds & M32) ^ (self.counters & M32)) ^ draw_salt)
        elem = torch.arange(n, dtype=torch.int64, device=self.seeds.device)
        bits = mix32((row_key[:, None] + elem[None, :] * _GOLDEN) & M32)
        u = ((bits >> 8).to(torch.float32) + 0.5) * (2.0**-24)
        return u.reshape(shape)


@dataclasses.dataclass
class GenerativeSequenceModelSamples:
    """One sampled event per row."""

    event_mask: torch.Tensor  # (B,)
    time_to_event: Optional[torch.Tensor] = None  # (B,)
    classification: Optional[dict] = None
    regression: Optional[dict] = None
    regression_indices: Optional[dict] = None


def sample_head_draws(
    preds: GenerativeSequenceModelPredictions,
    streams: Optional[RowStreams],
    categorical_sampler=None,
    greedy: bool = False,
) -> dict:
    """The raw per-head draws, keyed by the stable head names.

    ``categorical_sampler`` optionally replaces every `Categorical` head's
    draw: a ``(logits, stream) -> int32`` callable (the serving engine's
    fused tail). ``greedy`` takes every head's greedy statistic instead
    (``streams`` may then be ``None``).
    """

    def draw(dist, name):
        return dist.greedy() if greedy else dist.sample(streams.for_name(name))

    def draw_categorical(dist, name):
        if greedy or categorical_sampler is None:
            return draw(dist, name)
        return categorical_sampler(dist.logits, streams.for_name(name))

    draws = {}
    for k, (is_obs_dist, dist) in (preds.classification or {}).items():
        if is_obs_dist is not None:
            if not isinstance(dist, Categorical):
                raise ValueError(f"Don't know how to sample classification dist {dist}!")
            draws[f"cls_obs:{k}"] = draw(is_obs_dist, f"cls_obs:{k}")
        if isinstance(dist, Categorical):
            draws[f"cls:{k}"] = draw_categorical(dist, f"cls:{k}")
        else:
            draws[f"cls:{k}"] = draw(dist, f"cls:{k}")
    for k, (is_obs_dist, dist) in (preds.regression or {}).items():
        draws[f"reg:{k}"] = draw(dist, f"reg:{k}")
        if is_obs_dist is not None:
            draws[f"reg_obs:{k}"] = draw(is_obs_dist, f"reg_obs:{k}")
    if preds.time_to_event is not None:
        draws["tte"] = draw(preds.time_to_event, "tte")
    return draws


def assemble_event_sample(preds, draws: dict, event_mask: torch.Tensor) -> GenerativeSequenceModelSamples:
    """Is-observed gating (single-label unobserved -> 0, regression
    unobserved -> NaN) and the reference's +inf -> 1000 TTE clamp."""
    classification = None
    if preds.classification is not None:
        classification = {}
        for k, (is_obs_dist, _) in preds.classification.items():
            samp = draws[f"cls:{k}"]
            if is_obs_dist is not None:
                samp = torch.where(draws[f"cls_obs:{k}"] == 1, samp, torch.zeros_like(samp))
            classification[k] = samp
    regression = None
    if preds.regression is not None:
        regression = {}
        for k, (is_obs_dist, _) in preds.regression.items():
            samp = draws[f"reg:{k}"]
            if is_obs_dist is not None:
                obs = (draws[f"reg_obs:{k}"] == 1)[..., None].expand(samp.shape)
                samp = torch.where(obs, samp, torch.nan)
            regression[k] = samp
    tte = None
    if preds.time_to_event is not None:
        tte = torch.nan_to_num(draws["tte"], nan=0.0, posinf=1000.0)
    return GenerativeSequenceModelSamples(
        event_mask=event_mask,
        time_to_event=tte,
        classification=classification,
        regression=regression,
        regression_indices=preds.regression_indices,
    )


def sample_predictions(
    preds: GenerativeSequenceModelPredictions,
    event_mask: torch.Tensor,
    streams: Optional[RowStreams],
    categorical_sampler=None,
    greedy: bool = False,
) -> GenerativeSequenceModelSamples:
    """One event a row from per-head predictions sliced to the source event
    (``(B, ...)`` parameters); ``event_mask`` ``(B,)`` is the sampled event's
    mask. `sample_head_draws` then `assemble_event_sample`."""
    return assemble_event_sample(preds, sample_head_draws(preds, streams, categorical_sampler, greedy), event_mask)


def compact_data_elements(dynamic_indices, dynamic_measurement_indices, dynamic_values, dynamic_values_mask, out_width):
    """Moves nonzero-index elements to the front (stable), truncates/pads to ``out_width``."""
    order = torch.argsort((dynamic_indices == 0).to(torch.int8), dim=-1, stable=True)
    keep = min(dynamic_indices.shape[-1], out_width)
    kept = order[..., :keep]
    di, dmi, dv, dvm = (
        gather_last(x, kept)
        for x in (dynamic_indices, dynamic_measurement_indices, dynamic_values, dynamic_values_mask)
    )
    if keep < out_width:
        pad = (0, out_width - keep)
        di, dmi, dv, dvm = (torch.nn.functional.pad(x, pad) for x in (di, dmi, dv, dvm))
    valid = di != 0
    return di, torch.where(valid, dmi, 0), torch.where(valid & dvm, dv, 0.0), valid & dvm


def measurements_to_fill(config: StructuredTransformerConfig) -> set:
    """``event_type`` plus every dynamic, undropped measurement (the JAX set)."""
    out = ["event_type"]
    for m, cfg in config.measurement_configs.items():
        if not cfg.is_dropped and cfg.temporality == TemporalityType.DYNAMIC:
            out.append(m)
    return set(out)


def _masked_row_write(buf: torch.Tensor, rows, cols, values, active, drop_oob: bool = False) -> None:
    """``buf[rows, cols] = values`` for active rows; inactive rows keep theirs.

    ``values`` is a tensor or a python scalar (selected into the rows
    without a kernel of its own when ``active`` is given; written as a
    device constant otherwise: a CUDA graph may copy no host value).
    Columns are clamped into the buffer: an inactive row's cursor may sit at
    its end, and the clamped write puts back the value already there.
    ``drop_oob``: a row whose column lies past the buffer writes nothing
    either (JAX's scatter drops it; the speculative draft writes there).
    """
    if drop_oob:
        in_range = cols < buf.shape[1]
        active = in_range if active is None else active & in_range
    cols = cols.long().clamp(max=buf.shape[1] - 1)
    if torch.is_tensor(values):
        values = values.to(buf.dtype)
    elif active is None:
        values = torch.full((), values, dtype=buf.dtype, device=buf.device)
    if active is not None:
        old = buf[rows, cols]
        shape = active.shape + (1,) * (old.ndim - 1)
        values = torch.where(active.reshape(shape), values, old)
    buf[rows, cols] = values


def functor_measurements(config: StructuredTransformerConfig) -> list:
    """``(measurement index, vocabulary offset, functor, vocabulary, metadata)``
    of each undropped functional-time-dependent measurement, in the config's
    order (JAX's loop in ``_functor_elements``); read when a program is
    traced or captured."""
    out = []
    for m, cfg in config.measurement_configs.items():
        if cfg.temporality != TemporalityType.FUNCTIONAL_TIME_DEPENDENT or cfg.is_dropped:
            continue
        out.append((config.measurements_idxmap[m], config.vocab_offsets_by_measurement[m], cfg.functor_object,
                    cfg.vocabulary_object, cfg.measurement_metadata))  # fmt: skip
    return out


def functor_elements(batch: EventStreamBatch, sample, functors: list, cursor: torch.Tensor) -> tuple:
    """The new event's functional-time-dependent elements, ``(B, nf)``
    indices, measurement indices, values and value mask, and its absolute
    time ``(B,)`` (JAX's ``_functor_elements``): each functor updates its
    element of the prior event (``cursor - 1``) by the sampled time to the
    new one. The new time is ``start_time`` plus the deltas of the real
    events before the prior one plus that time, with the deltas summed in
    fp64 and rounded once to fp32 (a row's sum does not depend on its
    batch), then added in JAX's order."""
    B, L = batch.event_mask.shape
    rows = torch.arange(B, device=cursor.device)
    prior = (cursor.long() - 1).clamp(0, L - 1)
    prior_idx, prior_meas, prior_val, prior_vmask = (
        getattr(batch, n)[rows, prior]
        for n in ("dynamic_indices", "dynamic_measurement_indices", "dynamic_values", "dynamic_values_mask")
    )
    positions = torch.arange(L, device=cursor.device)[None, :]
    before = (positions < (cursor.long() - 1)[:, None]) & batch.event_mask
    deltas_before = torch.where(before, batch.time_delta.double(), 0.0).sum(-1).float()
    tte = sample.time_to_event
    start = batch.start_time if batch.start_time is not None else torch.zeros_like(deltas_before)
    new_time = torch.where(sample.event_mask, start + deltas_before + tte, 0.0)

    parts = ([], [], [], [])
    for meas_idx, offset, functor, vocab, metadata in functors:
        is_m = prior_meas == meas_idx
        indices = torch.where(is_m, prior_idx, 0).sum(-1)
        vals = torch.where(is_m & prior_vmask, prior_val, 0.0).sum(-1)
        new_indices, new_values = functor.update_from_prior_timepoint(
            prior_indices=indices - offset, prior_values=vals, new_delta=tte, new_time=new_time, vocab=vocab,
            measurement_metadata=metadata,
        )  # fmt: skip
        new_indices = (new_indices + offset).to(prior_idx.dtype)
        parts[0].append(new_indices)
        parts[1].append(torch.full_like(new_indices, meas_idx).to(prior_meas.dtype))
        parts[2].append(torch.nan_to_num(new_values, nan=0.0, posinf=0.0, neginf=0.0))
        parts[3].append(~torch.isnan(new_values))
    return tuple(torch.stack(p, -1) for p in parts) + (new_time,)


def append_new_event(
    batch: EventStreamBatch, sample, config: StructuredTransformerConfig, cursor: torch.Tensor, active=None,
    drop_oob: bool = False,
) -> None:
    """Writes the sampled TTE as ``time_delta[cursor - 1]`` and opens event
    ``cursor`` in place (JAX's ``append_new_event``): filler delta 1, the
    sampled event mask, and as content the new event's functor elements
    (`functor_elements`) in its first data slots, zeroed for rows that are
    not events; `update_last_event_data` appends the sampled content after
    them. ``drop_oob`` as in `_masked_row_write`."""
    B, _, M = batch.dynamic_indices.shape
    rows = torch.arange(B, device=cursor.device)
    cursor = cursor.long()
    prev = cursor - 1
    functors = functor_measurements(config)
    content = None
    if functors:  # read the prior event before this call writes anything
        if len(functors) > M:
            raise ValueError(f"{len(functors)} functor measurements do not fit an event of {M} data elements")
        em = sample.event_mask[:, None]
        content = []
        for f, name in zip(functor_elements(batch, sample, functors, cursor)[:4], _DATA_FIELDS):
            plane = getattr(batch, name)
            f = torch.nn.functional.pad(f.to(plane.dtype), (0, M - f.shape[1]))
            content.append(f & em if plane.dtype == torch.bool else torch.where(em, f, 0))
    td_prev = batch.time_delta[rows, prev.clamp(max=batch.time_delta.shape[1] - 1)]
    _masked_row_write(
        batch.time_delta, rows, prev, torch.where(sample.event_mask, sample.time_to_event, td_prev), active, drop_oob
    )
    _masked_row_write(batch.time_delta, rows, cursor, 1.0, active, drop_oob)
    _masked_row_write(batch.event_mask, rows, cursor, sample.event_mask, active, drop_oob)
    for i, name in enumerate(_DATA_FIELDS):
        buf = getattr(batch, name)
        value = content[i] if content is not None else (False if buf.dtype == torch.bool else 0)
        _masked_row_write(buf, rows, cursor, value, active, drop_oob)


def _format_new_elements(sample, config: StructuredTransformerConfig, to_fill: set, dtype: torch.dtype, current=None):
    """Fixed-layout content arrays for the sampled measurements (zeros where
    unsampled); indices in ``dtype``, the index planes' own. ``to_fill`` holds
    measurement names or, from split dep-graph levels, ``(name, mode)``
    pairs; a NUMERICAL_ONLY pair regresses the values of the categories
    ``current`` (the event's ``(indices, measurement indices)`` before the
    fill) holds for it."""
    idx_parts, meas_parts, val_parts, vmask_parts = [], [], [], []

    def add_single_label(m):
        indices = (config.vocab_offsets_by_measurement[m] + sample.classification[m].to(dtype))[:, None]
        idx_parts.append(indices)
        meas_parts.append(torch.full_like(indices, config.measurements_idxmap[m]))
        val_parts.append(torch.zeros(indices.shape, dtype=torch.float32, device=indices.device))
        vmask_parts.append(torch.zeros(indices.shape, dtype=torch.bool, device=indices.device))

    def add_multi_label(m):
        offset = config.vocab_offsets_by_measurement[m]
        V = config.vocab_sizes_by_measurement[m]
        preds = sample.classification[m]
        ar = torch.arange(V, dtype=dtype, device=preds.device)[None, :] + offset
        indices = torch.where(preds == 1, ar, 0)
        idx_parts.append(indices)
        meas_parts.append(torch.where(indices != 0, config.measurements_idxmap[m], indices))
        return indices

    def add_multivariate_regression(m, indices, aligned_to_vocab=True):
        regressed = sample.regression[m]
        offset = config.vocab_offsets_by_measurement[m]
        mask = indices >= offset
        if not aligned_to_vocab:  # the regression plane at each element's category
            regressed = gather_last(regressed, torch.where(mask, indices - offset, 0).long())
        val_parts.append(torch.where(mask, torch.nan_to_num(regressed, nan=0.0), 0.0))
        vmask_parts.append(mask & ~torch.isnan(regressed))

    def add_univariate_regression(m):
        preds = sample.regression[m]
        preds = preds[..., 0] if preds.ndim == 2 else preds
        obs = ~torch.isnan(preds)
        val_parts.append(torch.nan_to_num(preds, nan=0.0)[:, None])
        vmask_parts.append(obs[:, None])
        idx_parts.append((config.vocab_offsets_by_measurement[m] * obs.to(dtype))[:, None])
        meas_parts.append((config.measurements_idxmap[m] * obs.to(dtype))[:, None])

    if "event_type" in to_fill:
        add_single_label("event_type")
    def add_zero_values(indices):
        val_parts.append(torch.zeros(indices.shape, dtype=torch.float32, device=indices.device))
        vmask_parts.append(torch.zeros(indices.shape, dtype=torch.bool, device=indices.device))

    for m in to_fill:  # set order, as in the JAX code (same process, same order)
        mode = None
        if isinstance(m, (tuple, list)):
            m, mode = m
        if m == "event_type":
            continue
        modality = config.measurement_configs[m].modality
        if modality == DataModality.SINGLE_LABEL_CLASSIFICATION and mode is None:
            add_single_label(m)
        elif modality == DataModality.MULTI_LABEL_CLASSIFICATION and mode is None:
            add_zero_values(add_multi_label(m))
        elif modality == DataModality.UNIVARIATE_REGRESSION and mode is None:
            add_univariate_regression(m)
        elif modality == DataModality.MULTIVARIATE_REGRESSION and mode in (None, "categorical_and_numerical"):
            add_multivariate_regression(m, add_multi_label(m))
        elif modality == DataModality.MULTIVARIATE_REGRESSION and mode == "categorical_only":
            add_zero_values(add_multi_label(m))
        elif modality == DataModality.MULTIVARIATE_REGRESSION and mode == "numerical_only":
            cur_idx, cur_meas = current
            indices = torch.where(cur_meas == config.measurements_idxmap[m], cur_idx, 0).to(dtype)
            idx_parts.append(indices)
            meas_parts.append(torch.where(indices != 0, config.measurements_idxmap[m], indices))
            add_multivariate_regression(m, indices, aligned_to_vocab=False)
        else:
            raise ValueError(f"{modality}, {mode} invalid!")
    return (
        torch.cat(idx_parts, dim=1),
        torch.cat(meas_parts, dim=1),
        torch.cat(val_parts, dim=1),
        torch.cat(vmask_parts, dim=1),
    )


def update_last_event_data(
    batch: EventStreamBatch, sample, config: StructuredTransformerConfig, cursor, to_fill: set, active=None,
    drop_oob: bool = False,
) -> None:
    """Merges sampled content into event ``cursor - 1``, in place: existing
    elements kept, new ones appended, all compacted to the data-element width
    (``drop_oob`` as in `_masked_row_write`)."""
    B, _, M = batch.dynamic_indices.shape
    rows = torch.arange(B, device=cursor.device)
    col = (cursor.long() - 1).clamp(max=batch.dynamic_indices.shape[1] - 1)
    prev = [getattr(batch, n)[rows, col] for n in _DATA_FIELDS]
    new_idx, new_meas, new_val, new_vmask = _format_new_elements(sample, config, to_fill, prev[0].dtype, prev[:2])
    # A NUMERICAL_ONLY fill replaces the elements of its measurement the event holds.
    numerical_only = [config.measurements_idxmap[m[0]] for m in to_fill
                      if isinstance(m, (tuple, list)) and m[1] == "numerical_only"]  # fmt: skip
    if numerical_only:
        drop = functools.reduce(torch.logical_or, [prev[1] == i for i in numerical_only])
        prev = [torch.where(drop, False if x.dtype == torch.bool else 0, x) for x in prev]
    em = sample.event_mask[:, None]
    new_idx = torch.where(em, new_idx, 0)
    new_meas = torch.where(em, new_meas, 0)
    new_val = torch.where(em, new_val, 0.0)
    new_vmask = new_vmask & em
    di, dmi, dv, dvm = compact_data_elements(
        torch.cat([prev[0], new_idx.to(prev[0].dtype)], dim=1),
        torch.cat([prev[1], new_meas.to(prev[1].dtype)], dim=1),
        torch.cat([prev[2], new_val.to(prev[2].dtype)], dim=1),
        torch.cat([prev[3], new_vmask], dim=1),
        M,
    )
    for name, v in zip(_DATA_FIELDS, (di, dmi, dv, dvm)):
        _masked_row_write(getattr(batch, name), rows, cursor.long() - 1 if drop_oob else col, v, active, drop_oob)
