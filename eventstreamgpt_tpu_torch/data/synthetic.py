"""Synthetic prompts, training batches and packing data, and the benchmark's model configurations.

Counterpart: ``eventstreamgpt_tpu/data/synthetic.py``, whose vocabulary
layout (UNK at 0, then ``event_type``, ``lab``, ``med``, ``demo`` slices),
per-subject recipe (lognormal lengths clipped to ``[4, 512]``, inter-event
times uniform in 1-240 minutes) and per-event recipe (one event type, labs
by default, meds at the end of 40% of events, at most 24 elements) these
follow. Everything is built in memory from a numpy generator; nothing is
written to disk. Index planes are int32, as the JAX package (x64 off)
holds them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.config import StructuredTransformerConfig
from .config import MeasurementConfig
from .torch_dataset import CSRData, packed_batches
from .types import EventStreamBatch

# bench.py's serving shape: 40 event types, 3,500 labs, 500 meds, 16 statics.
BENCH_VOCAB = (40, 3500, 500, 16)
BENCH_WIDTHS = dict(hidden_size=256, head_dim=64, intermediate_size=1024, seq_window_size=32)


def serving_config(
    precision: str = "bf16",
    mean_log: float = 4.5,
    std_log: float = 0.85,
    sizes: tuple = BENCH_VOCAB,
    **overrides,
) -> StructuredTransformerConfig:
    """The CI model the repository's serving benchmark serves (``bench.py``):
    2 layers (local, global), 4 heads, a 3-component lognormal-mixture TTE
    head, over the synthetic vocabulary of ``sizes`` (event types, labs,
    meds, statics). ``overrides`` replace the widths (hidden, head_dim,
    intermediate, window) or any other config field."""
    n_et, n_labs, n_meds, n_static = sizes
    offsets = {"event_type": 1, "lab": 1 + n_et, "med": 1 + n_et + n_labs, "demo": 1 + n_et + n_labs + n_meds}
    return StructuredTransformerConfig(
        measurement_configs={
            "lab": MeasurementConfig(
                name="lab", temporality="dynamic", modality="multivariate_regression", values_column="lab_value"
            ),
            "med": MeasurementConfig(name="med", temporality="dynamic", modality="multi_label_classification"),
            "demo": MeasurementConfig(name="demo", temporality="static", modality="single_label_classification"),
        },
        vocab_sizes_by_measurement={"event_type": n_et, "lab": n_labs, "med": n_meds, "demo": n_static},
        vocab_offsets_by_measurement=offsets,
        measurements_idxmap={"event_type": 1, "lab": 2, "med": 3, "demo": 4},
        measurements_per_generative_mode={
            "single_label_classification": ["event_type"],
            "multi_label_classification": ["lab", "med"],
            "multivariate_regression": ["lab"],
        },
        mean_log_inter_event_time_min=mean_log,
        std_log_inter_event_time_min=std_log,
        precision=precision,
        **{
            **dict(
                BENCH_WIDTHS,
                max_seq_len=256,
                num_attention_heads=4,
                num_hidden_layers=2,
                seq_attention_types=["local", "global"],
                TTE_generation_layer_type="log_normal_mixture",
                TTE_lognormal_generation_num_components=3,
            ),
            **overrides,
        },
    )


def synthetic_event(rng: np.random.Generator, config, max_obs: int = 24):
    """One event's ``(measurement indices, indices, values)``: an event type,
    then labs (with standard-normal values), the last 1-3 elements meds in
    40% of events; values are 0 off the labs."""
    off, size = config.vocab_offsets_by_measurement, config.vocab_sizes_by_measurement
    n_obs = int(np.clip(rng.poisson(14), 1, max_obs))
    m = np.full(n_obs, 2)
    m[0] = 1
    if n_obs > 2 and rng.random() < 0.4:
        m[-(1 + int(rng.integers(0, min(3, n_obs - 2)))) :] = 3
    idx = np.zeros(n_obs, np.int32)
    for code, name in ((1, "event_type"), (2, "lab"), (3, "med")):
        sel = m == code
        idx[sel] = rng.integers(off[name] + 1, off[name] + size[name], size=int(sel.sum()))
    return m, idx, np.where(m == 2, rng.normal(size=n_obs), 0.0)


def synthetic_prompts(rng: np.random.Generator, n: int, config, len_range, budget_range, max_obs: int = 24):
    """``n`` one-row prompts with lengths and budgets drawn from the inclusive
    ranges; returns ``[(prompt, budget), ...]`` (CPU tensors)."""
    off, size = config.vocab_offsets_by_measurement, config.vocab_sizes_by_measurement
    out = []
    for _ in range(n):
        L = int(rng.integers(len_range[0], len_range[1] + 1))
        idx = np.zeros((1, L, max_obs), np.int32)
        meas = np.zeros((1, L, max_obs), np.int32)
        vals = np.zeros((1, L, max_obs), np.float32)
        for e in range(L):
            m, ix, v = synthetic_event(rng, config, max_obs)
            meas[0, e, : len(m)], idx[0, e, : len(m)], vals[0, e, : len(m)] = m, ix, v
        prompt = EventStreamBatch(
            event_mask=torch.ones(1, L, dtype=torch.bool),
            time_delta=torch.from_numpy(rng.uniform(1.0, 240.0, size=(1, L)).astype(np.float32)),
            static_indices=torch.tensor([[int(rng.integers(off["demo"] + 1, off["demo"] + size["demo"]))]],
                                        dtype=torch.int32),
            static_measurement_indices=torch.tensor([[config.measurements_idxmap["demo"]]], dtype=torch.int32),
            dynamic_indices=torch.from_numpy(idx),
            dynamic_measurement_indices=torch.from_numpy(meas),
            dynamic_values=torch.from_numpy(vals),
            dynamic_values_mask=torch.from_numpy(meas == 2),
            start_time=torch.from_numpy(rng.uniform(0, 1e5, size=(1,)).astype(np.float32)),
        )
        out.append((prompt, int(rng.integers(budget_range[0], budget_range[1] + 1))))
    return out


def log_time_stats(prompts) -> tuple[float, float]:
    """Mean and std of log inter-event times over prompts (the statistics
    ``set_to_dataset`` gives a lognormal TTE head)."""
    logd = np.log(np.concatenate([p.time_delta.numpy().ravel() for p, _ in prompts]))
    return float(logd.mean()), float(logd.std())


def synthetic_training_batches(
    rng: np.random.Generator, config, batch_size: int, seq_len: int, mean_seq_len: int = 200, max_obs: int = 24
):
    """An endless iterator of training batches (CPU tensors) in the layout
    ``JaxDataset.collate`` gives: right padding to ``seq_len`` events,
    ``n_data`` the batch's widest event, values 0 and ``dynamic_values_mask``
    False where unobserved, ``time_delta`` the minutes to the next event (1
    after a subject's last event, 0 on padding).

    Each subject follows ``write_synthetic_dataset``: a length drawn
    lognormal around ``mean_seq_len`` (sigma 0.6) and clipped to
    ``[4, 512]``, cropped to its first ``seq_len`` events, inter-event times
    uniform in 1-240 minutes, one static ``demo`` element.
    """
    off, size = config.vocab_offsets_by_measurement, config.vocab_sizes_by_measurement
    demo = config.measurements_idxmap["demo"]
    while True:
        subjects = []
        for _ in range(batch_size):
            n = int(np.clip(rng.lognormal(np.log(mean_seq_len), 0.6), 4, 512))
            deltas = np.append(rng.uniform(1.0, 240.0, size=n - 1), 1.0)[:seq_len]
            events = [synthetic_event(rng, config, max_obs) for _ in range(len(deltas))]
            static = int(rng.integers(off["demo"] + 1, off["demo"] + size["demo"]))
            subjects.append((deltas, events, static))
        n_data = max(len(m) for _, events, _ in subjects for m, _, _ in events)
        B, L = batch_size, seq_len
        event_mask = np.zeros((B, L), bool)
        time_delta = np.zeros((B, L), np.float32)
        idx = np.zeros((B, L, n_data), np.int32)
        meas = np.zeros((B, L, n_data), np.int32)
        vals = np.zeros((B, L, n_data), np.float32)
        for b, (deltas, events, _) in enumerate(subjects):
            event_mask[b, : len(deltas)] = True
            time_delta[b, : len(deltas)] = deltas
            for e, (m, ix, v) in enumerate(events):
                meas[b, e, : len(m)], idx[b, e, : len(m)], vals[b, e, : len(m)] = m, ix, v
        yield EventStreamBatch(
            event_mask=torch.from_numpy(event_mask),
            time_delta=torch.from_numpy(time_delta),
            static_indices=torch.tensor([[s] for _, _, s in subjects], dtype=torch.int32),
            static_measurement_indices=torch.full((B, 1), demo, dtype=torch.int32),
            dynamic_indices=torch.from_numpy(idx),
            dynamic_measurement_indices=torch.from_numpy(meas),
            dynamic_values=torch.from_numpy(vals),
            dynamic_values_mask=torch.from_numpy(meas == 2),
        )


def training_config(batches, precision: str = "bf16", **overrides) -> StructuredTransformerConfig:
    """`serving_config` with the log inter-event-time statistics of
    ``batches`` (over the gaps between two real events), as
    ``set_to_dataset`` gives a lognormal TTE head."""
    gaps = []
    for b in batches:
        real = b.event_mask[:, 1:] & b.event_mask[:, :-1]
        if b.segment_ids is not None:  # packed rows: no gap across two subjects
            real = real & (b.segment_ids[:, 1:] == b.segment_ids[:, :-1])
        gaps.append(b.time_delta[:, :-1].numpy()[real.numpy()])
    logd = np.log(np.concatenate(gaps))
    return serving_config(precision=precision, mean_log=float(logd.mean()), std_log=float(logd.std()), **overrides)


def synthetic_csr(rng: np.random.Generator, config, n_subjects: int, mean_seq_len: int = 200, max_obs: int = 24):
    """A `CSRData` split of ``n_subjects`` subjects drawn as
    `synthetic_training_batches` draws them (lengths lognormal around
    ``mean_seq_len`` with sigma 0.6, clipped to ``[4, 512]`` and not cropped;
    inter-event times uniform in 1-240 minutes, 1 after a subject's last
    event; `synthetic_event` contents; one static ``demo`` element), the
    input of `data.torch_dataset.packed_batches`."""
    off, size = config.vocab_offsets_by_measurement, config.vocab_sizes_by_measurement
    demo = config.measurements_idxmap["demo"]
    lengths, deltas, counts, meas, idx, vals, statics = [], [], [], [], [], [], []
    for _ in range(n_subjects):
        n = int(np.clip(rng.lognormal(np.log(mean_seq_len), 0.6), 4, 512))
        lengths.append(n)
        deltas.append(np.append(rng.uniform(1.0, 240.0, size=n - 1), 1.0))
        for _ in range(n):
            m, ix, v = synthetic_event(rng, config, max_obs)
            counts.append(len(m))
            meas.append(m)
            idx.append(ix)
            vals.append(v)
        statics.append(int(rng.integers(off["demo"] + 1, off["demo"] + size["demo"])))

    def offsets(n):
        return np.concatenate([[0], np.cumsum(n)]).astype(np.int64)

    return CSRData(
        subject_event_offsets=offsets(lengths),
        time_delta=np.concatenate(deltas).astype(np.float32),
        event_data_offsets=offsets(counts),
        dynamic_indices=np.concatenate(idx).astype(np.int32),
        dynamic_measurement_indices=np.concatenate(meas).astype(np.int32),
        dynamic_values=np.concatenate(vals).astype(np.float32),
        dynamic_values_observed=np.concatenate(meas) == 2,
        static_offsets=np.arange(n_subjects + 1, dtype=np.int64),
        static_indices=np.asarray(statics, dtype=np.int32),
        static_measurement_indices=np.full(n_subjects, demo, dtype=np.int32),
        start_time_min=np.zeros(n_subjects, dtype=np.float64),
    )


# bench.py's packed long-context model: global layers on the flash kernel,
# attention dropout off (the kernels have none), rows of 1,024 events.
PACKED_OVERRIDES = dict(attention_implementation="pallas_flash", attention_dropout=0.0, max_seq_len=1024)


def packed_batch(config, n_subjects: int, batch_size: int, seq_len: int, seed: int = 0, **kw) -> EventStreamBatch:
    """``bench.py``'s packed batch: the first of `packed_batches` (its seed 1)
    over `synthetic_csr` of ``n_subjects`` (numpy seed ``seed``; ``kw`` to
    it), on the CPU. ``packed_batch(serving_config(), 512, 8, 1024)`` is the
    packed training configuration's batch."""
    csr = synthetic_csr(np.random.default_rng(seed), config, n_subjects, **kw)
    return next(packed_batches(csr, batch_size, seq_len, seed=1))


def packed_training_config(batches, precision: str = "bf16", **overrides) -> StructuredTransformerConfig:
    """`training_config` for ``bench.py``'s packed long-context model (its
    packed section: the CI widths under ``pallas_flash``, attention dropout
    0, ``max_seq_len`` 1024); ``batches`` are packed batches."""
    return training_config(batches, precision=precision, **{**PACKED_OVERRIDES, **overrides})


# bench.py's nested-attention model: three dep-graph levels, global dep-graph
# attention, bare attention for the sequence and a full block for the graph.
NA_OVERRIDES = dict(
    structured_event_processing_mode="nested_attention",
    measurements_per_dep_graph_level=[[], ["event_type"], ["lab", "med"]],
    dep_graph_attention_types="global",
    do_full_block_in_seq_attention=False,
    do_full_block_in_dep_graph_attention=True,
)


def na_training_config(batches, precision: str = "bf16", **overrides) -> StructuredTransformerConfig:
    """`training_config` for ``bench.py``'s nested-attention (NA) model
    (``bench.py``'s NA section: the CI widths with `NA_OVERRIDES`)."""
    return training_config(batches, precision=precision, **{**NA_OVERRIDES, **overrides})
