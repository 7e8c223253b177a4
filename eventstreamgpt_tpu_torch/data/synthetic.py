"""Synthetic prompts and the serving benchmark's model configuration.

Counterpart: ``eventstreamgpt_tpu/data/synthetic.py``, whose vocabulary
layout (UNK at 0, then ``event_type``, ``lab``, ``med``, ``demo`` slices)
and per-event recipe (one event type, labs by default, meds at the end of
40% of events, at most 24 elements) these follow. Prompts are built in
memory from a numpy generator; nothing is written to disk.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.config import StructuredTransformerConfig
from .config import MeasurementConfig
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
        max_seq_len=256,
        num_attention_heads=4,
        num_hidden_layers=2,
        seq_attention_types=["local", "global"],
        TTE_generation_layer_type="log_normal_mixture",
        TTE_lognormal_generation_num_components=3,
        mean_log_inter_event_time_min=mean_log,
        std_log_inter_event_time_min=std_log,
        precision=precision,
        **dict(BENCH_WIDTHS, **overrides),
    )


def synthetic_prompts(rng: np.random.Generator, n: int, config, len_range, budget_range, max_obs: int = 24):
    """``n`` one-row prompts with lengths and budgets drawn from the inclusive
    ranges; returns ``[(prompt, budget), ...]`` (CPU tensors)."""
    off, size = config.vocab_offsets_by_measurement, config.vocab_sizes_by_measurement
    out = []
    for _ in range(n):
        L = int(rng.integers(len_range[0], len_range[1] + 1))
        idx = np.zeros((1, L, max_obs), np.int64)
        meas = np.zeros((1, L, max_obs), np.int64)
        vals = np.zeros((1, L, max_obs), np.float32)
        for e in range(L):
            n_obs = int(np.clip(rng.poisson(14), 1, max_obs))
            m = np.full(n_obs, 2)
            m[0] = 1
            if n_obs > 2 and rng.random() < 0.4:
                m[-(1 + int(rng.integers(0, min(3, n_obs - 2)))) :] = 3
            for code, name in ((1, "event_type"), (2, "lab"), (3, "med")):
                sel = m == code
                idx[0, e, :n_obs][sel] = rng.integers(off[name] + 1, off[name] + size[name], size=int(sel.sum()))
            meas[0, e, :n_obs] = m
            vals[0, e, :n_obs] = np.where(m == 2, rng.normal(size=n_obs), 0.0)
        prompt = EventStreamBatch(
            event_mask=torch.ones(1, L, dtype=torch.bool),
            time_delta=torch.from_numpy(rng.uniform(1.0, 240.0, size=(1, L)).astype(np.float32)),
            static_indices=torch.tensor([[int(rng.integers(off["demo"] + 1, off["demo"] + size["demo"]))]]),
            static_measurement_indices=torch.tensor([[config.measurements_idxmap["demo"]]]),
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
