"""Where a train step's time goes, on one CUDA device.

Builds the benchmark's CI training model (`data.synthetic.training_config`:
hidden 256, 2 layers, bf16 compute over fp32 master weights, dropout 0.1,
numpy-seeded random weights), or with ``--na`` its nested-attention model
(`data.synthetic.na_training_config`: the same widths over three dep-graph
levels), or with ``--packed`` its packed long-context model
(`data.synthetic.packed_training_config`: the same widths under
``attention_implementation="pallas_flash"``, kernel E on the global layer)
on ``bench.py``'s packed batch (the first of `data.torch_dataset.packed_batches`
over `data.synthetic.synthetic_csr`: 8 rows x 1,024 events), with AdamW
under warmup, and one synthetic batch of 32 subjects x 256 events (or the
packed batch) resident on the device. It measures the step captured into
a CUDA graph (the default of `training.make_train_step`) and the same step
run eagerly (``cuda_graph=False``), each on a fresh model in alternating
runs (captured, eager, eager, captured):

* the wall time of one train step (host clock around a synchronised step,
  median and min of 20 a run, after 3 warm-up steps: the captured step is
  warmed up on its first, captured on its second) and trained events/s
  (real events a step over that time);
* with ``torch.profiler`` over 3 steps: the device time of every kernel
  (summed per kernel name; the top 15), the kernels the device ran a step,
  the host's launches a step (kernel and graph launches, copies, memsets)
  and the device's busy share of the wall time, profiled and unprofiled;
* the peak device memory and the captures and replays.

Run from the root of a checkout:

    python -m eventstreamgpt_tpu_torch.tools.profile_train --out build/profile_train.json
    python -m eventstreamgpt_tpu_torch.tools.profile_train --na --out build/profile_train_na.json
    python -m eventstreamgpt_tpu_torch.tools.profile_train --packed --out build/profile_train_packed.json

It prints one JSON object (also written to ``--out``) and exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..convert import init_params_from_seed
from ..data.synthetic import (
    na_training_config,
    packed_batch,
    packed_training_config,
    serving_config,
    synthetic_training_batches,
    training_config,
)
from ..models.config import OptimizationConfig
from ..training import build_model, build_optimizer, make_train_step
from .profile_decode import ORDER, PROGRAMS, profile_summary

BATCH, SEQ_LEN, PROFILED_STEPS, TIMED_STEPS = 32, 256, 3, 20
PACKED_BATCH, PACKED_SEQ_LEN, PACKED_SUBJECTS = 8, 1024, 512


def program_run(config, batch, cuda_graph: bool) -> dict:
    """A fresh model's step (``cuda_graph`` captured or eager): 3 warm-up
    steps, `TIMED_STEPS` timed ones, `PROFILED_STEPS` under the profiler."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = init_params_from_seed(build_model(config), seed=0)
    oc = OptimizationConfig(init_lr=1e-3, batch_size=BATCH, max_epochs=3, lr_frac_warmup_steps=0.1)
    oc.set_to_dataset(n_subjects=512)
    optimizer, scheduler = build_optimizer(model, oc)
    step = make_train_step(model, optimizer, scheduler, cuda_graph=cuda_graph)
    for _ in range(3):
        step(batch, 0)
    torch.cuda.synchronize()
    walls = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        step(batch, 0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step(batch, 0)
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    return dict(walls=walls, prof=prof, profiled_ms=profiled_wall_ms, stats=step.stats(),
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)  # fmt: skip


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--na", action="store_true", help="profile the nested-attention model's step")
    mode.add_argument("--packed", action="store_true", help="profile the packed long-context model's step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    if args.packed:
        batch = packed_batch(serving_config(), PACKED_SUBJECTS, PACKED_BATCH, PACKED_SEQ_LEN)
        config = packed_training_config([batch])
    else:
        batch = next(synthetic_training_batches(np.random.default_rng(0), serving_config(), BATCH, SEQ_LEN))
        config = (na_training_config if args.na else training_config)([batch])
    batch = batch.map(lambda t: t.cuda())
    runs = {name: [] for name in PROGRAMS}
    for name in ORDER:
        runs[name].append(program_run(config, batch, PROGRAMS[name]))
    events = int(batch.event_mask.sum())
    programs = {}
    for name, rs in runs.items():
        walls = [w for r in rs for w in r["walls"]]
        step_ms = float(np.median(walls))
        last = rs[-1]
        summary = profile_summary(last["prof"], PROFILED_STEPS, step_ms, last["profiled_ms"])
        programs[name] = {
            "step_wall_ms_median": step_ms,
            "step_wall_ms_min": float(np.min(walls)),
            "step_wall_ms_median_per_run": [float(np.median(r["walls"])) for r in rs],
            "trained_events_per_s": events / (step_ms / 1e3),
            **summary,
            "peak_memory_gb": max(r["peak_memory_gb"] for r in rs),
            "graph": last["stats"],
        }
    out = {
        "card": smi,
        "model": config.structured_event_processing_mode,
        "attention_implementation": config.attention_implementation,
        "shape": {
            "batch": int(batch.event_mask.shape[0]),
            "seq_len": int(batch.event_mask.shape[1]),
            "n_data": int(batch.dynamic_indices.shape[-1]),
        },
        "real_events_per_step": events,
        "programs": programs,
    }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
