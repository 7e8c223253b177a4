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

With ``--chunked`` it measures instead the device-resident chunked step
(`training.make_chunked_train_step`) as ``bench.py`` times it
(``_timed_chunk_epochs``): `data.synthetic.synthetic_csr` of 512 subjects
(numpy seed 0, ``bench.py``'s cohort) resident in a
`data.device_dataset.DeviceDataset`, padded plans of 32 x 256 in chunks of
16 (``--na`` the NA model on them), or with ``--packed`` packed plans of
8 x 1,024 in fixed-size chunks of 4; one warm chunk (plan seed 0), then 3
epochs on fresh plan seeds (1, 2, 3), each timed from its first chunk to a
synchronise after its last, trained events/s from the plans' event counts
(no device readback inside the window). Beside it, the single-step path
(`make_train_step`, captured) on the same plans' batches, collated on the
device before each epoch's window. For both: events/s an epoch, the wall
a step, then with ``torch.profiler`` over one chunk (its ``k`` steps) the
kernels a step, host launches a step and device busy time; the chunk's
capture and instantiation seconds, its plan bytes a step and the peak
memory of each run.

Run from the root of a checkout:

    python -m eventstreamgpt_tpu_torch.tools.profile_train --out build/profile_train.json
    python -m eventstreamgpt_tpu_torch.tools.profile_train --na --out build/profile_train_na.json
    python -m eventstreamgpt_tpu_torch.tools.profile_train --packed --out build/profile_train_packed.json
    python -m eventstreamgpt_tpu_torch.tools.profile_train --chunked [--na | --packed] --out build/chunked.json

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
from ..data.device_dataset import DeviceDataset
from ..data.synthetic import (
    na_training_config,
    packed_batch,
    packed_training_config,
    serving_config,
    synthetic_csr,
    synthetic_training_batches,
    training_config,
)
from ..data.config import PytorchDatasetConfig
from ..data.torch_dataset import CSRDataset
from ..models.config import OptimizationConfig
from ..training import build_model, build_optimizer, make_chunked_train_step, make_train_step
from .profile_decode import ORDER, PROGRAMS, profile_summary

BATCH, SEQ_LEN, PROFILED_STEPS, TIMED_STEPS = 32, 256, 3, 20
PACKED_BATCH, PACKED_SEQ_LEN, PACKED_SUBJECTS = 8, 1024, 512
CHUNK, CHUNK_PACKED, MEASURED_EPOCHS = 16, 4, 3  # bench.py's


def fresh_optimized(config):
    """A fresh model (numpy seed 0) with ``bench.py``'s AdamW: ``(model, optimizer, scheduler)``."""
    model = init_params_from_seed(build_model(config), seed=0)
    oc = OptimizationConfig(init_lr=1e-3, batch_size=BATCH, max_epochs=MEASURED_EPOCHS, lr_frac_warmup_steps=0.1)
    oc.set_to_dataset(range(512))  # a stand-in for bench.py's 512 training subjects
    return (model, *build_optimizer(model, oc))


def program_run(config, batch, cuda_graph: bool) -> dict:
    """A fresh model's step (``cuda_graph`` captured or eager): 3 warm-up
    steps, `TIMED_STEPS` timed ones, `PROFILED_STEPS` under the profiler."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(*fresh_optimized(config), cuda_graph=cuda_graph)
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


def epoch_chunks(dd: DeviceDataset, packed: bool, seed: int) -> list:
    """One epoch's ``(plans, n_events)`` chunks, as ``bench.py`` streams
    them: chunks of 16 padded plans, or fixed-size chunks of 4 packed ones."""
    if packed:
        chunks = dd.packed_plan_chunks(PACKED_BATCH, CHUNK_PACKED, seq_len=PACKED_SEQ_LEN, seed=seed)
        return [(p, n) for p, n in chunks if len(p["event_ids"]) == CHUNK_PACKED]
    return list(dd.plan_chunks(BATCH, CHUNK, shuffle=True, seed=seed))


def epoch_batches(dd: DeviceDataset, packed: bool, seed: int, n: int) -> list:
    """The first ``n`` batches of the epoch `epoch_chunks` plans, collated on the device."""
    if packed:
        return [b for _, b in zip(range(n), dd.packed_batches(PACKED_BATCH, seq_len=PACKED_SEQ_LEN, seed=seed))]
    return [b for _, b in zip(range(n), dd.batches(BATCH, shuffle=True, seed=seed))]


def timed_epochs(run_epoch, epochs) -> list:
    """``[(events/s, seconds, steps)]``: each epoch from its first call to a
    synchronise after its last; the events come from its plans."""
    out = []
    for events, steps, args in epochs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_epoch(args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out.append((events / dt, dt, steps))
    return out


def profiled(fn, steps: int, step_ms: float) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    return profile_summary(prof, steps, step_ms, profiled_ms)


def chunked_main(args, smi: str) -> dict:
    """``--chunked``: the resident chunked step against single steps (module docstring)."""
    packed = args.packed
    config0 = serving_config()
    csr = synthetic_csr(np.random.default_rng(0), config0, PACKED_SUBJECTS, mean_seq_len=200)
    L = PACKED_SEQ_LEN if packed else SEQ_LEN
    dd = DeviceDataset(CSRDataset(csr, PytorchDatasetConfig(max_seq_len=L)))
    epochs = {seed: epoch_chunks(dd, packed, seed) for seed in range(MEASURED_EPOCHS + 1)}
    k = len(epochs[0][0][0]["event_ids" if packed else "starts"])
    first = epoch_batches(dd, packed, 0, 1)[0].map(lambda t: t.cpu())
    if packed:
        config = packed_training_config([first])
    else:
        config = (na_training_config if args.na else training_config)([first])
    out = {}

    # The chunked step: one warm chunk, then the timed epochs.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk_step = make_chunked_train_step(*fresh_optimized(config), dd, packed=packed)
    chunk_step(epochs[0][0][0], 0)

    def chunk_epoch(chunks):
        for plans, _ in chunks:
            chunk_step(plans, 0)

    def n_steps(chunks):
        return sum(len(next(iter(p.values()))) for p, _ in chunks)

    rates = timed_epochs(chunk_epoch, [(sum(n for _, n in epochs[s]), n_steps(epochs[s]), epochs[s])
                                       for s in range(1, MEASURED_EPOCHS + 1)])  # fmt: skip
    out["chunked"] = dict(rates=rates, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, stats=chunk_step.stats())

    # The single-step path on the same plans' batches (collated before each window).
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(*fresh_optimized(config))
    for b in epoch_batches(dd, packed, 0, n_steps(epochs[0][:1])):
        step(b, 0)
    windows = []
    for s in range(1, MEASURED_EPOCHS + 1):
        batches = epoch_batches(dd, packed, s, n_steps(epochs[s]))
        windows.append((sum(n for _, n in epochs[s]), len(batches), batches))

    def single_epoch(batches):
        for b in batches:
            step(b, 0)

    single_rates = timed_epochs(single_epoch, windows)
    out["single"] = dict(rates=single_rates, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, stats=step.stats())

    # Profiles after every capture: one chunk, and its k single steps.
    for name, fn, rs in (("chunked", lambda: chunk_epoch(epochs[1][:1]), rates),
                         ("single", lambda: single_epoch(windows[0][2][:k]), single_rates)):  # fmt: skip
        best = max(rs)
        out[name]["events_per_s_per_epoch"] = [r for r, _, _ in rs]
        out[name]["trained_events_per_s"] = best[0]
        out[name]["step_wall_ms"] = best[1] / best[2] * 1e3
        out[name].update(profiled(fn, k, best[1] / best[2] * 1e3))
        del out[name]["rates"]
    out["chunked"]["plan_bytes_per_step"] = {
        key: v["plan_bytes"] / k for key, v in out["chunked"]["stats"]["keys"].items()
    }
    return {
        "card": smi,
        "mode": "chunked",
        "model": config.structured_event_processing_mode,
        "attention_implementation": config.attention_implementation,
        "packed": packed,
        "shape": {"batch": PACKED_BATCH if packed else BATCH, "seq_len": L, "n_data": dd.dataset.max_n_dynamic},
        "chunk_steps": k,
        "resident_mb": dd.nbytes / 1e6,
        "epochs": {
            s: {"chunks": len(c), "steps": n_steps(c), "events": sum(n for _, n in c)} for s, c in epochs.items()
        },
        "programs": out,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--na", action="store_true", help="profile the nested-attention model's step")
    mode.add_argument("--packed", action="store_true", help="profile the packed long-context model's step")
    ap.add_argument("--chunked", action="store_true", help="the resident chunked step against single steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    if args.chunked:
        return write(chunked_main(args, smi), args.out)
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
    return write(out, args.out)


def write(out: dict, path) -> int:
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
