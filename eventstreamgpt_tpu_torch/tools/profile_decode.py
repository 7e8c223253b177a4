"""Where a decode step's time goes, on one CUDA device.

Builds the serving benchmark's CI model (`data.synthetic.serving_config`,
bf16, numpy-seeded random weights) behind a 32-slot `GenerationEngine`,
fills every slot (prompts of 128-192 events, budgets of 64), and for greedy
and sampled decoding measures:

* the wall time of one decode step (host clock around a synchronized step,
  median of 20);
* with ``torch.profiler`` over 5 steps: the device time of every kernel
  (summed per kernel name), the launches per step, and the device's busy
  share of the wall time;
* in one more step, under a dispatch mode: the ATen operations other than
  views (each one kernel launch on the card) dispatched inside the sampling
  tail (`generation.sampling.sample_head_draws`) and, of those, inside the
  counter-hash generator (`RowStreams.uniform`).

Run from the root of a checkout:

    python -m eventstreamgpt_tpu_torch.tools.profile_decode --out build/profile_decode.json

It prints one JSON object (also written to ``--out``) and exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..convert import init_params_from_seed
from ..generation import sampling
from ..data.synthetic import log_time_stats, serving_config, synthetic_prompts
from ..models.ci_model import CIPPTForGenerativeSequenceModeling
from ..serving import GenerationEngine, Request
from ..serving import engine as engine_module

N_SLOTS, PROFILED_STEPS, TIMED_STEPS = 32, 5, 20


def _kernel_time_us(evt) -> float:
    """Device time of a kernel entry; 0 for host-side ops and for user
    annotations (``Optimizer.step#AdamW.step``), whose entries also carry
    their kernels' device time and would count it twice."""
    if "CUDA" not in str(getattr(evt, "device_type", "")):
        return 0.0
    if getattr(evt, "is_user_annotation", False) or evt.key.startswith(("Optimizer.", "ProfilerStep")):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


class _ScopedOpCount(TorchDispatchMode):
    """Counts the non-view ATen operations dispatched inside each open scope."""

    def __init__(self):
        super().__init__()
        self.open, self.counts = [], collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not getattr(func, "is_view", False):
            for scope in set(self.open):
                self.counts[scope] += 1
        return func(*args, **(kwargs or {}))

    @contextlib.contextmanager
    def scope(self, name):
        self.open.append(name)
        try:
            yield
        finally:
            self.open.pop()


def sampling_ops(engine) -> dict:
    """The ATen operations (views aside) one decode step dispatches inside the
    sampling tail and inside `RowStreams.uniform`."""
    counter = _ScopedOpCount()
    uniform, draws = sampling.RowStreams.uniform, engine_module.sample_head_draws

    def counted_uniform(self, shape):
        with counter.scope("rng_uniform"):
            return uniform(self, shape)

    def counted_draws(*args, **kwargs):
        with counter.scope("sample_head_draws"):
            return draws(*args, **kwargs)

    sampling.RowStreams.uniform, engine_module.sample_head_draws = counted_uniform, counted_draws
    try:
        with counter:
            engine._decode_step()
        torch.cuda.synchronize()
    finally:
        sampling.RowStreams.uniform, engine_module.sample_head_draws = uniform, draws
    return {f"{k}_ops_per_step": counter.counts[k] for k in ("sample_head_draws", "rng_uniform")}


def profile_mode(model, config, prompts, greedy: bool) -> dict:
    engine = GenerationEngine(
        model, config, template=prompts[0][0], n_slots=N_SLOTS, max_len=256, max_prompt_len=192,
        min_bucket=32, decode_chunk=16, greedy=greedy,
    )  # fmt: skip
    for i, (p, _) in enumerate(prompts):
        engine.submit(Request(prompt=p, max_new_events=64, request_id=i))
    engine.plan_and_dispatch()
    if engine.occupied != N_SLOTS:
        raise RuntimeError(f"expected {N_SLOTS} admitted requests, got {engine.occupied}")
    with torch.inference_mode():
        for _ in range(4):  # warm-up
            engine._decode_step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            engine._decode_step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                engine._decode_step()
            torch.cuda.synchronize()
            profiled_wall_ms = (time.perf_counter() - t0) * 1e3
        ops = sampling_ops(engine)
    kernels = {}
    for evt in prof.key_averages():
        us = _kernel_time_us(evt)
        if us > 0:
            k = kernels.setdefault(evt.key, [0, 0.0])
            k[0] += evt.count
            k[1] += us
    busy_ms = sum(us for _, us in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    active_slots = int((engine.live & ~engine.done).sum())
    return {
        "mode": "greedy" if greedy else "sampled",
        "active_slots": active_slots,
        "step_wall_ms_median": float(np.median(walls)),
        "step_wall_ms_min": float(np.min(walls)),
        "profiled_step_wall_ms": profiled_wall_ms / PROFILED_STEPS,
        "device_busy_ms_per_step": busy_ms / PROFILED_STEPS,
        "device_idle_share_profiled": 1.0 - busy_ms / profiled_wall_ms,
        "device_idle_share_unprofiled": 1.0 - (busy_ms / PROFILED_STEPS) / float(np.median(walls)),
        "kernel_launches_per_step": sum(c for c, _ in kernels.values()) / PROFILED_STEPS,
        **ops,
        "top_kernels_per_step": [
            {"name": name[:90], "launches": c / PROFILED_STEPS, "device_us": us / PROFILED_STEPS}
            for name, (c, us) in top
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    rng = np.random.default_rng(0)
    prompts = synthetic_prompts(rng, N_SLOTS, serving_config(), (128, 192), (64, 64))
    mean_log, std_log = log_time_stats(prompts)
    config = serving_config(mean_log=mean_log, std_log=std_log)
    model = init_params_from_seed(CIPPTForGenerativeSequenceModeling(config), seed=0)
    out = {"card": smi, "modes": [profile_mode(model, config, prompts, greedy) for greedy in (True, False)]}
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
