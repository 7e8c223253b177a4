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
  counter-hash generator (`RowStreams.uniform`);
* the wall time a step of the engine's own chunk loop: 3 chunks issued
  and resolved as `GenerationEngine.run` does, with ``--dispatch-depth``
  chunks in flight (host clock to the last boundary, over the steps);
* end to end, `GenerationEngine.run` on 64 requests (prompts of 128-192
  events, budgets of 16-64, numpy seed 0, after a warm-up run of 4): the
  wall time, generated events per second, chunks dispatched and
  ``wasted_decode_frac`` (a freed slot waits up to ``dispatch_depth - 1``
  chunks for its next request).

``--kv-cache-dtype`` sets the slot caches' type (``bf16``, the compute
dtype, or ``int8`` / ``fp8``: kernel B's quantized entry). Run from the
root of a checkout:

    python -m eventstreamgpt_tpu_torch.tools.profile_decode --out build/profile_decode.json
    python -m eventstreamgpt_tpu_torch.tools.profile_decode --kv-cache-dtype int8 --dispatch-depth 2

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

N_SLOTS, PROFILED_STEPS, TIMED_STEPS, LOOP_CHUNKS = 32, 5, 20, 3


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


def filled_engine(model, config, prompts, greedy: bool, kv_cache_dtype: str, dispatch_depth: int):
    """The 32-slot engine with every slot admitted (budgets of 64 events)."""
    engine = GenerationEngine(
        model, config, template=prompts[0][0], n_slots=N_SLOTS, max_len=256, max_prompt_len=192,
        min_bucket=32, decode_chunk=16, greedy=greedy, kv_cache_dtype=kv_cache_dtype, dispatch_depth=dispatch_depth,
    )  # fmt: skip
    for i, (p, _) in enumerate(prompts):
        engine.submit(Request(prompt=p, max_new_events=64, request_id=i))
    engine.plan_and_dispatch()
    if engine.occupied != N_SLOTS:
        raise RuntimeError(f"expected {N_SLOTS} admitted requests, got {engine.occupied}")
    return engine


def chunk_loop_step_ms(model, config, prompts, greedy, kv_cache_dtype, dispatch_depth) -> float:
    """Wall time a decode step of `LOOP_CHUNKS` chunks issued and resolved as
    `GenerationEngine.run` does (``dispatch_depth`` in flight), on a fresh
    filled engine after one warm-up chunk; no slot finishes in that span."""
    engine = filled_engine(model, config, prompts, greedy, kv_cache_dtype, dispatch_depth)
    engine.issue_chunk()
    engine.resolve_chunk(0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOOP_CHUNKS):
        engine.issue_chunk()
        if engine.inflight_chunks >= dispatch_depth:
            engine.resolve_chunk(0.0)
    while engine.inflight_chunks:
        engine.resolve_chunk(0.0)
    wall = time.perf_counter() - t0
    return wall * 1e3 / (LOOP_CHUNKS * engine.decode_chunk)


def serve_run(model, config, greedy: bool, kv_cache_dtype: str, dispatch_depth: int) -> dict:
    """`GenerationEngine.run` on 64 requests, end to end (module docstring)."""
    prompts = synthetic_prompts(np.random.default_rng(0), 64, serving_config(), (128, 192), (16, 64))

    def engine():
        return GenerationEngine(
            model, config, template=prompts[0][0], n_slots=N_SLOTS, max_len=256, max_prompt_len=192, min_bucket=32,
            decode_chunk=16, greedy=greedy, kv_cache_dtype=kv_cache_dtype, dispatch_depth=dispatch_depth,
        )  # fmt: skip

    def requests():
        return [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]

    engine().run(requests()[:4])
    eng = engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    generated = sum(r.n_generated for r in results)
    if any(r.error is not None for r in results):
        raise RuntimeError("profile_decode: a request failed")
    stats = eng.stats()
    return {"requests": len(results), "generated": generated, "wall_s": wall, "generated_per_s": generated / wall,
            "dispatched_chunks": stats["dispatched_chunks"], "wasted_decode_frac": stats["wasted_decode_frac"]}  # fmt: skip


def profile_mode(model, config, prompts, greedy: bool, kv_cache_dtype: str = "bf16", dispatch_depth: int = 2) -> dict:
    engine = filled_engine(model, config, prompts, greedy, kv_cache_dtype, dispatch_depth)
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
        "kv_cache_dtype": kv_cache_dtype,
        "dispatch_depth": dispatch_depth,
        "chunk_loop_step_wall_ms": chunk_loop_step_ms(model, config, prompts, greedy, kv_cache_dtype, dispatch_depth),
        "run_64_requests": serve_run(model, config, greedy, kv_cache_dtype, dispatch_depth),
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
    ap.add_argument("--kv-cache-dtype", default="bf16", choices=("bf16", "int8", "fp8"))
    ap.add_argument("--dispatch-depth", type=int, default=2)
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
    out = {
        "card": smi,
        "modes": [
            profile_mode(model, config, prompts, greedy, args.kv_cache_dtype, args.dispatch_depth)
            for greedy in (True, False)
        ],
    }
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
