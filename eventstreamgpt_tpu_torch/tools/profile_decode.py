"""Where a decode step's time goes, on one CUDA device: the captured chunk beside the eager one.

Builds the serving benchmark's CI model (`data.synthetic.serving_config`,
bf16, numpy-seeded random weights) behind 32-slot `GenerationEngine`s whose
every slot is admitted (prompts of 128-192 events, budgets of 64), one
whose decode chunk is captured into a CUDA graph (the default) and one that
runs it eagerly (``cuda_graph=False``), and for greedy and sampled decoding
measures each, in alternating runs (captured, eager, eager, captured), on
fresh engines:

* the wall time of one decode step: host clock around a chunk issued and
  its boundary resolved, over the chunk's 16 steps (two chunks a run, after
  one warm-up chunk; median and min over the runs);
* with ``torch.profiler`` over one more chunk of each program's last run
  (resolved with ``fetch_results=False``: the harvest's extraction is
  `--run-split`'s to time), after every other measurement of both modes
  (and so every capture): the device time of every
  kernel (summed per kernel name), the kernels the device ran a step, the
  host's launches a step (kernel launches, graph launches, copies and
  memsets issued through the ``cuda*`` or ``cu*`` API) and the device's busy
  share of the wall time, profiled and unprofiled (the busy time over the
  unprofiled step);
* the peak device memory the engine's run reached, above what the process
  held before the engine was built;
* in one eager step, under a dispatch mode: the ATen operations other than
  views (each one kernel launch on the card) dispatched inside the sampling
  tail (`generation.sampling.sample_head_draws`) and, of those, inside the
  counter-hash generator (`RowStreams.uniform`);
* at each ``--dispatch-depths`` depth: the wall time a step of the engine's
  own chunk loop (3 chunks issued and resolved as `GenerationEngine.run`
  does, ``depth`` chunks in flight), and end to end `GenerationEngine.run`
  on 64 requests (prompts of 128-192 events, budgets of 16-64, numpy seed
  0; the second run of an engine warmed by the first and reset): the wall time, generated events per second,
  chunks dispatched and ``wasted_decode_frac``, captured and eager in
  alternating runs (captured, eager, eager, captured).

``--kv-cache-dtype`` sets the slot caches' type (``bf16``, the compute
dtype, or ``int8`` / ``fp8``: kernel B's quantized entry).

``--run-split`` measures whole runs instead: `GenerationEngine.run` on the
64 requests, warmed by one run (every program key captured), ``reset()``,
then timed with and without ``fetch_results``, greedy and sampled, at each
``--dispatch-depths`` depth, captured and eager in alternating engines
(captured, eager, eager, captured). Each timed run's host wall is split
into prefill and admission (`GenerationEngine.plan_and_dispatch`), chunk
issue (`issue_chunk`) and boundary resolve with harvest (`resolve_chunk`),
with the rest of the loop beside; each engine's peak device memory is
read (above what the process held before the engine was built). After every run (so after every capture), one replay of each prefill
(bucket, group width) key and each extraction width of a depth-1 captured
engine runs under ``torch.profiler``: its device time and kernels.

``--spec`` profiles speculative decoding instead (``bench.py``'s spec arm:
the draft the target's first ``num_hidden_layers // 2`` layers,
`serving.spec.truncated_draft`, ``k`` 4, sampled at the default
tolerances): three filled 32-slot engines, captured, depth 1, built before
the first profile: the spec engine, the unfused (``decode_step_impl="xla"``)
one and the kernel-B one. Each one's chunk of 16 steps (16 rounds for spec)
under ``torch.profiler`` (device ms, kernels and host launches a step or
round; spec: the events each round committed a slot), and the spec round's
parts as programs of their own on the filled engine's admitted state,
measured before its chunks run (`spec_parts`: the ``k`` draft steps, and the
whole round; the verify forward with the accept walk and the commit is their
difference): device ms a replay (CUDA events, `utils.timing.time_ms`) and
kernels a replay (one profiled replay).

Run from the root of a checkout:

    python -m eventstreamgpt_tpu_torch.tools.profile_decode --out build/profile_decode.json
    python -m eventstreamgpt_tpu_torch.tools.profile_decode --kv-cache-dtype int8 --dispatch-depths 1,2
    python -m eventstreamgpt_tpu_torch.tools.profile_decode --run-split --out build/run_split.json
    python -m eventstreamgpt_tpu_torch.tools.profile_decode --spec --out build/spec.json

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
from ..serving import GenerationEngine, Request, SpecConfig, truncated_draft
from ..serving import engine as engine_module
from ..utils.graphs import CapturedProgram
from ..utils.timing import time_ms

N_SLOTS, TIMED_CHUNKS, LOOP_CHUNKS = 32, 2, 3
SPEC_K = 4  # bench.py's spec arm
PROGRAMS = {"captured": True, "eager": False}
ORDER = ("captured", "eager", "eager", "captured")
# Host-side calls that put work on the device's queue, as the profiler names them.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")  # fmt: skip


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


def profile_summary(prof, steps: int, wall_ms: float, profiled_wall_ms: float) -> dict:
    """Per step of a profiled window of ``steps`` steps: device busy time,
    kernels run, host launches (graph launches apart) and idle shares,
    against the unprofiled step wall ``wall_ms`` and the profiled window's
    wall ``profiled_wall_ms``; the top kernels by device time."""
    kernels, host = {}, collections.Counter()
    for evt in prof.key_averages():
        us = _kernel_time_us(evt)
        if us > 0:
            k = kernels.setdefault(evt.key, [0, 0.0])
            k[0] += evt.count
            k[1] += us
        elif evt.key in LAUNCH_CALLS:
            host[evt.key] += evt.count
    busy_ms = sum(us for _, us in kernels.values()) / 1e3 / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share_unprofiled": 1.0 - busy_ms / wall_ms,
        "device_idle_share_profiled": 1.0 - busy_ms * steps / profiled_wall_ms,
        "profiled_step_wall_ms": profiled_wall_ms / steps,
        "device_kernels_per_step": sum(c for c, _ in kernels.values()) / steps,
        "host_launches_per_step": sum(host.values()) / steps,
        "graph_launches_per_step": host["cudaGraphLaunch"] / steps,
        "host_launch_calls": {k: v / steps for k, v in sorted(host.items())},
        "top_kernels_per_step": [
            {"name": name[:90], "launches": c / steps, "device_us": us / steps} for name, (c, us) in top
        ],
    }


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
    """The ATen operations (views aside) one eager decode step dispatches
    inside the sampling tail and inside `RowStreams.uniform`."""
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
        with counter, torch.inference_mode():
            st = {k: getattr(engine, k) for k in engine_module._CHUNK_STATE}
            engine._decode_step(dict(st, counters=engine.counters.long()), engine.seeds.long())
        torch.cuda.synchronize()
    finally:
        sampling.RowStreams.uniform, engine_module.sample_head_draws = uniform, draws
    return {f"{k}_ops_per_step": counter.counts[k] for k in ("sample_head_draws", "rng_uniform")}


def engine_kw(greedy: bool, kv_cache_dtype: str, dispatch_depth: int, cuda_graph: bool) -> dict:
    return dict(n_slots=N_SLOTS, max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16, greedy=greedy,
                kv_cache_dtype=kv_cache_dtype, dispatch_depth=dispatch_depth, cuda_graph=cuda_graph)  # fmt: skip


def filled_engine(model, config, prompts, **kw):
    """The 32-slot engine with every slot admitted (budgets of 64 events)."""
    engine = GenerationEngine(model, config, template=prompts[0][0], **kw)
    for i, (p, _) in enumerate(prompts):
        engine.submit(Request(prompt=p, max_new_events=64, request_id=i))
    engine.plan_and_dispatch()
    if engine.occupied != N_SLOTS:
        raise RuntimeError(f"expected {N_SLOTS} admitted requests, got {engine.occupied}")
    return engine


def chunk_ms(engine) -> float:
    """Wall time of one chunk issued and its boundary resolved (accounting
    only: a step's time is the decode chunk's; extraction is timed apart)."""
    t0 = time.perf_counter()
    engine.issue_chunk()
    engine.resolve_chunk(0.0, fetch_results=False)
    return (time.perf_counter() - t0) * 1e3


def program_run(model, config, prompts, kw) -> dict:
    """One fresh filled engine: a warm-up chunk and `TIMED_CHUNKS` timed
    chunks; the engine is returned with one chunk of every slot's budget
    left, for `profiled_chunk`."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    engine = filled_engine(model, config, prompts, **kw)
    chunk_ms(engine)
    walls = [chunk_ms(engine) / engine.decode_chunk for _ in range(TIMED_CHUNKS)]
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - before) / 1e9  # above what earlier engines hold
    return dict(walls=walls, engine=engine, peak_memory_gb=peak)


def profiled_chunk(engine) -> tuple:
    """One chunk of ``engine`` under ``torch.profiler``: ``(profile, wall ms, active slots)``.
    Every capture is made before the first profile: a capture after one
    was seen to fail on the card."""
    active = int((engine.live & ~engine.done).sum())
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = chunk_ms(engine)
        torch.cuda.synchronize()
    return prof, wall, active


def chunk_loop_step_ms(model, config, prompts, kw) -> float:
    """Wall time a decode step of `LOOP_CHUNKS` chunks issued and resolved as
    `GenerationEngine.run` does (``kw["dispatch_depth"]`` in flight), on a
    fresh filled engine after one warm-up chunk; no slot finishes in that span."""
    engine = filled_engine(model, config, prompts, **kw)
    chunk_ms(engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOOP_CHUNKS):
        engine.issue_chunk()
        if engine.inflight_chunks >= kw["dispatch_depth"]:
            engine.resolve_chunk(0.0, fetch_results=False)
    while engine.inflight_chunks:
        engine.resolve_chunk(0.0, fetch_results=False)
    wall = time.perf_counter() - t0
    return wall * 1e3 / (LOOP_CHUNKS * engine.decode_chunk)


def serve_run(model, config, kw) -> dict:
    """`GenerationEngine.run` on 64 requests, end to end (module docstring):
    the engine warmed by one run of them (every program captured), reset,
    and the second run timed."""
    prompts = synthetic_prompts(np.random.default_rng(0), 64, serving_config(), (128, 192), (16, 64))

    def requests():
        return [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]

    eng = GenerationEngine(model, config, template=prompts[0][0], **kw)
    eng.run(requests())
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    generated = sum(r.n_generated for r in results)
    if any(r.error is not None for r in results):
        raise RuntimeError("profile_decode: a request failed")
    stats = eng.stats()
    return {"generated": generated, "wall_s": wall, "generated_per_s": generated / wall,
            "dispatched_chunks": stats["dispatched_chunks"], "graph_replays": stats["graph_replays"],
            "wasted_decode_frac": stats["wasted_decode_frac"]}  # fmt: skip


def timed_mode(model, config, prompts, greedy: bool, kv_cache_dtype: str, depths) -> tuple:
    """Every timing of one mode (no profiler): ``(result, runs)``; `profiled_mode`
    adds the profiles to ``result`` from ``runs``' engines."""
    runs = collections.defaultdict(list)
    for name in ORDER:
        runs[name].append(program_run(model, config, prompts, engine_kw(greedy, kv_cache_dtype, 2, PROGRAMS[name])))
    result = {"mode": "greedy" if greedy else "sampled", "kv_cache_dtype": kv_cache_dtype}
    for depth in depths:
        loop, serve = collections.defaultdict(list), collections.defaultdict(list)
        for name in ORDER:
            kw = engine_kw(greedy, kv_cache_dtype, depth, PROGRAMS[name])
            loop[name].append(chunk_loop_step_ms(model, config, prompts, kw))
            serve[name].append(serve_run(model, config, kw))
        result[f"depth_{depth}"] = {
            name: {"chunk_loop_step_wall_ms": loop[name], "run_64_requests": serve[name]} for name in PROGRAMS
        }
    return result, runs


def profiled_mode(result: dict, runs) -> dict:
    """``result`` with each program's step walls, profile of one more chunk
    of its last run's engine, peak memory, and the eager step's sampling ops."""
    programs = {}
    for name, rs in runs.items():
        walls = [w for r in rs for w in r["walls"]]
        wall = float(np.median(walls))
        engine = rs[-1]["engine"]
        prof, profiled_ms, active = profiled_chunk(engine)
        programs[name] = {
            "step_wall_ms_median": wall,
            "step_wall_ms_min": float(np.min(walls)),
            "step_wall_ms_runs": walls,
            **profile_summary(prof, engine.decode_chunk, wall, profiled_ms),
            "peak_memory_gb": max(r["peak_memory_gb"] for r in rs),
            "active_slots": active,
        }
    programs["eager"].update(sampling_ops(runs["eager"][-1]["engine"]))
    return dict(result, programs=programs)


SPLIT_PARTS = {"plan_and_dispatch": "prefill_and_admission_ms", "issue_chunk": "chunk_issue_ms",
               "resolve_chunk": "resolve_and_harvest_ms"}  # fmt: skip


def split_run(engine, requests, fetch_results: bool) -> dict:
    """One `GenerationEngine.run` of ``requests``: its wall and the host time
    spent in each of `SPLIT_PARTS` (ms)."""
    spent = collections.Counter()

    def timed(name):
        fn = getattr(engine, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0

        return wrapper

    for name in SPLIT_PARTS:
        setattr(engine, name, timed(name))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run(requests, fetch_results=fetch_results)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name in SPLIT_PARTS:
            delattr(engine, name)
    if any(r.error is not None for r in results):
        raise RuntimeError("profile_decode: a request failed")
    generated = sum(r.n_generated for r in results)
    stats = engine.stats()
    out = {"wall_ms": wall * 1e3, "generated": generated, "generated_per_s": generated / wall,
           **{part: spent[name] * 1e3 for name, part in SPLIT_PARTS.items()}}  # fmt: skip
    out["rest_of_loop_ms"] = out["wall_ms"] - sum(out[p] for p in SPLIT_PARTS.values())
    out.update({k: stats[k] for k in ("dispatched_chunks", "prefill_dispatches", "wasted_decode_frac")})
    return out


def split_engine(model, config, prompts, kw) -> dict:
    """A fresh engine: one warm run of ``prompts``, ``reset()``, a timed run
    fetching results, ``reset()``, a timed run with ``fetch_results=False``;
    the engine's peak device memory and program counts."""

    def requests():
        return [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    engine = GenerationEngine(model, config, template=prompts[0][0], **kw)
    engine.run(requests())
    out = {}
    for fetch in (True, False):
        engine.reset()
        out["fetching" if fetch else "accounting"] = split_run(engine, requests(), fetch)
    engine.reset()
    torch.cuda.synchronize()
    out["peak_memory_gb"] = (torch.cuda.max_memory_allocated() - before) / 1e9  # above what was held before it
    out["programs"] = engine.program_stats()
    return out, engine


def profiled_programs(engine) -> dict:
    """One replay of each prefill and extraction program of ``engine`` under
    ``torch.profiler``: its device time and kernels (every capture is made
    before the first profile)."""
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for kind, family in engine._families.items():
        for key, program in family.programs.items():
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                program.replay()
                torch.cuda.synchronize()
            kernels = [(evt.count, _kernel_time_us(evt)) for evt in prof.key_averages()]
            kernels = [(c, us) for c, us in kernels if us > 0]
            out[f"{kind} {key}"] = {"device_ms": sum(us for _, us in kernels) / 1e3,
                                    "kernels": sum(c for c, _ in kernels)}  # fmt: skip
    engine.reset()
    return out


def run_split(model, config, depths) -> dict:
    """The ``--run-split`` measurements (module docstring)."""
    prompts = synthetic_prompts(np.random.default_rng(0), 64, serving_config(), (128, 192), (16, 64))
    out, keep = [], {}
    for greedy in (True, False):
        for depth in depths:
            runs = collections.defaultdict(list)
            for name in ORDER:
                kw = engine_kw(greedy, "bf16", depth, PROGRAMS[name])
                result, engine = split_engine(model, config, prompts, kw)
                runs[name].append(result)
                if PROGRAMS[name] and depth == depths[0]:
                    keep[greedy] = engine
            out.append({"mode": "greedy" if greedy else "sampled", "dispatch_depth": depth, **runs})
    programs = {("greedy" if g else "sampled"): profiled_programs(e) for g, e in keep.items()}
    return {"runs": out, "program_device_time": programs}


def spec_config(model, config, k: int = SPEC_K) -> SpecConfig:
    """``bench.py``'s draft: the target's first ``num_hidden_layers // 2`` layers."""
    dcfg, draft = truncated_draft(config, model, config.num_hidden_layers // 2)
    return SpecConfig(model=draft, config=dcfg, k=k)


def capture_spec_parts(engine) -> dict:
    """The filled spec engine's round split into programs of their own, on
    its state as it stands (nothing copied back, so each replay starts from
    the same cursors): ``draft``, the ``k`` draft steps (`_spec_draft`), and
    ``round``, the whole round (`_spec_round`), each warmed up and captured;
    an NA engine's also ``draft_verify``, the draft chunk, the window forward
    and the per-level accept walk (`_spec_draft_na`, `_spec_verify_na`), so
    the round's correction walk and commit are a part of their own. Call
    before any ``torch.profiler`` session."""
    st = {k: getattr(engine, k) for k in engine_module._SPEC_STATE}
    seeds, active = engine.seeds.long(), engine.live & ~engine.done
    if engine._na:
        fns = {"draft": lambda: engine._spec_draft_na(st, seeds, active),
               "draft_verify": lambda: engine._spec_verify_na(st, seeds, active,
                                                              engine._spec_draft_na(st, seeds, active)[0]),
               "round": lambda: engine._spec_round_na(st, seeds)}  # fmt: skip
    else:
        fns = {"draft": lambda: engine._spec_draft(st, seeds, active), "round": lambda: engine._spec_round(st, seeds)}
    programs = {}
    with torch.inference_mode():
        for name, fn in fns.items():
            programs[name] = CapturedProgram(fn, f"the spec {name}", device=engine.device)
            programs[name].warmup()
            programs[name].capture()
    return programs


def spec_parts(programs: dict) -> dict:
    """Device ms a replay (CUDA events) and kernels a replay (one profiled
    replay) of each `capture_spec_parts` program; ``verify``: the round less
    the draft steps (the window forward, accept walk, commit and advance);
    an NA engine's ``verify`` is the window forward and the accept walk
    alone and ``commit`` the round less the draft and the verify (the
    correction walk, the commit and the advance)."""
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, program in programs.items():
        ms = time_ms(program.graph.replay, n=4)["ms"]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            program.graph.replay()
            torch.cuda.synchronize()
        kernels = [(evt.count, _kernel_time_us(evt)) for evt in prof.key_averages()]
        out[name] = {"device_ms": ms, "kernels": sum(c for c, us in kernels if us > 0),
                     "profiled_device_ms": sum(us for _, us in kernels) / 1e3}  # fmt: skip
    if "draft_verify" in out:
        draft_verify = out.pop("draft_verify")
        out["verify"] = {k: draft_verify[k] - out["draft"][k] for k in out["round"]}
        out["commit"] = {k: out["round"][k] - draft_verify[k] for k in out["round"]}
    else:
        out["verify"] = {k: out["round"][k] - out["draft"][k] for k in out["round"]}
    return out


def profiled_engine_chunk(engine) -> dict:
    """The step (or round) wall of two chunks (the faster), then one profiled
    chunk (`profile_summary`); spec engines also give the events each round
    committed a slot, over the profiled chunk's active slots."""
    chunk_ms(engine)
    wall = min(chunk_ms(engine), chunk_ms(engine)) / engine.decode_chunk
    cursor = engine.cursor.clone()
    prof, profiled_wall, active = profiled_chunk(engine)
    out = dict(step_wall_ms=wall, active_slots=active, **profile_summary(prof, engine.decode_chunk, wall, profiled_wall))
    if engine.spec is not None:
        committed = int((engine.cursor - cursor).sum())
        out["committed_events_per_round_and_slot"] = committed / (engine.decode_chunk * max(active, 1))
    return out


def spec_profiles(model, config, prompts) -> dict:
    """The ``--spec`` measurements (module docstring)."""
    kw = engine_kw(False, "bf16", 1, True)
    engines = {
        "spec": filled_engine(model, config, prompts, spec=spec_config(model, config), **kw),
        "unfused": filled_engine(model, config, prompts, decode_step_impl="xla", **kw),
        "kernel B": filled_engine(model, config, prompts, **kw),
    }
    parts = spec_parts(capture_spec_parts(engines["spec"]))  # on the admitted state, after every capture
    out = {name: profiled_engine_chunk(engine) for name, engine in engines.items()}
    out["spec_round_parts"] = parts
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--kv-cache-dtype", default="bf16", choices=("bf16", "int8", "fp8"))
    ap.add_argument("--dispatch-depths", default="1,2", help="comma-separated dispatch depths of the chunk loop and run")
    ap.add_argument("--run-split", action="store_true", help="time whole runs split into their parts instead")
    ap.add_argument("--spec", action="store_true", help="profile the speculative round beside the decode steps")
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
    depths = [int(d) for d in args.dispatch_depths.split(",")]
    if args.run_split:
        # phase 2's model of chip_smoke.py: the log-time statistics of its 64 prompts
        mean_log, std_log = log_time_stats(
            synthetic_prompts(np.random.default_rng(0), 64, serving_config(), (128, 192), (16, 64))
        )
        rconfig = serving_config(mean_log=mean_log, std_log=std_log)
        rmodel = init_params_from_seed(CIPPTForGenerativeSequenceModeling(rconfig), seed=0)
        out = {"card": smi, "run_split": run_split(rmodel, rconfig, depths)}
    elif args.spec:
        out = {"card": smi, "spec": spec_profiles(model, config, prompts)}
    else:
        timed = [timed_mode(model, config, prompts, greedy, args.kv_cache_dtype, depths) for greedy in (True, False)]
        out = {"card": smi, "modes": [profiled_mode(result, runs) for result, runs in timed]}
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
