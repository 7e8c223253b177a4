#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``eventstreamgpt_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (a failed phase exits non-zero; nothing is caught and passed over):

1. Device: the card's name and power limit (``nvidia-smi``), TF32 off, the
   kernels built from the checkout's sources (one ``nvcc`` per ``csrc/``
   source, all at once).
2. Engine at full width: the serving benchmark's CI model (hidden 256,
   4 heads x 64, 2 layers local/global with window 32, intermediate 1024,
   lognormal-mixture TTE with 3 components, bf16, a 4,057-entry vocabulary
   laid out as ``data/synthetic.py`` writes it) with numpy-seeded random
   weights behind `GenerationEngine` (32 slots, ``max_len`` 256, prompts up to
   192 events, buckets from 32, chunks of 16), serving 64 requests with
   prompts of 128-192 events and budgets of 16-64 new events, once greedy
   and once sampled. Each engine serves them three times, as a benchmark
   times an engine: a warm pass, ``reset()``, a pass that fetches every
   row, ``reset()``, and a pass with ``fetch_results=False`` (its events/s
   are the ones a throughput benchmark reads). The engine captures its
   decode chunk at construction (one warm-up chunk run eagerly, then the
   capture), each prefill (bucket, group width) key and each extraction
   width at its first use in the warm pass (one warm-up on inert rows, then
   the capture), and replays them: one capture a key, none after
   ``reset()``, one decode replay a dispatched chunk and one prefill replay
   a prefill dispatch. Every request must finish without error, with
   ``n_events == prompt_len + n_generated`` and finite outputs; the passes
   after ``reset()`` give the warm pass's events, integers and floats bit for
   bit (the accounting pass no rows and the same accounting). Both kernels'
   launch counters, set to 0 before the engine is built and before each
   later pass and counting through the replays, must move (kernel A, which
   the engine calls as `fused_categorical_stream`, only samples); kernel B
   launches once a decode step run, warm-up chunk included; kernel A
   launches as often as in the eager engine, plus the warm-ups. The same
   engine with ``cuda_graph=False`` (every program run eagerly) must give
   every request's events, integers and floats bit for bit in every pass
   (the same kernels on the same inputs in the same order); the wall time,
   a chunk, a step and events/s of both are printed, with
   ``slots_report()`` at the card's memory. A small fp32 greedy engine on
   the card whose groups are padded (group sizes 4 and 8 at 8 slots) must
   also match the same engine on the CPU (plain PyTorch versions of the
   kernels).
3. Kernels against their plain versions, on the card, on inputs captured
   from the eager sampled run's first decode step (the logits, the stream's seeds,
   counters and draw salt, keep and active): kernel A's noise bit for bit
   ``gumbel(stream).to(dtype)`` (at the captured shape and on a 4,096 x
   4,057 plane), and the indices of both its entries (noise drawn inside,
   noise given) exactly equal to their plain versions' (fp32 and bf16, with
   and without keep and active masks; then 4,096 rows of fresh seeds and
   counters at V = 40 and 4,057 with NaN, +inf and all--inf rows). Kernel A
   is timed with the noise drawn inside beside its plain version (the ATen
   noise and the reference), ``torch.argmax`` of the given noise plus the
   logits, the ATen ``gumbel(stream)`` alone (what the kernel replaces) and
   the launch floor (an empty kernel, timed the same way); kernel
   B's ``h`` within rtol=atol=1e-4 in fp32 and atol=2e-2 in bf16, cache
   positions other than the cursor bit-equal, the cursor entries within the
   same tolerances, mask and length exact; B's cluster shape and CTAs.
3b. The quantized decode cache: phase 2's model and 64 requests served with
   ``kv_cache_dtype`` "int8" and then "fp8", greedy and sampled, at
   ``dispatch_depth=2``, in three passes each as in phase 2, on the captured
   programs (every request finishes with
   ``n_events == prompt_len + n_generated`` and finite outputs; kernel B's
   quantized launch counter for that dtype and, sampling, kernel A's counter
   move; the float entry never launches; kernel B launches once a decode step
   run; the captures and replays of phase 2; each pass after ``reset()``
   equal to the warm pass). Each sampled run is repeated with the eager
   programs and must give the same events, integers and floats bit for bit,
   and kernel A's launches as in phase 2. A small fp32 int8 engine on the card must
   match the same engine on the CPU (events and integers exact, floats within
   2e-2, the JAX package's quantized-cache tolerance). Quantized
   B against its plain version on the inputs captured from each sampled
   eager run's first decode step, fp32 and bf16: codes and scales off the cursor
   bit-equal, the dequantized cursor keys and values within phase 3's
   tolerances (of each row's largest) plus one quantisation step, ``h``
   within phase 3's tolerance
   on the rows whose cursor codes agree (a key one rounding apart can move
   a code by a step), mask and length exact. Printed, not checked: quantized
   B's time beside the bf16 B on the same rows (dequantized), its bound and
   its plain version's; the share of greedy requests whose events equal the
   bf16 run's; ``slots_report()`` at the card's own memory (int8 and fp8).
4. Training at full width: the same model with dropout 0.1 and fp32 master
   weights, AdamW with warmup (``bench.py``'s optimizer settings), 20 train
   steps through `make_train_step` on one fixed synthetic batch of 32
   subjects x 256 events (up to 24 data elements an event): the first step
   eager (its warm-up), the second captured, and that and every later step
   one replay. Every loss is finite, the loss falls from step 1 to step 20,
   and kernel C's forward and backward each launch exactly once a step,
   counted through the replays. 20 steps of the same model with
   ``cuda_graph=False`` must give the first 5 losses and ``[loss, grad
   norm]`` vectors bit for bit (a difference would mean the dropout stream
   or the learning rate went wrong under capture). Median step time and
   trained events/s (real events a step over the step time), captured and
   eager. A small fp32
   train step on the card must also match the same step on the CPU (loss
   and every gradient within 1e-4, dropout 0).
5. Kernel C against its plain version, on the card, on the regression
   plane, indices and cotangent captured from phase 4's first step, in bf16 and
   fp32: forward bit-exact; backward within one bf16 ulp (fp32: rtol 1e-6,
   atol 1e-6 of the largest cotangent), the plain version summing
   duplicates with atomics in no fixed order; the kernel's backward also
   equals the CPU's plain version (ordered sums) bit for bit. The backward's
   write rate of the plane beside its bound, the forward beside the launch
   floor.
6. Nested-attention training at full width: ``bench.py``'s NA model (the
   phase-4 widths with three dep-graph levels ``[[], ["event_type"], ["lab",
   "med"]]``, global dep-graph attention, bare sequence attention and a full
   dep-graph block) with dropout 0.1, 20 train steps through
   `make_train_step(build_model(...))` on the phase-4 batch. Every loss and
   gradient norm is finite, the loss falls from step 1 to step 20, kernel D's
   forward and backward each launch ``num_hidden_layers`` times a step and
   kernel C's once a step; captured and compared with the eager step as in
   phase 4. Median step time and trained events/s. A small
   fp32 NA train step on the card must also match the CPU's (loss and every
   gradient within 1e-4, dropout 0; hidden 32, one head of 32), and at hidden
   128 (4 heads of 32) the same step with kernels C and D must match the
   step with their plain versions on the card (loss within 1e-5, every
   gradient within 2e-5 of its tensor's largest magnitude).
7. Kernel D against its plain version, on the card, on the query (as the
   ``[:, 1:]`` view the model passes), key, value, keep-mask and output
   cotangent (scaled to a largest magnitude of 1) captured from phase 6's
   first step, in bf16 and fp32, with and without the keep-mask: forward and
   backward within 1e-5 of the largest magnitude in fp32; in bf16 within
   1e-2 of it, and the output also within 2e-2 absolute. Timed in bf16 with the
   keep-mask beside its bound, its plain version (autograd for the
   backward) and ``scaled_dot_product_attention`` with the same graph mask
   and no dropout (a yardstick only: it takes no external keep-mask).
8. Packed long-context training at full width: ``bench.py``'s packed model
   (the phase-4 widths under ``attention_implementation="pallas_flash"`` with
   attention dropout 0, input and residual dropout 0.1) on its packed batch:
   the first of ``packed_batches(synthetic_csr(seed 0, 512 subjects), 8,
   seq_len=1024, seed=1)``. 20 steps with the benchmark's local window of 32
   (the global layer on kernel E, the local one on the band product): kernel
   E and kernel C each launch once a step each way, kernel F never. Then 10
   steps with a local window of 256: kernels E and F each launch once a step
   each way. Every loss is finite and falls; each run captured and compared
   with the eager step as in phase 4. Small fp32 packed steps on the
   card must match the CPU's (hidden 32, one head of 32, windows 32 and 160,
   within 1e-4; both given the same float64-derived event time), and at
   hidden 128 (4 heads of 32, window 160) the step with kernels C, E and F
   must match the step with their plain versions on the card (loss within
   1e-5, every gradient within 2e-5 of its tensor's largest).
9. Kernels E and F against their plain versions, on the card, on the query,
   key, value, segment ids and output cotangent (scaled to a largest
   magnitude of 1) captured from a phase-8 run's first step (E from the window-32 run,
   F from the window-256 run), in fp32 (within 3e-5 of each tensor's
   largest) and bf16 (within 5e-2 of it: the kernel takes ``di`` from the
   rounded output, as the TPU kernels do), each version's distance from the
   function computed in fp64 printed beside; then timed in bf16 beside their
   bound (bytes of q, k, v, o, segment ids and each row's softmax statistics,
   plus do, dq, dk, dv backward; FLOPs of the batch's allowed pairs), their plain
   versions and ``scaled_dot_product_attention`` with the same boolean mask.
   Beside: the 64 x 64 tiles each kernel walked (forward, dq, dk/dv), counted
   on the card and held equal to what `tile_schedule` visits, on the batch
   and with one segment a row (every causal tile), their share of the causal
   (and window) tiles (``visited_share``), and each kernel's time on the same
   q, k, v with one segment a row, where no tile is skipped.
10. One ``{"kernels": [...]}`` line, then the device line as the last line.

Timing: each kernel, its plain version and the nearest single PyTorch call
are timed by CUDA events around N back-to-back launches queued behind a
device-side sleep, so the device runs them without waiting on the host
(``ms``, per launch, median of 5); the time of one synchronised call, host
work included, is printed beside it.

It exits non-zero, printing no result, when no CUDA device is available or
when the repository is not beside it.
"""

from __future__ import annotations

import copy
import functools
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense tensor-core bf16; fp32 outside the tensor cores
N_REQUESTS, SEED = 64, 0
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, EQUAL_STEPS = 32, 256, 20, 5
PACKED_BATCH, PACKED_SEQ, WIDE_WINDOW, WIDE_STEPS = 8, 1024, 256, 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------- phase 1
def device_phase():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from eventstreamgpt_tpu_torch.ops import (
        build,
        decode_step,
        dep_graph,
        flash_attention,
        fused_sampling,
        vocab_gather,
    )

    t0 = time.perf_counter()
    errors = []
    sources = [fused_sampling.SOURCE, decode_step.SOURCE, vocab_gather.SOURCE, dep_graph.SOURCE, flash_attention.SOURCE]
    nvcc = threading.Thread(target=lambda: errors.extend(_try(build.build_all, sources)))
    nvcc.start()
    torch.zeros(1, device="cuda")  # the CUDA context, while nvcc runs
    nvcc.join()
    if errors:
        raise errors[0]
    for source in sources:
        build.load_library(source)
    torch.cuda.synchronize()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    return smi


def _try(fn, *args):
    try:
        fn(*args)
        return []
    except Exception as e:  # re-raised by the caller's thread
        return [e]


# ---------------------------------------------------------------- phase 2
def check_results(results, requests, label):
    import torch

    check(len(results) == len(requests), f"{label}: {len(results)} results for {len(requests)} requests")
    for r in results:
        check(r.error is None, f"{label}: request {r.request_id} failed: {r.error!r}")
        check(r.n_events == r.prompt_len + r.n_generated, f"{label}: request {r.request_id} accounting")
        b = r.batch
        check(b.event_mask.shape == (1, r.n_events), f"{label}: request {r.request_id} shape {tuple(b.event_mask.shape)}")
        for f in ("time_delta", "dynamic_values", "start_time"):
            check(bool(torch.isfinite(getattr(b, f)).all()), f"{label}: request {r.request_id} non-finite {f}")


class Capture:
    """Wraps the engine's two kernel entry points to keep the inputs of the
    first call made while ``armed`` (cloned before the in-place cache write;
    for kernel A the stream's seeds, counters and the salt of the draw)."""

    def __init__(self, engine_module):
        self.mod, self.armed, self.a, self.b = engine_module, False, None, None
        self.orig_a, self.orig_b = engine_module.fused_categorical_stream, engine_module.decode_stack_step

        def a(logits, stream, keep=None, active=None, fill=0):
            if self.armed and self.a is None and active is not None:  # a decode step, not a prefill
                self.a = dict(logits=logits.clone(), seeds=stream.seeds.clone(), counters=stream.counters.clone(),
                              salt=copy.copy(stream).next_draw_salt(), keep=keep, active=active.clone())  # fmt: skip
            return self.orig_a(logits, stream, keep, active, fill)

        def b(weights, kc, vc, h0, start, em, mask, **kw):
            if self.armed and self.b is None:
                kept = {k: v.clone() if k.endswith("_scale") and v is not None else v for k, v in kw.items()}
                self.b = dict(weights=weights, kc=kc.clone(), vc=vc.clone(), h0=h0.clone(), start=start.clone(),
                              em=em.clone(), mask=mask.clone(), kw=kept)  # fmt: skip
            return self.orig_b(weights, kc, vc, h0, start, em, mask, **kw)

        engine_module.fused_categorical_stream, engine_module.decode_stack_step = a, b

    def restore(self):
        self.mod.fused_categorical_stream, self.mod.decode_stack_step = self.orig_a, self.orig_b


PASSES = ("warm", "fetching", "accounting")


def engine_run(model, config, prompts, counters, **engine_kw):
    """One engine built and run three times on ``prompts`` (64 requests), as
    a benchmark warms, resets and times an engine: pass 1 (``warm``) captures
    every program key the schedule touches; ``reset()``; pass 2
    (``fetching``) fetches every finished row; ``reset()``; pass 3
    (``accounting``) runs with ``fetch_results=False``. Every counter in
    ``counters`` (``name -> (wrapper, attribute)``) is set to 0 just before
    the engine is built (its warm-up and capture included) and before each
    later pass, and read just after each pass. Returns the engine and, per
    pass, its results, wall time, launches and the engine's stats;
    ``results``, ``wall_s`` and ``stats`` of pass 1 at the top, ``launches``
    summed over the passes."""
    import torch

    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    def zero():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    zero()
    engine = GenerationEngine(model, config, template=prompts[0][0], **engine_kw)
    passes = {}
    for name in PASSES:
        if name != "warm":
            engine.reset()
            zero()
        reqs = [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run(reqs, fetch_results=name != "accounting")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        passes[name] = dict(results=results, requests=reqs, wall_s=wall, launches=launches, stats=engine.stats())
    warm = passes["warm"]
    total = {k: sum(p["launches"][k] for p in passes.values()) for k in counters}
    return dict(warm, launches=total, passes=passes, engine=engine)


def check_graph_counts(run, label, counter):
    """The captured engine's programs: the decode chunk captured once with
    one warm-up chunk and replayed once a dispatched chunk, kernel B's
    ``counter`` counting every decode step run through the replays (warm-up
    included); one prefill capture (after one warm-up) a (bucket, group)
    key and one extraction capture a group width, all in the warm pass, one
    prefill replay a prefill dispatch; nothing captured after ``reset()``."""
    warm = run["passes"]["warm"]["stats"]
    check(warm["cuda_graph"] and warm["graph_captures"] == 1 and warm["graph_warmup_chunks"] == 1,
          f"{label}: the decode chunk was not captured once: {warm}")  # fmt: skip
    check(warm["prefill_graph_captures"] == warm["prefill_graph_warmups"] == warm["prefill_graph_keys"] > 0,
          f"{label}: not one prefill capture a key: {warm}")  # fmt: skip
    check(warm["extract_graph_captures"] == warm["extract_graph_keys"] > 0,
          f"{label}: not one extraction capture a width: {warm}")  # fmt: skip
    before = dict.fromkeys(("graph_replays", "prefill_graph_replays"), 0)
    for name in PASSES:
        p = run["passes"][name]
        s = p["stats"]
        for k in ("graph_captures", "prefill_graph_captures", "extract_graph_captures", "prefill_graph_keys"):
            check(s[k] == warm[k], f"{label} [{name} pass]: {k} {s[k]} after the warm pass's {warm[k]}")
        check(s["graph_replays"] - before["graph_replays"] == s["dispatched_chunks"] > 0,
              f"{label} [{name} pass]: {s['graph_replays']} chunk replays for {s['dispatched_chunks']} chunks")  # fmt: skip
        check(s["prefill_graph_replays"] - before["prefill_graph_replays"] == s["prefill_dispatches"] > 0,
              f"{label} [{name} pass]: {s['prefill_graph_replays']} prefill replays for {s['prefill_dispatches']} "
              "prefill dispatches")  # fmt: skip
        before = {k: s[k] for k in before}
        steps = (s["dispatched_chunks"] + (s["graph_warmup_chunks"] if name == "warm" else 0)) * s["decode_chunk"]
        check(p["launches"][counter] == steps,
              f"{label} [{name} pass]: kernel B launched {p['launches'][counter]} times for {steps} decode steps run")
    acct, fetching = (run["passes"][k]["stats"]["extract_graph_replays"] for k in ("accounting", "fetching"))
    check(acct == fetching, f"{label}: the accounting pass extracted rows")


def check_eager_counts(run, label, counter, sampled):
    """The eager engine's kernel B launches once a decode step run, and kernel
    A, sampling, once a categorical head a prefill row group and a step."""
    for name in PASSES:
        p = run["passes"][name]
        s = p["stats"]
        check(not s["cuda_graph"] and s["prefill_graph_captures"] == 0, f"{label}: the eager engine captured")
        check(p["launches"][counter] == s["dispatched_chunks"] * s["decode_chunk"],
              f"{label} [{name} pass]: the eager engine's kernel B launches {p['launches']}")  # fmt: skip
        calls = s["prefill_dispatches"] + s["dispatched_chunks"] * s["decode_chunk"]
        a = p["launches"]["fused_categorical_stream"]
        check((a > 0 and a % calls == 0) if sampled else a == 0,
              f"{label} [{name} pass]: kernel A launched {a} times for {calls} prefills and steps")  # fmt: skip


def kernel_a_through_replays(captured, eager, label):
    """Kernel A counted through the captured programs' replays as eager: the
    same launches in the passes after ``reset()`` (no warm-up runs there), and
    in the warm pass the eager count plus the warm-up chunk's and each
    prefill key's warm-up."""
    for name in PASSES[1:]:
        a, b = (r["passes"][name]["launches"]["fused_categorical_stream"] for r in (captured, eager))
        check(a == b, f"{label} [{name} pass]: kernel A launched {a} times captured, {b} eager")
    s, e = captured["passes"]["warm"]["stats"], eager["passes"]["warm"]["stats"]
    per_call = eager["passes"]["warm"]["launches"]["fused_categorical_stream"] // (
        e["prefill_dispatches"] + e["dispatched_chunks"] * e["decode_chunk"])  # fmt: skip
    want = per_call * (s["prefill_dispatches"] + s["prefill_graph_warmups"]
                       + (s["dispatched_chunks"] + s["graph_warmup_chunks"]) * s["decode_chunk"])  # fmt: skip
    got = captured["passes"]["warm"]["launches"]["fused_categorical_stream"]
    check(got == want, f"{label} [warm pass]: kernel A launched {got} times captured, {want} expected")
    return per_call


def same_results(a_results, b_results, label, what="captured vs eager"):
    """Every request's events, integers and floats equal in two runs, bit for
    bit (NaN where NaN): the same kernels on the same inputs in the same
    order. On a difference, fails with the largest gap of each float field."""
    import torch

    gaps = {}
    check(len(a_results) == len(b_results), f"{label}: {len(a_results)} results against {len(b_results)}")
    for a, b in zip(a_results, b_results):
        check(a.request_id == b.request_id, f"{label}: results in another order")
        check((a.n_events, a.n_generated, a.prompt_len) == (b.n_events, b.n_generated, b.prompt_len),
              f"{label}: request {a.request_id} has {a.n_generated} events, {b.n_generated} ({what})")  # fmt: skip
        if a.batch is None and b.batch is None:  # accounting-only runs
            continue
        for k, t in vars(a.batch).items():
            if not torch.is_tensor(t):
                continue
            u = getattr(b.batch, k)
            if t.is_floating_point():
                if not torch.equal(t.nan_to_num(-7.0), u.nan_to_num(-7.0)):
                    gaps[k] = max(gaps.get(k, 0.0), (t - u).nan_to_num(0.0).abs().max().item())
            else:
                check(torch.equal(t, u), f"{label}: request {a.request_id}'s {k} differs ({what})")
    check(not gaps, f"{label}: floats differ ({what}); largest gaps {gaps}")


def check_passes(run, label):
    """The passes after ``reset()`` give the warm pass's results bit for bit;
    the accounting pass's results carry no rows and the same accounting."""
    passes = run["passes"]
    same_results(passes["warm"]["results"], passes["fetching"]["results"], label, "warm pass vs the pass after reset()")
    fetched, acct = passes["fetching"]["results"], passes["accounting"]["results"]
    check(len(acct) == len(fetched) and all(r.batch is None and r.error is None for r in acct),
          f"{label}: the accounting pass fetched rows or failed")  # fmt: skip
    for a, b in zip(fetched, acct):
        check((a.request_id, a.n_events, a.n_generated, a.prompt_len) == (b.request_id, b.n_events, b.n_generated,
              b.prompt_len), f"{label}: request {a.request_id}'s accounting differs in the accounting pass")  # fmt: skip


def same_as_eager(captured, eager, label):
    """The captured engine's results equal the eager engine's, bit for bit, in every pass."""
    for name in PASSES:
        same_results(captured["passes"][name]["results"], eager["passes"][name]["results"], f"{label} [{name} pass]")


def walls_line(captured, eager, generated) -> str:
    """Wall time of the timed passes, a chunk and a decode step, and events/s,
    captured beside eager: the accounting pass (``fetch_results=False``, the
    events/s a throughput benchmark reads) and the fetching pass; the warm
    pass's wall (captures included) beside."""
    parts = []
    for name, run in (("captured", captured), ("eager", eager)):
        acct, fetch = (run["passes"][k] for k in ("accounting", "fetching"))
        s = acct["stats"]
        chunk_ms = acct["wall_s"] * 1e3 / s["dispatched_chunks"]
        parts.append(f"{name} {generated / acct['wall_s']:.1f} events/s ({acct['wall_s']:.4f} s, {chunk_ms:.3f} ms a "
                     f"chunk, {chunk_ms / s['decode_chunk']:.3f} ms a step; fetching {generated / fetch['wall_s']:.1f} "
                     f"events/s in {fetch['wall_s']:.4f} s; warm pass {run['passes']['warm']['wall_s']:.3f} s)")  # fmt: skip
    return "; ".join(parts)


def programs_line(run) -> str:
    s = run["passes"]["accounting"]["stats"]
    return (f"prefill programs {s['prefill_graph_keys']} keys ({s['prefill_graph_captures']} captures, "
            f"{s['prefill_graph_replays']} replays over the three passes), extraction programs "
            f"{s['extract_graph_keys']} widths ({s['extract_graph_captures']} captures, {s['extract_graph_replays']} "
            f"replays), decode chunk {s['graph_captures']} capture, {s['graph_replays']} replays")  # fmt: skip


def engine_phase(smi):
    import numpy as np

    import eventstreamgpt_tpu_torch.serving.engine as engine_module
    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import log_time_stats, serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
    from eventstreamgpt_tpu_torch.ops.decode_step import decode_stack_step
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical, fused_categorical_stream
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    rng = np.random.default_rng(SEED)
    prompts = synthetic_prompts(rng, N_REQUESTS, serving_config(), (128, 192), (16, 64))
    mean_log, std_log = log_time_stats(prompts)
    config = serving_config(mean_log=mean_log, std_log=std_log)
    model = init_params_from_seed(CIPPTForGenerativeSequenceModeling(config), seed=SEED)
    capture = Capture(engine_module)
    engine_kw = dict(n_slots=32, max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16, seed=SEED)
    counters = {"decode_stack_step": (decode_stack_step, "launches"),
                "fused_categorical_stream": (fused_categorical_stream, "launches"),
                "fused_categorical": (fused_categorical, "launches")}  # fmt: skip

    # Warm-up (cuBLAS handles, allocator) on a few requests, not counted.
    requests = [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts[:4])]
    GenerationEngine(model, config, template=prompts[0][0], **engine_kw).run(requests)
    out = {}
    for mode in ("greedy", "sampled"):
        kw = dict(engine_kw, greedy=mode == "greedy")
        label = f"phase 2 [{mode}]"
        run = engine_run(model, config, prompts, counters, **kw)
        # The eager programs (``cuda_graph=False``) for comparison; kernel
        # inputs for phase 3 come from their first sampled decode step.
        capture.armed = mode == "sampled"
        eager = engine_run(model, config, prompts, counters, cuda_graph=False, **kw)
        capture.armed = False
        results, launches, stats = run["results"], run["launches"], run["stats"]
        check_results(results, run["requests"], mode)
        check(launches["decode_stack_step"] > 0, f"{mode}: the decode kernel was never launched")
        check(launches["fused_categorical"] == 0, f"{mode}: the engine launched kernel A with given noise")
        if mode == "sampled":
            check(launches["fused_categorical_stream"] > 0, "sampled: the sampling kernel was never launched")
        else:
            check(launches["fused_categorical_stream"] == 0, "greedy: the sampling kernel launched in greedy mode")
        check_graph_counts(run, label, "decode_stack_step")
        check_eager_counts(eager, label, "decode_stack_step", mode == "sampled")
        heads = kernel_a_through_replays(run, eager, label)
        check_passes(run, label)
        check_passes(eager, f"{label} eager")
        same_as_eager(run, eager, label)
        generated = sum(r.n_generated for r in results)
        out[mode] = dict(run, generated=generated, eager=eager)
        print(
            f"{label} {len(results)} requests, {generated} generated events, every event, integer and float equal "
            f"captured and eager and in each pass after reset(); {walls_line(run, eager, generated)}; "
            f"{programs_line(run)}; captured launches {launches} over three passes (warm pass "
            f"{run['passes']['warm']['launches']}; kernel A {heads} a prefill or step), dispatch_depth "
            f"{stats['dispatch_depth']}, wasted_decode_frac {stats['wasted_decode_frac']} ({smi})",
            flush=True,
        )  # fmt: skip
    print(f"phase 2: slots_report() at the card's memory (bf16 cache): {json.dumps(run['engine'].slots_report())} "
          f"({smi})", flush=True)  # fmt: skip
    capture.restore()
    check(capture.a is not None and capture.b is not None, "no decode-step inputs were captured")
    small_engine_matches_cpu()
    return model, config, capture, out


def small_engine_matches_cpu(**engine_kw):
    """The whole path on the card against the same engine on the CPU (plain
    versions of both kernels), fp32 greedy at a small size: a small
    vocabulary (few Bernoulli draws that float noise could tip over 0.5) and
    a narrow log-time scale (moderate times for the sinusoidal encoding).
    ``engine_kw`` go to both engines (``kv_cache_dtype``)."""
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    config = serving_config(precision="fp32", mean_log=1.0, std_log=0.1, sizes=(5, 8, 6, 3), hidden_size=32,
                            head_dim=8, intermediate_size=64, seq_window_size=4)  # fmt: skip
    # Weights of std ~ 1/sqrt(hidden): unit gain, so float noise is not amplified from event to event.
    model = init_params_from_seed(CIPPTForGenerativeSequenceModeling(config), seed=1, std=0.15)
    with torch.no_grad():  # a near-constant TTE head: inter-event times of about e^1 minutes
        model.output_layer.TTE_layer.proj.weight.mul_(0.02)
    prompts = synthetic_prompts(np.random.default_rng(1), 6, config, (6, 12), (4, 8))
    kw = dict(n_slots=8, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=4, greedy=True, **engine_kw)
    # A quantized cache: a key one rounding apart can move a code by a step,
    # and floats then agree to the JAX package's quantized-cache tolerance
    # (tests/test_kv_quant.py, 2e-2); float caches to 1e-4.
    float_tol, float_diff = (2e-2 if engine_kw.get("kv_cache_dtype") in QUANT_DTYPES else 1e-4), 0.0
    res = {}
    widths = []
    for dev in ("cuda", "cpu"):
        reqs = [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]
        engine = GenerationEngine(model, config, template=prompts[0][0], device=dev, **kw)
        engine.scheduler.group_sizes = (4, 8)  # groups of fewer than 4 requests padded to 4 rows
        dispatch = engine._dispatch_group
        engine._dispatch_group = lambda g, d=dispatch: (widths.append((dev, len(g.requests), g.group_size)), d(g))
        res[dev] = engine.run(reqs)
    padded = [(n, g) for dev, n, g in widths if dev == "cuda" and g > n]
    check(padded and padded == [(n, g) for dev, n, g in widths if dev == "cpu" and g > n],
          f"small engine: no padded group or not the same on both devices: {widths}")  # fmt: skip
    for g, c in zip(res["cuda"], res["cpu"]):
        check((g.n_events, g.n_generated) == (c.n_events, c.n_generated), f"small engine: request {g.request_id}")
        for f in ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask"):
            a, b = getattr(g.batch, f), getattr(c.batch, f)
            if not torch.equal(a, b):
                first = int((a != b).reshape(a.shape[0], a.shape[1], -1).any(-1)[0].nonzero()[0])
                td = (g.batch.time_delta - c.batch.time_delta)[0, :first].abs().max().item() if first else 0.0
                fail(f"small engine: {f} of request {g.request_id} differs from event {first} of "
                     f"{a.shape[1]} (prompt {g.prompt_len}); max |time_delta diff| before it {td:.3g}; "
                     f"card {a[0, first].tolist()} cpu {b[0, first].tolist()}")  # fmt: skip
        for f in ("time_delta", "dynamic_values"):
            a, b = getattr(g.batch, f), getattr(c.batch, f)
            float_diff = max(float_diff, (a - b).abs().max().item())
            torch.testing.assert_close(a, b, rtol=float_tol, atol=float_tol)
    print(f"phase 2: small fp32 greedy engine {engine_kw or ''} on the card matches the CPU engine, groups padded "
          f"(requests, rows) {padded}: events and integers exact, floats within {float_tol} (max |diff| "
          f"{float_diff:.3g})", flush=True)  # fmt: skip


# ---------------------------------------------------------------- phase 3
def timings(kernel, plain, library=None, **kw) -> dict:
    """``ms``/``plain_ms``/``library_ms`` and their single-call times (`time_ms`)."""
    from eventstreamgpt_tpu_torch.utils.timing import time_ms

    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        if fn is None:
            out[key], out[f"single_{key}"] = None, None
        else:
            t = time_ms(fn, **kw)
            out[key], out[f"single_{key}"] = t["ms"], t["single_ms"]
    return out


def fmt_times(t: dict) -> str:
    return ", ".join(
        f"{k} {t[k]:.4f} (one synchronised call {t['single_' + k]:.4f})" for k in ("ms", "plain_ms", "library_ms")
        if t[k] is not None
    )


# Kernel A's operations an element, each counted as one: the hash (key plus
# element, one mix32: 10), the uniform (shift, convert, add, multiply: 4), two
# logs and two negations, the cast to the logits' type, the add and its
# rounding, and the running max and index (3).
A_OPS_PER_ELEMENT = 24


def special_plane(rng, rows, V, dtype):
    """Normal logits (scale 3) with NaN, +inf, all--inf and all-equal rows, on the card."""
    import torch

    z = (rng.normal(size=(rows, V)) * 3).astype("float32")
    z[0::97, rng.integers(V)] = float("nan")
    z[1::97, rng.integers(V)] = float("inf")
    z[2::97] = -float("inf")
    z[3::97] = 1.0
    return torch.from_numpy(z).to(dtype).cuda()


def kernel_a_phase(capture):
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.distributions import gumbel
    from eventstreamgpt_tpu_torch.generation.sampling import RowStreams
    from eventstreamgpt_tpu_torch.ops.fused_sampling import (
        fused_categorical,
        fused_categorical_reference,
        fused_categorical_stream,
        gumbel_noise,
        launch_floor,
        topk_topp_mask,
    )
    from eventstreamgpt_tpu_torch.utils.timing import time_ms

    cap = capture.a
    logits, active = cap["logits"], cap["active"]
    rows, V = logits.shape

    def stream(seeds=cap["seeds"], counters=cap["counters"], salt=cap["salt"]):
        return RowStreams(seeds, counters, salt)  # its next draw is the captured one

    # The noise, bit for bit, at the captured shape and on a wide plane.
    rng = np.random.default_rng(SEED)
    wide = dict(seeds=torch.from_numpy(rng.integers(-(2**62), 2**62, size=4096)).cuda(),
                counters=torch.from_numpy(rng.integers(0, 2**40, size=4096)).cuda(), salt=12345)  # fmt: skip
    for kw, shape in ((dict(), (rows, V)), (wide, (4096, 4057))):
        for dt, bits in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
            got, want = gumbel_noise(stream(**kw), shape, dt), gumbel(stream(**kw), shape, "cuda").to(dt)
            differ = int((got.view(bits) != want.view(bits)).sum())
            check(differ == 0, f"kernel A's noise differs from gumbel(stream) in {differ} of {got.numel()} ({dt}, {shape})")
    print("phase 3: kernel A's noise equals gumbel(stream).to(dtype) bit for bit at "
          f"({rows}, {V}) and (4096, 4057), fp32 and bf16", flush=True)  # fmt: skip

    # Both entries against their plain versions, at the captured shape ...
    max_err = 0
    for dt in (torch.float32, torch.bfloat16):
        z = logits.to(dt)
        g = gumbel(stream(), z.shape, "cuda").to(dt)
        for keep in (None, topk_topp_mask(z, top_k=5)):
            for act in (None, active):
                want = fused_categorical_reference(z, g, keep, act, fill=0)
                for name, got in (("stream", fused_categorical_stream(z, stream(), keep, act, fill=0)),
                                  ("given noise", fused_categorical(z, g, keep, act, fill=0))):  # fmt: skip
                    max_err = max(max_err, (got.long() - want.long()).abs().max().item())
                    check(torch.equal(got, want), f"kernel A ({name}) disagrees ({dt}, keep={keep is not None}, "
                                                  f"active={act is not None})")  # fmt: skip
    # ... and on 4,096 rows of fresh streams with NaN, +inf and all--inf rows.
    for V_sweep in (40, 4057):
        for dt in (torch.float32, torch.bfloat16):
            z = special_plane(rng, 4096, V_sweep, dt)
            keep = torch.from_numpy(rng.random((4096, V_sweep)) < 0.5).cuda()
            act = torch.from_numpy(rng.random(4096) < 0.9).cuda()
            for k, a in ((None, None), (keep, act)):
                for trial in range(2):
                    kw = dict(seeds=torch.from_numpy(rng.integers(-(2**62), 2**62, size=4096)).cuda(),
                              counters=torch.from_numpy(rng.integers(0, 2**40, size=4096)).cuda(),
                              salt=int(rng.integers(0, 2**32)))  # fmt: skip
                    want = fused_categorical_reference(z, gumbel(stream(**kw), z.shape, "cuda").to(dt), k, a, fill=-1)
                    got = fused_categorical_stream(z, stream(**kw), k, a, fill=-1)
                    max_err = max(max_err, (got.long() - want.long()).abs().max().item())
                    check(torch.equal(got, want), f"kernel A (stream) disagrees on the sweep (V {V_sweep}, {dt}, "
                                                  f"keep and active {k is not None}, trial {trial})")  # fmt: skip
    torch.cuda.synchronize()
    print(f"phase 3: kernel A exact vs plain at ({rows}, {V}) (both entries) and on 4,096 rows at V 40 and 4057",
          flush=True)  # fmt: skip

    # Timing at the main path's shape and type (fp32 logits, an active mask, no keep).
    dt = logits.dtype
    g = gumbel(stream(), logits.shape, "cuda").to(dt)
    s_kernel, s_plain, s_noise = stream(), stream(), stream()
    t = timings(lambda: fused_categorical_stream(logits, s_kernel, None, active), None,
                lambda: torch.argmax(g + logits, dim=-1))  # fmt: skip
    # The ATen noise is about a hundred launches: 4 calls at a time keep the
    # stream's queue of pending launches short, so the device is what is timed
    # (`utils.timing.time_ms`).
    plain = time_ms(lambda: fused_categorical_reference(logits, gumbel(s_plain, logits.shape, "cuda").to(dt), None,
                                                        active), n=4)  # fmt: skip
    t["plain_ms"], t["single_plain_ms"] = plain["ms"], plain["single_ms"]
    extra = {"gumbel_ms": time_ms(lambda: gumbel(s_noise, logits.shape, "cuda").to(dt), n=4),
             "given_noise_ms": time_ms(lambda: fused_categorical(logits, g, None, active)),
             "launch_floor_ms": time_ms(launch_floor)}  # fmt: skip
    nbytes = rows * V * logits.element_size() + 2 * rows * 8 + rows + rows * 4  # logits, seeds, counters, active, out
    ops = A_OPS_PER_ELEMENT * rows * V
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FLOPS["fp32"] * 1e3
    print(f"phase 3: kernel A (noise drawn inside) at ({rows}, {V}) {dt}: {fmt_times(t)}; "
          + "; ".join(f"{k} {v['ms']:.4f} (one synchronised call {v['single_ms']:.4f})" for k, v in extra.items())
          + f"; bound {max(bytes_ms, ops_ms):.7f} ms ({nbytes} bytes, {ops} operations)", flush=True)  # fmt: skip
    return dict(t, **{k: v["ms"] for k, v in extra.items()}, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", max_abs_err=float(max_err),
                shape=[rows, V])  # fmt: skip


def live_rows(start, event_mask, mask, window):
    """Per row, the cache positions kernel B's output depends on: those that
    pass the causal, window and padding tests (the padding mask already
    holding this event's bit at the cursor). Returns ``(live, cursor_live)``."""
    import torch

    pos = torch.arange(mask.shape[1], device=mask.device)[None, :]
    st = start.long()[:, None]
    ok = (pos <= st) & torch.where(pos == st, event_mask[:, None], mask)
    if window > 0:
        ok &= pos > st - window
    return ok.sum(1), (ok & (pos == st)).sum(1)


def kernel_b_phase(model, config, capture):
    import torch

    from eventstreamgpt_tpu_torch.ops.decode_step import (
        cluster_size,
        decode_stack_step,
        decode_stack_step_reference,
        stack_layer_weights,
    )

    cap = capture.b
    kw = cap["kw"]
    L, B, H, M, D = cap["kc"].shape
    blocks = model.to("cuda").encoder.blocks()
    max_err = 0.0
    for dt, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-4)), (torch.bfloat16, dict(rtol=0.0, atol=2e-2))):
        weights = cap["weights"] if dt == torch.bfloat16 else stack_layer_weights(blocks, dt)
        inputs = [cap["h0"].to(dt), cap["start"], cap["em"], cap["mask"]]

        def run(fn):
            kc, vc = cap["kc"].to(dt).clone(), cap["vc"].to(dt).clone()
            return fn(weights, kc, vc, *inputs, **kw)

        want, got = run(decode_stack_step_reference), run(decode_stack_step)
        torch.cuda.synchronize()
        err = (got[0].float() - want[0].float()).abs().max().item()
        torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
        at = torch.arange(M, device="cuda")[None, :] == cap["start"][:, None].long()
        at = at[None, :, None, :, None].expand(L, B, H, M, D)
        for i in (1, 2):
            check(torch.equal(got[i][~at], want[i][~at]), f"kernel B ({dt}): cache changed off the cursor")
            torch.testing.assert_close(got[i][at].float(), want[i][at].float(), **tol)
        check(torch.equal(got[5], want[5]) and torch.equal(got[6], want[6]), f"kernel B ({dt}): mask/length")
        print(f"phase 3: kernel B ({dt}) within {tol}: max |h diff| {err:.3g}", flush=True)
        if dt == torch.bfloat16:
            max_err = err
    weights = cap["weights"]
    kc, vc = cap["kc"].clone(), cap["vc"].clone()
    args = (weights, kc, vc, cap["h0"], cap["start"], cap["em"], cap["mask"])
    t = timings(lambda: decode_stack_step(*args, **kw), lambda: decode_stack_step_reference(*args, **kw), n=20)
    # The bound counts what the function needs on this run's inputs: the
    # weights once, K and V only at each row's live positions (the cursor's
    # are computed, not read; a row with none live averages V over all M),
    # the cursor writes and the small inputs and outputs.
    E, I, esz = H * D, weights["wfc"].shape[-1], kc.element_size()
    w_bytes = sum(t.numel() * t.element_size() for t in weights.values())
    k_rows = v_rows = attn_rows = 0
    for window in kw["windows"]:
        live, cursor = live_rows(cap["start"], cap["em"], cap["mask"], int(window))
        k_rows += int((live - cursor).sum())
        v_rows += int(torch.where(live > 0, live - cursor, M).sum())
        attn_rows += int(live.sum() + torch.where(live > 0, live, M).sum())
    written = int((cap["start"] < M).sum())
    small = 2 * B * E * esz + B * (4 + 1 + M + 1) + 4 * L + B * (M + 4)  # h0, h; start, em, mask, active; out
    nbytes = w_bytes + (k_rows + v_rows) * E * esz + 2 * L * written * E * esz + small
    flops = 2 * B * L * (4 * E * E + 2 * E * I) + 2 * H * D * attn_rows
    bound = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS["bf16"]) * 1e3
    C = cluster_size(H)
    print(f"phase 3: kernel B at (L={L}, B={B}, H={H}, M={M}, D={D}) in clusters of {C} CTAs, {B * C} CTAs; "
          f"{fmt_times(t)}, bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; whole cache "
          f"{2 * kc.numel() * esz / 1e6:.2f} MB)", flush=True)  # fmt: skip
    return dict(t, bound_ms=bound,
                bound_by="bytes" if nbytes / PEAK_BYTES_PER_S >= flops / PEAK_FLOPS["bf16"] else "operations",
                max_abs_err=max_err, shape=[L, B, H, M, D], cluster=[C, 1, 1], blocks=B * C)  # fmt: skip


# ---------------------------------------------------------------- phase 3b
QUANT_DTYPES = ("int8", "fp8")


def quantized_engine_phase(smi, model, config, runs):
    """Phase 2's model and requests served with an int8 and an fp8 cache at
    ``dispatch_depth=2``, greedy and sampled, each sampled run also eagerly;
    returns the captured inputs of each eager sampled run's first decode step
    and the captured runs' launch counts."""
    import numpy as np

    import eventstreamgpt_tpu_torch.serving.engine as engine_module
    from eventstreamgpt_tpu_torch.data.synthetic import synthetic_prompts, serving_config
    from eventstreamgpt_tpu_torch.ops.decode_step import decode_stack_step
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical, fused_categorical_stream

    prompts = synthetic_prompts(np.random.default_rng(SEED), N_REQUESTS, serving_config(), (128, 192), (16, 64))
    engine_kw = dict(n_slots=32, max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16, seed=SEED,
                     dispatch_depth=2)  # fmt: skip
    entries = ("launches", "launches_int8", "launches_fp8")
    counters = {f"decode_stack_step.{c}": (decode_stack_step, c) for c in entries}
    counters.update(fused_categorical_stream=(fused_categorical_stream, "launches"),
                    fused_categorical=(fused_categorical, "launches"))  # fmt: skip
    captures, out = {}, {}
    for kv in QUANT_DTYPES:
        captures[kv] = capture = Capture(engine_module)
        for mode in ("greedy", "sampled"):
            kw = dict(engine_kw, greedy=mode == "greedy", kv_cache_dtype=kv)
            run = engine_run(model, config, prompts, counters, **kw)
            results, launches, stats, wall = run["results"], run["launches"], run["stats"], run["wall_s"]
            label = f"phase 3b [{kv} {mode}]"
            check_results(results, run["requests"], label)
            ours = launches[f"decode_stack_step.launches_{kv}"]
            check(ours > 0, f"{label}: the quantized decode kernel never ran")
            check(sum(launches[f"decode_stack_step.{c}"] for c in entries) == ours,
                  f"{label}: another entry of kernel B launched: {launches}")  # fmt: skip
            check(launches["fused_categorical"] == 0, f"{label}: the engine launched kernel A with given noise")
            if mode == "sampled":
                check(launches["fused_categorical_stream"] > 0, f"{label}: the sampling kernel was never launched")
            else:
                check(launches["fused_categorical_stream"] == 0, f"{label}: the sampling kernel ran in greedy mode")
            check(stats["kv_cache_dtype"] == kv and stats["dispatch_depth"] == 2, f"{label}: {stats}")
            check_graph_counts(run, label, f"decode_stack_step.launches_{kv}")
            check_passes(run, label)
            generated = sum(r.n_generated for r in results)
            acct = run["passes"]["accounting"]["wall_s"]
            line = (f"{label} {len(results)} requests, {generated} generated events, each pass after reset() equal "
                    f"to the warm pass: {generated / acct:.1f} events/s in {acct:.4f} s (fetch_results=False; "
                    f"fetching {generated / run['passes']['fetching']['wall_s']:.1f}), launches {launches} over three "
                    f"passes, dispatched chunks {stats['dispatched_chunks']} a pass, {programs_line(run)}, "
                    f"wasted_decode_frac {stats['wasted_decode_frac']}, kv_cache_bytes {stats['kv_cache_bytes']}")  # fmt: skip
            if mode == "greedy":
                base = {r.request_id: r for r in runs["greedy"]["results"]}
                agree = [same_generated_events(r, base[r.request_id]) for r in results]
                same = sum(n == r.n_generated == base[r.request_id].n_generated for n, r in zip(agree, results))
                line += (f"; greedy requests whose events equal the bf16 cache's: {same} of {len(results)}, generated "
                         f"events equal before the first difference: median {float(np.median(agree))}, "
                         f"{sum(agree)} of {generated} (not checked)")  # fmt: skip
            else:  # the eager chunk, for equality; quantized B's inputs for this phase come from it
                capture.armed = True
                eager = engine_run(model, config, prompts, counters, cuda_graph=False, **kw)
                capture.armed = False
                check_eager_counts(eager, label, f"decode_stack_step.launches_{kv}", True)
                kernel_a_through_replays(run, eager, label)
                check_passes(eager, f"{label} eager")
                same_as_eager(run, eager, label)
                line += f"; every event, integer and float equal captured and eager: {walls_line(run, eager, generated)}"
            print(f"{line} ({smi})", flush=True)
            out[(kv, mode)] = dict(launches=launches, wall_s=wall, generated=generated)
            if mode == "sampled":
                print(f"phase 3b: slots_report() at the card's memory ({kv} cache): "
                      f"{json.dumps(run['engine'].slots_report())} ({smi})", flush=True)  # fmt: skip
        capture.restore()
        check(capture.b is not None, f"no quantized decode-step inputs were captured ({kv})")
    small_engine_matches_cpu(kv_cache_dtype="int8")
    return captures, out


def same_generated_events(a, b) -> int:
    """The generated events of two results of one request (same prompt) that
    are equal, event mask and every data element's index, before the first
    that differs."""
    import torch

    n = min(a.n_events, b.n_events)
    ea, eb = a.batch.event_mask[0, :n], b.batch.event_mask[0, :n]
    ia, ib = a.batch.dynamic_indices[0, :n], b.batch.dynamic_indices[0, :n]
    differ = torch.nonzero((ea != eb) | (ia != ib).flatten(1).any(-1)).flatten()
    first = int(differ[0]) if len(differ) else n
    return max(first - a.prompt_len, 0)


def quant_step(value, scale, kv):
    """One quantisation step at each dequantized value: the scale in int8; in
    e4m3 (3 mantissa bits) at most 2^-3 of the scaled value, 2^-9 among the
    subnormals, times the scale."""
    import torch

    if kv == "int8":
        return scale
    return scale * torch.clamp((value / scale).abs() * 2.0**-3, min=2.0**-9)


def kernel_b_quant_phase(model, captures, smi):
    """Quantized B against its plain version on the captured inputs, and timed."""
    import torch

    from eventstreamgpt_tpu_torch.ops.decode_step import (
        decode_stack_step,
        decode_stack_step_reference,
        stack_layer_weights,
    )
    from eventstreamgpt_tpu_torch.ops.kv_quant import dequantize_kv, storage
    from eventstreamgpt_tpu_torch.utils.timing import time_ms

    result = {}
    blocks = model.to("cuda").encoder.blocks()
    for kv in QUANT_DTYPES:
        cap = captures[kv].b
        kw = {k: v for k, v in cap["kw"].items() if not k.endswith("_scale")}
        scales = (cap["kw"]["key_scale"], cap["kw"]["value_scale"])
        L, B, H, M, D = cap["kc"].shape
        max_err = 0.0
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            weights = cap["weights"] if dt == torch.bfloat16 else stack_layer_weights(blocks, dt)
            inputs = [cap["h0"].to(dt), cap["start"], cap["em"], cap["mask"]]

            def run(fn):
                kc, vc, ks, vs = (t.clone() for t in (cap["kc"], cap["vc"], *scales))
                return fn(weights, kc, vc, *inputs, key_scale=ks, value_scale=vs, **kw)

            want, got = run(decode_stack_step_reference), run(decode_stack_step)
            torch.cuda.synchronize()
            at_s = torch.arange(M, device="cuda")[None, :] == cap["start"][:, None].long()
            at_s = at_s[None, :, None, :].expand(L, B, H, M)
            at = at_s[..., None].expand(L, B, H, M, D)
            same = torch.ones(B, dtype=torch.bool, device="cuda")
            for plane, scale in ((1, 3), (2, 4)):
                gb, wb = storage(got[plane]), storage(want[plane])
                check(torch.equal(gb[~at], wb[~at]), f"quantized B ({kv}, {dt}): codes changed off the cursor")
                check(torch.equal(got[scale][~at_s], want[scale][~at_s]),
                      f"quantized B ({kv}, {dt}): scales changed off the cursor")  # fmt: skip
                same &= (gb == wb).reshape(L, B, -1).all(-1).all(0)
                # A key one rounding apart can move a code by a step.
                # The layer's input differs by the earlier layers' roundings, a
                # share of its magnitude: the tolerance scales with each row's largest.
                gd = dequantize_kv(got[plane], got[scale], torch.float32)
                wd = dequantize_kv(want[plane], want[scale], torch.float32)
                top = wd.abs().amax(-1, keepdim=True).expand_as(wd)[at]
                gd, wd = gd[at], wd[at]
                limit = tol + tol * top + quant_step(wd, want[scale][..., None].expand(L, B, H, M, D)[at], kv)
                check(bool(((gd - wd).abs() <= limit).all()),
                      f"quantized B ({kv}, {dt}): a cursor key or value is off by more than {tol} plus a step")  # fmt: skip
            check(torch.equal(got[5], want[5]) and torch.equal(got[6], want[6]),
                  f"quantized B ({kv}, {dt}): mask/length")  # fmt: skip
            # h on the rows whose cursor codes agree: a moved code moves the scores by a step.
            check(bool(same.any()), f"quantized B ({kv}, {dt}): no row's cursor codes agree")
            g, w = got[0].float()[same], want[0].float()[same]
            err = (g - w).abs().max().item()
            torch.testing.assert_close(g, w, rtol=tol if dt == torch.float32 else 0.0, atol=tol)
            print(f"phase 3b: quantized B ({kv}, {dt}) within {tol} (+ one quantisation step at the cursor): max |h "
                  f"diff| {err:.3g} on the {int(same.sum())} of {B} rows whose cursor codes agree", flush=True)  # fmt: skip
            if dt == torch.bfloat16:
                max_err = err

        # Timing: quantized B, its plain version, and the bf16 B on the same rows (the caches dequantized).
        weights = cap["weights"]
        kc, vc, ks, vs = (t.clone() for t in (cap["kc"], cap["vc"], *scales))
        args = (weights, kc, vc, cap["h0"], cap["start"], cap["em"], cap["mask"])
        qkw = dict(kw, key_scale=ks, value_scale=vs)
        t = timings(lambda: decode_stack_step(*args, **qkw), lambda: decode_stack_step_reference(*args, **qkw), n=20)
        kd, vd = dequantize_kv(kc, ks, torch.bfloat16), dequantize_kv(vc, vs, torch.bfloat16)
        fargs = (weights, kd, vd, cap["h0"], cap["start"], cap["em"], cap["mask"])
        bf16_ms = time_ms(lambda: decode_stack_step(*fargs, **kw), n=20)["ms"]
        # The bound: the weights once, codes and scales at each row's live
        # positions (the cursor's are computed, not read; a row with none
        # live averages V over all M), the cursor's codes and scales written,
        # and the small inputs and outputs; the operations of the float B
        # plus one multiply a dequantized element.
        E, I = H * D, weights["wfc"].shape[-1]
        per_pos = E * kc.element_size() + H * 4  # codes and scales of one position, every head
        w_bytes = sum(x.numel() * x.element_size() for x in weights.values())
        k_rows = v_rows = attn_rows = 0
        for window in kw["windows"]:
            live, cursor = live_rows(cap["start"], cap["em"], cap["mask"], int(window))
            k_rows += int((live - cursor).sum())
            v_rows += int(torch.where(live > 0, live - cursor, M).sum())
            attn_rows += int(live.sum() + torch.where(live > 0, live, M).sum())
        written = int((cap["start"] < M).sum())
        esz = cap["h0"].element_size()
        small = 2 * B * E * esz + B * (4 + 1 + M + 1) + 4 * L + B * (M + 4)
        nbytes = w_bytes + (k_rows + v_rows) * per_pos + 2 * L * written * per_pos + small
        flops = 2 * B * L * (4 * E * E + 2 * E * I) + 2 * H * D * attn_rows + (k_rows + v_rows) * E
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bf16"] * 1e3
        print(f"phase 3b: quantized B ({kv}) at (L={L}, B={B}, H={H}, M={M}, D={D}): {fmt_times(t)}; the bf16 B on "
              f"the same rows {bf16_ms:.4f}; bound {max(bytes_ms, ops_ms):.5f} ms ({nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP; whole cache {2 * (kc.numel() + 4 * ks.numel()) / 1e6:.2f} MB) ({smi})",
              flush=True)  # fmt: skip
        result[kv] = dict(t, bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                          max_abs_err=max_err, bf16_ms=bf16_ms, shape=[L, B, H, M, D])  # fmt: skip
    return result


# ---------------------------------------------------------------- phase 4
class GatherCapture:
    """Wraps the regression head's `vocab_gather` to keep the plane, the
    indices and the cotangent of the first call made while ``armed``."""

    def __init__(self, layers_module):
        self.mod, self.armed, self.z, self.ci, self.g = layers_module, False, None, None, None
        self.orig = layers_module.vocab_gather

        def wrapped(z, ci):
            out = self.orig(z, ci)
            if self.armed and self.z is None:
                self.z, self.ci = z.detach().clone(), ci.clone()
                out.register_hook(lambda g: setattr(self, "g", g.detach().clone()))
            return out

        layers_module.vocab_gather = wrapped

    def restore(self):
        self.mod.vocab_gather = self.orig


def training_run(label, smi, config, batch, counters, capture=None, steps=TRAIN_STEPS):
    """``steps`` steps of a fresh model through `make_train_step` (after 2
    warm-up steps of another fresh model, not counted): the first runs
    eagerly (its warm-up), the second is captured, and every step from the
    second on is a replay. The counters in ``counters`` (launch-counted
    kernel entry points) are set to 0 just before the counted steps and
    read just after. ``capture.armed`` is set for the first step (eager:
    the captured steps run no Python). Then ``steps`` steps of a fresh
    model with ``cuda_graph=False``: their first `EQUAL_STEPS` losses and
    health vectors must equal the captured steps', bit for bit. Returns
    ``(losses, launches, step_ms, events, eager_step_ms)``."""
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_train_step

    def fresh(**kw):
        model = init_params_from_seed(build_model(config), seed=SEED)
        oc = OptimizationConfig(init_lr=1e-3, batch_size=TRAIN_BATCH, max_epochs=3, lr_frac_warmup_steps=0.1)
        oc.set_to_dataset(n_subjects=512)  # bench.py's 512 training subjects
        optimizer, scheduler = build_optimizer(model, oc)
        return make_train_step(model, optimizer, scheduler, with_health=True, **kw)

    def run(step, arm=False):
        healths, walls = [], []
        for i in range(steps):
            if arm and capture is not None:
                capture.armed = i == 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, health = step(batch, SEED)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            healths.append(health.cpu())
        if arm and capture is not None:
            capture.armed = False
        return torch.stack(healths), walls

    warm = fresh()  # cuBLAS handles, allocator, kernel loads: not counted
    for _ in range(2):
        warm(batch, SEED)
    torch.cuda.synchronize()

    step = fresh()
    for fn in counters:
        fn.launches = 0
    healths, walls = run(step, arm=True)
    launches = {fn.__name__: fn.launches for fn in counters}
    if capture is not None:
        capture.restore()
    s = step.stats()
    check((s["graph_warmup_steps"], s["graph_captures"], s["graph_replays"]) == (1, 1, steps - 1),
          f"{label}: the train step was not warmed up once, captured once and replayed after: {s}")  # fmt: skip
    eager_healths, eager_walls = run(fresh(cuda_graph=False))
    n = EQUAL_STEPS
    check(torch.equal(healths[:n], eager_healths[:n]),
          f"{label}: the captured steps' [loss, grad norm] differ from the eager steps': {healths[:n].tolist()} vs "
          f"{eager_healths[:n].tolist()}")  # fmt: skip
    losses, norms = healths[:, 0].tolist(), healths[:, 1].tolist()
    check(all(math.isfinite(x) for x in losses + norms), f"{label}: a loss or gradient norm is not finite: {losses}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall over {steps} steps: {losses}")
    events = int(batch.event_mask.sum())
    step_ms, eager_ms = float(np.median(walls)) * 1e3, float(np.median(eager_walls)) * 1e3
    B, L = batch.event_mask.shape
    print(f"{label}: {steps} train steps at (B={B}, L={L}, n_data="
          f"{batch.dynamic_indices.shape[-1]}), {events} real events a step: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; captured: median step {step_ms:.3f} ms (min {min(walls) * 1e3:.3f}), "
          f"{events / (step_ms / 1e3):.1f} trained events/s; eager: median step {eager_ms:.3f} ms (min "
          f"{min(eager_walls) * 1e3:.3f}), {events / (eager_ms / 1e3):.1f} trained events/s; [loss, grad norm] "
          f"equal captured and eager over the first {n} steps (all {steps}: "
          f"{torch.equal(healths, eager_healths)}); launches {launches} ({s['graph_captures']} capture, "
          f"{s['graph_replays']} replays) ({smi})", flush=True)  # fmt: skip
    return losses, launches, step_ms, events, eager_ms


def training_batch():
    """The phase-4 batch: 32 subjects x 256 events, numpy seed 0, on the card."""
    import numpy as np

    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_training_batches

    return next(synthetic_training_batches(np.random.default_rng(SEED), serving_config(), TRAIN_BATCH, TRAIN_SEQ))


def training_phase(smi):
    import eventstreamgpt_tpu_torch.models.generative_layers as layers_module
    from eventstreamgpt_tpu_torch.data.synthetic import training_config
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd

    batch = training_batch()
    config = training_config([batch])  # bf16, dropout 0.1 (the config defaults)
    batch = batch.map(lambda t: t.cuda())  # resident, as a prefetching loader leaves it
    check(config.precision == "bf16" and config.resid_dropout == 0.1, "phase 4: not the benchmark's training config")
    capture = GatherCapture(layers_module)
    counters = (vocab_gather_fwd, vocab_gather_bwd)
    losses, launches, step_ms, events, eager_ms = training_run("phase 4", smi, config, batch, counters, capture)
    check(launches == {k: TRAIN_STEPS for k in launches}, f"phase 4: kernel C launches {launches}, not 1 a step")
    check(capture.z is not None and capture.g is not None, "phase 4: no regression-plane inputs were captured")
    small_train_step_matches_cpu()
    return dict(launches=launches, step_ms=step_ms, eager_step_ms=eager_ms, events=events, losses=losses), capture


def small_fp32_setup(na, **widths):
    """A small fp32 model (numpy seed 1, std-0.1 weights, dropout 0) and a
    4 x 24-event batch on the CPU."""
    import numpy as np

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import (
        na_training_config,
        serving_config,
        synthetic_training_batches,
        training_config,
    )
    from eventstreamgpt_tpu_torch.training import build_model

    small = dict(sizes=(5, 40, 6, 3), intermediate_size=64, seq_window_size=4, attention_dropout=0.0,
                 input_dropout=0.0, resid_dropout=0.0, **widths)  # fmt: skip
    vocab = serving_config(precision="fp32", **small)
    batch = next(synthetic_training_batches(np.random.default_rng(1), vocab, 4, 24, mean_seq_len=16))
    config = (na_training_config if na else training_config)([batch], precision="fp32", **small)
    return init_params_from_seed(build_model(config), seed=1, std=0.1), batch


def one_fp32_step(base, batch, dev):
    """One train step of a copy of ``base`` on ``dev``: ``(loss, {name: grad on the CPU})``."""
    import copy

    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training import build_optimizer, make_train_step

    model = copy.deepcopy(base)
    oc = OptimizationConfig(init_lr=1e-3, lr_num_warmup_steps=0, lr_frac_warmup_steps=None, max_training_steps=10)
    optimizer, scheduler = build_optimizer(model, oc)
    loss = float(make_train_step(model, optimizer, scheduler, device=dev)(batch, 0))
    return loss, {n: p.grad.cpu() for n, p in model.named_parameters()}


def steps_match(a, b, tol, what):
    """Loss and every gradient of two `one_fp32_step` results within ``tol`` (rtol = atol)."""
    import torch

    torch.testing.assert_close(a[0], b[0], rtol=tol, atol=tol, msg=lambda m: f"{what}, loss: {m}")
    # Gradients, not the updated parameters: Adam's first step moves each
    # element by about lr * sign(grad), so an element whose gradient is float
    # noise around 0 moves either way.
    for name, grad in b[1].items():
        torch.testing.assert_close(a[1][name], grad, rtol=tol, atol=tol, msg=lambda m: f"{what}, {name}: {m}")


def grad_diff(a, b, relative=False) -> float:
    """The largest gradient difference; with ``relative``, as a share of each tensor's largest |gradient|."""
    return max(
        (a[1][n] - g).abs().max().item() / (g.abs().max().item() if relative else 1.0) for n, g in b[1].items()
    )


def small_train_step_matches_cpu(na=False):
    """One fp32 train step at a small size on the card against the same step
    on the CPU (plain versions of kernels C and D), dropout 0, within 1e-4.

    The NA model keeps the CI check's hidden 32, as one head of 32 (kernel
    D's narrowest): at hidden 128 the card and the CPU differ by up to ~2e-3
    whichever versions of C and D the card runs. `na_kernels_match_plain_on_card`
    holds the kernels at hidden 128 on the card alone and prints those
    card-vs-CPU differences."""
    heads = dict(num_attention_heads=1, head_dim=32) if na else dict(head_dim=8)
    base, batch = small_fp32_setup(na, hidden_size=32, **heads)
    cuda, cpu = one_fp32_step(base, batch, "cuda"), one_fp32_step(base, batch, "cpu")
    steps_match(cuda, cpu, 1e-4, "card vs CPU")
    print(f"phase {6 if na else 4}: small fp32 {'NA ' if na else ''}train step on the card matches the CPU "
          f"(loss {cpu[0]:.6f}, max |grad diff| {grad_diff(cuda, cpu):.3g})", flush=True)  # fmt: skip


def dep_graph_attention_f64(query, key, value, q_offset=0, window=None, dropout_mask=None, dropout_rate=0.0):
    """Kernel D's function without dropout, computed in fp64 both ways and
    rounded once to the value dtype: one change of fp32 rounding, for the
    envelope `na_kernels_match_plain_on_card` prints."""
    import torch

    from eventstreamgpt_tpu_torch.ops.dep_graph import graph_mask

    check(dropout_mask is None, "the fp64 dep-graph attention takes no dropout")
    mask = graph_mask(query.shape[1], key.shape[1], q_offset, window, query.device)
    logits = (query.double()[:, :, None] * key.double()[:, None]).sum(dim=-1)  # (N, Q, S, H)
    probs = torch.softmax(logits.masked_fill(~mask[None, :, :, None], float("-inf")), dim=2)
    return (probs[..., None] * value.double()[:, None]).sum(dim=2).to(value.dtype)


def na_kernels_match_plain_on_card():
    """The small fp32 NA step at hidden 128 (4 heads of 32), dropout 0, held
    by `kernels_match_plain_on_card` with kernels C and D."""
    import eventstreamgpt_tpu_torch.models.generative_layers as layers_module
    import eventstreamgpt_tpu_torch.models.transformer as transformer_module
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_attention_reference, dep_graph_bwd, dep_graph_fwd
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd, vocab_gather_reference

    base, batch = small_fp32_setup(True, hidden_size=128, num_attention_heads=4, head_dim=32)
    kernels_match_plain_on_card(
        "phase 6", "NA", base, batch, (dep_graph_fwd, dep_graph_bwd, vocab_gather_fwd, vocab_gather_bwd),
        [(transformer_module, "dep_graph_attention", dep_graph_attention_reference, dep_graph_attention_f64),
         (layers_module, "vocab_gather", vocab_gather_reference, vocab_gather_reference)],
    )  # fmt: skip


def kernels_match_plain_on_card(phase, what, base, batch, counters, swaps):
    """One small fp32 step on the card with the kernels in ``counters``
    against the same step on the card with their plain versions swapped in
    (``swaps``: ``(module, name, plain, fp64)``): the loss within 1e-5 of it
    and every gradient within 2e-5 of its tensor's largest. Rounding the
    attention kernel's output and gradients once from fp64 instead of the
    plain version's fp32 sums moves gradients by up to ~7e-6 of their
    tensor's largest at these widths (the model amplifies last-bit changes),
    so a kernel summing in another order moves them as far; a wrong kernel
    moves them by far more. The step with those fp64 versions and each card
    step's distance from the CPU's are printed, not checked."""
    before = [fn.launches for fn in counters]
    kernels = one_fp32_step(base, batch, "cuda")
    check(all(fn.launches > n for fn, n in zip(counters, before)), f"{phase}: the hidden-128 step missed a kernel")
    orig = [getattr(mod, name) for mod, name, _, _ in swaps]

    def plain_step(which):
        before = [fn.launches for fn in counters]
        for (mod, name, *versions) in swaps:
            setattr(mod, name, versions[which])
        try:
            out = one_fp32_step(base, batch, "cuda")
        finally:
            for (mod, name, _, _), fn in zip(swaps, orig):
                setattr(mod, name, fn)
        check([fn.launches for fn in counters] == before, f"{phase}: a plain hidden-128 step launched a kernel")
        return out

    plain, rounded = plain_step(0), plain_step(1)
    cpu = one_fp32_step(base, batch, "cpu")
    loss_err, rel = abs(kernels[0] - plain[0]), grad_diff(kernels, plain, relative=True)
    check(loss_err <= 1e-5 * abs(plain[0]) and rel <= 2e-5,
          f"{phase}: hidden 128, kernels vs plain versions on the card: loss {kernels[0]} vs {plain[0]}, largest "
          f"gradient difference {rel:.3g} of its tensor's largest (tolerance 2e-5)")  # fmt: skip
    print(f"{phase}: small fp32 {what} step at hidden 128 on the card, kernels vs plain versions: loss "
          f"{kernels[0]:.6f} vs {plain[0]:.6f}, max |grad diff| {grad_diff(kernels, plain):.3g} ({rel:.3g} of its "
          f"tensor's largest); not checked: plain with the attention rounded once from fp64 vs plain "
          f"{grad_diff(rounded, plain):.3g} ({grad_diff(rounded, plain, relative=True):.3g}); card vs CPU, kernels "
          f"{grad_diff(kernels, cpu):.3g}, plain versions {grad_diff(plain, cpu):.3g}; largest |grad| "
          f"{max(g.abs().max().item() for g in cpu[1].values()):.3g}", flush=True)  # fmt: skip


# ---------------------------------------------------------------- phase 5
def bf16_ulp(x):
    import torch

    mag = x.abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_c_phase(capture):
    import torch

    from eventstreamgpt_tpu_torch.ops.fused_sampling import launch_floor
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd, vocab_gather_reference
    from eventstreamgpt_tpu_torch.utils.timing import time_ms

    V = capture.z.shape[-1]
    z0 = capture.z.reshape(-1, V)
    ci = capture.ci.reshape(-1, capture.ci.shape[-1]).contiguous()
    g = capture.g.reshape(ci.shape).float().contiguous()
    rows, M = ci.shape
    valid = (ci >= 0) & (ci < V)
    ci64 = ci.long()
    result = {}
    for dt in (torch.bfloat16, torch.float32):
        z = z0.to(dt).contiguous()
        zr = z.detach().requires_grad_(True)
        ref_out = vocab_gather_reference(zr, ci)
        got = vocab_gather_fwd(z, ci)
        check(torch.equal(got, ref_out.detach()), f"kernel C forward ({dt}) differs from its plain version")
        (want_dz,) = torch.autograd.grad(ref_out, zr, g, retain_graph=True)
        got_dz = vocab_gather_bwd(g, ci, V, dt)
        torch.cuda.synchronize()
        diff = (got_dz.float() - want_dz.float()).abs()
        if dt == torch.bfloat16:
            tol = bf16_ulp(torch.maximum(got_dz.float().abs(), want_dz.float().abs()))
        else:
            tol = 1e-6 * want_dz.abs() + 1e-6 * g.abs().max()
        check(bool((diff <= tol).all()), f"kernel C backward ({dt}) off its plain version by {diff.max().item():.3g}")
        cpu_z = z.detach().cpu().clone().requires_grad_(True)
        vocab_gather_reference(cpu_z, ci.cpu()).backward(g.cpu())
        check(torch.equal(got_dz.cpu(), cpu_z.grad), f"kernel C backward ({dt}) differs from the CPU's ordered sums")
        print(f"phase 5: kernel C ({dt}) at rows {rows}, V {V}, M {M}: forward bit-exact, backward max |diff| "
              f"{diff.max().item():.3g} vs the card's plain version, exact vs the CPU's", flush=True)  # fmt: skip
        if dt != torch.bfloat16:
            continue
        esz = z.element_size()
        # Forward: indices and outputs once, and each distinct in-range element once.
        s = torch.sort(torch.where(valid, ci, -1), dim=-1).values
        distinct = int((s[:, :1] >= 0).sum() + ((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum())
        fwd_bytes = rows * M * 4 * 2 + distinct * esz
        fwd_ops = int(valid.sum())  # one conversion per gathered element
        # Backward: the whole dz plane once, g and ci once; one add per in-range slot.
        bwd_bytes = rows * V * esz + rows * M * 4 * 2
        bwd_ops = fwd_ops
        t_fwd = timings(lambda: vocab_gather_fwd(z, ci), lambda: vocab_gather_reference(z, ci),
                        lambda: torch.gather(z, -1, ci64).float(), n=100)  # fmt: skip
        floor = time_ms(launch_floor, n=100)
        t_bwd = timings(
            lambda: vocab_gather_bwd(g, ci, V, dt),
            lambda: torch.autograd.grad(ref_out, zr, g, retain_graph=True),
            lambda: torch.zeros_like(z).scatter_add_(-1, ci64, g.to(dt)),  # accumulates in z's dtype
        )
        for name, t, nbytes, ops in (("fwd", t_fwd, fwd_bytes, fwd_ops), ("bwd", t_bwd, bwd_bytes, bwd_ops)):
            bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FLOPS["fp32"] * 1e3
            result[name] = dict(t, bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                                max_abs_err=0.0 if name == "fwd" else diff.max().item(), shape=[rows, V, M])  # fmt: skip
            if name == "bwd":  # the plane's write, the bound's bytes, at the kernel's time
                result[name]["write_GBps"] = rows * V * esz / (t["ms"] * 1e-3) / 1e9
                rate = f", the plane written at {result[name]['write_GBps']:.1f} GB/s"
            else:  # an empty kernel, timed the same way
                result[name]["launch_floor_ms"] = floor["ms"]
                rate = f"; launch floor {floor['ms']:.4f} ms (one synchronised call {floor['single_ms']:.4f})"
            print(f"phase 5: kernel C {name} (bf16): {fmt_times(t)}; bound {result[name]['bound_ms']:.5f} ms "
                  f"({nbytes / 1e6:.2f} MB, {distinct} distinct gathered elements){rate}", flush=True)  # fmt: skip
    return result


# ---------------------------------------------------------------- phase 6
class DepGraphCapture:
    """Wraps the transformer's `dep_graph_attention` to keep the query, key,
    value, keep-mask and output cotangent of the first call made while ``armed``."""

    def __init__(self, transformer_module):
        self.mod, self.armed, self.args, self.g = transformer_module, False, None, None
        self.orig = transformer_module.dep_graph_attention

        def wrapped(query, key, value, q_offset=0, window=None, dropout_mask=None, dropout_rate=0.0):
            out = self.orig(query, key, value, q_offset, window, dropout_mask, dropout_rate)
            if self.armed and self.args is None:
                keep = None if dropout_mask is None else dropout_mask.clone()
                self.args = dict(q=query.detach().clone(), k=key.detach().clone(), v=value.detach().clone(),
                                 keep=keep, q_offset=q_offset, window=window, rate=dropout_rate)  # fmt: skip
                out.register_hook(lambda g: setattr(self, "g", g.detach().clone()))
            return out

        transformer_module.dep_graph_attention = wrapped

    def restore(self):
        self.mod.dep_graph_attention = self.orig


def na_training_phase(smi):
    import eventstreamgpt_tpu_torch.models.transformer as transformer_module
    from eventstreamgpt_tpu_torch.data.synthetic import na_training_config
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_bwd, dep_graph_fwd
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd

    batch = training_batch()
    config = na_training_config([batch])  # bf16, dropout 0.1, bench.py's three levels
    batch = batch.map(lambda t: t.cuda())
    check(config.hidden_size == 256 and config.attention_dropout == 0.1 and config.precision == "bf16",
          "phase 6: not the benchmark's NA training config")  # fmt: skip
    capture = DepGraphCapture(transformer_module)
    counters = (dep_graph_fwd, dep_graph_bwd, vocab_gather_fwd, vocab_gather_bwd)
    losses, launches, step_ms, events, eager_ms = training_run("phase 6 [NA]", smi, config, batch, counters,
                                                               capture)  # fmt: skip
    layers = config.num_hidden_layers
    want = {"dep_graph_fwd": layers * TRAIN_STEPS, "dep_graph_bwd": layers * TRAIN_STEPS,
            "vocab_gather_fwd": TRAIN_STEPS, "vocab_gather_bwd": TRAIN_STEPS}  # fmt: skip
    check(launches == want, f"phase 6: launches {launches}, expected {want}")
    check(capture.args is not None and capture.g is not None, "phase 6: no dep-graph inputs were captured")
    check(capture.args["keep"] is not None, "phase 6: the dep-graph attention ran without its dropout keep-mask")
    small_train_step_matches_cpu(na=True)
    na_kernels_match_plain_on_card()
    return dict(launches=launches, step_ms=step_ms, eager_step_ms=eager_ms, events=events, losses=losses), capture


# ---------------------------------------------------------------- phase 7
def kernel_d_phase(capture):
    import torch
    import torch.nn.functional as F

    from eventstreamgpt_tpu_torch.ops.dep_graph import (
        dep_graph_attention_reference,
        dep_graph_bwd,
        dep_graph_fwd,
        graph_mask,
    )

    a = capture.args
    q_offset, window, rate = a["q_offset"], a["window"], a["rate"]
    N, Q, H, D = a["q"].shape
    S = a["k"].shape[1]
    result, max_err = {}, {"fwd": 0.0, "bwd": 0.0}
    # The captured cotangent is small (the loss averages over ~8k rows); scaled
    # to a largest magnitude of 1 it gives O(1) gradients, which the bf16
    # tolerance below can tell from zeros.
    g_unit = capture.g / capture.g.float().abs().max()
    for dt in (torch.bfloat16, torch.float32):
        k, v, g = a["k"].to(dt), a["v"].to(dt), g_unit.to(dt)
        # The query as the model passes it: a [:, q_offset:] view of the (N, S, H, D) projection.
        q = torch.cat([k[:, :q_offset], a["q"].to(dt)], dim=1)[:, q_offset:]
        for keep in (a["keep"], None):
            keep_prob = 1.0 - rate if keep is not None else 1.0
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            want = dep_graph_attention_reference(*leaves, q_offset, window, keep, rate if keep is not None else 0.0)
            want_grads = torch.autograd.grad(want, leaves, g)
            got = dep_graph_fwd(q, k, v, q_offset, window, keep, keep_prob)
            got_grads = dep_graph_bwd(q, k, v, g, q_offset, window, keep, keep_prob)
            torch.cuda.synchronize()
            errs = []
            for name, x, y in zip(("out", "dq", "dk", "dv"), (got, *got_grads), (want, *want_grads)):
                err = (x.float() - y.float()).abs().max().item()
                # fp32: 1e-5 of the largest magnitude. bf16: 1e-2 of it (the
                # card tests' rule), and 2e-2 absolute for the O(1) output.
                top = y.float().abs().max().item()
                tol = 1e-5 * top if dt == torch.float32 else 1e-2 * top
                if dt == torch.bfloat16 and name == "out":
                    tol = min(tol, 2e-2)
                check(err <= tol, f"kernel D {name} ({dt}, keep-mask={keep is not None}) off its plain version by "
                                  f"{err:.3g} (tolerance {tol:.3g})")  # fmt: skip
                errs.append(err)
                if dt == torch.bfloat16 and keep is not None:
                    max_err["fwd" if name == "out" else "bwd"] = max(max_err["fwd" if name == "out" else "bwd"], err)
            print(f"phase 7: kernel D ({dt}, keep-mask={keep is not None}) at N={N}, Q={Q}, S={S}, H={H}, D={D}: "
                  f"max |diff| out/dq/dk/dv {', '.join(f'{e:.3g}' for e in errs)} (largest |plain| "
                  f"{', '.join(f'{y.float().abs().max().item():.3g}' for y in (want, *want_grads))})", flush=True)  # fmt: skip

    # Timing at the main path's shapes and type: bf16, with the keep-mask, the strided query.
    dt, keep = torch.bfloat16, a["keep"]
    k, v, g = a["k"].to(dt), a["v"].to(dt), capture.g.to(dt)
    q = torch.cat([k[:, :q_offset], a["q"].to(dt)], dim=1)[:, q_offset:]
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ref_out = dep_graph_attention_reference(*leaves, q_offset, window, keep, rate)
    # Library yardstick: scaled_dot_product_attention on (N, H, Q|S, D) with the
    # same graph mask, unscaled, without dropout (it takes no external keep-mask).
    heads = [t.detach().transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
    sdpa_mask = graph_mask(Q, S, q_offset, window, q.device)
    sdpa_out = F.scaled_dot_product_attention(*heads, attn_mask=sdpa_mask, scale=1.0)
    g_heads = g.transpose(1, 2).contiguous()
    keep_prob = 1.0 - rate
    t_fwd = timings(lambda: dep_graph_fwd(q, k, v, q_offset, window, keep, keep_prob),
                    lambda: dep_graph_attention_reference(q, k, v, q_offset, window, keep, rate),
                    lambda: F.scaled_dot_product_attention(*heads, attn_mask=sdpa_mask, scale=1.0))  # fmt: skip
    t_bwd = timings(lambda: dep_graph_bwd(q, k, v, g, q_offset, window, keep, keep_prob),
                    lambda: torch.autograd.grad(ref_out, leaves, g, retain_graph=True),
                    lambda: torch.autograd.grad(sdpa_out, heads, g_heads, retain_graph=True))  # fmt: skip
    esz = q.element_size()
    pairs = int(graph_mask(Q, S, q_offset, window).sum())  # visible (query, position) pairs a row and head
    qo_bytes, kv_bytes, mask_bytes = N * Q * H * D * esz, N * S * H * D * esz, N * Q * S * H
    fwd_bytes = 2 * qo_bytes + 2 * kv_bytes + mask_bytes  # q, k, v, mask in; out
    bwd_bytes = 3 * qo_bytes + 4 * kv_bytes + mask_bytes  # q, k, v, g, mask in; dq, dk, dv out
    # fp32 arithmetic outside the tensor cores: per visible pair and head, a
    # D-long dot product and a D-long PV update (fwd); logits, dv, dP, dq and
    # dk, each D long (bwd); plus the softmax's handful per pair.
    fwd_ops = N * H * pairs * (4 * D + 6)
    bwd_ops = N * H * pairs * (10 * D + 10)
    for name, t, nbytes, ops in (("fwd", t_fwd, fwd_bytes, fwd_ops), ("bwd", t_bwd, bwd_bytes, bwd_ops)):
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FLOPS["fp32"] * 1e3
        result[name] = dict(t, bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                            max_abs_err=max_err[name], shape=[N, Q, S, H, D])  # fmt: skip
        print(f"phase 7: kernel D {name} (bf16, keep-mask, strided query): {fmt_times(t)}; bound "
              f"{result[name]['bound_ms']:.5f} ms ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)", flush=True)  # fmt: skip
    return result


# ---------------------------------------------------------------- phase 8
class FlashCapture:
    """Wraps the transformer's `flash_attention` to keep the query, key,
    value, segment ids and output cotangent of each window's first call
    made while ``armed`` (``args[window]``, ``None`` for a global layer)."""

    def __init__(self, transformer_module):
        self.mod, self.armed, self.args = transformer_module, False, {}
        self.orig = transformer_module.flash_attention

        def wrapped(query, key, value, segment_ids, window=None):
            out = self.orig(query, key, value, segment_ids, window)
            if self.armed and window not in self.args:
                a = dict(q=query.detach().clone(), k=key.detach().clone(), v=value.detach().clone(),
                         seg=segment_ids.clone(), g=None)  # fmt: skip
                self.args[window] = a
                out.register_hook(lambda g: a.__setitem__("g", g.detach().clone()))
            return out

        transformer_module.flash_attention = wrapped

    def restore(self):
        self.mod.flash_attention = self.orig


def with_segment_time(batch):
    """``batch`` with each event's minutes since its segment's first event,
    summed in float64 and rounded once to fp32. A packed row's fp32
    cumulative time runs on across its subjects (~3e4 minutes in 1,024
    events), where the card's and the CPU's cumulative sums differ by ulps
    of ~4e-3 minutes; given the same ``time``, card and CPU steps compare
    the rest of the model."""
    import torch

    td = torch.where(batch.event_mask, batch.time_delta.double(), 0.0)
    t = torch.cat([torch.zeros_like(td[:, :1]), td.cumsum(1)[:, :-1]], dim=1)
    seg = batch.segment_ids
    start = torch.cat([torch.ones_like(seg[:, :1], dtype=torch.bool), seg[:, 1:] != seg[:, :-1]], dim=1)
    offsets = torch.cummax(torch.where(start, t, -math.inf), dim=1).values
    return batch.replace(time=(t - offsets).float())


def packed_training_phase(smi):
    import eventstreamgpt_tpu_torch.models.transformer as transformer_module
    from eventstreamgpt_tpu_torch.data.synthetic import packed_batch, packed_training_config, serving_config
    from eventstreamgpt_tpu_torch.ops import flash_attention as fa
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd

    batch = packed_batch(serving_config(), 512, PACKED_BATCH, PACKED_SEQ, seed=SEED)
    n_seg = [int(s.max()) + 1 for s in batch.segment_ids]
    print(f"phase 8: packed batch {tuple(batch.event_mask.shape)}, {int(batch.event_mask.sum())} real events, "
          f"subjects a row {n_seg}", flush=True)  # fmt: skip
    batch = batch.map(lambda t: t.cuda())
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_window_fwd,
                fa.flash_attention_window_bwd, vocab_gather_fwd, vocab_gather_bwd)  # fmt: skip
    runs, args = {}, {}
    for window, steps in ((None, TRAIN_STEPS), (WIDE_WINDOW, WIDE_STEPS)):
        overrides = {} if window is None else {"seq_window_size": window}
        config = packed_training_config([batch.map(lambda t: t.cpu())], **overrides)
        check(config.precision == "bf16" and config.resid_dropout == 0.1 and config.attention_dropout == 0.0
              and config.seq_attention_layers == ["local", "global"] and config.hidden_size == 256,
              "phase 8: not the benchmark's packed training config")  # fmt: skip
        label = f"phase 8 [packed, local window {config.seq_window_size}]"
        capture = FlashCapture(transformer_module)  # restored by training_run
        losses, launches, step_ms, events, eager_ms = training_run(label, smi, config, batch, counters, capture,
                                                                   steps=steps)  # fmt: skip
        wide = window is not None
        want = {"flash_attention_fwd": steps, "flash_attention_bwd": steps, "vocab_gather_fwd": steps,
                "vocab_gather_bwd": steps, "flash_attention_window_fwd": steps if wide else 0,
                "flash_attention_window_bwd": steps if wide else 0}  # fmt: skip
        check(launches == want, f"{label}: launches {launches}, expected {want}")
        # Kernel E's inputs from the benchmark's run, F's from the wide-window one.
        a = capture.args.get(window)
        check(a is not None and a["g"] is not None, f"{label}: the attention inputs were not captured")
        runs[window] = dict(launches=launches, step_ms=step_ms, eager_step_ms=eager_ms, events=events, losses=losses)
        args[window] = a
    small_packed_step_matches_cpu()
    packed_kernels_match_plain_on_card()
    return runs, args


def small_packed_setup(**widths):
    """A small fp32 packed model (numpy seed 1, std-0.1 weights, dropout 0)
    and 2 packed rows of 256 events on the CPU, with float64-derived ``time``."""
    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import packed_batch, packed_training_config, serving_config
    from eventstreamgpt_tpu_torch.training import build_model

    small = dict(sizes=(5, 40, 6, 3), intermediate_size=64, input_dropout=0.0, resid_dropout=0.0, **widths)
    # Short subjects (16 events on average, as phase 4's small batch): event times of a few thousand minutes.
    batch = packed_batch(serving_config(precision="fp32", **small), 40, 2, 256, seed=SEED, mean_seq_len=16)
    config = packed_training_config([batch], precision="fp32", **small)
    return init_params_from_seed(build_model(config), seed=1, std=0.1), with_segment_time(batch)


def small_packed_step_matches_cpu():
    """One fp32 packed step at hidden 32 (one head of 32) on the card
    against the CPU, once with a local window of 32 (the band and kernel E)
    and once of 160 (kernels F and E), within 1e-4 as phase 4's small step."""
    for window in (32, 160):
        base, batch = small_packed_setup(hidden_size=32, num_attention_heads=1, head_dim=32, seq_window_size=window)
        cuda, cpu = one_fp32_step(base, batch, "cuda"), one_fp32_step(base, batch, "cpu")
        steps_match(cuda, cpu, 1e-4, f"packed, window {window}: card vs CPU")
        print(f"phase 8: small fp32 packed step (window {window}) on the card matches the CPU (loss {cpu[0]:.6f}, "
              f"max |grad diff| {grad_diff(cuda, cpu):.3g})", flush=True)  # fmt: skip


def flash_attention_f64(query, key, value, segment_ids, window=None):
    """Kernels E and F's function computed in fp64 and rounded once to the value dtype."""
    import torch

    from eventstreamgpt_tpu_torch.ops.flash_attention import attention_mask

    logits = torch.matmul(query.double(), key.double().transpose(-1, -2))
    probs = torch.softmax(logits.masked_fill(~attention_mask(segment_ids, window), float("-inf")), dim=-1)
    return torch.matmul(probs, value.double()).to(value.dtype)


def packed_kernels_match_plain_on_card():
    """The small fp32 packed step at hidden 128 (4 heads of 32), local window
    160, held by `kernels_match_plain_on_card` with kernels C, E and F."""
    import eventstreamgpt_tpu_torch.models.generative_layers as layers_module
    import eventstreamgpt_tpu_torch.models.transformer as transformer_module
    from eventstreamgpt_tpu_torch.ops import flash_attention as fa
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd, vocab_gather_reference

    base, batch = small_packed_setup(hidden_size=128, num_attention_heads=4, head_dim=32, seq_window_size=160)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_window_fwd,
                fa.flash_attention_window_bwd, vocab_gather_fwd, vocab_gather_bwd)  # fmt: skip
    kernels_match_plain_on_card(
        "phase 8", "packed", base, batch, counters,
        [(transformer_module, "flash_attention", fa.flash_attention_reference, flash_attention_f64),
         (layers_module, "vocab_gather", vocab_gather_reference, vocab_gather_reference)],
    )  # fmt: skip


# ---------------------------------------------------------------- phase 9
def kernel_ef_phase(args):
    """Kernels E (``window`` None) and F against their plain versions on the
    captured inputs, then timed in bf16 beside their bound and the library call."""
    import torch
    import torch.nn.functional as F

    from eventstreamgpt_tpu_torch.ops import flash_attention as fa

    result = {}
    for window, a in args.items():
        B, H, S, D = a["q"].shape
        seg = a["seg"]
        fwd = fa.flash_attention_fwd if window is None else fa.flash_attention_window_fwd
        bwd = fa.flash_attention_bwd if window is None else fa.flash_attention_window_bwd
        extra = () if window is None else (window,)
        name = "flash_attention" if window is None else "flash_attention_window"
        # The captured cotangent is small (the loss averages over ~8k events);
        # scaled to a largest magnitude of 1 it gives O(1) gradients.
        g_unit = a["g"] / a["g"].float().abs().max()
        max_err = {"fwd": 0.0, "bwd": 0.0}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, g = (t.to(dt) for t in (a["q"], a["k"], a["v"], g_unit))
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            want = fa.flash_attention_reference(*leaves, seg, window)
            want_grads = torch.autograd.grad(want, leaves, g)
            out, stats = fwd(q, k, v, seg, *extra)
            got_grads = bwd(q, k, v, seg, out, stats, g, *extra)
            # Not checked: each version's distance from the function computed in fp64.
            leaves64 = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
            exact = flash_attention_f64(*leaves64, seg, window)
            exact = (exact, *torch.autograd.grad(exact, leaves64, g.double()))
            # Not checked either: the kernel's backward given the fp64 output, so
            # that its di = sum(o * do) carries no rounding of o.
            exact_di = bwd(q, k, v, seg, exact[0].to(dt), stats, g, *extra)
            torch.cuda.synchronize()
            errs, tols, kernel64, plain64 = [], [], [], []
            for part, x, y, z in zip(("out", "dq", "dk", "dv"), (out, *got_grads), (want, *want_grads), exact):
                # fp32: 3e-5 of the largest magnitude; bf16: 5e-2 of it. The
                # kernel takes di = sum(o * do) from the rounded output, as the
                # TPU kernels do, where the plain version's autograd sums p * dP:
                # on trained activations, whose softmax rows are peaked, dP - di
                # cancels and leaves the output's rounding (fp32 ulps, or a bf16
                # ulp: 2^-9 of |o| |do|) in dS, which the plain version does not
                # carry. In bf16 the kernel also rounds the unnormalised
                # probabilities and the plain version the normalised ones and,
                # through its bf16 product, dP. Each version's distance from the
                # fp64 function is printed.
                top = y.float().abs().max().item()
                errs.append((x.float() - y.float()).abs().max().item())
                tols.append((3e-5 if dt == torch.float32 else 5e-2) * top)
                kernel64.append((x.double() - z).abs().max().item())
                plain64.append((y.double() - z).abs().max().item())
                if dt == torch.bfloat16:
                    key = "fwd" if part == "out" else "bwd"
                    max_err[key] = max(max_err[key], errs[-1])
            print(f"phase 9: {name} ({dt}) at (B={B}, H={H}, S={S}, D={D}), window {window}: max |diff| "
                  f"out/dq/dk/dv {', '.join(f'{e:.3g}' for e in errs)} (largest |plain| "
                  f"{', '.join(f'{y.float().abs().max().item():.3g}' for y in (want, *want_grads))}); not "
                  f"checked, vs fp64: kernel {', '.join(f'{e:.3g}' for e in kernel64)}, plain "
                  f"{', '.join(f'{e:.3g}' for e in plain64)}, kernel backward with di from the fp64 output "
                  f"{', '.join(f'{(x.double() - z).abs().max().item():.3g}' for x, z in zip(exact_di, exact[1:]))}",
                  flush=True)  # fmt: skip
            for part, err, tol in zip(("out", "dq", "dk", "dv"), errs, tols):
                check(err <= tol, f"kernel {name} {part} ({dt}) off its plain version by {err:.3g} "
                                  f"(tolerance {tol:.3g})")  # fmt: skip

        # Timing at the main path's shapes and type: bf16, the views the model passes.
        dt = torch.bfloat16
        q, k, v, g = (t.to(dt) for t in (a["q"], a["k"], a["v"], a["g"]))
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        ref_out = fa.flash_attention_reference(*leaves, seg, window)
        out, stats = fwd(q, k, v, seg, *extra)
        mask = fa.attention_mask(seg, window)  # (B, 1, S, S)
        lib = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib, attn_mask=mask, scale=1.0)
        t_fwd = timings(lambda: fwd(q, k, v, seg, *extra),
                        lambda: fa.flash_attention_reference(q, k, v, seg, window),
                        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0))  # fmt: skip
        t_bwd = timings(lambda: bwd(q, k, v, seg, out, stats, g, *extra),
                        lambda: torch.autograd.grad(ref_out, leaves, g, retain_graph=True),
                        lambda: torch.autograd.grad(lib_out, lib, g, retain_graph=True))  # fmt: skip
        # What tile skipping leaves, counted on the card: the tiles each kernel
        # walked in one forward and one backward, held equal to what
        # `tile_schedule` visits (H times), over the causal (and window) tiles;
        # and the time on the same q, k, v with one segment a row (no tile skipped).
        from eventstreamgpt_tpu_torch.utils.timing import time_ms

        one = torch.zeros_like(seg)
        in_range = fa.causal_tiles(S // fa.TILE, window).sum().item() * B * H
        walked = {}
        for label, ids in (("packed", seg), ("one-segment", one)):
            fa.tiles_walked()
            o_ids, stats_ids = fwd(q, k, v, ids, *extra)
            bwd(q, k, v, ids, o_ids, stats_ids, g, *extra)
            walked[label] = fa.tiles_walked()
            want = fa.tile_schedule(ids, window).sum().item() * H
            check(all(n == want for n in walked[label].values()),
                  f"kernel {name} walked {walked[label]} tiles on the {label} batch, where tile_schedule "
                  f"visits {want}")  # fmt: skip
        share = walked["packed"]["fwd"] / in_range
        one_out, one_stats = fwd(q, k, v, one, *extra)
        t_one = {"fwd": time_ms(lambda: fwd(q, k, v, one, *extra))["ms"],
                 "bwd": time_ms(lambda: bwd(q, k, v, one, one_out, one_stats, g, *extra))["ms"]}  # fmt: skip
        print(f"phase 9: {name} (window {window}) walked {walked['packed']} tiles (counted on the card; "
              f"tile_schedule's count) of {in_range} causal tiles over {B} rows x {H} heads: share {share:.4f}; "
              f"with one segment a row it walked {walked['one-segment']} (all) in forward {t_one['fwd']:.4f} ms, "
              f"backward {t_one['bwd']:.4f} ms against {t_fwd['ms']:.4f} / {t_bwd['ms']:.4f} ms on the packed batch",
              flush=True)  # fmt: skip
        esz = q.element_size()
        pairs = int(mask.sum()) * H  # allowed (query, key) pairs of this batch, every head
        tensor = B * H * S * D * esz
        small = B * S * 4 + 2 * B * H * S * 4  # segment ids; each row's m and l
        fwd_bytes, bwd_bytes = 4 * tensor + small, 8 * tensor + small  # q, k, v, o (+ do, dq, dk, dv)
        parts = (("fwd", t_fwd, fwd_bytes, 4 * D * pairs), ("bwd", t_bwd, bwd_bytes, 10 * D * pairs))
        for part, t, nbytes, flops in parts:
            bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bf16"] * 1e3
            result[f"{name}_{part}"] = dict(t, bound_ms=max(bytes_ms, ops_ms),
                                            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                                            max_abs_err=max_err[part], shape=[B, H, S, D], window=window,
                                            visited_share=share, one_segment_ms=t_one[part])  # fmt: skip
            print(f"phase 9: {name} {part} (bf16, window {window}): {fmt_times(t)}; bound "
                  f"{result[f'{name}_{part}']['bound_ms']:.5f} ms ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP over "
                  f"{pairs} allowed pairs, {pairs / (B * H * S * (S + 1) / 2):.3f} of the causal triangle)",
                  flush=True)  # fmt: skip
    return result


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke run needs one", file=sys.stderr)
        return 2
    if not (REPO / "eventstreamgpt_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the eventstreamgpt_tpu_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t0 = time.perf_counter()
    smi = device_phase()
    model, config, capture, runs = engine_phase(smi)
    a = kernel_a_phase(capture)
    b = kernel_b_phase(model, config, capture)
    captures_q, runs_q = quantized_engine_phase(smi, model, config, runs)
    bq = kernel_b_quant_phase(model, captures_q, smi)
    train, gather_capture = training_phase(smi)
    c = kernel_c_phase(gather_capture)
    na_train, dep_capture = na_training_phase(smi)
    d_times = kernel_d_phase(dep_capture)
    packed, flash_args = packed_training_phase(smi)
    ef = kernel_ef_phase(flash_args)
    kernels = [
        dict(name="fused_categorical", route="cuda", source="eventstreamgpt_tpu_torch/csrc/fused_sampling.cu",
             replaces="eventstreamgpt_tpu/ops/fused_sampling.py:171", entry="fused_categorical_stream",
             launches=runs["sampled"]["launches"]["fused_categorical_stream"], **a),
        dict(name="decode_stack_step", route="cuda", source="eventstreamgpt_tpu_torch/csrc/decode_step.cu",
             replaces="eventstreamgpt_tpu/ops/pallas_decode_step.py:297",
             launches=runs["greedy"]["launches"]["decode_stack_step"]
             + runs["sampled"]["launches"]["decode_stack_step"], **b),
    ] + [
        dict(name=f"decode_stack_step_{kv}", route="cuda", source="eventstreamgpt_tpu_torch/csrc/decode_step.cu",
             replaces="eventstreamgpt_tpu/ops/pallas_decode_step.py:297", entry="esgpt_decode_stack_step_quant",
             launches=sum(runs_q[(kv, m)]["launches"][f"decode_stack_step.launches_{kv}"]
                          for m in ("greedy", "sampled")),
             **bq[kv])
        for kv in QUANT_DTYPES
    ] + [
        dict(name=f"vocab_gather_{d}", route="cuda", source="eventstreamgpt_tpu_torch/csrc/vocab_gather.cu",
             replaces="eventstreamgpt_tpu/ops/pallas_heads.py:182", launches=train["launches"][f"vocab_gather_{d}"],
             **c[d])
        for d in ("fwd", "bwd")
    ] + [
        dict(name=f"dep_graph_{k}", route="cuda", source="eventstreamgpt_tpu_torch/csrc/dep_graph.cu",
             replaces="eventstreamgpt_tpu/ops/pallas_dep_graph.py:397", launches=na_train["launches"][f"dep_graph_{k}"],
             **d_times[k])
        for k in ("fwd", "bwd")
    ] + [
        dict(name=f"{n}_{k}", route="cuda", source="eventstreamgpt_tpu_torch/csrc/flash_attention.cu",
             replaces=f"eventstreamgpt_tpu/models/transformer.py:{line}",
             launches=sum(run["launches"][f"{n}_{k}"] for run in packed.values()), **ef[f"{n}_{k}"])
        for n, line in (("flash_attention", 864), ("flash_attention_window", 900))
        for k in ("fwd", "bwd")
    ]  # fmt: skip
    for k in kernels:
        check(all(isinstance(k[f], (int, float)) and math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms")),
              f"{k['name']}: a timing is missing")  # fmt: skip
        check(k["launches"] > 0, f"{k['name']}: never launched on the main path")
    single = {k["name"]: {f: k.pop(f"single_{f}") for f in ("ms", "plain_ms", "library_ms")} for k in kernels}
    print(f"chip_smoke: one synchronised call each, host work included: {json.dumps(single)}", flush=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)  # fmt: skip
    return 0


if __name__ == "__main__":
    sys.exit(main())
