"""A/B timing of versions of kernel A (``csrc/fused_sampling.cu`` against
another checkout's), kernel B (``csrc/decode_step.cu``), kernel C's forward
and backward (``csrc/vocab_gather.cu``) and kernel D (``csrc/dep_graph.cu``,
forward and backward) on one CUDA device.

Builds the checkout's sources and each given version (all at once, as
`ops.build` builds the port's kernels), then, in turns (the checkout, each
given version, then the same in reverse order), times each version through
the port's own launch code on the same inputs. Only the kernels given a
version run (all of them, the checkout's alone, when none is given):

* A at the serving shape: the 40-way ``event_type`` columns of a (32, 4057)
  fp32 plane (a strided view, as the heads pass it; normal logits of scale
  3, 90% of rows active, numpy seed 0), through the checkout's
  `fused_categorical_stream` (noise drawn inside) and `fused_categorical`
  (noise given), and through each other checkout's `fused_categorical`
  (``--a name=DIR``: the ``eventstreamgpt_tpu_torch`` package under DIR,
  imported under its own name), with the noise given and with the ATen
  ``gumbel(stream)`` drawn first as the engine drew it there; every
  version's indices must equal the checkout's plain version's on the same
  noise. Beside them the ATen noise alone and the launch floor (an empty
  kernel);

* B at the serving shape: the serving benchmark's CI model
  (`data.synthetic.serving_config`, bf16, numpy-seeded weights of std 0.02),
  32 slots with cursors drawn from 128-255, padding bits set below each
  cursor except a few, normal K, V and h0 (numpy seed 0), windows (32, 0)
  (every call writes the same k and v at the cursors, so repeated calls
  compute the same step); beside the versions (all through the float entry,
  whose C signature older builds share), the checkout's quantized entry on
  the same caches as int8 and as fp8 codes with their scales
  (`ops.kv_quant.quantize_kv`), each version in turns;
* C forward and backward at the training shape: a normal (8192, 7000) bf16
  plane, gathered at and its gradient scattered from (8192, 48) indices
  laid out as the regression head lays them out (``2 i`` and ``2 i + 1``
  for 24 data elements an event, 60% of them padding index 0) with a
  normal fp32 cotangent; beside the forward the launch floor;
* D forward and backward at the nested-attention training shape: N = 8192
  rows, Q = 3 queries (the ``[:, 1:]`` view of an ``(N, 4, 4, 64)``
  projection, as the model passes it), S = 4 positions, H = 4, D = 64,
  bf16, normal q, k, v and cotangent of std 0.5 and a keep-mask at rate 0.1
  (numpy seed 0).

For each it prints the device time per call (`utils.timing.time_ms`, the
timer `chip_smoke.py` uses) and each output's largest distance from the
checkout's (C must be bit-equal; D prints out, dq, dk and dv).
Beside D it times two floors on the same inputs: the checkout's source
built with ``-DESGPT_DG_COPY_ONLY=1`` (the same loads and stores, no
arithmetic) and a PyTorch copy moving as many bytes (half read, half
written). The card's name and power limit come first. With ``--trace`` the checkout's B is also built with
``-DESGPT_DECODE_TRACE`` and run once more, and its per-CTA record (global
timer, ns) is summarised: for each layer's phases, the median and largest
time a CTA spent in it, and the kernel's span. Run from the root of a
checkout:

    python -m eventstreamgpt_tpu_torch.tools.ab_kernels --b old=build/old_b.cu --c old=build/old_c.cu
    python -m eventstreamgpt_tpu_torch.tools.ab_kernels --trace
    python -m eventstreamgpt_tpu_torch.tools.ab_kernels --d old=build/old_d.cu
    python -m eventstreamgpt_tpu_torch.tools.ab_kernels --a parent=build/parent --c-fwd old=build/old_c.cu

A version is ``name=path`` with optional ``:NAME=VALUE,NAME2`` macro
definitions; it must have the same C interface as the checkout's source. It
exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..convert import init_params_from_seed
from ..data.synthetic import serving_config
from ..distributions import gumbel
from ..generation.sampling import RowStreams
from ..models.ci_model import CIPPTForGenerativeSequenceModeling
from ..ops import build
from ..ops import decode_step as ds
from ..ops import dep_graph as dg
from ..ops import fused_sampling as fs
from ..ops import vocab_gather as vg
from ..ops.kv_quant import FP8_DTYPE, quantize_kv
from ..utils.timing import time_ms

B_SLOTS, M = 32, 256
A_VOCAB, A_COLUMNS, A_SALT = 4057, slice(1, 41), 7  # the event_type head's columns of the serving plane
ROWS, V, ELEMENTS = 8192, 7000, 24
D_SHAPE, D_RATE = (8192, 4, 4, 64), 0.1  # (N, S, H, D); Q = S - 1 queries at q_offset 1
TRACE_DEFINE = "ESGPT_DECODE_TRACE"
TRACE_SHAPE = (1024, 64)  # csrc/decode_step.cu's g_trace
D_FLOOR_DEFINE = "ESGPT_DG_COPY_ONLY=1"
PHASES = ("ln1", "qkv", "attention", "exchange_o", "wo", "exchange_x", "ln2", "fc", "exchange_f", "wpr", "exchange_h")
QUANT = {"int8": torch.int8, "fp8": FP8_DTYPE}


def version_jobs(specs: list[str], source: str) -> dict[str, tuple]:
    """The build jobs of the checkout's ``source`` and of each ``name=path[:MACROS]``."""
    jobs = {"checkout": (str(build.CSRC_DIR / source), ())}
    for spec in specs:
        name, rest = spec.split("=", 1)
        path, _, defs = rest.partition(":")
        jobs[name] = (str(Path(path).resolve()), tuple(d for d in defs.split(",") if d))
    return jobs


def load(jobs: dict, paths: dict) -> dict[str, ctypes.CDLL]:
    return {name: ctypes.CDLL(str(paths[job])) for name, job in jobs.items()}


@functools.cache
def b_inputs():
    config = serving_config()
    model = init_params_from_seed(CIPPTForGenerativeSequenceModeling(config), seed=0).cuda()
    weights = ds.stack_layer_weights(model.encoder.blocks(), torch.bfloat16)
    L, H, D = config.num_hidden_layers, config.num_attention_heads, config.head_dim
    rng = np.random.default_rng(0)
    start = rng.integers(128, 256, size=B_SLOTS).astype(np.int32)
    mask = np.arange(M)[None, :] < start[:, None]
    mask[rng.random((B_SLOTS, M)) < 0.02] = False

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    kc, vc = (t(rng.normal(size=(L, B_SLOTS, H, M, D)).astype(np.float32)).bfloat16() for _ in range(2))
    h0 = t(rng.normal(size=(B_SLOTS, H * D)).astype(np.float32)).bfloat16()
    windows = tuple(config.seq_window_size if a == "local" else 0 for a in config.seq_attention_layers)
    kw = dict(windows=windows, activation=config.activation_function, layer_norm_eps=config.layer_norm_epsilon,
              active=t(np.ones(B_SLOTS, bool)))  # fmt: skip
    return weights, kc, vc, h0, t(start), t(np.ones(B_SLOTS, bool)), t(mask), kw


@functools.cache
def c_inputs():
    rng = np.random.default_rng(0)
    idx = np.where(rng.random((ROWS, ELEMENTS)) < 0.4, rng.integers(1, V // 2, size=(ROWS, ELEMENTS)), 0)
    ci = torch.from_numpy(np.concatenate([2 * idx, 2 * idx + 1], axis=-1).astype(np.int32)).cuda()
    g = torch.from_numpy(rng.normal(size=(ROWS, 2 * ELEMENTS)).astype(np.float32)).cuda()
    return g, ci


@functools.cache
def d_inputs():
    rng = np.random.default_rng(0)
    N, S, H, D = D_SHAPE

    def t(shape):
        return torch.from_numpy(rng.normal(scale=0.5, size=shape).astype(np.float32)).cuda().bfloat16()

    full, k, v, g = t(D_SHAPE), t(D_SHAPE), t(D_SHAPE), t((N, S - 1, H, D))
    keep = torch.from_numpy(rng.random((N, S - 1, S, H)) >= D_RATE).cuda()
    return full[:, 1:], k, v, g, keep


def run_d_fwd(fn, inputs) -> tuple[float, tuple]:
    q, k, v, g, keep = inputs

    def call():
        return dg._fwd(q, k, v, 1, None, keep, 1.0 - D_RATE, fn)

    return time_ms(call)["ms"], (call(),)


def run_d_bwd(fn, inputs) -> tuple[float, tuple]:
    q, k, v, g, keep = inputs

    def call():
        return dg._bwd(q, k, v, g, 1, None, keep, 1.0 - D_RATE, fn)

    return time_ms(call)["ms"], call()


def run_b(fn, inputs) -> tuple[float, torch.Tensor]:
    weights, kc, vc, h0, start, em, mask, kw = inputs
    k2, v2 = kc.clone(), vc.clone()

    def call():
        return ds._launch(weights, k2, v2, h0, start, em, mask, kw["windows"], kw["activation"],
                          kw["layer_norm_eps"], kw["active"], fn)  # fmt: skip

    h = call()[0].float()
    return time_ms(call, n=20)["ms"], h


def b_quant_inputs(kv: str):
    """`b_inputs` with the caches quantized to ``kv`` codes and fp32 scales."""
    weights, kc, vc, h0, start, em, mask, kw = b_inputs()
    (kq, ks), (vq, vs) = (quantize_kv(c, QUANT[kv]) for c in (kc, vc))
    return weights, kq, vq, h0, start, em, mask, dict(kw, key_scale=ks, value_scale=vs)


def run_b_quant(inputs) -> tuple[float, torch.Tensor]:
    weights, kc, vc, h0, start, em, mask, kw = inputs
    k2, v2, ks, vs = kc.clone(), vc.clone(), kw["key_scale"].clone(), kw["value_scale"].clone()

    def call():
        return ds._launch(weights, k2, v2, h0, start, em, mask, kw["windows"], kw["activation"],
                          kw["layer_norm_eps"], kw["active"], key_scale=ks, value_scale=vs)  # fmt: skip

    h = call()[0].float()
    return time_ms(call, n=20)["ms"], h


def ab_b_quant(float_h: torch.Tensor) -> list[dict]:
    """The checkout's quantized B (int8, fp8) in turns, with each one's
    largest distance of ``h`` from the checkout's float B on the float caches."""
    runs = []
    for turn, kv in enumerate(list(QUANT) + list(QUANT)[::-1]):
        ms, h = run_b_quant(b_quant_inputs(kv))
        torch.cuda.synchronize()
        diff = (h - float_h).abs().max().item()
        runs.append(dict(version=f"checkout {kv}", turn=turn, ms=ms, max_abs_diff_from_float_cache=diff))
        print(f"B quantized {kv} (turn {turn}): {ms:.4f} ms, max |h diff| from the float cache {diff:.3g}", flush=True)
    return runs


def run_c(fn, inputs) -> tuple[float, torch.Tensor]:
    g, ci = inputs
    dz = vg._bwd(g, ci, V, torch.bfloat16, fn)
    return time_ms(lambda: vg._bwd(g, ci, V, torch.bfloat16, fn))["ms"], dz


@functools.cache
def c_fwd_inputs():
    ci = c_inputs()[1]
    z = torch.from_numpy(np.random.default_rng(1).normal(size=(ROWS, V)).astype(np.float32)).cuda().bfloat16()
    return z, ci


def run_c_fwd(fn, inputs) -> tuple[float, torch.Tensor]:
    z, ci = inputs
    return time_ms(lambda: vg._fwd(z, ci, fn), n=100)["ms"], vg._fwd(z, ci, fn)


def load_package(alias: str, root: str):
    """Another checkout's ``eventstreamgpt_tpu_torch`` (under ``root``), imported as ``alias``."""
    pkg = Path(root).resolve() / "eventstreamgpt_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def ab_a(specs: list[str]) -> list[dict]:
    """Kernel A's versions in turns at the serving shape (module docstring)."""
    rng = np.random.default_rng(0)
    plane = torch.from_numpy((rng.normal(size=(B_SLOTS, A_VOCAB)) * 3).astype(np.float32)).cuda()
    logits = plane[:, A_COLUMNS]
    seeds = torch.from_numpy(rng.integers(-(2**62), 2**62, size=B_SLOTS)).cuda()
    counters = torch.from_numpy(rng.integers(0, 2**20, size=B_SLOTS)).cuda()
    active = torch.from_numpy(rng.random(B_SLOTS) < 0.9).cuda()

    def stream():
        return RowStreams(seeds, counters, A_SALT)

    g = gumbel(stream(), logits.shape, "cuda")  # fp32, as the logits
    want = fs.fused_categorical_reference(logits, g, None, active)
    calls = {"checkout, noise inside": lambda s: fs.fused_categorical_stream(logits, s, None, active),
             "checkout, noise given": lambda s: fs.fused_categorical(logits, g, None, active)}  # fmt: skip
    for spec in specs:
        name, root = spec.split("=", 1)
        other = importlib.import_module(f"{load_package(f'ab_kernels_{name}', root).__name__}.ops.fused_sampling")
        calls[f"{name}, noise given"] = lambda s, m=other: m.fused_categorical(logits, g, None, active)
        calls[f"{name}, ATen noise then kernel"] = lambda s, m=other: m.fused_categorical(
            logits, gumbel(s, logits.shape, "cuda"), None, active
        )
    calls["ATen noise alone"] = lambda s: gumbel(s, logits.shape, "cuda")
    calls["launch floor"] = lambda s: fs.launch_floor()
    runs = []
    order = list(calls) + list(calls)[::-1]
    for turn, name in enumerate(order):
        out = calls[name](stream())
        torch.cuda.synchronize()
        if name not in ("ATen noise alone", "launch floor") and not torch.equal(out, want):
            raise RuntimeError(f"ab_kernels: kernel A version {name!r} differs from the plain version")
        s = stream()
        # The ATen noise is about a hundred launches a call: 4 calls keep the
        # queue of pending launches short enough that the device, not the
        # host's enqueueing, is timed.
        t = time_ms(lambda: calls[name](s), n=4 if "ATen" in name else 100)
        runs.append(dict(version=name, turn=turn, ms=t["ms"], single_ms=t["single_ms"]))
        print(f"A {name} (turn {turn}): {t['ms']:.4f} ms, one synchronised call {t['single_ms']:.4f} ms", flush=True)
    return runs


def trace_b(lib: ctypes.CDLL, inputs) -> dict:
    """One traced call of B; per layer and phase the median and largest CTA time (us), and the span."""
    weights, kc, vc, h0, start, em, mask, kw = inputs
    run_b(ds.bind(lib), inputs)
    torch.cuda.synchronize()
    buf = np.zeros(TRACE_SHAPE, np.uint64)
    err = lib.esgpt_decode_trace(ctypes.c_void_p(buf.ctypes.data))
    if err != 0:
        raise RuntimeError(f"ab_kernels: reading the trace failed with CUDA error {err}")
    L, H = kc.shape[0], kc.shape[2]
    ctas = B_SLOTS * ds.cluster_size(H)
    rec = buf[:ctas, : 2 + L * len(PHASES)].astype(np.int64)
    t0 = rec[:, 0].min()
    steps = np.diff(rec, axis=1) / 1e3  # us between stamps
    out = dict(span_us=float((rec[:, -1].max() - t0) / 1e3), start_spread_us=float((rec[:, 0].max() - t0) / 1e3))
    for l in range(L):
        for p, name in enumerate(PHASES):
            col = steps[:, l * len(PHASES) + p]
            out[f"l{l}_{name}"] = dict(median_us=float(np.median(col)), max_us=float(col.max()))
    out["final_exchange_us"] = float(np.median(steps[:, -1]))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--b", action="append", default=[], help="name=path[:MACRO=VALUE,...] of decode_step.cu")
    parser.add_argument("--a", action="append", default=[], help="name=DIR of another checkout (its kernel A)")
    parser.add_argument("--c", action="append", default=[], help="name=path[:MACRO=VALUE,...] of vocab_gather.cu")
    parser.add_argument("--c-fwd", action="append", default=[], help="the same, C's forward timed")
    parser.add_argument("--d", action="append", default=[], help="name=path[:MACRO=VALUE,...] of dep_graph.cu")
    parser.add_argument("--trace", action="store_true", help="summarise B's per-CTA phase trace")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]  # fmt: skip
    print(smi, flush=True)
    given = {"B": args.b, "C fwd": args.c_fwd, "C bwd": args.c, "D": args.d}
    sources = {"B": ds.SOURCE, "C fwd": vg.SOURCE, "C bwd": vg.SOURCE, "D": dg.SOURCE}
    run_all = not any(given.values()) and not args.a
    jobs = {kernel: version_jobs(specs, sources[kernel]) for kernel, specs in given.items() if specs or run_all}
    traced = (str(build.CSRC_DIR / ds.SOURCE), (TRACE_DEFINE,))
    d_floor = (str(build.CSRC_DIR / dg.SOURCE), (D_FLOOR_DEFINE,))
    extra = ([traced] if args.trace else []) + ([d_floor] if "D" in jobs else [])
    a_source = [fs.SOURCE] if args.a or run_all else []
    paths = build.build_all([job for versions in jobs.values() for job in versions.values()] + extra + a_source)
    libs = {kernel: load(versions, paths) for kernel, versions in jobs.items()}
    parts = {
        "B": [("B", ds.bind, run_b, b_inputs)],
        "C fwd": [("C fwd", lambda lib: vg.bind(lib)[0], run_c_fwd, c_fwd_inputs)],
        "C bwd": [("C bwd", lambda lib: vg.bind(lib)[1], run_c, c_inputs)],
        "D": [("D fwd", lambda lib: dg.bind(lib)[0], run_d_fwd, d_inputs),
              ("D bwd", lambda lib: dg.bind(lib)[1], run_d_bwd, d_inputs)],
    }  # fmt: skip
    report = dict(card=smi, runs={})
    if a_source:
        report["runs"]["A"] = ab_a(args.a)
    for kernel, versions in libs.items():
        for part, bind, run, make_inputs in parts[kernel]:
            inputs = make_inputs()
            names = list(versions)
            order = names + names[::-1]
            want = None
            runs = report["runs"][part] = []
            for turn, name in enumerate(order):
                ms, out = run(bind(versions[name]), inputs)
                torch.cuda.synchronize()
                outs = out if isinstance(out, tuple) else (out,)
                if want is None:
                    want = outs
                diffs = [(o.float() - w.float()).abs().max().item() for o, w in zip(outs, want)]
                runs.append(dict(version=name, turn=turn, ms=ms, max_abs_diff_from_checkout=max(diffs),
                                 max_abs_diffs=diffs))  # fmt: skip
                print(f"{part} {name} (turn {turn}): {ms:.4f} ms, max |diff| from the checkout "
                      f"{', '.join(f'{d:.3g}' for d in diffs)}", flush=True)  # fmt: skip
            if part.startswith("D"):
                floor_ms = run(bind(ctypes.CDLL(str(paths[d_floor]))), inputs)[0]
                q, k, v, g, keep = inputs
                read = (q, k, v, keep) if part == "D fwd" else (q, k, v, g, keep)
                nbytes = sum(t.numel() * t.element_size() for t in (*read, *want))
                src = torch.empty(nbytes // 4, dtype=torch.int16, device="cuda")
                dst = torch.empty_like(src)
                copy_ms = time_ms(lambda: dst.copy_(src))["ms"]
                report["runs"][f"{part} floors"] = dict(bytes=nbytes, copy_only_ms=floor_ms, torch_copy_ms=copy_ms)
                print(f"{part}: the same loads and stores without arithmetic {floor_ms:.4f} ms; a copy of the same "
                      f"{nbytes / 1e6:.2f} MB {copy_ms:.4f} ms", flush=True)  # fmt: skip
            if part == "B":
                report["runs"]["B quantized"] = ab_b_quant(want[0].float())
            if part == "C fwd":
                floor = time_ms(fs.launch_floor, n=100)
                report["runs"]["C fwd floor"] = dict(launch_floor_ms=floor["ms"], single_ms=floor["single_ms"])
                print(f"C fwd: launch floor (an empty kernel) {floor['ms']:.4f} ms", flush=True)
            if part.startswith("C") and any(r["max_abs_diff_from_checkout"] != 0 for r in runs):
                print(f"ab_kernels: a {part} version differs from the checkout's", file=sys.stderr)
                return 1
    if args.trace:
        report["trace_b"] = trace_b(ctypes.CDLL(str(paths[traced])), b_inputs())
        for key, value in report["trace_b"].items():
            print(f"trace B {key}: {json.dumps(value)}", flush=True)
    print(json.dumps(report))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
