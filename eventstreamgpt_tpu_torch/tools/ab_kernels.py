"""A/B timing of versions of kernel B (``csrc/decode_step.cu``) and kernel C's
backward (``csrc/vocab_gather.cu``) on one CUDA device.

Builds the checkout's two sources and each given version (all at once, as
`ops.build` builds the port's kernels), then, in turns (the checkout, each
given version, then the same in reverse order), times each version through
the port's own launch code on the same inputs:

* B at the serving shape: the serving benchmark's CI model
  (`data.synthetic.serving_config`, bf16, numpy-seeded weights of std 0.02),
  32 slots with cursors drawn from 128-255, padding bits set below each
  cursor except a few, normal K, V and h0 (numpy seed 0), windows (32, 0)
  (every call writes the same k and v at the cursors, so repeated calls
  compute the same step);
* C backward at the training shape: a (8192, 7000) bf16 plane's gradient
  from (8192, 48) indices laid out as the regression head lays them out
  (``2 i`` and ``2 i + 1`` for 24 data elements an event, 60% of them
  padding index 0) and a normal fp32 cotangent.

For each it prints the device time per call (`utils.timing.time_ms`, the
timer `chip_smoke.py` uses) and each output's largest distance from the
checkout's (C backward must be bit-equal). The card's name and power limit
come first. With ``--trace`` the checkout's B is also built with
``-DESGPT_DECODE_TRACE`` and run once more, and its per-CTA record (global
timer, ns) is summarised: for each layer's phases, the median and largest
time a CTA spent in it, and the kernel's span. Run from the root of a
checkout:

    python -m eventstreamgpt_tpu_torch.tools.ab_kernels --b old=build/old_b.cu --c old=build/old_c.cu
    python -m eventstreamgpt_tpu_torch.tools.ab_kernels --trace

A version is ``name=path`` with optional ``:NAME=VALUE,NAME2`` macro
definitions; it must have the same C interface as the checkout's source. It
exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..convert import init_params_from_seed
from ..data.synthetic import serving_config
from ..models.ci_model import CIPPTForGenerativeSequenceModeling
from ..ops import build
from ..ops import decode_step as ds
from ..ops import vocab_gather as vg
from ..utils.timing import time_ms

B_SLOTS, M = 32, 256
ROWS, V, ELEMENTS = 8192, 7000, 24
TRACE_DEFINE = "ESGPT_DECODE_TRACE"
TRACE_SHAPE = (1024, 64)  # csrc/decode_step.cu's g_trace
PHASES = ("ln1", "qkv", "attention", "exchange_o", "wo", "exchange_x", "ln2", "fc", "exchange_f", "wpr", "exchange_h")


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


def c_inputs():
    rng = np.random.default_rng(0)
    idx = np.where(rng.random((ROWS, ELEMENTS)) < 0.4, rng.integers(1, V // 2, size=(ROWS, ELEMENTS)), 0)
    ci = torch.from_numpy(np.concatenate([2 * idx, 2 * idx + 1], axis=-1).astype(np.int32)).cuda()
    g = torch.from_numpy(rng.normal(size=(ROWS, 2 * ELEMENTS)).astype(np.float32)).cuda()
    return g, ci


def run_b(fn, inputs) -> tuple[float, torch.Tensor]:
    weights, kc, vc, h0, start, em, mask, kw = inputs
    k2, v2 = kc.clone(), vc.clone()

    def call():
        return ds._launch(weights, k2, v2, h0, start, em, mask, kw["windows"], kw["activation"],
                          kw["layer_norm_eps"], kw["active"], fn)  # fmt: skip

    h = call()[0].float()
    return time_ms(call, n=20)["ms"], h


def run_c(fn, inputs) -> tuple[float, torch.Tensor]:
    g, ci = inputs
    dz = vg._bwd(g, ci, V, torch.bfloat16, fn)
    return time_ms(lambda: vg._bwd(g, ci, V, torch.bfloat16, fn))["ms"], dz


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
    parser.add_argument("--c", action="append", default=[], help="name=path[:MACRO=VALUE,...] of vocab_gather.cu")
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
    jobs = {"B": version_jobs(args.b, ds.SOURCE), "C bwd": version_jobs(args.c, vg.SOURCE)}
    traced = (str(build.CSRC_DIR / ds.SOURCE), (TRACE_DEFINE,))
    extra = [traced] if args.trace else []
    paths = build.build_all([job for versions in jobs.values() for job in versions.values()] + extra)
    libs = {kernel: load(versions, paths) for kernel, versions in jobs.items()}
    bound = {"B": (ds.bind, run_b, b_inputs()), "C bwd": (lambda lib: vg.bind(lib)[1], run_c, c_inputs())}
    report = dict(card=smi, runs={})
    for kernel, versions in libs.items():
        bind, run, inputs = bound[kernel]
        names = list(versions)
        order = names + names[::-1]
        want = None
        runs = report["runs"][kernel] = []
        for turn, name in enumerate(order):
            ms, out = run(bind(versions[name]), inputs)
            torch.cuda.synchronize()
            if want is None:
                want = out
            diff = (out.float() - want.float()).abs().max().item()
            runs.append(dict(version=name, turn=turn, ms=ms, max_abs_diff_from_checkout=diff))
            print(f"{kernel} {name} (turn {turn}): {ms:.4f} ms, max |diff| from the checkout {diff:.3g}", flush=True)
        if kernel == "C bwd" and any(r["max_abs_diff_from_checkout"] != 0 for r in runs):
            print("ab_kernels: a C backward version differs from the checkout's", file=sys.stderr)
            return 1
    if args.trace:
        report["trace_b"] = trace_b(ctypes.CDLL(str(paths[traced])), bound["B"][2])
        for key, value in report["trace_b"].items():
            print(f"trace B {key}: {json.dumps(value)}", flush=True)
    print(json.dumps(report))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
