"""A/B timing of versions of kernels E and F (``csrc/flash_attention.cu``) on one CUDA device.

Builds each given source with ``nvcc`` (all at once, as `ops.build` builds
the port's kernels), then, in turns (every version, then the first again),
runs and times its bf16 forward and backward through
`ops.flash_attention`'s own launch code on the same inputs: the packed
training batch (`data.synthetic.packed_batch`: 8 rows x 1,024 events) with
padding as segment ``-1``, numpy-seeded normal q, k, v and cotangent at
``(8, 4, 1024, 64)`` as heads-first views of ``(B, S, H, D)`` tensors,
without a window (E), with a window of 256 (F) and with one segment a row
(E, no tile skipped). For each it prints the tiles each kernel walked
(counted on the card), the device time per call (`utils.timing.time_ms`),
the backward's split between its dq and dk/dv kernels (``torch.profiler``),
and each output's largest distance from the plain version, over that
tensor's largest magnitude. With ``--trace`` each source is built with
``-DESGPT_FLASH_TRACE`` and the per-block record of each kernel (global
timer, ns) is summarised: the kernel's span, the median block's time before
and in its tile walk, the time a tile takes, the blocks resident at once,
and the longest block.

Run from the root of a checkout:

    python -m eventstreamgpt_tpu_torch.tools.ab_flash                       # the checkout's source
    python -m eventstreamgpt_tpu_torch.tools.ab_flash old=build/old.cu new=build/new.cu:NAME=1
    python -m eventstreamgpt_tpu_torch.tools.ab_flash --trace --out build/ab_flash.json
    python -m eventstreamgpt_tpu_torch.tools.ab_flash --heads 8 --head-dim 128 --registers

``--heads`` / ``--head-dim`` set the shape (bench.py's production width is
8 heads of 128); ``--registers`` prints each kernel's registers, shared
memory and spills as ``nvcc -Xptxas -v`` reports them for every version.

A version is ``name=path`` with optional ``:NAME=VALUE,NAME2`` macro
definitions; it must have this source's C interface. It exits non-zero
without a CUDA device.
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

from ..data.synthetic import packed_batch, serving_config
from ..ops import build
from ..ops import flash_attention as fa
from ..utils.timing import time_ms

B, H, S, D = 8, 4, 1024, 64
TRACE_DEFINE = "ESGPT_FLASH_TRACE"
TRACE_SHAPE = (3, 1 << 14, 5)  # csrc/flash_attention.cu's g_trace
TRACE_KERNELS = ("fwd", "dq", "dkv")


def build_versions(specs: list[str], trace: bool) -> dict[str, ctypes.CDLL]:
    """Each ``name=path[:MACROS]`` built (all at once) and bound."""
    jobs = {}
    for spec in specs:
        name, rest = spec.split("=", 1)
        path, _, defs = rest.partition(":")
        defines = tuple(d for d in defs.split(",") if d) + ((TRACE_DEFINE,) if trace else ())
        jobs[name] = (str(Path(path).resolve()), defines)
    paths = build.build_all(list(jobs.values()))
    return {name: fa.bind(ctypes.CDLL(str(paths[job]))) for name, job in jobs.items()}


def read_trace(lib: ctypes.CDLL, n_blocks: int) -> dict[str, np.ndarray]:
    """Each bf16 kernel's per-block record of its latest launch, ``(n_blocks, 5)``
    int64: global timer (ns) at the block's start, at its walk and at its end;
    its SM; the tiles it walked."""
    buf = np.zeros(TRACE_SHAPE, np.uint64)
    err = lib.esgpt_flash_trace(buf.ctypes.data)
    if err != 0:
        raise RuntimeError(f"ab_flash: reading the trace failed with CUDA error {err}")
    return {kernel: buf[i, :n_blocks].astype(np.int64) for i, kernel in enumerate(TRACE_KERNELS)}


def trace_summary(records: dict[str, np.ndarray]) -> dict:
    out = {}
    for kernel, rec in records.items():
        t0 = rec[:, 0].min()
        start, walk, end = ((rec[:, i] - t0) / 1e3 for i in range(3))  # us
        before, walking, tiles = walk - start, end - walk, rec[:, 4]
        resident = max(int(((start <= x) & (end > x)).sum()) for x in np.linspace(0, end.max(), 200))
        out[kernel] = dict(
            span_us=end.max(), block_us_median=float(np.median(end - start)), block_us_max=float((end - start).max()),
            before_walk_us_median=float(np.median(before)), walk_us_median=float(np.median(walking)),
            tile_us_median=float(np.median(walking / np.maximum(tiles, 1))), tiles_mean=float(tiles.mean()),
            tiles_max=int(tiles.max()), resident_blocks_max=resident, last_start_us=float(start.max()),
        )  # fmt: skip
    return out


def backward_split(bwd) -> dict:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            bwd()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        for kernel in ("mma_bwd_dq", "mma_bwd_dkv"):
            if kernel in evt.key:
                split[kernel] = split.get(kernel, 0.0) + us / 10 / 1000
    return split


def run(lib, q, k, v, g, seg, window, trace: bool) -> dict:
    what = "ab_flash"
    fa.tiles_walked(lib)
    out, stats = fa._fwd(q, k, v, seg, window, what, lib)
    grads = fa._bwd(q, k, v, seg, out, stats, g, window, what, lib)
    walked = fa.tiles_walked(lib)

    def fwd():
        fa._fwd(q, k, v, seg, window, what, lib)

    def bwd():
        fa._bwd(q, k, v, seg, out, stats, g, window, what, lib)

    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    want = fa.flash_attention_reference(*leaves, seg, window)
    wants = (want, *torch.autograd.grad(want, leaves, g))
    result = dict(tiles_walked=walked, fwd_ms=time_ms(fwd)["ms"], bwd_ms=time_ms(bwd)["ms"],
                  bwd_split_ms=backward_split(bwd),
                  rel_err={name: (x.float() - y.float()).abs().max().item() / y.float().abs().max().item()
                           for name, x, y in zip(("out", "dq", "dk", "dv"), (out, *grads), wants)})  # fmt: skip
    if trace:
        fwd()
        bwd()
        torch.cuda.synchronize()
        result["trace"] = trace_summary(read_trace(lib, q.shape[0] * q.shape[1] * q.shape[2] // fa.TILE))
    return result


def ptxas_report(path: str) -> str:
    """``nvcc -Xptxas -v``'s lines for the source at ``path`` (compiled to a
    cubin that is thrown away): each kernel's registers, shared memory and spills."""
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [build.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v", "-o", "/dev/null", path]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    keep = ("Compiling entry", "registers", "spill")
    return "\n".join(line for line in (out.stdout + out.stderr).splitlines() if any(k in line for k in keep))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("versions", nargs="*", help="name=path[:MACRO=VALUE,...]; default: the checkout's source")
    parser.add_argument("--trace", action="store_true", help="build with the per-block trace and summarise it")
    parser.add_argument("--heads", type=int, default=H)
    parser.add_argument("--head-dim", type=int, default=D)
    parser.add_argument("--registers", action="store_true", help="print nvcc -Xptxas -v for each version")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    heads, head_dim = args.heads, args.head_dim
    if not torch.cuda.is_available():
        print("ab_flash: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]  # fmt: skip
    print(smi, flush=True)
    versions = args.versions or [f"checkout={build.CSRC_DIR / fa.SOURCE}"]
    libs = build_versions(versions, args.trace)
    if args.registers:
        for spec in versions:
            print(f"{spec}:\n{ptxas_report(spec.split('=', 1)[1].partition(':')[0])}", flush=True)
    batch = packed_batch(serving_config(), 512, B, S)
    packed = torch.where(batch.event_mask, batch.segment_ids.to(torch.int32), -1).cuda()
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, S, heads, head_dim)).astype(np.float32) * scale)
                  .to(torch.bfloat16).cuda().transpose(1, 2) for scale in (0.3, 0.3, 1.0, 1.0))  # fmt: skip
    report = dict(card=smi, shape=[B, heads, S, head_dim], cases={})
    order = list(libs) + [next(iter(libs))]  # each version, then the first again
    for case, seg, window in (("packed", packed, None), ("packed_w256", packed, 256),
                              ("one_segment", torch.zeros_like(packed), None)):  # fmt: skip
        causal = fa.causal_tiles(S // fa.TILE, window).sum().item() * B * heads
        report["cases"][case] = dict(causal_tiles=causal, runs=[],
                                     schedule_tiles=fa.tile_schedule(seg, window).sum().item() * heads)  # fmt: skip
        for turn, name in enumerate(order):
            res = dict(version=name, turn=turn, **run(libs[name], q, k, v, g, seg, window, args.trace))
            report["cases"][case]["runs"].append(res)
            share = res["tiles_walked"]["fwd"] / causal
            print(f"{case} {name}: walked {json.dumps(res['tiles_walked'])} of {causal} causal tiles ({share:.4f}); "
                  f"fwd {res['fwd_ms']:.4f} ms, bwd {res['bwd_ms']:.4f} ms {json.dumps(res['bwd_split_ms'])}; "
                  f"rel err {json.dumps(res['rel_err'])}", flush=True)  # fmt: skip
            for kernel, t in res.get("trace", {}).items():
                print(f"  trace {kernel}: {json.dumps({key: round(x, 3) for key, x in t.items()})}", flush=True)
    print(json.dumps(report))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
