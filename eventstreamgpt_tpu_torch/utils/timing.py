"""Device time of a function on a CUDA device, with CUDA events.

Used by ``chip_smoke.py`` and ``tools/ab_flash.py``; nothing here runs on
import.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def _sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card (measured once)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def time_ms(fn, n=50, repeats=5, warmup=3) -> dict:
    """``ms``: device time per launch, from CUDA events around ``n``
    back-to-back calls queued behind a device-side sleep long enough for the
    host to enqueue them all (median of ``repeats``); ``single_ms``: one
    synchronised call, host work included (median of 30). ``n`` times the
    launches of one call must stay well under the depth of the stream's
    queue of pending launches: past it the host waits for the device, and
    the host's enqueueing rate is what gets timed (on an NVIDIA H100 80GB
    HBM3 at 700 W a function of about a hundred launches read 0.81-0.85 ms a
    call at ``n`` = 100 and 0.23 ms at ``n`` = 4)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    singles = []
    for _ in range(30):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        singles.append(start.elapsed_time(end))
    singles.sort()
    single = singles[len(singles) // 2]
    cycles = int(_sleep_cycles_per_ms() * min(2.0 * n * single + 5.0, 2000.0))
    device = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / n)
    device.sort()
    return dict(ms=device[len(device) // 2], single_ms=single)
