"""The host input pipeline: collation and the copy to the card in a background thread.

Counterpart: ``eventstreamgpt_tpu/data/prefetch.py`` (``DevicePrefetcher``,
``prefetch_to_device``). A thread drains the host batch iterator (host
collation), computes any host statistics of a batch, and hands it to
``place_fn``; on the card (`to_device`) that copies it into pinned memory
and from there to the device on a copy stream of its own, so the copy runs
beside the step the consumer has queued on the default stream instead of
behind it. A queue of depth 2 keeps the next batches ready while the current
step runs.

Prefetching wraps the iterator without touching its random stream, so the
``skip_batches`` resume of the dataset's ``batches`` holds bit for bit. The
multi-source sharded feed of JAX's pipeline is not ported (ROADMAP Queue 1
item 7).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator

_SENTINEL = object()
DEPTH = 2  # device batches buffered ahead (double buffering)


class DevicePrefetcher:
    """Iterates ``(device_batch, host_stats)`` with background collation.

    Args:
        batches: host batch iterable (e.g. ``TorchDataset.batches(...)``).
        place_fn: host batch -> device batch (e.g. `to_device`), called in
            the worker thread, so its wait for the copy blocks only the
            worker.
        host_stats_fn: optional host batch -> picklable stats, computed in the
            worker **before** transfer so the training loop never syncs the
            device to read e.g. the event count.

    The iterator re-raises worker exceptions at the consuming site and stops
    its thread on `close` (also called on destruction and generator exit).
    """

    def __init__(
        self,
        batches: Iterable,
        place_fn: Callable[[Any], Any],
        host_stats_fn: Callable[[Any], Any] | None = None,
    ):
        # State used by close() is assigned before any validation so a
        # failed construction still destructs cleanly via __del__.
        self._stop = threading.Event()
        self._thread = None
        # A source with a close() is told to stop on close().
        self._source = batches
        self._queue: queue.Queue = queue.Queue(maxsize=DEPTH)
        self._thread = threading.Thread(
            target=self._worker,
            args=(iter(batches), place_fn, host_stats_fn),
            daemon=True,
        )
        self._thread.start()

    def _worker(self, it: Iterator, place_fn, host_stats_fn) -> None:
        try:
            for host_batch in it:
                if self._stop.is_set():
                    return
                stats = host_stats_fn(host_batch) if host_stats_fn is not None else None
                device_batch = place_fn(host_batch)
                self._put((device_batch, stats))
            self._put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - must surface in consumer
            self._put(e)

    def _put(self, item) -> None:
        """Blocking put that wakes on close() instead of deadlocking."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        # A closed (or exhausted) prefetcher terminates iteration instead of
        # blocking forever on an empty queue; the timeout loop also covers a
        # close() racing a blocked get().
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is _SENTINEL:
                self.close()
                raise StopIteration
            if isinstance(item, BaseException):
                self.close()
                raise item
            return item
        raise StopIteration

    def close(self, join_timeout: float = 5.0) -> None:
        self._stop.set()
        if getattr(self, "_queue", None) is None:
            return
        # A streaming source with its own lifecycle (shard workers, file
        # handles) gets told to stop FIRST: a worker blocked inside the
        # source's __next__ can't see the stop flag, so without this the
        # bounded join below would always burn its full timeout on a
        # stalled shard. Generators refuse cross-thread close() while
        # executing - that (or any source-side failure) must not break
        # teardown, so errors are swallowed and the bounded join still
        # guarantees close() returns.
        src_close = getattr(getattr(self, "_source", None), "close", None)
        if src_close is not None:
            try:
                src_close()
            except Exception:
                pass
        # Drain so a blocked worker put() can observe the stop flag.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        # Join the worker (bounded): teardown must not leave a thread racing
        # a live device_put against e.g. pytest's fixture cleanup or the
        # preemption drain. The worker polls the stop flag every 0.1s, so a
        # healthy thread exits well inside the timeout; a wedged device_put
        # is abandoned as a daemon rather than hanging the process.
        t = getattr(self, "_thread", None)
        if t is not None and t is not threading.current_thread() and t.is_alive():
            t.join(timeout=join_timeout)
        # The worker may have completed one last put() between the first
        # drain and its stop-flag check - including the case where it
        # already exited before the liveness check above - so the final
        # drain is unconditional: no device buffers may linger in the dead
        # queue.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        self.close(join_timeout=1.0)


def to_device(device) -> Callable[[Any], Any]:
    """The ``place_fn`` of a device: the identity for the CPU; on the card,
    each tensor of a batch copied into pinned memory and from there, on a
    copy stream of the device's own, to ``device``. The calling thread waits
    for the copy, so the batch it returns is ready for any stream; each
    tensor is marked as used by the default stream, where the consumer reads
    it, so its memory is not reused before that read has run."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return lambda batch: batch
    stream = torch.cuda.Stream(device)
    consumer = torch.cuda.default_stream(device)

    def copy(t):
        out = t.pin_memory().to(device, non_blocking=True)
        out.record_stream(consumer)
        return out

    def place(batch):
        with torch.cuda.stream(stream):
            out = batch.map(copy)
        stream.synchronize()
        return out

    return place


def prefetch_to_device(
    batches: Iterable,
    place_fn: Callable[[Any], Any],
    host_stats_fn: Callable[[Any], Any] | None = None,
) -> DevicePrefetcher:
    """Convenience constructor; see `DevicePrefetcher`."""
    return DevicePrefetcher(batches, place_fn, host_stats_fn=host_stats_fn)
