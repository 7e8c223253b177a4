"""Graceful preemption: drain at a boundary, exit with a distinct code.

Counterpart: ``eventstreamgpt_tpu/reliability/preemption.py`` (stdlib only).

Cluster schedulers deliver ``SIGTERM`` with a grace window before the hard
kill. `GracefulShutdown` turns the first signal into a flag that the serving
loops (`serving.service.ServingService.run`, `serving.fleet.ServingFleet.run`)
poll once a round and the training loop (`training.pretrain.train`) once a
dispatch (a Python bool read, no device sync); the loop then drains
its resident slots and raises `Preempted` with the completed results, which an
entry-point script converts to `EXIT_PREEMPTED` so an orchestrator can tell
"reschedule me" from a real failure. A second signal restores the previous
handler and re-delivers itself: the escape hatch when the drain itself wedges.
"""

from __future__ import annotations

import os
import signal
import threading

__all__ = ["EXIT_PREEMPTED", "GracefulShutdown", "Preempted"]

# The orchestrator contract: this exit status means "preempted after a clean
# drain: reschedule". Distinct from 0 (done), 1 (error), and the 128+signum
# codes of an *unhandled* signal death.
EXIT_PREEMPTED = 85


class Preempted(RuntimeError):
    """Raised by a serving loop after a graceful drain, the completed results
    on ``results``, or by the training loop after its final checkpoint, that
    checkpoint's step on ``step``. Entry-point scripts catch it and
    ``sys.exit(EXIT_PREEMPTED)``.
    """

    def __init__(self, message: str, results: list | None = None, step: int | None = None):
        super().__init__(message)
        self.results = results
        self.step = step


class GracefulShutdown:
    """Context manager turning SIGTERM/SIGINT into a pollable drain flag.

    Handlers install only in the main thread (the signal module's
    constraint); elsewhere the object is inert but still usable
    programmatically via `request` (how tests and embedders deliver
    preemption in-process). Previous handlers are restored on exit, also on
    error, so nested/sequential in-process runs start clean.
    """

    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._requested = threading.Event()
        self._prev: dict[int, object] = {}
        self._signum: int | None = None

    def __enter__(self) -> "GracefulShutdown":
        if threading.current_thread() is threading.main_thread():
            for sig in self._SIGNALS:
                self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _handle(self, signum, frame) -> None:
        if self._requested.is_set():
            # Second signal while draining: restore the previous disposition
            # and re-deliver — the operator's hard-stop escape hatch.
            signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
            os.kill(os.getpid(), signum)
            return
        self._signum = signum
        self._requested.set()

    def request(self) -> None:
        """Programmatic preemption (fault injection, tests, embedders)."""
        self._requested.set()

    @property
    def requested(self) -> bool:
        return self._requested.is_set()
