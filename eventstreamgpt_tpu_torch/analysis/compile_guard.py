"""The capture guard: fail fast when a step function captures a new program.

Counterpart: ``eventstreamgpt_tpu/analysis/compile_guard.py`` (``CompileGuard``,
``RecompileError``). JAX's guard watches a jitted function's trace cache; the
port's counterpart of a recompile is a new program: a batch signature's or
chunk key's first use (its warm-up), captured into a CUDA graph at its next
use. This guard watches each watched step's ``stats()``
(`training.pretrain.make_train_step`, `make_chunked_train_step`): once armed,
a capture beyond the programs that existed at `CompileGuard.arm` (each
captures once) is a new program's. A new program in the middle of an epoch
(a batch of a new shape) costs a warm-up and a capture, and the run goes on
at a fraction of its speed; the guard makes it an error instead. The
capture of a program warmed up before `arm` is not one: an epoch of one
chunk warms its key up in epoch 0 and captures it in epoch 1, where JAX
compiled it in epoch 0. `training.pretrain.train` arms it from the second
in-process epoch on and checks it after every full-size dispatch.
"""

from __future__ import annotations

from typing import Callable, Sequence

__all__ = ["CompileGuard", "RecompileError"]


class RecompileError(RuntimeError):
    """A guarded region captured more programs than its budget allows."""


def _captures(fn) -> int:
    return int(fn.stats()["graph_captures"])


def _programs(fn) -> int:
    return int(fn.stats()["graph_programs"])


class CompileGuard:
    """An armable sentinel over the captures of step functions: once armed,
    no watched function may capture a program it did not have at `arm`.

    Args:
        watch: step functions with a ``stats()`` that counts ``graph_programs``
            (programs made, each warmed up once) and ``graph_captures``.
        label: names the region in the error.
    """

    def __init__(self, watch: Sequence[Callable], label: str = "guarded region"):
        if not watch:
            raise ValueError("CompileGuard watches step functions; give it at least one")
        self.watch = list(watch)
        self.label = label
        self.armed = False
        self._baseline: list[int] = []

    def arm(self) -> "CompileGuard":
        """Snapshots the program counts: the captures `check` allows."""
        self._baseline = [_programs(fn) for fn in self.watch]
        self.armed = True
        return self

    @property
    def compiles(self) -> int:
        """Captures of programs made since `arm` (0 when unarmed)."""
        if not self.armed:
            return 0
        return sum(max(_captures(fn) - base, 0) for fn, base in zip(self.watch, self._baseline))

    def check(self) -> None:
        """Raises `RecompileError` when an armed region captured a program."""
        n = self.compiles
        if n:
            raise RecompileError(
                f"{self.label}: {n} new capture(s). A steady-state step captured a new program: look for a batch "
                "whose shape or field set drifted."
            )

    def disarm(self) -> None:
        self.armed = False
