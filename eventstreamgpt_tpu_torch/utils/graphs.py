"""The port's compile step: a function captured once into a CUDA graph and replayed.

Counterpart: ``jax.jit``'s trace-then-dispatch (one trace per shape, one
dispatch per call) and the capture count of
``eventstreamgpt_tpu/analysis/compile_guard.py``. A `CapturedProgram` wraps
a function of no arguments that reads and writes tensors at fixed addresses
(its static inputs, its state and its outputs):

* `CapturedProgram.warmup` runs it eagerly on the program's own side
  stream, as PyTorch's capture recipe asks: kernels built at first use,
  device constants cached at first call, cuBLAS workspaces and optimizer
  state come into being there, never under capture;
* `CapturedProgram.capture` records it into a ``torch.cuda.CUDAGraph`` with
  a memory pool of its own (or one it shares), on the same stream, each given
  ``torch.Generator`` registered with the graph so that a replay draws from
  the generator's state at replay time, with Python's garbage collector
  paused; a failed capture raises, and nothing falls back to eager;
* `CapturedProgram.replay` launches the graph: one host launch for the
  whole program, its outputs rewritten in place.

A `ProgramFamily` holds the programs of one function at several shapes
(``jax.jit``'s cache of traces, one per shape), each captured lazily at its
key's first use; its programs may share one memory pool, since they replay
one at a time on one stream and return nothing that lives in the pool.

Launch counters. Every kernel wrapper counts its launches in Python
(`COUNTED`): the count moves when the wrapper runs, which capture does once
and replay never does. `capture` takes each counter's delta across the
capture and takes it back (capture launches nothing), and every `replay`
adds the delta again, so each counter keeps counting the kernels that ran.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import math
import time
from typing import Callable

import torch

# Every kernel wrapper that counts its launches: (module in ``ops``, wrapper, counter attributes).
COUNTED = (
    ("fused_sampling", "fused_categorical", ("launches",)),
    ("fused_sampling", "fused_categorical_stream", ("launches",)),
    ("decode_step", "decode_stack_step", ("launches", "launches_int8", "launches_fp8")),
    ("vocab_gather", "vocab_gather_fwd", ("launches",)),
    ("vocab_gather", "vocab_gather_bwd", ("launches",)),
    ("dep_graph", "dep_graph_fwd", ("launches",)),
    ("dep_graph", "dep_graph_bwd", ("launches",)),
    ("flash_attention", "flash_attention_fwd", ("launches",)),
    ("flash_attention", "flash_attention_bwd", ("launches",)),
    ("flash_attention", "flash_attention_window_fwd", ("launches",)),
    ("flash_attention", "flash_attention_window_bwd", ("launches",)),
)


def counted_wrappers() -> list[tuple[object, str]]:
    """``(wrapper, counter attribute)`` for every counter in `COUNTED`."""
    out = []
    for module, name, attrs in COUNTED:
        wrapper = getattr(importlib.import_module(f"..ops.{module}", __package__), name)
        out += [(wrapper, attr) for attr in attrs]
    return out


class CapturedProgram:
    """``fn`` (no arguments) warmed up, captured once and replayed.

    Args:
        fn: the program; every tensor it reads or writes outside its own
            temporaries must keep its address for the program's life.
        name: what the program is, for errors.
        device: its CUDA device. Any other device (the CPU tests' stub
            graphs) runs warm-up and capture on the current thread, with no
            side stream.
        generators: ``torch.Generator``s the program draws from, registered
            with the graph at capture.
        counters: the ``(wrapper, attribute)`` launch counters to keep true
            (default: `counted_wrappers`).
        graph: a factory of graphs (default ``torch.cuda.CUDAGraph``).
        graph_context: ``(graph, stream) -> context manager`` that captures
            into ``graph`` (default ``torch.cuda.graph``).
        pool: a memory pool handle (``torch.cuda.graph_pool_handle()``) to
            capture into, shared with other programs; default a pool of its own.
    """

    def __init__(
        self,
        fn: Callable,
        name: str,
        *,
        device,
        generators=(),
        counters=None,
        graph: Callable | None = None,
        graph_context: Callable | None = None,
        pool=None,
    ):
        self.fn, self.name, self.device = fn, name, torch.device(device)
        self.generators = tuple(generators)
        self.counters = counters
        self._new_graph = graph or torch.cuda.CUDAGraph
        self._graph_context = graph_context or (lambda g, stream: torch.cuda.graph(g, pool=pool, stream=stream))
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.graph = None
        self.output = None
        self.delta: list = []
        self.warmups = self.captures = self.replays = 0
        self.capture_s = 0.0  # seconds of the capture and the graph's instantiation

    @contextlib.contextmanager
    def _side_stream(self):
        if self.stream is None:
            yield
            return
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            yield
        current.wait_stream(self.stream)

    def warmup(self):
        """Runs the program once, eagerly, on its side stream; returns its output."""
        with self._side_stream():
            out = self.fn()
        self.warmups += 1
        return out

    def capture(self) -> None:
        """Records the program into a new graph (nothing runs); raises if capture fails."""
        if self.graph is not None:
            raise RuntimeError(f"{self.name} is captured already")
        t0 = time.perf_counter()
        counters = counted_wrappers() if self.counters is None else self.counters
        before = [getattr(fn, attr) for fn, attr in counters]
        graph = self._new_graph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        # No garbage collection inside the capture: a collection that frees another
        # program's graph (engines hold their programs in reference cycles) runs its
        # destructor, which the card refuses while a stream captures, and that
        # invalidates this capture.
        gc_enabled = gc.isenabled()
        gc.disable()
        try:
            with self._graph_context(graph, self.stream):
                output = self.fn()
        except Exception as e:
            raise RuntimeError(f"capturing {self.name} into a CUDA graph failed: {e}") from e
        finally:
            if gc_enabled:
                gc.enable()
            after = [getattr(fn, attr) for fn, attr in counters]
            for (fn, attr), n in zip(counters, before):
                setattr(fn, attr, n)
        self.delta = [(fn, attr, b - a) for (fn, attr), a, b in zip(counters, before, after) if b != a]
        self.graph, self.output = graph, output
        self.captures += 1
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        """Launches the captured program; returns its (static) output."""
        self.graph.replay()
        for fn, attr, d in self.delta:
            setattr(fn, attr, getattr(fn, attr) + d)
        self.replays += 1
        return self.output


class ByteLayout:
    """Named tensors packed in one ``uint8`` buffer, each at a 16-byte boundary.

    A program's static inputs (or outputs) laid out so that one copy moves
    them all between the host and the device: `empty` allocates the buffer,
    `views` gives each field as a typed view of it.

    Examples:
        >>> layout = ByteLayout({"plen": ((3,), torch.int32), "valid": ((3,), torch.bool)})
        >>> layout.nbytes
        19
        >>> x = layout.views(layout.empty("cpu").zero_())
        >>> x["plen"][1] = 7
        >>> x["plen"].tolist(), x["valid"].dtype
        ([0, 7, 0], torch.bool)
    """

    def __init__(self, fields: dict):
        self.fields, self.offsets, off = dict(fields), {}, 0
        for name, (shape, dtype) in self.fields.items():
            off = -(-off // 16) * 16
            self.offsets[name] = off
            off += math.prod(shape) * dtype.itemsize
        self.nbytes = off

    def empty(self, device, pin_memory: bool = False) -> torch.Tensor:
        return torch.empty(self.nbytes, dtype=torch.uint8, device=device, pin_memory=pin_memory)

    def views(self, buf: torch.Tensor) -> dict:
        out = {}
        for name, (shape, dtype) in self.fields.items():
            off = self.offsets[name]
            out[name] = buf[off : off + math.prod(shape) * dtype.itemsize].view(dtype).view(shape)
        return out


class ProgramFamily:
    """`CapturedProgram`s of one kind keyed by shape, made at each key's first use.

    Args:
        name: what the programs are, for errors (each gets its key appended).
        device: their CUDA device.
        pool: the memory pool handle every program captures into (default:
            each its own).
        **kwargs: passed on to each `CapturedProgram` (``counters``,
            ``graph``, ``graph_context``).
    """

    def __init__(self, name: str, *, device, pool=None, **kwargs):
        self.name, self.device, self.pool, self.kwargs = name, device, pool, kwargs
        self.programs: dict = {}

    def get(self, key, fn: Callable) -> tuple[CapturedProgram, bool]:
        """``(program, new)``: the program of ``key``, made around ``fn`` if
        ``key`` has none yet (``new``: it still needs its warm-up and capture)."""
        if key in self.programs:
            return self.programs[key], False
        program = CapturedProgram(fn, f"{self.name} {key}", device=self.device, pool=self.pool, **self.kwargs)
        self.programs[key] = program
        return program, True

    def counts(self) -> dict:
        """Keys, warm-ups, captures and replays over every program."""
        progs = self.programs.values()
        return {
            "keys": len(self.programs),
            "warmups": sum(p.warmups for p in progs),
            "captures": sum(p.captures for p in progs),
            "replays": sum(p.replays for p in progs),
        }
