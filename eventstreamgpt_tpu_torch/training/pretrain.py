"""The single-device train step, for CI and nested-attention models.

Counterpart: ``eventstreamgpt_tpu/training/pretrain.py`` (`TrainState`,
`build_model`, `_train_step_body` behind `make_train_step`). One step runs
the model forward with the losses (``is_generation=False``), backpropagates
the summed loss and applies one AdamW update with the scheduled learning
rate. Dropout draws its keep masks from a ``torch.Generator`` seeded from
``(seed, step)``, the counterpart of ``fold_in(rng, state.step)``: the
same seed and step give the same masks, whatever ran before. On the card
the step is captured into a CUDA graph per batch signature and replayed
(`make_train_step`).

Parameters stay fp32 (the master weights); the model casts them to the
compute dtype on every call. Metrics, the health sentinel's host side,
checkpoints, meshes, remat, scan-over-layers and chunked or device-resident
steps are not part of the port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch

from ..data.types import X32, EventStreamBatch
from ..models.ci_model import CIPPTForGenerativeSequenceModeling
from ..models.na_model import NAPPTForGenerativeSequenceModeling
from ..models.config import StructuredEventProcessingMode, StructuredTransformerConfig
from ..utils.device import resolve_device
from ..utils.graphs import CapturedProgram
from .optimizer import make_capturable


@dataclasses.dataclass
class TrainState:
    """The count of steps taken (the optimizer and model hold the rest)."""

    step: int = 0


def build_model(
    config: StructuredTransformerConfig,
) -> CIPPTForGenerativeSequenceModeling | NAPPTForGenerativeSequenceModeling:
    """The generative model ``config`` describes: CI or nested attention."""
    mode = config.structured_event_processing_mode
    if mode == StructuredEventProcessingMode.NESTED_ATTENTION:
        return NAPPTForGenerativeSequenceModeling(config)
    if mode == StructuredEventProcessingMode.CONDITIONALLY_INDEPENDENT:
        return CIPPTForGenerativeSequenceModeling(config)
    raise ValueError(f"Unsupported structured event processing mode: {mode}")


def dropout_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed mixed from ``(seed, step)``."""
    hi, lo = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def _leaves(batch: EventStreamBatch) -> list[tuple]:
    """``(field, key, tensor)`` for every tensor of the batch, in field order
    (``stream_labels`` by key)."""
    out = []
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        items = v.items() if isinstance(v, dict) else [] if v is None else [(None, v)]
        out += [(f.name, k, t) for k, t in items]
    return out


def _signature(batch: EventStreamBatch) -> tuple:
    """The fields present, their shapes and the static buffers' dtypes: one
    captured program each (the counterpart of a retrace)."""
    return tuple((name, key, tuple(t.shape), X32.get(t.dtype, t.dtype)) for name, key, t in _leaves(batch))


def _copy_batch(dst: EventStreamBatch, src: EventStreamBatch) -> None:
    """Copies ``src`` into the static buffers ``dst`` (int64 and fp64 cast to
    32 bits on the way); host tensors go through pinned memory, ``non_blocking``."""
    for (*_, d), (*_, t) in zip(_leaves(dst), _leaves(src)):
        if t.device.type == "cpu":
            t = t.to(d.dtype)  # on the host; a device source is cast by the copy itself
            if d.is_cuda and not t.is_pinned():
                t = t.pin_memory()
        d.copy_(t, non_blocking=d.is_cuda)


def make_train_step(
    model: CIPPTForGenerativeSequenceModeling | NAPPTForGenerativeSequenceModeling,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    device=None,
    with_health: bool = False,
    cuda_graph: bool = True,
) -> Callable:
    """A ``step(batch, seed) -> loss`` function that trains ``model`` in place.

    ``device=None`` means the CUDA device (and raises without one); the
    model moves there, and each batch is copied into that batch signature's
    static buffers there. The loss comes back as a 0-d tensor on the device,
    unsynchronised. ``with_health=True`` returns ``(loss, health)`` with
    ``health = [loss, grad_global_norm]`` (fp32), the JAX step's
    divergence-sentinel vector. ``step.state`` is the `TrainState`;
    ``step.stats()`` counts warm-up steps, captures and replays.

    The step (JAX's ``jax.jit(step, donate_argnums=(0,))``) reads and writes
    tensors at fixed addresses: the static batch buffers, the parameters,
    their gradients (zeroed in place at the start of each step, from the
    first step on), the optimizer's state and its rate, and the dropout
    generator, reseeded from ``dropout_seed(seed, state.step)`` before each
    step. On a CUDA device the optimizer takes its capturable form
    (`training.optimizer.make_capturable`), and with ``cuda_graph=True`` (the
    default) each batch signature's first step runs eagerly on a side stream
    as its warm-up, its second is captured into a CUDA graph, and that step
    and every later one are one replay. ``cuda_graph=False`` runs every step
    eagerly (the counterpart of ``jax.disable_jit()``, for comparisons); the
    CPU always does, with the float-rate optimizer.
    """
    device = resolve_device(device, "make_train_step")
    model.to(device).train()
    if device.type == "cuda":
        make_capturable(optimizer, device)
    params = [p for p in model.parameters() if p.requires_grad]
    state = TrainState()
    rng = torch.Generator(device=device)
    capture = cuda_graph and device.type == "cuda"
    programs: dict = {}  # batch signature -> [static batch, CapturedProgram or None]

    def body(batch: EventStreamBatch) -> tuple:
        optimizer.zero_grad(set_to_none=False)
        loss = model(batch, is_generation=False, dropout=rng).loss
        loss.backward()
        if with_health:
            grad_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(p.grad.float()) for p in params if p.grad is not None])
            )
        optimizer.step()
        loss = loss.detach()
        return (loss, torch.stack([loss, grad_norm]).float()) if with_health else (loss,)

    def step(batch: EventStreamBatch, seed: int):
        signature = _signature(batch)
        if signature not in programs:
            programs[signature] = [
                batch.map(lambda t: torch.empty(t.shape, dtype=X32.get(t.dtype, t.dtype), device=device)), None
            ]
        static, program = programs[signature]
        _copy_batch(static, batch)
        # A replay draws from the generator's state at replay time, whatever it was at capture.
        rng.manual_seed(dropout_seed(seed, state.step))
        if not capture:
            out = body(static)
        elif program is None:  # this signature's warm-up
            program = programs[signature][1] = CapturedProgram(
                lambda: body(static), "the train step", device=device, generators=(rng,)
            )
            out = program.warmup()
        else:
            if program.graph is None:
                program.capture()
            out = tuple(t.clone() for t in program.replay())  # the next replay rewrites its outputs
        scheduler.step()
        state.step += 1
        return out if with_health else out[0]

    def stats() -> dict:
        progs = [p for _, p in programs.values() if p is not None]
        return {
            "cuda_graph": capture,
            "batch_signatures": len(programs),
            "graph_warmup_steps": sum(p.warmups for p in progs),
            "graph_captures": sum(p.captures for p in progs),
            "graph_replays": sum(p.replays for p in progs),
        }

    step.state = state
    step.stats = stats
    return step


def train_steps(step: Callable, batches: Iterable[EventStreamBatch], seed: int) -> list[float]:
    """Runs ``step`` over ``batches``; returns the losses, read from the device once at the end."""
    losses = [step(b, seed) for b in batches]
    losses = [x[0] if isinstance(x, tuple) else x for x in losses]
    return [float(x) for x in torch.stack(losses).cpu()] if losses else []
