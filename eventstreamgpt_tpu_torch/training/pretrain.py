"""The single-device train steps, for CI and nested-attention models.

Counterpart: ``eventstreamgpt_tpu/training/pretrain.py`` (`TrainState`,
`build_model`, `_train_step_body` behind `make_train_step` and
`make_chunked_train_step`, `_plan_event_count`). One step runs the model
forward with the losses (``is_generation=False``), backpropagates the
summed loss and applies one AdamW update with the scheduled learning rate.
Dropout draws its keep masks from a ``torch.Generator`` seeded from
``(seed, step)``, the counterpart of ``fold_in(rng, state.step)``: the
same seed and step give the same masks, whatever ran before. On the card
the step is captured into a CUDA graph per batch signature and replayed
(`make_train_step`); the chunked step collates K batches from a
`data.device_dataset.DeviceDataset`'s resident tables and trains on them
in one captured program (`make_chunked_train_step`), both through the same
step body.

Parameters stay fp32 (the master weights); the model casts them to the
compute dtype on every call. Metrics, the health sentinel's host side,
checkpoints, meshes, remat and scan-over-layers are not part of the port
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch

from ..data.device_dataset import DeviceDataset
from ..data.types import X32, EventStreamBatch
from ..models.ci_model import CIPPTForGenerativeSequenceModeling
from ..models.na_model import NAPPTForGenerativeSequenceModeling
from ..models.config import StructuredEventProcessingMode, StructuredTransformerConfig
from ..utils.device import resolve_device
from ..utils.graphs import ByteLayout, CapturedProgram
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


def _step_body(model, optimizer: torch.optim.Optimizer, with_health: bool) -> Callable:
    """``body(batch, rng) -> (loss,)`` or ``(loss, health)``: one train step
    on ``batch`` with dropout drawn from ``rng`` (JAX's `_train_step_body`),
    shared by `make_train_step` and `make_chunked_train_step`. The gradients
    are zeroed in place, from the first step on, so a captured step keeps
    their addresses; ``health`` is ``[loss, grad_global_norm]`` (fp32)."""
    params = [p for p in model.parameters() if p.requires_grad]

    def body(batch: EventStreamBatch, rng: torch.Generator) -> tuple:
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

    return body


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
    CPU always does, with the float-rate optimizer. ``stats()["capture_s"]``
    sums the captures' seconds (capture and instantiation together).
    """
    device = resolve_device(device, "make_train_step")
    model.to(device).train()
    if device.type == "cuda":
        make_capturable(optimizer, device)
    body = _step_body(model, optimizer, with_health)
    state = TrainState()
    rng = torch.Generator(device=device)
    capture = cuda_graph and device.type == "cuda"
    programs: dict = {}  # batch signature -> [static batch, CapturedProgram or None]

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
            out = body(static, rng)
        elif program is None:  # this signature's warm-up
            program = programs[signature][1] = CapturedProgram(
                lambda: body(static, rng), "the train step", device=device, generators=(rng,)
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
            "capture_s": sum(p.capture_s for p in progs),
        }

    step.state = state
    step.stats = stats
    return step


# The fields of a stacked plan chunk (`DeviceDataset.plan_chunks` /
# `packed_plan_chunks`) and the dtype each is held in on the device.
_PLAN_FIELDS = {
    False: {"subject_indices": torch.int32, "starts": torch.int32, "valid_mask": torch.bool},
    True: {"event_ids": torch.int32, "segment_ids": torch.int32, "event_mask": torch.bool},
}
_NUMPY = {torch.int32: np.int32, torch.bool: np.bool_}


def _scheduled_rates(scheduler: torch.optim.lr_scheduler.LRScheduler, k: int) -> list[list[float]]:
    """Each param group's rate for the scheduler's next ``k`` steps, from its
    current one (as it would set them, stepping ``k`` times), without
    stepping it or reading the device."""
    if not isinstance(scheduler, torch.optim.lr_scheduler.LambdaLR):
        raise ValueError(
            f"make_chunked_train_step takes the LambdaLR of training.build_optimizer, not {type(scheduler).__name__}"
        )
    epoch = scheduler.last_epoch
    return [[base * fn(epoch + i) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)] for i in range(k)]


def make_chunked_train_step(
    model: CIPPTForGenerativeSequenceModeling | NAPPTForGenerativeSequenceModeling,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    device_data: DeviceDataset,
    packed: bool = False,
    with_health: bool = False,
    device=None,
    cuda_graph: bool = True,
) -> Callable:
    """A ``chunk_step(plans, seed)`` function that runs ``k`` collate and
    train steps of ``model`` in one program.

    Counterpart of JAX's ``make_chunked_train_step`` (a ``lax.scan`` of the
    step body over ``k`` stacked plans in one dispatch). ``plans`` is one
    chunk of `DeviceDataset.plan_chunks` (padded rows: ``(k, B)``
    ``subject_indices``, ``starts``, ``valid_mask``) or, with
    ``packed=True``, of `DeviceDataset.packed_plan_chunks` (``(k, B, L)``
    ``event_ids``, ``segment_ids``, ``event_mask``). Step ``i`` collates its
    batch from ``device_data``'s resident tables (`DeviceDataset.padded_kernel`
    / `packed_kernel`) and runs the body `make_train_step` runs, with the
    rate and dropout stream of step ``state.step + i``, so a chunk equals
    ``k`` single steps on the same batches bit for bit. Returns the ``(k,)``
    losses, or ``((k,) losses, (k, 2) healths)`` with ``with_health``, on
    the device, unsynchronised; ``chunk_step.state.step`` advances by ``k``
    and the scheduler steps ``k`` times after the program.

    Host-to-device traffic a chunk is the plan and the ``k`` scheduled rates,
    in one buffer (`utils.graphs.ByteLayout`) filled by one copy from pinned
    memory; the tables stay put. The program holds ``k`` dropout generators,
    step ``i`` drawing from generator ``i``, each reseeded from
    ``dropout_seed(seed, state.step + i)`` before the program runs; each
    param group's 0-d rate (`training.optimizer.make_capturable`) is copied
    from the rate buffer before step ``i``'s update.

    On a CUDA device with ``cuda_graph=True`` (the default) each ``(packed,
    k, B, L, M)`` key's first chunk runs eagerly on a side stream (its
    warm-up, which trains as any chunk does), its second is captured into
    one CUDA graph and replayed, and every later chunk of that key is one
    replay. ``cuda_graph=False`` runs every chunk eagerly; the CPU always
    does. ``chunk_step.stats()`` counts keys, warm-ups, captures and
    replays, with each key's plan bytes and capture seconds (capture and
    instantiation together).
    """
    device = resolve_device(device, "make_chunked_train_step")
    if device_data.device != device:
        raise ValueError(f"device_data's tables are on {device_data.device}, the step runs on {device}")
    model.to(device).train()
    if device.type == "cuda":
        make_capturable(optimizer, device)
    body = _step_body(model, optimizer, with_health)
    kernel = device_data.packed_kernel() if packed else device_data.padded_kernel()
    groups = optimizer.param_groups
    fields = _PLAN_FIELDS[bool(packed)]
    state = TrainState()
    capture = cuda_graph and device.type == "cuda"
    chunks: dict = {}  # key -> the key's static buffers, generators and CapturedProgram
    host_rates: list = []  # the float rates of the CPU optimizer, for the chunk being run

    def collate(plan: dict, i: int) -> EventStreamBatch:
        if packed:
            out = kernel(device_data.arrays, plan["event_ids"][i], plan["event_mask"][i])
            B = plan["event_ids"].shape[1]
            return EventStreamBatch(
                segment_ids=plan["segment_ids"][i], valid_mask=torch.ones(B, dtype=torch.bool, device=device), **out
            )
        out = kernel(device_data.arrays, plan["subject_indices"][i], plan["starts"][i], plan["valid_mask"][i])
        return EventStreamBatch(valid_mask=plan["valid_mask"][i], **out)

    def make_chunk(layout: ByteLayout, k: int) -> dict:
        buf = layout.empty(device)
        plan = layout.views(buf)
        gens = [torch.Generator(device=device) for _ in range(k)]

        def program() -> tuple:
            outs = []
            for i in range(k):
                for g, group in enumerate(groups):
                    if torch.is_tensor(group["lr"]):
                        group["lr"].copy_(plan["rates"][i, g])
                    else:
                        group["lr"] = host_rates[i][g]
                outs.append(body(collate(plan, i), gens[i]))
            return tuple(torch.stack(parts) for parts in zip(*outs))

        return dict(layout=layout, buf=buf, gens=gens, fn=program, program=None)

    def chunk_step(plans: dict, seed: int):
        if set(plans) != set(fields):
            kind = "packed plan" if packed else "plan"
            raise ValueError(f"a {kind} chunk has the fields {sorted(fields)}, not {sorted(plans)}")
        arrays = {name: np.asarray(plans[name], dtype=_NUMPY[dt]) for name, dt in fields.items()}
        first = arrays[next(iter(fields))]
        k, B = first.shape[:2]
        L = first.shape[2] if packed else device_data.dataset.max_seq_len
        key = (bool(packed), k, B, L, device_data.dataset.max_n_dynamic)
        if key not in chunks:
            layout = ByteLayout(
                {**{n: (arrays[n].shape, dt) for n, dt in fields.items()}, "rates": ((k, len(groups)), torch.float32)}
            )
            chunks[key] = make_chunk(layout, k)
        chunk = chunks[key]
        rates = _scheduled_rates(scheduler, k)
        host_rates[:] = rates
        staging = chunk["layout"].empty("cpu", pin_memory=device.type == "cuda")
        views = chunk["layout"].views(staging)
        for name in fields:
            views[name].copy_(torch.from_numpy(arrays[name]))
        views["rates"].copy_(torch.tensor(rates, dtype=torch.float32))
        chunk["buf"].copy_(staging, non_blocking=device.type == "cuda")
        # A replay draws from each generator's state at replay time.
        for i, gen in enumerate(chunk["gens"]):
            gen.manual_seed(dropout_seed(seed, state.step + i))
        program = chunk["program"]
        if not capture:
            out = chunk["fn"]()
        elif program is None:  # this key's warm-up
            program = chunk["program"] = CapturedProgram(
                chunk["fn"], f"the chunked train step {key}", device=device, generators=chunk["gens"]
            )
            out = program.warmup()
        else:
            if program.graph is None:
                program.capture()
            out = tuple(t.clone() for t in program.replay())  # the next replay rewrites its outputs
        for _ in range(k):
            scheduler.step()
        state.step += k
        return out if with_health else out[0]

    def stats() -> dict:
        progs = [c["program"] for c in chunks.values() if c["program"] is not None]
        return {
            "cuda_graph": capture,
            "chunk_keys": len(chunks),
            "graph_warmup_chunks": sum(p.warmups for p in progs),
            "graph_captures": sum(p.captures for p in progs),
            "graph_replays": sum(p.replays for p in progs),
            "keys": {
                str(key): {"plan_bytes": c["layout"].nbytes, "capture_s": c["program"] and c["program"].capture_s}
                for key, c in chunks.items()
            },
        }

    chunk_step.state = state
    chunk_step.stats = stats
    return chunk_step


def _plan_event_count(plans: dict, dataset) -> int:
    """The real events of a (possibly sliced) stacked plan chunk: packed
    plans' mask, or each valid row's ``min(seq_len, max_seq_len)``."""
    if "event_mask" in plans:  # packed plans carry the mask directly
        return int(np.asarray(plans["event_mask"]).sum())
    off = np.asarray(dataset.data.subject_event_offsets, np.int64)
    idx = np.asarray(plans["subject_indices"], np.int64)
    kept = np.minimum(off[idx + 1] - off[idx], dataset.max_seq_len)
    return int(kept[np.asarray(plans["valid_mask"])].sum())


def train_steps(step: Callable, batches: Iterable[EventStreamBatch], seed: int) -> list[float]:
    """Runs ``step`` over ``batches``; returns the losses, read from the device once at the end."""
    losses = [step(b, seed) for b in batches]
    losses = [x[0] if isinstance(x, tuple) else x for x in losses]
    return [float(x) for x in torch.stack(losses).cpu()] if losses else []
