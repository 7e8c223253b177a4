"""Generative pretraining on one device: the train steps, evaluation and `train`.

Counterpart: ``eventstreamgpt_tpu/training/pretrain.py`` (`TrainState`,
`build_model`, `_train_step_body` behind `make_train_step` and
`make_chunked_train_step`, `_plan_event_count`, `make_eval_step`,
`evaluate`, `PretrainConfig`, `train`). One step runs the model
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
compute dtype on every call. With gradient accumulation
(`training.optimizer.GradientAccumulator`) each batch signature has two
programs, one that accumulates and one that accumulates and applies the
update, and the host picks the one the loop step's phase needs; a chunk's
phases follow the global step.

`train` is JAX's training loop: datasets from a converted DL cache
(`data.torch_dataset.TorchDataset`), ``set_to_dataset``, the five config
files, resume through the checksummed checkpoint manager, the resident
chunked step (or host collation with the prefetch thread feeding the
single step), the divergence sentinel and its rollback, graceful
preemption, the capture guard, the tuning evaluation each epoch, early
stopping, ``save_pretrained`` and the final validation. A restore (resume
or rollback) writes into the live parameters, AdamW state, rates,
accumulation buffers and step counters in place, so captured programs keep
reading them. Meshes (tensor, FSDP and context parallelism) and a profiler
window inside `train` are refused (`refusals`); task data
(``data_config.task_df_name``) trains on the task windows, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import time
from pathlib import Path
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..data.config import PytorchDatasetConfig
from ..data.device_dataset import DeviceDataset
from ..data.prefetch import prefetch_to_device, to_device
from ..data.torch_dataset import SHARDED_FEEDS, TorchDataset
from ..data.types import X32, EventStreamBatch
from ..models.ci_model import CIPPTForGenerativeSequenceModeling
from ..models.na_model import NAPPTForGenerativeSequenceModeling
from ..models.config import (
    MetricsConfig,
    OptimizationConfig,
    Split,
    StructuredEventProcessingMode,
    StructuredTransformerConfig,
)
from ..utils import config_dataclass
from ..utils.config_tool import coerce_to_signature
from ..utils.device import resolve_device
from ..utils.graphs import ByteLayout, CapturedProgram
from .generative_metrics import GenerativeMetrics
from .optimizer import build_optimizer, make_capturable, polynomial_decay_with_warmup


@dataclasses.dataclass
class TrainState:
    """The count of loop steps taken (the optimizer and model hold the rest);
    with gradient accumulation it counts micro-steps, as JAX's does."""

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
    """``body(batch, rng, apply=True) -> (loss,)`` or ``(loss, health)``: one
    train step on ``batch`` with dropout drawn from ``rng`` (JAX's
    `_train_step_body`), shared by `make_train_step` and
    `make_chunked_train_step`. The gradients are zeroed in place, from the
    first step on, so a captured step keeps their addresses; ``health`` is
    ``[loss, grad_global_norm]`` (fp32) of this step's gradients. With the
    optimizer's `GradientAccumulator` the gradients are folded into its
    running mean, and the update (with the mean) runs only when ``apply``."""
    params = [p for p in model.parameters() if p.requires_grad]
    acc = getattr(optimizer, "accumulator", None)
    if acc is not None:
        acc.bind(params)

    def body(batch: EventStreamBatch, rng: torch.Generator, apply: bool = True) -> tuple:
        optimizer.zero_grad(set_to_none=False)
        loss = model(batch, is_generation=False, dropout=rng).loss
        loss.backward()
        if with_health:
            grad_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(p.grad.float()) for p in params if p.grad is not None])
            )
        if acc is None:
            optimizer.step()
        else:
            acc.accumulate()
            if apply:
                acc.load()
                optimizer.step()
                acc.reset()
        loss = loss.detach()
        return (loss, torch.stack([loss, grad_norm]).float()) if with_health else (loss,)

    return body


def _applies(optimizer, step: int) -> bool:
    """Whether loop step ``step`` applies an optimizer update (every
    ``k``-th with accumulation, JAX's ``MultiSteps`` emit)."""
    acc = getattr(optimizer, "accumulator", None)
    return acc is None or step % acc.k == acc.k - 1


def _graph_context(graph, stream):
    """Captures with ``thread_local`` errors: the prefetch thread may copy the
    next batch to the card while the step is being captured."""
    return torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local")


def make_train_step(
    model: CIPPTForGenerativeSequenceModeling | NAPPTForGenerativeSequenceModeling,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    device=None,
    with_health: bool = False,
    cuda_graph: bool = True,
    state: TrainState | None = None,
) -> Callable:
    """A ``step(batch, seed) -> loss`` function that trains ``model`` in place.

    ``device=None`` means the CUDA device (and raises without one); the
    model moves there, and each batch is copied into that batch signature's
    static buffers there. The loss comes back as a 0-d tensor on the device,
    unsynchronised. ``with_health=True`` returns ``(loss, health)`` with
    ``health = [loss, grad_global_norm]`` (fp32), the JAX step's
    divergence-sentinel vector. ``step.state`` is the `TrainState`;
    ``step.stats()`` counts programs, warm-up steps, captures and replays.

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

    With gradient accumulation a signature has two programs (accumulate;
    accumulate and apply), picked by ``state.step``'s phase, and the
    scheduler steps only when an update is applied. ``state`` shares a
    `TrainState` with the caller (`train`'s resume writes it).
    """
    device = resolve_device(device, "make_train_step")
    model.to(device).train()
    if device.type == "cuda":
        make_capturable(optimizer, device)
    body = _step_body(model, optimizer, with_health)
    state = TrainState() if state is None else state
    rng = torch.Generator(device=device)
    capture = cuda_graph and device.type == "cuda"
    statics: dict = {}  # batch signature -> static batch
    programs: dict = {}  # (batch signature, apply) -> CapturedProgram

    def step(batch: EventStreamBatch, seed: int):
        signature = _signature(batch)
        if signature not in statics:
            statics[signature] = batch.map(
                lambda t: torch.empty(t.shape, dtype=X32.get(t.dtype, t.dtype), device=device)
            )
        static = statics[signature]
        apply = _applies(optimizer, state.step)
        _copy_batch(static, batch)
        # A replay draws from the generator's state at replay time, whatever it was at capture.
        rng.manual_seed(dropout_seed(seed, state.step))
        key = (signature, apply)
        program = programs.get(key)
        if not capture:
            out = body(static, rng, apply)
        elif program is None:  # this program's warm-up
            program = programs[key] = CapturedProgram(
                lambda: body(static, rng, apply), "the train step", device=device, generators=(rng,),
                graph_context=_graph_context,
            )  # fmt: skip
            out = program.warmup()
        else:
            if program.graph is None:
                program.capture()
            out = tuple(t.clone() for t in program.replay())  # the next replay rewrites its outputs
        if apply:
            scheduler.step()
        state.step += 1
        return out if with_health else out[0]

    def stats() -> dict:
        progs = list(programs.values())
        return {
            "cuda_graph": capture,
            "batch_signatures": len(statics),
            "graph_programs": len(progs),
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


def _scheduled_rates(scheduler: torch.optim.lr_scheduler.LRScheduler, applies: list[bool]) -> list[list[float]]:
    """Each param group's rate for each of the next loop steps: the rate the
    scheduler would set for the update a step applies (its next updates in
    order, as it would set them stepping once an update), without stepping
    it or reading the device; a step that applies none gets the next one's."""
    if not isinstance(scheduler, torch.optim.lr_scheduler.LambdaLR):
        raise ValueError(
            f"make_chunked_train_step takes the LambdaLR of training.build_optimizer, not {type(scheduler).__name__}"
        )
    epoch = scheduler.last_epoch
    updates = np.cumsum([False, *applies[:-1]])  # updates applied before each step
    return [[base * fn(epoch + int(n)) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)] for n in updates]


def make_chunked_train_step(
    model: CIPPTForGenerativeSequenceModeling | NAPPTForGenerativeSequenceModeling,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    device_data: DeviceDataset,
    packed: bool = False,
    with_health: bool = False,
    device=None,
    cuda_graph: bool = True,
    state: TrainState | None = None,
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

    With gradient accumulation step ``i`` applies the update when
    ``state.step + i`` ends an accumulation window, the pattern of applying
    steps is part of the key, and the scheduler steps once an update.
    ``state`` shares a `TrainState` with the caller.
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
    state = TrainState() if state is None else state
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

    def make_chunk(layout: ByteLayout, applies: tuple) -> dict:
        buf = layout.empty(device)
        plan = layout.views(buf)
        gens = [torch.Generator(device=device) for _ in applies]

        def program() -> tuple:
            outs = []
            for i, apply in enumerate(applies):
                for g, group in enumerate(groups):
                    if not apply:
                        break
                    if torch.is_tensor(group["lr"]):
                        group["lr"].copy_(plan["rates"][i, g])
                    else:
                        group["lr"] = host_rates[i][g]
                outs.append(body(collate(plan, i), gens[i], apply))
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
        applies = tuple(_applies(optimizer, state.step + i) for i in range(k))
        key = (bool(packed), k, B, L, device_data.dataset.max_n_dynamic)
        if not all(applies):
            key += (applies,)
        if key not in chunks:
            layout = ByteLayout(
                {**{n: (arrays[n].shape, dt) for n, dt in fields.items()}, "rates": ((k, len(groups)), torch.float32)}
            )
            chunks[key] = make_chunk(layout, applies)
        chunk = chunks[key]
        rates = _scheduled_rates(scheduler, list(applies))
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
                chunk["fn"], f"the chunked train step {key}", device=device, generators=chunk["gens"],
                graph_context=_graph_context,
            )  # fmt: skip
            out = program.warmup()
        else:
            if program.graph is None:
                program.capture()
            out = tuple(t.clone() for t in program.replay())  # the next replay rewrites its outputs
        for _ in range(sum(applies)):
            scheduler.step()
        state.step += k
        return out if with_health else out[0]

    def stats() -> dict:
        progs = [c["program"] for c in chunks.values() if c["program"] is not None]
        return {
            "cuda_graph": capture,
            "chunk_keys": len(chunks),
            "graph_programs": len(progs),
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


# ------------------------------------------------------------------ evaluation
def make_eval_step(model, device=None) -> Callable:
    """``eval_step(batch) -> output``: the model's forward with its losses
    (``is_generation=False``), no dropout, no gradients, eagerly on
    ``device`` (None: the CUDA device); a host batch is copied there first."""
    device = resolve_device(device, "make_eval_step")
    model.to(device)

    def eval_step(batch: EventStreamBatch):
        batch = batch.map(lambda t: t.to(device, dtype=X32.get(t.dtype, t.dtype), non_blocking=True))
        with torch.no_grad():
            return model(batch, is_generation=False)

    return eval_step


def eval_batches(dataset, batch_size: int, device_data: DeviceDataset | None = None) -> Iterable[tuple]:
    """``(batch, valid_mask)`` over one evaluation pass of a split: crops
    drawn with ``seed=0`` so every pass scores the same data, the last short
    batch filled and its fill rows flagged False in ``valid_mask`` (a host
    tensor). With ``device_data`` (a `DeviceDataset` over the same split)
    the batches are collated on the device, otherwise on the host with the
    prefetch thread."""
    if device_data is not None:
        for batch in device_data.batches(batch_size, shuffle=False, drop_last=False, seed=0):
            yield batch, batch.valid_mask
        return
    batch_iter = prefetch_to_device(
        dataset.batches(batch_size, shuffle=False, drop_last=False, seed=0),
        lambda b: b,
        host_stats_fn=lambda b: b.valid_mask,
    )
    try:
        yield from batch_iter
    finally:
        batch_iter.close()


def evaluate(
    eval_step: Callable,
    dataset,
    batch_size: int,
    config: StructuredTransformerConfig,
    metrics_config: MetricsConfig,
    split: str,
    generator: torch.Generator | None = None,
    device_data: DeviceDataset | None = None,
) -> dict[str, float]:
    """One pass over a split (`eval_batches`); returns its ``{split}_...``
    metrics, the loss parts re-weighted by each batch's count of valid rows.
    ``generator`` draws the sampled TTE and regression metrics."""
    metrics = GenerativeMetrics(config, metrics_config, split=split)
    for batch, valid in eval_batches(dataset, batch_size, device_data):
        metrics.update(eval_step(batch), generator=generator, n_valid=int(valid.sum()))
    return metrics.compute()


# ------------------------------------------------------------ resume state
def train_state_dict(model, optimizer, scheduler, state: TrainState) -> dict:
    """The training state as CPU tensors and integers (a resume checkpoint's
    contents): the model's ``state_dict``, AdamW's ``step``, ``exp_avg`` and
    ``exp_avg_sq`` by parameter name, the scheduler's position,
    ``TrainState.step`` and the accumulation buffers."""
    names = {id(p): n for n, p in model.named_parameters()}
    adam: dict = {"step": {}, "exp_avg": {}, "exp_avg_sq": {}}
    for p, st in optimizer.state.items():
        for field in adam:
            adam[field][names[id(p)]] = torch.as_tensor(st[field]).detach().to("cpu", copy=True)
    out = {
        "step": int(state.step),
        "scheduler_step": int(scheduler.last_epoch),
        "params": {n: t.detach().to("cpu", copy=True) for n, t in model.state_dict().items()},
        "adam": adam,
    }
    acc = getattr(optimizer, "accumulator", None)
    if acc is not None and acc.mini is not None:
        out["accumulation"] = {
            "mini_step": acc.mini.detach().to("cpu", copy=True),
            "acc": {names[id(p)]: a.detach().to("cpu", copy=True) for p, a in zip(acc.params, acc.acc)},
        }
    return out


@torch.no_grad()
def load_train_state(sd: dict, model, optimizer, scheduler, state: TrainState) -> None:
    """Writes a `train_state_dict` into the live training state in place.

    Every parameter, AdamW state tensor, capturable rate and accumulation
    buffer is written with ``copy_``, so its address (and every captured
    program reading it) stays; AdamW state the optimizer has not made yet
    (a restore before the first step) is made as its first step would make
    it, in its capturable form where the optimizer is. The scheduler's
    position and ``state.step`` are set."""
    live = model.state_dict()
    if set(live) != set(sd["params"]):
        raise ValueError(
            f"the checkpoint's parameters {sorted(set(sd['params']) ^ set(live))} do not match the model's"
        )
    for name, t in live.items():
        t.copy_(sd["params"][name])
    params = dict(model.named_parameters())
    for name, step in sd["adam"]["step"].items():
        p = params[name]
        st = optimizer.state[p]
        if not st:
            group = next(g for g in optimizer.param_groups if any(q is p for q in g["params"]))
            on = p.device if group.get("capturable") or group.get("fused") else "cpu"
            st["step"] = torch.zeros((), dtype=torch.float32, device=on)
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        st["step"].copy_(step)
        st["exp_avg"].copy_(sd["adam"]["exp_avg"][name])
        st["exp_avg_sq"].copy_(sd["adam"]["exp_avg_sq"][name])
    scheduler.last_epoch = int(sd["scheduler_step"])
    rates = [base * fn(scheduler.last_epoch) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, rate in zip(optimizer.param_groups, rates):
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(rate)
        else:
            group["lr"] = rate
    scheduler._last_lr = rates
    acc = getattr(optimizer, "accumulator", None)
    if acc is not None:
        acc.bind([p for p in model.parameters() if p.requires_grad])
        saved = sd.get("accumulation")
        if saved is None:
            acc.reset()
        else:
            acc.mini.copy_(saved["mini_step"])
            names = {id(p): n for n, p in model.named_parameters()}
            for p, a in zip(acc.params, acc.acc):
                a.copy_(saved["acc"][names[id(p)]])
    state.step = int(sd["step"])


# --------------------------------------------------------------------- config
SKIP_CFG_PARAMS = {"seq_attention_layers", "dep_graph_attention_layers"}


def _default_trainer_config() -> dict:
    return {"log_every_n_steps": 10, "checkpoint_every_n_steps": 100, "max_checkpoints_to_keep": 2, "profile_dir": None}


@config_dataclass
class PretrainConfig:
    """The configuration of a pretraining run (JAX's ``PretrainConfig``).

    ``config`` holds `StructuredTransformerConfig` keyword arguments (a
    ``_target_`` key is ignored); the three config fields take their class
    or a dict of its fields. ``${experiment_dir}`` in ``save_dir`` is
    replaced by ``experiment_dir``. ``do_detect_anomaly`` runs every step
    eagerly under ``torch.autograd.detect_anomaly``.
    """

    do_overwrite: bool = False
    seed: int = 1
    do_detect_anomaly: bool = False

    config: dict[str, Any] = dataclasses.field(default_factory=dict)
    optimization_config: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    data_config: PytorchDatasetConfig = dataclasses.field(default_factory=PytorchDatasetConfig)
    pretraining_metrics_config: MetricsConfig = dataclasses.field(
        default_factory=lambda: MetricsConfig(do_skip_all_metrics=True)
    )
    final_validation_metrics_config: MetricsConfig = dataclasses.field(
        default_factory=lambda: MetricsConfig(do_skip_all_metrics=False)
    )
    trainer_config: dict[str, Any] = dataclasses.field(default_factory=_default_trainer_config)

    experiment_dir: str = "./experiments"
    save_dir: str = "${experiment_dir}/pretrain"

    do_final_validation_on_metrics: bool = True
    do_resume_from_checkpoint: bool = True

    def __post_init__(self):
        if "max_epochs" in self.trainer_config:
            raise ValueError("Max epochs is set in the optimization_config, not the trainer config!")
        for name, cls in (("optimization_config", OptimizationConfig), ("data_config", PytorchDatasetConfig),
                          ("pretraining_metrics_config", MetricsConfig),
                          ("final_validation_metrics_config", MetricsConfig)):  # fmt: skip
            if isinstance(getattr(self, name), dict):
                setattr(self, name, cls.from_dict(getattr(self, name)))
        self.save_dir = str(self.save_dir).replace("${experiment_dir}", str(self.experiment_dir))

    def build_model_config(self) -> StructuredTransformerConfig:
        """The model config of ``config``, each string entry whose parameter
        is annotated ``int``, ``float`` or ``bool`` coerced to it (the port's
        repair: JAX passes ``config.resid_dropout=1e-05``, a YAML 1.1
        string, on as a string)."""
        kwargs = {k: v for k, v in self.config.items() if k not in SKIP_CFG_PARAMS and k != "_target_"}
        return StructuredTransformerConfig(**coerce_to_signature(StructuredTransformerConfig.__init__, kwargs))


def refusals(cfg: PretrainConfig) -> None:
    """Raises ``ValueError`` for what `train` does not run yet, naming where
    it waits: meshes (tensor, FSDP and context parallelism; ROADMAP Queue 1
    item 7) and ``trainer_config["profile_dir"]`` (a profiler window inside
    the loop would precede the captures that follow; ``tools/profile_train.py``
    profiles the step)."""
    tc = dict(cfg.trainer_config or {})
    for key in ("tensor_parallel_shards", "fsdp_shards", "context_parallel_shards"):
        if int(tc.get(key) or 1) > 1:
            raise ValueError(f"trainer_config.{key} > 1 is not part of the PyTorch port yet ({SHARDED_FEEDS})")
    if tc.get("profile_dir"):
        raise ValueError(
            "trainer_config.profile_dir is refused by the PyTorch port's train(): no capture may follow a "
            "torch.profiler session; profile the step with eventstreamgpt_tpu_torch.tools.profile_train"
        )


# ---------------------------------------------------------------------- train
class _Clock:
    """Marks on the device's timeline (CUDA events on the current stream), or
    the host clock on the CPU; a span is read once the device has passed it."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def seconds(self, span) -> float:
        start, end = span
        return start.elapsed_time(end) / 1e3 if self.cuda else end - start


def _eval_generator(device, seed: int, which: int) -> torch.Generator:
    """The sampled metrics' generator of one evaluation (``which``: the epoch, or -1 / -2 for the final ones)."""
    return torch.Generator(device=device).manual_seed(dropout_seed(seed, (1 << 40) + which))


def write_run_configs(cfg, config: StructuredTransformerConfig, save_dir: Path) -> None:
    """Writes ``config.json``, ``data_config.json`` and
    ``optimization_config.json`` under ``save_dir``; raises
    ``FileExistsError`` over an existing ``config.json`` unless
    ``cfg.do_overwrite`` or a checkpoint to resume from is there."""
    save_dir.mkdir(parents=True, exist_ok=True)
    config_fp = save_dir / "config.json"
    has_resume_target = cfg.do_resume_from_checkpoint and any(
        p.name.isdigit() for p in (save_dir / "model_checkpoints").glob("*")
    )
    if config_fp.exists() and not cfg.do_overwrite and not has_resume_target:
        raise FileExistsError(f"{config_fp} already exists!")
    config.to_json_file(config_fp, do_overwrite=True)
    cfg.data_config.to_json_file(save_dir / "data_config.json", do_overwrite=True)
    cfg.optimization_config.to_json_file(save_dir / "optimization_config.json", do_overwrite=True)


def check_train_size(train_ds, oc: OptimizationConfig) -> None:
    if len(train_ds) < oc.batch_size:
        raise ValueError(
            f"Train split has {len(train_ds)} subjects but batch_size is {oc.batch_size}; training batches drop the "
            "last short batch, so no batch can be formed. Lower optimization_config.batch_size."
        )


def optimizer_setup(model, oc: OptimizationConfig, device: torch.device) -> tuple:
    """``(optimizer, scheduler, TrainState())`` for ``model`` on ``device``:
    `build_optimizer`'s AdamW, capturable on the card, its accumulator bound."""
    optimizer, scheduler = build_optimizer(model, oc)
    if device.type == "cuda":
        make_capturable(optimizer, device)
    if optimizer.accumulator is not None:
        optimizer.accumulator.bind([p for p in model.parameters() if p.requires_grad])
    return optimizer, scheduler, TrainState()


def resident_datasets(tc: dict, train_ds, tuning_ds, device) -> tuple:
    """``(device_train, device_tuning, budget)``: the train and tuning splits'
    `DeviceDataset`s as ``trainer_config["device_resident_data"]`` asks
    (True; ``"auto"``, when they fit ``device_resident_max_bytes``; False:
    None for both)."""
    resident_mode = tc.get("device_resident_data", "auto")
    budget = int(tc.get("device_resident_max_bytes") or DeviceDataset.DEFAULT_BUDGET_BYTES)
    device_train = device_tuning = None
    if resident_mode is True:
        device_train = DeviceDataset(train_ds, device=device)
        device_tuning = DeviceDataset(tuning_ds, device=device)
    elif resident_mode == "auto":
        device_train = DeviceDataset.try_create(train_ds, device=device, max_bytes=budget)
        if device_train is not None:
            device_tuning = DeviceDataset.try_create(tuning_ds, device=device, max_bytes=budget)
    return device_train, device_tuning, budget


def host_dispatches(train_step: Callable, batches: Iterable[EventStreamBatch], device, seed: int):
    """`fit`'s ``(run, 1, n_events)`` over host batches, the prefetch thread
    copying each to ``device`` ahead of its step."""
    batch_iter = prefetch_to_device(batches, to_device(device), host_stats_fn=lambda b: int(b.event_mask.sum()))
    try:
        for batch, n_events in batch_iter:
            yield functools.partial(train_step, batch, seed), 1, n_events
    finally:
        batch_iter.close()


def json_logger(log_fp: Path) -> Callable:
    """``log_record(rec)``: appends ``rec`` to ``log_fp`` as one JSON line."""

    def log_record(rec: dict) -> None:
        with open(log_fp, "a") as f:
            f.write(json.dumps(rec) + "\n")

    return log_record


def write_final_metrics(save_dir: Path, tuning: dict, held_out: dict) -> None:
    print("Saving final metrics...")
    with open(save_dir / "tuning_metrics.json", "w") as f:
        json.dump(tuning, f)
    with open(save_dir / "held_out_metrics.json", "w") as f:
        json.dump(held_out, f)


def reliability_setup(tc: dict, save_dir: Path) -> tuple:
    """``(sentinel, rollback_ctl, ckpt_mgr)`` of a trainer config: the
    divergence sentinel and its rollback controller (None without the
    sentinel's keys) and the checksummed checkpoint manager of
    ``save_dir/model_checkpoints``."""
    from ..reliability.integrity import ReliableCheckpointManager
    from ..reliability.sentinel import DivergenceSentinel, RollbackController, SentinelConfig

    sentinel_cfg = SentinelConfig.from_trainer_config(tc)
    sentinel = DivergenceSentinel(sentinel_cfg) if sentinel_cfg is not None else None
    rollback_ctl = (
        RollbackController(sentinel_cfg.max_rollbacks, save_dir / "divergence_diagnostics.json")
        if sentinel_cfg is not None
        else None
    )
    ckpt_mgr = ReliableCheckpointManager(
        save_dir / "model_checkpoints",
        max_to_keep=int(tc.get("max_checkpoints_to_keep") or 2),
        retries=int(tc.get("ckpt_retries", 3)),
        backoff_base=float(tc.get("ckpt_backoff_base", 0.5)),
    )
    return sentinel, rollback_ctl, ckpt_mgr


def fit(
    *,
    label: str,
    oc: OptimizationConfig,
    tc: dict,
    device: torch.device,
    state: TrainState,
    step_fn: Callable,
    dispatches: Callable,
    full_dispatch: int,
    evaluate_epoch: Callable,
    sentinel,
    rollback_ctl,
    ckpt_mgr,
    start_epoch: int,
    skip_batches: int,
    state_dict: Callable,
    load_state: Callable,
    log_record: Callable,
    total_steps: int,
    anomaly: bool = False,
) -> dict | None:
    """The epochs of a training run, shared by pretraining's and fine-tuning's
    `train`; returns the last epoch's tuning metrics (None if no epoch ran).

    ``dispatches(epoch, skip)`` yields ``(run, k, n_events)``: ``run()``
    trains ``k`` steps (one single step, or one chunk of ``full_dispatch``
    steps or fewer) on ``n_events`` events and returns the losses (with
    ``(losses, healths)`` when the sentinel is on), after skipping the
    epoch's first ``skip`` batches. ``step_fn`` is the step behind it (its
    ``stats()`` and the capture guard's watch), ``evaluate_epoch(epoch)``
    the tuning metrics. Each dispatch: the window record every
    ``log_every_n_steps``, a sentinel-vetted checkpoint every
    ``checkpoint_every_n_steps``, the capture guard (armed from the second
    in-process epoch), ``max_training_steps`` and preemption. Each epoch:
    `reliability.sentinel.finish_epoch` (``label`` names the run in its
    errors), the tuning evaluation, the epoch-end checkpoint and early
    stopping on the tuning loss."""
    from ..analysis.compile_guard import CompileGuard
    from ..reliability import faults
    from ..reliability.preemption import GracefulShutdown
    from ..reliability.sentinel import HealthMonitor, finish_epoch

    log_every = int(tc.get("log_every_n_steps") or 10)
    ckpt_every = int(tc.get("checkpoint_every_n_steps") or 100)
    accum = oc.gradient_accumulation or 1
    with_health = sentinel is not None
    schedule = polynomial_decay_with_warmup(
        oc.init_lr, oc.end_lr, oc.lr_num_warmup_steps, oc.max_training_steps, oc.lr_decay_power
    )
    step_guard = None
    if bool(tc.get("guard_recompiles", True)):
        step_guard = CompileGuard(watch=[step_fn], label=f"{label} step (mid-epoch)")

    best_tuning_loss = float("inf")
    epochs_since_best = 0
    global_step = state.step
    stop = False
    full_epoch_completed_in_process = False
    tuning_metrics = None
    shutdown = GracefulShutdown()
    resume_epoch, resume_skip = start_epoch, skip_batches
    epoch = start_epoch
    clock = _Clock(device)
    anomaly_prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(anomaly)
    try:
        with shutdown:
            while epoch < oc.max_epochs:
                if step_guard is not None:
                    step_guard.arm() if full_epoch_completed_in_process else step_guard.disarm()
                epoch_t0 = time.perf_counter()
                window_mark, window_events, window_n = None, 0, 0
                window_losses: list = []
                spans: list = []  # the device spans of the epoch's steps, window by window
                epoch_skip = resume_skip if epoch == resume_epoch else 0
                if rollback_ctl is not None:
                    epoch_skip = rollback_ctl.epoch_skip(epoch, epoch_skip)
                epoch_progress = epoch_skip
                preempt_requested = False
                health_mon = HealthMonitor(sentinel)
                timing = {"save_s": 0.0}

                def flush_window() -> dict:
                    nonlocal window_mark, window_events, window_n, window_losses
                    span = (window_mark, clock.mark())
                    spans.append(span)
                    rec = {
                        "split": str(Split.TRAIN),
                        "epoch": epoch,
                        "step": global_step,
                        "_losses": [x.reshape(-1) for x in window_losses],
                        "_span": span,
                        "_n": window_n,
                        "events": window_events,
                    }
                    window_mark, window_events, window_n = None, 0, 0
                    window_losses = []
                    return rec

                def finalize_record(rec: dict) -> None:
                    rec["train_loss"] = float(torch.cat(rec.pop("_losses")).float().mean())  # waits for the steps
                    dt = clock.seconds(rec.pop("_span"))
                    rec["events_per_sec"] = rec["events"] / dt if dt > 0 else None
                    rec["step_time_ms"] = 1000.0 * dt / max(rec.pop("_n"), 1)
                    rec["lr"] = float(schedule(rec["step"] // accum))
                    log_record(rec)

                def handle_window(step_in_epoch: int, stepped: int, pending: list) -> None:
                    nonlocal stop, preempt_requested
                    if global_step % log_every < stepped:
                        pending.append(flush_window())
                    if global_step % ckpt_every < stepped:
                        t0 = time.perf_counter()
                        if health_mon.vetted_save(
                            ckpt_mgr,
                            global_step,
                            state_dict,
                            {"epoch": epoch, "epoch_complete": False, "step_in_epoch": step_in_epoch},
                            epoch=epoch,
                            progress=step_in_epoch,
                        ):
                            for rec in pending:
                                finalize_record(rec)
                            pending.clear()
                        timing["save_s"] += time.perf_counter() - t0
                    if step_guard is not None and step_guard.armed:
                        if stepped == full_dispatch:
                            step_guard.check()
                        elif step_guard.compiles > 0:
                            step_guard.arm()  # a short tail chunk owns its key
                    if oc.max_training_steps is not None and global_step // accum >= oc.max_training_steps:
                        stop = True
                    if shutdown.requested:
                        preempt_requested = True

                pending_logs: list[dict] = []
                dispatch_iter = dispatches(epoch, epoch_skip)
                try:
                    step_in_epoch = epoch_skip
                    for run, k, n_events in dispatch_iter:
                        window_mark = window_mark or clock.mark()
                        out = run()
                        losses = out[0] if with_health else out
                        if with_health:
                            health_mon.record(out[1])
                        global_step += k
                        step_in_epoch += k
                        epoch_progress = step_in_epoch
                        faults.maybe_sigterm(global_step, shutdown)
                        window_events += n_events
                        window_losses.append(losses)
                        window_n += k
                        handle_window(step_in_epoch, k, pending_logs)
                        if stop or health_mon.rollback_requested or preempt_requested:
                            break
                finally:
                    dispatch_iter.close()
                    if window_mark is not None:  # a tail shorter than a window
                        spans.append((window_mark, clock.mark()))
                    for rec in pending_logs:
                        finalize_record(rec)

                outcome = finish_epoch(
                    health_mon=health_mon,
                    rollback_ctl=rollback_ctl,
                    ckpt_mgr=ckpt_mgr,
                    shutdown=shutdown,
                    state_dict_fn=state_dict,
                    load_state=load_state,
                    log_record=log_record,
                    epoch=epoch,
                    epoch_progress=epoch_progress,
                    global_step=global_step,
                    accum=accum,
                    max_training_steps=oc.max_training_steps,
                    label=label,
                )
                if outcome.action == "rollback":
                    global_step = outcome.global_step
                    resume_epoch, resume_skip = outcome.resume_epoch, outcome.resume_skip
                    stop = outcome.stop
                    epoch = resume_epoch
                    continue
                if epoch_skip == 0:
                    full_epoch_completed_in_process = True

                eval_t0 = time.perf_counter()
                tuning_metrics = evaluate_epoch(epoch)
                eval_s = time.perf_counter() - eval_t0
                tuning_loss = tuning_metrics.get("tuning_loss", float("nan"))
                t0 = time.perf_counter()
                if outcome.tail_healthy:
                    ckpt_mgr.save(global_step, state_dict(), metadata={"epoch": epoch, "epoch_complete": True})
                timing["save_s"] += time.perf_counter() - t0
                log_record(
                    {
                        "split": str(Split.TUNING),
                        "epoch": epoch,
                        "step": global_step,
                        **tuning_metrics,
                        "epoch_time_s": time.perf_counter() - epoch_t0,
                        "steps_s": sum(clock.seconds(span) for span in spans),
                        "eval_s": eval_s,
                        "checkpoint_s": timing["save_s"],
                        "graph_captures": step_fn.stats()["graph_captures"],
                    }
                )
                print(f"epoch {epoch}: opt step {global_step // accum}/{total_steps} tuning_loss={tuning_loss:.4f}")
                if np.isfinite(tuning_loss) and tuning_loss < best_tuning_loss - 1e-12:
                    best_tuning_loss = tuning_loss
                    epochs_since_best = 0
                else:
                    epochs_since_best += 1
                    if oc.patience is not None and epochs_since_best >= max(oc.patience, 1):
                        print(f"Early stopping at epoch {epoch} (patience {oc.patience})")
                        break
                if stop:
                    break
                epoch += 1
    finally:
        torch.autograd.set_detect_anomaly(anomaly_prev)
    return tuning_metrics


def train(
    cfg: PretrainConfig, model_config: StructuredTransformerConfig | None = None, device=None
) -> tuple[float | None, dict | None, dict | None]:
    """End-to-end pretraining from a converted DL cache (JAX's ``train``).

    Returns ``(tuning_loss, tuning_metrics, held_out_metrics)`` of the final
    validation, or ``(None, None, None)`` without it. ``device=None`` means
    the CUDA device (and raises without one); the tests pass ``"cpu"``.

    In JAX's order: ``train`` and ``tuning`` `TorchDataset`s, the configs set
    to the dataset, the five config files under ``cfg.save_dir``, the model
    (numpy-seeded from ``cfg.seed``) and AdamW, resume from the newest
    verified checkpoint in ``save_dir/model_checkpoints``, then the epochs
    (`fit`): with the tables resident (``trainer_config["device_resident_data"]``:
    ``"auto"`` when they fit `DeviceDataset.DEFAULT_BUDGET_BYTES`, True, or
    False) the captured chunked step over ``steps_per_execution`` plans a
    dispatch (default ``min(log_every, checkpoint_every, 16)``), otherwise
    host collation with the prefetch thread feeding the captured single
    step. Then ``save_pretrained`` and the final validation on ``tuning`` and
    ``held_out`` with the full metrics config (``tuning_metrics.json``,
    ``held_out_metrics.json``). Beside JAX's fields, ``train_log.jsonl``'s
    window records carry their ``events``, the epoch records the seconds of
    the steps, the evaluation and the checkpoint saves and the step's
    ``graph_captures`` so far, and a ``"final"`` record the seconds of
    ``save_pretrained`` and the final validation. A window's
    ``events_per_sec`` and ``step_time_ms`` and an epoch's ``steps_s`` are
    read off the device's timeline (CUDA events around the window's steps,
    read when the loop next waits for the device), so the loop never waits
    to time them; on the CPU, off the host clock.

    Raises `reliability.sentinel.DivergenceError` when rollbacks are spent,
    and ``ValueError`` for what `refusals` names.
    """
    from ..convert import init_params_from_seed
    from ..reliability import faults
    from ..reliability.integrity import resume_training_state
    from .checkpoint import save_pretrained

    device = resolve_device(device, "train")
    refusals(cfg)
    np.random.seed(cfg.seed)
    anomaly = bool(cfg.do_detect_anomaly)

    train_ds = TorchDataset(cfg.data_config, split="train")
    tuning_ds = TorchDataset(cfg.data_config, split="tuning")
    config = model_config if model_config is not None else cfg.build_model_config()
    oc, data_config = cfg.optimization_config, cfg.data_config
    configured_max_seq_len = config.max_seq_len
    config.set_to_dataset(train_ds)

    tc = dict(cfg.trainer_config or {})
    use_packed = bool(tc.get("use_packed_batches"))
    packed_L = int(tc.get("packed_seq_len") or max(configured_max_seq_len, train_ds.max_seq_len))
    if use_packed:
        config.max_seq_len = packed_L
    steps_per_epoch = (
        train_ds.packed_batch_count(oc.batch_size, seq_len=packed_L, seed=cfg.seed) if use_packed else None
    )
    oc.set_to_dataset(train_ds, steps_per_epoch=steps_per_epoch)
    if steps_per_epoch is None:
        steps_per_epoch = len(train_ds) // oc.batch_size

    save_dir = Path(cfg.save_dir)
    write_run_configs(cfg, config, save_dir)
    cfg.pretraining_metrics_config.to_json_file(save_dir / "pretraining_metrics_config.json", do_overwrite=True)
    cfg.final_validation_metrics_config.to_json_file(
        save_dir / "final_validation_metrics_config.json", do_overwrite=True
    )

    check_train_size(train_ds, oc)
    model = init_params_from_seed(build_model(config), seed=cfg.seed).to(device).train()
    optimizer, scheduler, state = optimizer_setup(model, oc, device)
    accum = oc.gradient_accumulation or 1

    def state_dict() -> dict:
        return train_state_dict(model, optimizer, scheduler, state)

    def load_state(sd: dict) -> None:
        load_train_state(sd, model, optimizer, scheduler, state)

    log_every = int(tc.get("log_every_n_steps") or 10)
    ckpt_every = int(tc.get("checkpoint_every_n_steps") or 100)
    sentinel, rollback_ctl, ckpt_mgr = reliability_setup(tc, save_dir)
    start_epoch = skip_batches = 0
    if cfg.do_resume_from_checkpoint and ckpt_mgr.latest_step() is not None:
        _, start_epoch, skip_batches = resume_training_state(ckpt_mgr, load_state)

    device_train, device_tuning, budget = resident_datasets(tc, train_ds, tuning_ds, device)
    chunk_steps = tc.get("steps_per_execution") or "auto"
    if chunk_steps == "auto":
        chunk_steps = max(min(log_every, ckpt_every, 16), 1)
    chunk_steps = int(chunk_steps)
    step_kw = dict(with_health=sentinel is not None, device=device, cuda_graph=not anomaly, state=state)
    if device_train is not None:
        chunked_step = make_chunked_train_step(model, optimizer, scheduler, device_train, packed=use_packed, **step_kw)
        train_step = None
    else:
        chunked_step = None
        train_step = make_train_step(model, optimizer, scheduler, **step_kw)
    eval_step = make_eval_step(model, device)

    def train_batches(epoch: int, skip: int):
        if not use_packed:
            return train_ds.batches(oc.batch_size, shuffle=True, seed=cfg.seed + epoch, skip_batches=skip)
        packed = (
            b for b in train_ds.packed_batches(oc.batch_size, seq_len=packed_L, seed=cfg.seed + epoch)
            if b.event_mask.shape[0] == oc.batch_size
        )  # fmt: skip
        return itertools.islice(packed, skip, None)

    def train_plan_chunks(epoch: int, skip: int):
        if use_packed:
            return device_train.packed_plan_chunks(
                oc.batch_size, chunk_steps, seq_len=packed_L, seed=cfg.seed + epoch, skip_batches=skip
            )
        return device_train.plan_chunks(oc.batch_size, chunk_steps, shuffle=True, seed=cfg.seed + epoch,
                                        skip_batches=skip)  # fmt: skip

    def dispatches(epoch: int, skip: int):
        if chunked_step is None:
            yield from host_dispatches(
                train_step, faults.wrap_batches(train_batches(epoch, skip), epoch=epoch, first_index=skip),
                device, cfg.seed,
            )  # fmt: skip
            return
        for plans, n_events in train_plan_chunks(epoch, skip):
            k = int(next(iter(plans.values())).shape[0])
            if oc.max_training_steps is not None:
                remaining = oc.max_training_steps * accum - state.step
                if remaining < k:
                    plans = {key: v[:remaining] for key, v in plans.items()}
                    k = remaining
                    n_events = _plan_event_count(plans, train_ds) if k > 0 else 0
            if k <= 0:
                return
            yield functools.partial(chunked_step, plans, cfg.seed), k, n_events

    def evaluate_epoch(epoch: int) -> dict:
        return evaluate(
            eval_step, tuning_ds, oc.validation_batch_size, config, cfg.pretraining_metrics_config,
            Split.TUNING, generator=_eval_generator(device, cfg.seed, epoch), device_data=device_tuning,
        )  # fmt: skip

    log_record = json_logger(save_dir / "train_log.jsonl")
    fit(
        label="pretraining", oc=oc, tc=tc, device=device, state=state, step_fn=chunked_step or train_step,
        dispatches=dispatches, full_dispatch=chunk_steps if chunked_step is not None else 1,
        evaluate_epoch=evaluate_epoch, sentinel=sentinel, rollback_ctl=rollback_ctl, ckpt_mgr=ckpt_mgr,
        start_epoch=start_epoch, skip_batches=skip_batches, state_dict=state_dict, load_state=load_state,
        log_record=log_record, total_steps=oc.max_training_steps or steps_per_epoch * oc.max_epochs,
        anomaly=anomaly,
    )  # fmt: skip

    ckpt_mgr.wait_until_finished()
    t0 = time.perf_counter()
    save_pretrained(save_dir, model)
    save_s = time.perf_counter() - t0
    if not cfg.do_final_validation_on_metrics:
        log_record({"split": "final", "save_pretrained_s": save_s})
        ckpt_mgr.close()
        return None, None, None

    held_out_ds = TorchDataset(cfg.data_config, split="held_out")
    device_held_out = (
        DeviceDataset.try_create(held_out_ds, device=device, max_bytes=budget) if device_train is not None else None
    )
    final_tuning = evaluate(
        eval_step, tuning_ds, oc.validation_batch_size, config, cfg.final_validation_metrics_config, Split.TUNING,
        generator=_eval_generator(device, cfg.seed, -1), device_data=device_tuning,
    )  # fmt: skip
    final_held_out = evaluate(
        eval_step, held_out_ds, oc.validation_batch_size, config, cfg.final_validation_metrics_config,
        Split.HELD_OUT, generator=_eval_generator(device, cfg.seed, -2), device_data=device_held_out,
    )  # fmt: skip
    log_record({"split": "final", "save_pretrained_s": save_s, "validation_s": time.perf_counter() - t0 - save_s})
    write_final_metrics(save_dir, final_tuning, final_held_out)
    ckpt_mgr.close()
    return final_tuning.get("tuning_loss"), final_tuning, final_held_out
