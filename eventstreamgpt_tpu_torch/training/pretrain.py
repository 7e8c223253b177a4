"""The single-device train step, for CI and nested-attention models.

Counterpart: ``eventstreamgpt_tpu/training/pretrain.py`` (`TrainState`,
`build_model`, `_train_step_body` behind `make_train_step`). One step runs
the model forward with the losses (``is_generation=False``), backpropagates
the summed loss and applies one AdamW update with the scheduled learning
rate. Dropout draws its keep masks from a ``torch.Generator`` seeded from
``(seed, step)``, the counterpart of ``fold_in(rng, state.step)``: the
same seed and step give the same masks, whatever ran before.

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

from ..data.types import EventStreamBatch
from ..models.ci_model import CIPPTForGenerativeSequenceModeling
from ..models.na_model import NAPPTForGenerativeSequenceModeling
from ..models.config import StructuredEventProcessingMode, StructuredTransformerConfig
from ..utils.device import resolve_device


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


def make_train_step(
    model: CIPPTForGenerativeSequenceModeling | NAPPTForGenerativeSequenceModeling,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    device=None,
    with_health: bool = False,
) -> Callable:
    """A ``step(batch, seed) -> loss`` function that trains ``model`` in place.

    ``device=None`` means the CUDA device (and raises without one); the
    model moves there, and each batch is copied there. The loss comes back
    as a 0-d tensor on the device, unsynchronised. ``with_health=True``
    returns ``(loss, health)`` with ``health = [loss, grad_global_norm]``
    (fp32), the JAX step's divergence-sentinel vector. ``step.state`` is the
    `TrainState`.
    """
    device = resolve_device(device, "make_train_step")
    model.to(device).train()
    params = [p for p in model.parameters() if p.requires_grad]
    state = TrainState()

    def step(batch: EventStreamBatch, seed: int):
        batch = batch.map(lambda t: t.to(device, non_blocking=True))
        rng = torch.Generator(device=device)
        rng.manual_seed(dropout_seed(seed, state.step))
        optimizer.zero_grad(set_to_none=True)
        loss = model(batch, is_generation=False, dropout=rng).loss
        loss.backward()
        if with_health:
            grad_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(p.grad.float()) for p in params if p.grad is not None])
            )
        optimizer.step()
        scheduler.step()
        state.step += 1
        loss = loss.detach()
        return (loss, torch.stack([loss, grad_norm]).float()) if with_health else loss

    step.state = state
    return step


def train_steps(step: Callable, batches: Iterable[EventStreamBatch], seed: int) -> list[float]:
    """Runs ``step`` over ``batches``; returns the losses, read from the device once at the end."""
    losses = [step(b, seed) for b in batches]
    losses = [x[0] if isinstance(x, tuple) else x for x in losses]
    return [float(x) for x in torch.stack(losses).cpu()] if losses else []
