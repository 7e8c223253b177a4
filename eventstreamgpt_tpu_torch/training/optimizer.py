"""Optimizer construction from ``OptimizationConfig``.

Counterpart: ``eventstreamgpt_tpu/training/optimizer.py``. AdamW (betas 0.9
and 0.999, eps 1e-8) with the learning rate warming up linearly from 0 to
``init_lr`` and then decaying polynomially to ``end_lr``, as
``optax.adamw(schedule, weight_decay)``: update ``k`` (from 0) uses
``schedule(k)``, so the first update under warmup moves only the moments,
and the decoupled weight decay applies to every parameter (optax's default
mask is None), biases and LayerNorm scales included.

Two forms of the same optimizer. `build_optimizer` gives AdamW with a float
rate that ``LambdaLR`` rebinds after each step: the CPU train step runs it,
and the JAX parity tests hold it. On a CUDA device the train step first
applies `make_capturable`: ``capturable=True`` (step counts and bias
corrections on the device) and the rate as a 0-d device tensor that the
scheduler writes in place, so a step captured into a CUDA graph reads each
step's rate rather than the one it was captured with. (PyTorch refuses a
tensor rate in its ``foreach`` path, the card's default, unless the
optimizer is capturable.)

Gradient accumulation (``OptimizationConfig.gradient_accumulation = k > 1``,
JAX's ``optax.MultiSteps``): `build_optimizer` hangs a `GradientAccumulator`
on the optimizer (``optimizer.accumulator``). Every loop step adds its
gradient into a running mean, ``acc += (g - acc) / (m + 1)`` at micro-step
``m``; every ``k``-th step applies one AdamW update with that mean, then
zeroes the buffers. The scheduler counts optimizer steps, not loop steps.
The buffers and the micro-step count live on the device, at fixed
addresses, so the accumulating and the applying step can each be captured.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..models.config import OptimizationConfig


def polynomial_decay_with_warmup(
    init_lr: float, end_lr: float, num_warmup_steps: int, num_training_steps: int, power: float = 1.0
) -> Callable[[int], float]:
    """The learning rate at a step, as HF's ``get_polynomial_decay_schedule_with_warmup``.

    step < warmup:  init_lr * step / warmup
    step >= total:  end_lr
    otherwise:      end_lr + (init_lr - end_lr) * (1 - (step - warmup) / (total - warmup)) ** power

    Examples:
        >>> s = polynomial_decay_with_warmup(1.0, 0.0, 2, 6)
        >>> [s(k) for k in (0, 1, 2, 4, 6, 9)]
        [0.0, 0.5, 1.0, 0.5, 0.0, 0.0]
    """
    if init_lr <= end_lr:
        raise ValueError(f"end_lr ({end_lr}) must be smaller than init_lr ({init_lr})")

    def schedule(step: int) -> float:
        if step >= num_training_steps:
            return end_lr
        if step < num_warmup_steps:
            return init_lr * step / max(num_warmup_steps, 1)
        remaining = 1.0 - (step - num_warmup_steps) / max(num_training_steps - num_warmup_steps, 1)
        return (init_lr - end_lr) * remaining**power + end_lr

    return schedule


def build_optimizer(
    model: torch.nn.Module, optimization_config: OptimizationConfig
) -> tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """``(optimizer, scheduler)`` over every parameter of ``model``; call
    ``scheduler.step()`` after each ``optimizer.step()``."""
    oc = optimization_config
    if oc.max_training_steps is None or oc.lr_num_warmup_steps is None:
        raise ValueError(
            "OptimizationConfig.max_training_steps / lr_num_warmup_steps are unset; "
            "call optimization_config.set_to_dataset(...) first."
        )
    accumulation = 1 if oc.gradient_accumulation is None else int(oc.gradient_accumulation)
    if accumulation < 1:
        raise ValueError(f"gradient_accumulation must be None or at least 1; got {oc.gradient_accumulation}")
    schedule = polynomial_decay_with_warmup(
        oc.init_lr, oc.end_lr, oc.lr_num_warmup_steps, oc.max_training_steps, oc.lr_decay_power
    )
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=oc.init_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=oc.weight_decay
    )
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: schedule(step) / oc.init_lr)
    optimizer.accumulator = GradientAccumulator(accumulation) if accumulation > 1 else None
    return optimizer, scheduler


class GradientAccumulator:
    """The running mean of ``k`` micro-steps' gradients (``optax.MultiSteps``).

    ``bind(params)`` allocates, once, an fp32 buffer a parameter and the
    micro-step count ``mini`` (a 0-d fp32 tensor) on the parameters' device.
    `accumulate` folds the current gradients in; `load` writes the mean into
    the gradients for the optimizer; `reset` zeroes the buffers. All three
    write in place, so a captured step keeps reading and writing the same
    tensors."""

    def __init__(self, k: int):
        if k < 2:
            raise ValueError(f"a GradientAccumulator accumulates k >= 2 micro-steps, not {k}")
        self.k = int(k)
        self.params: list = []
        self.acc: list[torch.Tensor] = []
        self.mini: torch.Tensor | None = None

    def bind(self, params: list[nn.Parameter]) -> "GradientAccumulator":
        params = list(params)
        if self.mini is None or self.acc[0].device != params[0].device:
            self.params = params
            self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            self.mini = torch.zeros((), dtype=torch.float32, device=params[0].device)
        return self

    def accumulate(self) -> None:
        denom = self.mini + 1
        for p, acc in zip(self.params, self.acc):
            if p.grad is not None:
                acc.add_((p.grad.float() - acc) / denom)
        self.mini.add_(1)

    def load(self) -> None:
        for p, acc in zip(self.params, self.acc):
            if p.grad is not None:
                p.grad.copy_(acc)

    def reset(self) -> None:
        for acc in self.acc:
            acc.zero_()
        self.mini.zero_()


def make_capturable(optimizer: torch.optim.Optimizer, device) -> None:
    """Turns a `build_optimizer` AdamW into its capturable form (module
    docstring) on ``device``, before its first step: each group's rate
    becomes a 0-d fp32 tensor on ``device`` holding the current rate, which
    an ``LRScheduler`` fills in place from then on, and ``capturable`` is set.
    An optimizer in that form already is left as it is."""
    if all(g.get("capturable") and torch.is_tensor(g["lr"]) and g["lr"].device.type == torch.device(device).type
           for g in optimizer.param_groups):  # fmt: skip
        return
    if optimizer.state:
        raise ValueError("make_capturable: the optimizer has taken a step already")
    for group in optimizer.param_groups:
        group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32, device=device)
        group["capturable"] = True
