"""Deterministic fault injection for the training loop's recovery paths.

Counterpart: ``eventstreamgpt_tpu/reliability/faults.py`` (beside the port's
`serving_faults`). A `FaultPlan` scripts faults against deterministic
counters: the batch index within an epoch's (seeded, reproducible) order,
the checkpoint-save call index, the global optimizer-loop step. Every
recovery path of `training.pretrain.train` runs with the same timeline on
every run:

* ``nan_batch`` / ``spike_batch``: poison the host batch at epoch-order
  index N (NaN values and times, or both scaled by ``scale``), driving a
  non-finite loss or a loss spike through the divergence sentinel;
* ``save_error``: raise ``OSError`` for the first ``times`` attempts of
  checkpoint-save call N (`integrity.retry_transient`);
* ``corrupt_checkpoint``: garble the largest file of the step just written
  after save call N, its manifest left as it was (walk-back restore);
* ``sigterm``: request a graceful shutdown at global step N (a real
  ``SIGTERM`` when no `GracefulShutdown` is given);
* ``kill``: ``SIGKILL`` this process during save call N, after the state is
  written and before the manifest (a checkpoint that exists on disk but
  does not verify).

Plans are installed process-wide (`install_fault_plan` or the `fault_plan`
context manager); every hook does nothing when no plan is installed. Batch
faults key on the epoch-order index, not the global step, so the window a
rollback excises stays excised.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterable, Iterator

import torch

__all__ = [
    "Fault",
    "FaultPlan",
    "active_fault_plan",
    "clear_fault_plan",
    "corrupt_checkpoint_step",
    "fault_plan",
    "install_fault_plan",
    "maybe_corrupt_after_save",
    "maybe_fail_save",
    "maybe_kill_during_save",
    "maybe_sigterm",
    "wrap_batches",
]

BATCH_KINDS = frozenset({"nan_batch", "spike_batch"})
SAVE_KINDS = frozenset({"save_error", "corrupt_checkpoint", "kill"})


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted fault. Which trigger field applies depends on ``kind``:

    ``nan_batch``/``spike_batch`` fire on ``(epoch, batch_index)`` (epoch
    ``None`` = every epoch; the index counts the epoch's deterministic batch
    order from 0). ``save_error``/``corrupt_checkpoint``/``kill`` fire on
    ``save_index`` (counting checkpoint-save *calls* from 0). ``sigterm``
    fires once at global optimizer-loop step ``step``.
    """

    kind: str
    step: int | None = None  # sigterm: global step
    epoch: int | None = None  # batch faults: restrict to one epoch
    batch_index: int | None = None  # batch faults: 0-based epoch-order index
    save_index: int | None = None  # save faults: 0-based save-call index
    times: int = 1  # save_error: attempts to fail before succeeding
    scale: float = 1e6  # spike_batch: value multiplier

    def __post_init__(self):
        known = BATCH_KINDS | SAVE_KINDS | {"sigterm"}
        if self.kind not in known:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {sorted(known)}")
        if self.kind in BATCH_KINDS and self.batch_index is None:
            raise ValueError(f"{self.kind} needs batch_index")
        if self.kind in SAVE_KINDS and self.save_index is None:
            raise ValueError(f"{self.kind} needs save_index")
        if self.kind == "sigterm" and self.step is None:
            raise ValueError("sigterm needs step")


@dataclasses.dataclass
class FaultPlan:
    """A scripted, deterministic fault timeline plus a log of what fired."""

    faults: list[Fault] = dataclasses.field(default_factory=list)
    fired: list[dict] = dataclasses.field(default_factory=list)
    _spent: set = dataclasses.field(default_factory=set)  # one-shot triggers

    def _log(self, fault: Fault, **context) -> None:
        self.fired.append({"kind": fault.kind, **context})

    # ---- batch faults (re-fire if the same batch is retrained: data-caused)
    def batch_fault(self, epoch: int, batch_index: int) -> Fault | None:
        for f in self.faults:
            if (
                f.kind in BATCH_KINDS
                and f.batch_index == batch_index
                and (f.epoch is None or f.epoch == epoch)
            ):
                return f
        return None

    # ---- save faults (keyed per save call; save_error fails `times` attempts)
    def save_fault(self, kind: str, save_index: int) -> Fault | None:
        for f in self.faults:
            if f.kind == kind and f.save_index == save_index:
                return f
        return None

    # ---- sigterm (one-shot; fires at the first boundary crossing the step,
    # since a scanned chunk can advance the global counter by k at once)
    def take_sigterm(self, step: int) -> Fault | None:
        for f in self.faults:
            key = ("sigterm", f.step)
            if f.kind == "sigterm" and step >= f.step and key not in self._spent:
                self._spent.add(key)
                return f
        return None


_ACTIVE: FaultPlan | None = None


def install_fault_plan(plan: FaultPlan) -> FaultPlan:
    global _ACTIVE
    _ACTIVE = plan
    return plan


def clear_fault_plan() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_fault_plan() -> FaultPlan | None:
    return _ACTIVE


@contextmanager
def fault_plan(plan: FaultPlan):
    install_fault_plan(plan)
    try:
        yield plan
    finally:
        clear_fault_plan()


# --------------------------------------------------------------- batch hooks
def _poison_batch(batch: Any, fault: Fault) -> Any:
    """Returns a poisoned copy of a host batch (CPU tensors).

    ``nan_batch`` drives the loss non-finite through every head that consumes
    values or inter-event times; ``spike_batch`` scales the same fields so
    the loss spikes but stays finite (the EMA-spike detection path).
    """
    updates: dict[str, Any] = {}
    for name in ("dynamic_values", "time_delta"):
        val = getattr(batch, name, None)
        if val is None:
            continue
        arr = val.detach().to(torch.float32, copy=True)
        if fault.kind == "nan_batch":
            arr.fill_(float("nan"))
        else:
            arr *= fault.scale
        updates[name] = arr.to(val.dtype)
    return batch.replace(**updates)


def wrap_batches(batches: Iterable, epoch: int, first_index: int) -> Iterator:
    """Wraps an epoch's host batch stream with the active plan's batch faults.

    ``first_index`` is the epoch-order index of the stream's first batch
    (``skip_batches`` on resume), so triggers stay aligned with the epoch's
    deterministic order no matter where the stream starts. Returns the input
    unchanged when no plan (or no batch fault) is active - zero overhead on
    the production path.
    """
    plan = _ACTIVE
    if plan is None or not any(f.kind in BATCH_KINDS for f in plan.faults):
        return iter(batches)

    def gen():
        for i, batch in enumerate(batches, start=first_index):
            fault = plan.batch_fault(epoch, i)
            if fault is not None:
                plan._log(fault, epoch=epoch, batch_index=i)
                batch = _poison_batch(batch, fault)
            yield batch

    return gen()


# ---------------------------------------------------------------- save hooks
def maybe_fail_save(save_index: int, attempt: int) -> None:
    """Raises the scripted transient ``OSError`` for (save call, attempt)."""
    plan = _ACTIVE
    if plan is None:
        return
    fault = plan.save_fault("save_error", save_index)
    if fault is not None and attempt < fault.times:
        plan._log(fault, save_index=save_index, attempt=attempt)
        raise OSError(
            f"injected transient I/O failure (save {save_index}, attempt {attempt})"
        )


def maybe_kill_during_save(ckpt_dir: Path, step: int, save_index: int) -> None:
    """The crash window: SIGKILL during save call N, after the state file is
    written and before the integrity manifest. The step just written is
    truncated (the torn write a kill leaves) and the process dies. Hooked
    before the manifest write."""
    plan = _ACTIVE
    if plan is None:
        return
    fault = plan.save_fault("kill", save_index)
    if fault is not None:
        plan._log(fault, save_index=save_index, step=step)
        corrupt_checkpoint_step(ckpt_dir, step, mode="truncate")
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_corrupt_after_save(ckpt_dir: Path, step: int, save_index: int) -> None:
    """Silent post-save corruption: the step's bytes rot *after* the
    manifest was written (bit rot, torn replication) - the case only the
    checksum verification catches. Hooked after the manifest write."""
    plan = _ACTIVE
    if plan is None:
        return
    fault = plan.save_fault("corrupt_checkpoint", save_index)
    if fault is not None:
        plan._log(fault, save_index=save_index, step=step)
        corrupt_checkpoint_step(ckpt_dir, step, mode="garbage")


# ------------------------------------------------------------- sigterm hook
def maybe_sigterm(step: int, shutdown=None) -> None:
    """Delivers the scripted preemption at global step ``step``.

    With a `GracefulShutdown` in hand the request is set directly (exactly
    what the signal handler would do, minus delivery timing jitter - the
    deterministic in-process path). Without one, a real ``SIGTERM`` is sent
    to this process (the subprocess e2e path).
    """
    plan = _ACTIVE
    if plan is None:
        return
    fault = plan.take_sigterm(step)
    if fault is None:
        return
    plan._log(fault, step=step)
    if shutdown is not None:
        shutdown.request()
    else:
        os.kill(os.getpid(), signal.SIGTERM)


# --------------------------------------------------------------- disk faults
def corrupt_checkpoint_step(ckpt_dir: Path | str, step: int, mode: str = "truncate") -> Path:
    """Corrupts the largest file of checkpoint ``step`` on disk.

    ``truncate`` halves the file (a partial write / torn upload);
    ``garbage`` rewrites its first bytes (silent bit corruption - the case
    only the checksum manifest catches). Returns the corrupted path. Also a
    test utility, usable without any plan installed.
    """
    step_dir = Path(ckpt_dir) / str(step)
    files = sorted(
        (p for p in step_dir.rglob("*") if p.is_file()),
        key=lambda p: p.stat().st_size,
        reverse=True,
    )
    if not files:
        raise FileNotFoundError(f"no files to corrupt under {step_dir}")
    target = files[0]
    if mode == "truncate":
        size = target.stat().st_size
        with open(target, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif mode == "garbage":
        with open(target, "r+b") as f:
            f.write(b"\xde\xad\xbe\xef" * 8)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return target
