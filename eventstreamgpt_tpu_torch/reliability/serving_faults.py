"""Deterministic fault injection for the serving stack's recovery paths.

Counterpart: ``eventstreamgpt_tpu/reliability/serving_faults.py``. A
`ServingFaultPlan` scripts faults against **deterministic serving counters**
(an engine's dispatched-chunk index and the fleet's service ids), never the
wall clock, so every recovery path of ``serving/`` (slot quarantine, replica
eviction and session replay, promotion rollback, deadline storms) runs on
the CPU with the same timeline on every run:

* ``nan_slot``: poison one slot's row at a chunk boundary so that its next
  forward produces non-finite outputs, driving the decode health sentinel
  (`GenerationEngine.health`): the slot quarantines, its request fails with
  `SlotHealthError` (or retries from its bound seed), and co-resident slots
  stay bit-identical to a clean run.
* ``hang``: sleep inside the dispatch at a chunk boundary, driving the
  fleet's hung-dispatch watchdog into an eviction. With deadline lanes
  (`slo.LaneConfig.deadline_s`) this is the **deadline storm**: the stall
  ages the queued backlog past its deadlines, and every expired request
  surfaces as a typed `DeadlineExceeded`.
* ``death``: every dispatch at or after a chunk boundary raises
  `ReplicaDeadError` (a dead replica stays dead), driving the fleet's
  eviction and deterministic session replay on survivors.
* ``corrupt_shadow``: garble a staged hot-swap checkpoint (NaN into its
  first floating-point tensor), driving `ServingFleet.promote`'s
  finite-output verification gate into a rollback.
* ``flip_failure``: raise from a service's flip during a fleet promotion,
  driving the mid-fleet rollback (already-flipped services flip back onto
  the old weights still held in their shadow buffers).

Faults are scoped by a **fault scope** string: engines carry a
``fault_scope`` attribute (the fleet stamps each service's engines with the
service id; tests may set it directly), and a fault with ``service=None``
matches every scope. Plans install process-globally
(`install_serving_fault_plan` or the `serving_fault_plan` context manager);
every hook below is a no-op when no plan is active, so serving pays one
``None`` check a dispatch.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Any, Iterator

import numpy as np
import torch

__all__ = [
    "ServingFault",
    "ServingFaultPlan",
    "active_serving_fault_plan",
    "clear_serving_fault_plan",
    "corrupt_params_tree",
    "install_serving_fault_plan",
    "maybe_corrupt_shadow",
    "maybe_die",
    "maybe_fail_flip",
    "maybe_hang",
    "poison_slots",
    "serving_fault_plan",
]

SERVING_FAULT_KINDS = frozenset(
    {"nan_slot", "hang", "death", "corrupt_shadow", "flip_failure"}
)


@dataclasses.dataclass(frozen=True)
class ServingFault:
    """One scripted serving fault. Which trigger fields apply depends on
    ``kind``:

    ``nan_slot`` fires at ``(service, chunk_index)`` and poisons ``slot``.
    ``hang`` fires at ``(service, chunk_index)`` and sleeps ``seconds``
    (once). ``death`` fires at every ``(service, chunk >= chunk_index)``
    dispatch — dead replicas stay dead. ``corrupt_shadow`` fires on the
    matching service's next shadow load. ``flip_failure`` fires on the
    matching service's flip during a promotion (once). ``service=None``
    matches any fault scope.
    """

    kind: str
    service: str | None = None  # fault scope (fleet service id); None = any
    slot: int | None = None  # nan_slot: which decode slot
    chunk_index: int | None = None  # chunk-boundary trigger (engine counter)
    seconds: float = 0.0  # hang: stall duration

    def __post_init__(self):
        if self.kind not in SERVING_FAULT_KINDS:
            raise ValueError(
                f"unknown serving fault kind {self.kind!r}; expected one of "
                f"{sorted(SERVING_FAULT_KINDS)}"
            )
        if self.kind == "nan_slot" and (self.slot is None or self.chunk_index is None):
            raise ValueError("nan_slot needs slot and chunk_index")
        if self.kind in ("hang", "death") and self.chunk_index is None:
            raise ValueError(f"{self.kind} needs chunk_index")
        if self.kind == "hang" and self.seconds <= 0:
            raise ValueError("hang needs seconds > 0")

    def _matches_scope(self, scope: str | None) -> bool:
        return self.service is None or self.service == scope


@dataclasses.dataclass
class ServingFaultPlan:
    """A scripted, deterministic serving-fault timeline + a log of firings."""

    faults: list[ServingFault] = dataclasses.field(default_factory=list)
    fired: list[dict] = dataclasses.field(default_factory=list)
    _spent: set = dataclasses.field(default_factory=set)  # one-shot triggers

    def _log(self, fault: ServingFault, **context) -> None:
        self.fired.append({"kind": fault.kind, "service": fault.service, **context})

    def poison_slots(self, scope: str | None, chunk_index: int) -> list[int]:
        """Slot indices to poison before dispatching chunk ``chunk_index``."""
        out = []
        for f in self.faults:
            if (
                f.kind == "nan_slot"
                and f._matches_scope(scope)
                and f.chunk_index == chunk_index
            ):
                self._log(f, scope=scope, chunk_index=chunk_index, slot=f.slot)
                out.append(f.slot)
        return out

    def hang_seconds(self, scope: str | None, chunk_index: int) -> float:
        """One-shot stall duration for this dispatch (0.0 = none)."""
        total = 0.0
        for f in self.faults:
            key = ("hang", f.service, f.chunk_index)
            if (
                f.kind == "hang"
                and f._matches_scope(scope)
                and chunk_index >= f.chunk_index
                and key not in self._spent
            ):
                self._spent.add(key)
                self._log(f, scope=scope, chunk_index=chunk_index, seconds=f.seconds)
                total += f.seconds
        return total

    def is_dead(self, scope: str | None, chunk_index: int) -> bool:
        """True when a ``death`` fault covers this dispatch (sticky: a dead
        replica raises on every dispatch at or after its death boundary)."""
        for f in self.faults:
            if (
                f.kind == "death"
                and f._matches_scope(scope)
                and chunk_index >= f.chunk_index
            ):
                key = ("death", f.service, f.chunk_index, scope)
                if key not in self._spent:
                    self._spent.add(key)
                    self._log(f, scope=scope, chunk_index=chunk_index)
                return True
        return False

    def take_corrupt_shadow(self, scope: str | None) -> bool:
        for f in self.faults:
            key = ("corrupt_shadow", f.service, scope)
            if (
                f.kind == "corrupt_shadow"
                and f._matches_scope(scope)
                and key not in self._spent
            ):
                self._spent.add(key)
                self._log(f, scope=scope)
                return True
        return False

    def take_flip_failure(self, scope: str | None) -> bool:
        for f in self.faults:
            key = ("flip_failure", f.service)
            if (
                f.kind == "flip_failure"
                and f._matches_scope(scope)
                and key not in self._spent
            ):
                self._spent.add(key)
                self._log(f, scope=scope)
                return True
        return False


_ACTIVE: ServingFaultPlan | None = None


def install_serving_fault_plan(plan: ServingFaultPlan) -> ServingFaultPlan:
    global _ACTIVE
    _ACTIVE = plan
    return plan


def clear_serving_fault_plan() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_serving_fault_plan() -> ServingFaultPlan | None:
    return _ACTIVE


@contextmanager
def serving_fault_plan(plan: ServingFaultPlan) -> Iterator[ServingFaultPlan]:
    install_serving_fault_plan(plan)
    try:
        yield plan
    finally:
        clear_serving_fault_plan()


# ------------------------------------------------------------ engine hooks
def poison_slots(scope: str | None, chunk_index: int) -> list[int]:
    """Slots whose row content the engine must poison before this chunk's
    dispatch (their next forward then produces non-finite logits/values —
    the on-device injection point for the decode health sentinel)."""
    plan = _ACTIVE
    if plan is None:
        return []
    return plan.poison_slots(scope, chunk_index)


def maybe_hang(scope: str | None, chunk_index: int) -> None:
    """Stalls the dispatch (the hung-dispatch scenario the fleet watchdog's
    bounded boundary-readback timeout must catch)."""
    plan = _ACTIVE
    if plan is None:
        return
    seconds = plan.hang_seconds(scope, chunk_index)
    if seconds > 0:
        time.sleep(seconds)


def maybe_die(scope: str | None, chunk_index: int) -> None:
    """Raises `ReplicaDeadError` when a death fault covers this dispatch."""
    plan = _ACTIVE
    if plan is None:
        return
    if plan.is_dead(scope, chunk_index):
        from ..serving.errors import ReplicaDeadError

        raise ReplicaDeadError(
            f"injected replica death (scope={scope!r}, chunk={chunk_index})"
        )


# --------------------------------------------------------- promotion hooks
def corrupt_params_tree(params: Any) -> Any:
    """A copy of ``params`` (a ``state_dict``: names to tensors or numpy
    arrays) with NaN in the first element of its first floating-point entry,
    a torn or garbled checkpoint staged for promotion; ``params`` itself is
    untouched. The first such entry in the dict's order is the port's module
    order, not JAX's (flax flattens its tree in sorted key order), so the
    two packages poison different tensors of one checkpoint. Also a test
    utility."""
    poisoned = type(params)(params)
    for name, leaf in params.items():
        if torch.is_tensor(leaf) and torch.is_floating_point(leaf):
            bad = leaf.detach().clone(memory_format=torch.contiguous_format)
        elif not torch.is_tensor(leaf) and np.issubdtype(np.asarray(leaf).dtype, np.floating):
            bad = np.array(leaf, copy=True)
        else:
            continue
        bad.reshape(-1)[0] = float("nan")
        poisoned[name] = bad
        break
    return poisoned


def maybe_corrupt_shadow(scope: str | None, params: Any) -> Any:
    """The (possibly corrupted) checkpoint to stage: the injection point
    `GenerationEngine.load_shadow` passes every staged ``state_dict``
    through; `ServingFleet.promote`'s verification probe must catch the
    corruption before any flip."""
    plan = _ACTIVE
    if plan is None:
        return params
    if plan.take_corrupt_shadow(scope):
        return corrupt_params_tree(params)
    return params


def maybe_fail_flip(scope: str | None) -> None:
    """Raises `PromotionError` when a flip-failure fault covers ``scope`` —
    the mid-fleet flip failure the promotion rollback path must survive."""
    plan = _ACTIVE
    if plan is None:
        return
    if plan.take_flip_failure(scope):
        from ..serving.errors import PromotionError

        raise PromotionError(f"injected flip failure (scope={scope!r})")
