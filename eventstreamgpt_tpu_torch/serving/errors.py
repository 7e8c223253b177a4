"""Typed serving errors (counterpart: ``eventstreamgpt_tpu/serving/errors.py``,
and `BlockLedgerError` of ``eventstreamgpt_tpu/serving/sanitizer.py``).

An accepted request either completes or fails with a typed error on its
result; a malformed prompt is rejected at the door before it is admitted.
"""

from __future__ import annotations

from .scheduler import AdmissionRejected

__all__ = [
    "BlockLedgerError",
    "DeadlineExceeded",
    "MalformedPromptRejected",
    "PromotionError",
    "ReplicaDeadError",
    "ReplicaHungError",
    "ServingError",
    "SlotHealthError",
]


class ServingError(RuntimeError):
    """Base class for post-acceptance serving faults."""


class SlotHealthError(ServingError):
    """Non-finite logits/values were detected in a decode slot on the device.

    The slot was quarantined the step it went bad; co-resident slots are
    untouched (no decode op mixes rows).
    """

    def __init__(self, message: str, *, request_id=None, admission_index=None, slot=None, chunk_index=None):
        super().__init__(message)
        self.request_id = request_id
        self.admission_index = admission_index
        self.slot = slot
        self.chunk_index = chunk_index


class DeadlineExceeded(ServingError):
    """A queued request's per-lane deadline expired before placement.

    Deadlines cancel queued requests only: a placed request runs to
    completion. The expired request's admission index is never reused, so
    the other requests' seeds do not move.
    """

    def __init__(self, message: str, *, lane=None, deadline_s=None, waited_s=None):
        super().__init__(message)
        self.lane = lane
        self.deadline_s = deadline_s
        self.waited_s = waited_s


class ReplicaDeadError(ServingError):
    """A replica's dispatch path died (device lost, injected death fault).

    Raised from the engine's dispatch hooks; the fleet's health monitor
    converts it into an eviction (`ServingFleet`) and replays the dead
    service's in-flight sessions on survivors from their bound seeds.
    """


class ReplicaHungError(ServingError):
    """A replica exceeded the bounded boundary-readback timeout (hung
    dispatch watchdog). Like `ReplicaDeadError`, handled by eviction."""


class PromotionError(ServingError):
    """A fleet checkpoint promotion failed and was rolled back.

    Either the shadow verification gate (finite-output probe on the staged
    weights) rejected the checkpoint before any flip, or a flip failed
    mid-fleet — in both cases the fleet rolls back onto the live weights
    via the hot-swap double buffer (`drop_shadow`, flipping back any
    already-flipped services) and keeps serving; no accepted request is
    dropped (`swap_report`).
    """


class MalformedPromptRejected(AdmissionRejected):
    """The prompt carried non-finite observed values or times and was
    rejected at submission, before any admission index was bound."""


class BlockLedgerError(RuntimeError):
    """A block-pool ledger violation (a double free, a free of the zero
    block), raised by the paged engine's block allocator itself, so that a
    corrupted free list never serves another admission."""
