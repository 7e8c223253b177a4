"""Fault tolerance (counterpart: ``eventstreamgpt_tpu/reliability``):

* `preemption`: SIGTERM/SIGINT as a pollable drain flag, `Preempted` and the
  distinct exit code orchestrators treat as "reschedule me".
* `serving_faults`: the deterministic serving fault plan (slot NaN
  injection, replica hang and death, corrupt shadow checkpoints, flip
  failures), keyed on chunk indices and service ids, so that slot
  quarantine, the fleet's eviction and replay, and promotion rollback run
  the same way on every run.
* `faults`: the deterministic training fault plan (poisoned batches, failed,
  torn and corrupted checkpoint saves, scripted preemption);
* `integrity`: checksum manifests, retried saves and walk-back restores of
  the resume checkpoints;
* `sentinel`: the divergence sentinel and the bounded rollback.
"""

from .faults import Fault, FaultPlan, corrupt_checkpoint_step, fault_plan
from .integrity import ReliableCheckpointManager
from .preemption import EXIT_PREEMPTED, GracefulShutdown, Preempted
from .sentinel import DivergenceError, SentinelConfig
from .serving_faults import (
    ServingFault,
    ServingFaultPlan,
    active_serving_fault_plan,
    clear_serving_fault_plan,
    install_serving_fault_plan,
    serving_fault_plan,
)

__all__ = [
    "EXIT_PREEMPTED",
    "DivergenceError",
    "Fault",
    "FaultPlan",
    "GracefulShutdown",
    "Preempted",
    "ReliableCheckpointManager",
    "SentinelConfig",
    "corrupt_checkpoint_step",
    "fault_plan",
    "ServingFault",
    "ServingFaultPlan",
    "active_serving_fault_plan",
    "clear_serving_fault_plan",
    "install_serving_fault_plan",
    "serving_fault_plan",
]
