"""Fault tolerance (counterpart: ``eventstreamgpt_tpu/reliability``), the
serving side so far:

* `preemption`: SIGTERM/SIGINT as a pollable drain flag, `Preempted` and the
  distinct exit code orchestrators treat as "reschedule me".
* `serving_faults`: the deterministic serving fault plan (slot NaN
  injection, replica hang and death, corrupt shadow checkpoints, flip
  failures), keyed on chunk indices and service ids, so that slot
  quarantine, the fleet's eviction and replay, and promotion rollback run
  the same way on every run.

The training side (``faults``, ``integrity``, ``sentinel``) is not ported
yet (``ROADMAP.md`` Queue 1, items 7 and 8).
"""

from .preemption import EXIT_PREEMPTED, GracefulShutdown, Preempted
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
    "GracefulShutdown",
    "Preempted",
    "ServingFault",
    "ServingFaultPlan",
    "active_serving_fault_plan",
    "clear_serving_fault_plan",
    "install_serving_fault_plan",
    "serving_fault_plan",
]
