"""SLO latency-class lanes and backpressure for the serving service.

Counterpart: ``eventstreamgpt_tpu/serving/slo.py``, host code copied as it
is. The service (`serving.service`) admits every request through a **lane**:
a bounded FIFO queue tagged with a latency class.

* **Lanes** (`LaneConfig`): name, drain priority, optional queue bound,
  optional ``min_share`` and ``deadline_s``. The default pair is
  ``interactive`` (drained first) and ``batch`` (drained from the leftover
  capacity, with a quarter of each round reserved).
* **Backpressure** (`LaneQueues.offer`): a full lane rejects the *new*
  request (counted per lane): admitted work is never evicted, so the
  admitted set's seeds, and every admitted result, are unchanged by
  rejections.
* **Anti-starvation** (``min_share``): a lane with queued work accrues
  ``k * min_share`` reservation credit every k-slot round, and each whole
  unit reserves one slot ahead of higher-priority traffic. The fractional
  credit carries across rounds, so at ``min_share=0.25`` and rounds of one
  slot the lane is served at least once every 4 rounds.
* **Determinism**: picks are a pure function of the queues and ``k``, and
  the service binds seeds at accept time, so lanes change scheduling and
  latency only, never a result.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Iterable, Optional

INTERACTIVE = "interactive"
BATCH = "batch"


@dataclasses.dataclass(frozen=True)
class LaneConfig:
    """One latency-class lane.

    Args:
        name: lane id; requests are submitted to a lane by name.
        priority: drain order — lower drains first (ties: declaration
            order).
        max_pending: bound on the lane's queue; ``None`` = unbounded.
            When full, `LaneQueues.offer` rejects the new request.
        min_share: fraction of every admission round reserved for this
            lane while it has queued work (anti-starvation floor for
            low-priority lanes). ``floor(k * min_share)`` slots; 0 means
            the lane only gets leftover capacity.
        deadline_s: per-lane queueing deadline. A request still QUEUED in
            this lane ``deadline_s`` seconds after its arrival time is
            cancelled with a typed `serving.errors.DeadlineExceeded` at the
            next scheduling round (`LaneQueues.expire`) instead of serving
            a stale answer. Deadlines never touch placed/resident requests
            and never reuse a cancelled request's admission index, so the
            surviving admitted set's seeds cannot drift. ``None`` (the
            default) disables expiry — existing behavior exactly.
    """

    name: str
    priority: int = 0
    max_pending: Optional[int] = None
    min_share: float = 0.0
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if not (0.0 <= self.min_share <= 1.0):
            raise ValueError(f"min_share must be in [0, 1], got {self.min_share}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {self.deadline_s}")


DEFAULT_LANES = (
    LaneConfig(INTERACTIVE, priority=0),
    LaneConfig(BATCH, priority=1, min_share=0.25),
)


class LaneQueues:
    """Bounded per-lane FIFO queues with a deterministic admission pick."""

    def __init__(self, lanes: Iterable[LaneConfig] = DEFAULT_LANES):
        lanes = tuple(lanes)
        if not lanes:
            raise ValueError("at least one lane is required")
        names = [l.name for l in lanes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate lane names: {names}")
        # Stable drain order: priority, then declaration order.
        ordered = sorted(enumerate(lanes), key=lambda il: (il[1].priority, il[0]))
        self.order = tuple(l.name for _, l in ordered)
        self.configs = {l.name: l for l in lanes}
        self._queues: dict[str, deque] = {l.name: deque() for l in lanes}
        self.accepted = {l.name: 0 for l in lanes}
        self.rejected = {l.name: 0 for l in lanes}
        self.expired = {l.name: 0 for l in lanes}
        self.max_depth = {l.name: 0 for l in lanes}
        # Fractional min_share reservation credit carried across rounds
        # (resets while the lane is empty — idle time banks nothing).
        self._share_credit = {l.name: 0.0 for l in lanes}

    def offer(self, item: Any, lane: str, force: bool = False) -> bool:
        """Enqueues ``item`` on ``lane``; False ⇒ rejected (lane full).
        ``force=True`` bypasses the bound (eviction replay of
        already-accepted work — see `ServingService.submit`)."""
        if lane not in self._queues:
            raise KeyError(f"unknown lane {lane!r} (have {list(self.order)})")
        cfg = self.configs[lane]
        q = self._queues[lane]
        if not force and cfg.max_pending is not None and len(q) >= cfg.max_pending:
            self.rejected[lane] += 1
            return False
        q.append(item)
        self.accepted[lane] += 1
        self.max_depth[lane] = max(self.max_depth[lane], len(q))
        return True

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depth(self, lane: str) -> int:
        return len(self._queues[lane])

    def expire(self, now: float) -> list[tuple[str, Any]]:
        """Removes and returns every queued item whose lane deadline has
        passed (``now - item.arrival_time > deadline_s``) — deadline
        enforcement, run by the service before each admission round.

        Only QUEUED work expires: placement binds device admission state,
        so a placed request always runs to completion. Expired items keep
        their already-bound admission indices (burned, never reused) —
        cancellation can therefore never drift a surviving request's
        seed. A deadline storm (every queued request expired at once) drains
        the lane with one typed rejection per request: zero silent drops.
        """
        out: list[tuple[str, Any]] = []
        for name in self.order:
            cfg = self.configs[name]
            if cfg.deadline_s is None:
                continue
            q = self._queues[name]
            keep: deque = deque()
            while q:
                item = q.popleft()
                waited = now - getattr(item, "arrival_time", 0.0)
                if waited > cfg.deadline_s:
                    self.expired[name] += 1
                    out.append((name, item))
                else:
                    keep.append(item)
            self._queues[name] = keep
        return out

    def pick(self, k: int) -> list[tuple[str, Any]]:
        """Dequeues up to ``k`` items: ``min_share`` reservations first
        (in drain order), then strict priority fill; FIFO within a lane.
        Reservations accrue as fractional credit across rounds (see the
        module docstring), so small rounds still honor the share. Emission
        order is drain order — the service places picks onto slots in this
        order, but placement never changes result content (seeds were
        assigned at accept)."""
        if k <= 0:
            return []
        counts = {name: 0 for name in self.order}
        remaining = k
        for name in self.order:
            cfg = self.configs[name]
            if cfg.min_share <= 0:
                continue
            if not self._queues[name]:
                self._share_credit[name] = 0.0
                continue
            self._share_credit[name] += k * cfg.min_share
            r = min(int(self._share_credit[name]), len(self._queues[name]), remaining)
            if r > 0:
                counts[name] += r
                remaining -= r
                self._share_credit[name] -= r
        for name in self.order:
            t = min(len(self._queues[name]) - counts[name], remaining)
            if t > 0:
                counts[name] += t
                remaining -= t
        picks: list[tuple[str, Any]] = []
        for name in self.order:
            q = self._queues[name]
            for _ in range(counts[name]):
                picks.append((name, q.popleft()))
        return picks

    def report(self) -> dict:
        """Per-lane accounting for `ServingService.stats`."""
        total_acc = sum(self.accepted.values())
        total_rej = sum(self.rejected.values())
        return {
            "lanes": {
                name: {
                    "queue_depth": len(self._queues[name]),
                    "max_queue_depth": self.max_depth[name],
                    "accepted": self.accepted[name],
                    "rejected": self.rejected[name],
                    "expired": self.expired[name],
                }
                for name in self.order
            },
            "accepted_total": total_acc,
            "rejected_total": total_rej,
            "expired_total": sum(self.expired.values()),
            "reject_frac": round(total_rej / max(total_acc + total_rej, 1), 4),
        }
