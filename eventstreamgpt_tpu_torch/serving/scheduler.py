"""Host-side scheduling for the continuous-batching generation engine.

Counterpart: ``eventstreamgpt_tpu/serving/scheduler.py``: a bounded FIFO
queue with monotonically assigned admission indices (the engine derives
each request's random stream from its index), power-of-two prompt buckets,
admission groups of power-of-two sizes, fork groups (a paged engine's
branched rollouts, `ForkSpec`) taken as atomic units, and the
padding/backpressure/fork accounting of ``padding_report`` (with a paged
engine's block-pool counters merged in) and the speculative-decoding totals
(`Scheduler.note_spec_harvest`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional

import numpy as np
import torch

from ..data.types import EventStreamBatch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def check_prompt_finite(prompt: EventStreamBatch) -> Optional[str]:
    """First malformed-value reason in a prompt, or ``None`` if clean.

    Checks the floats a prefill consumes: ``time_delta`` on real events,
    ``dynamic_values`` under the observed mask, and ``start_time``.
    """
    em = _np(prompt.event_mask).astype(bool)
    if not np.isfinite(_np(prompt.time_delta)[em]).all():
        return "non-finite time_delta on a real event"
    if prompt.dynamic_values is not None and prompt.dynamic_values_mask is not None:
        m = _np(prompt.dynamic_values_mask).astype(bool)
        if not np.isfinite(_np(prompt.dynamic_values)[m]).all():
            return "non-finite observed dynamic_values"
    if prompt.start_time is not None and not np.isfinite(_np(prompt.start_time)).all():
        return "non-finite start_time"
    return None


class AdmissionRejected(RuntimeError):
    """The bounded admission queue is full; the request was NOT enqueued."""


@dataclasses.dataclass
class ForkSpec:
    """What every request of one `fork()` group shares (JAX's `ForkSpec`).

    A fork group is ``n_branches`` requests over ONE prompt: the paged
    engine prefills the prompt once, lands it in refcounted blocks and
    admits every branch copy-on-write, all at one chunk boundary in one
    admission group. Branch ``j`` draws from ``derive_request_seed(session,
    j)``; the session seed is ``session_key`` (an int) or, when that is
    ``None``, ``derive_request_seed(engine seed, session_admission_index)``.
    """

    group_id: int
    n_branches: int
    session_key: Optional[int] = None
    # Branch 0's admission index, bound at submit.
    session_admission_index: int = -1


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is a one-row `EventStreamBatch` ``(1, Lp, M)``. ``key``
    (an int) overrides the request's seed, which otherwise derives from the
    engine seed and the admission index (or, for a fork branch, from its
    group's session and its ``branch_index``).
    """

    prompt: EventStreamBatch
    max_new_events: int
    key: Optional[int] = None
    request_id: Any = None
    arrival_time: float = 0.0
    # A fork branch's group and index in it (None / -1 for other requests).
    fork: Optional[ForkSpec] = None
    branch_index: int = -1
    admission_index: int = -1
    # Times this request was requeued after a slot quarantine (the engine's
    # ``health_retries`` budget); the retry keeps its seed.
    health_retries: int = 0
    prompt_validated: bool = dataclasses.field(default=False, repr=False)

    @property
    def prompt_len(self) -> int:
        return self.prompt.sequence_length


@dataclasses.dataclass
class EngineResult:
    """A finished request: the completed row plus per-request accounting."""

    request_id: Any
    admission_index: int
    batch: Optional[EventStreamBatch]  # one-row CPU batch trimmed to ``n_events``
    prompt_len: int
    n_events: int  # prompt + written events (the row's final cursor)
    n_generated: int  # REAL generated events
    completion_time: float = 0.0
    # Speculative decoding: this request's draft proposals and how many of its
    # committed events came from them (zero on other engines).
    spec_proposed: int = 0
    spec_accepted: int = 0
    error: Any = None

    @property
    def ok(self) -> bool:
        return self.error is None


def pow2_ceil(n: int) -> int:
    """The smallest power of two >= n (n >= 1)."""
    return 1 << (int(n) - 1).bit_length()


def make_buckets(min_bucket: int, max_prompt_len: int) -> tuple[int, ...]:
    """The power-of-two bucket ladder covering ``[1, max_prompt_len]``.

    Examples:
        >>> make_buckets(4, 24)
        (4, 8, 16, 24)
        >>> make_buckets(32, 192)
        (32, 64, 128, 192)
    """
    buckets = []
    b = pow2_ceil(min_bucket)
    while b < max_prompt_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_prompt_len)
    return tuple(buckets)


@dataclasses.dataclass
class AdmissionGroup:
    """One prefill dispatch: same-bucket requests onto specific slots;
    ``fork`` marks one fork group's branches (one shared prefill)."""

    bucket_len: int
    group_size: int  # the prefill program's row count (>= len(requests))
    requests: list
    slots: list
    fork: Optional[ForkSpec] = None


class Scheduler:
    """FIFO admission policy + bucket/waste accounting for the engine."""

    def __init__(
        self,
        n_slots: int,
        buckets: Iterable[int],
        group_sizes: Optional[Iterable[int]] = None,
        max_pending: Optional[int] = None,
    ):
        self.n_slots = n_slots
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if group_sizes is None:  # the power-of-two ladder up to n_slots
            gs, g = [], 1
            while g < n_slots:
                gs.append(g)
                g *= 2
            gs.append(n_slots)
            group_sizes = gs
        self.group_sizes = tuple(sorted(set(int(g) for g in group_sizes)))
        self.max_pending = None if max_pending is None else int(max_pending)
        self.queue: list[Request] = []
        self._next_admission = 0
        self._prompt_events = 0
        self._padded_events = 0
        self._rejected = 0
        self._max_depth = 0
        self._prefill_deferrals = 0
        self._malformed_rejected = 0
        self._prefill_dispatches = 0
        self._prefill_rows = 0
        self._health_requeued = 0
        self._fork_groups = 0
        self._fork_branches = 0
        self._fork_deferrals = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_committed = 0
        # A paged engine installs its block-pool counters here (a callable
        # returning a dict), merged into `padding_report`.
        self.block_pool_stats = None

    def submit(self, request: Request) -> Request:
        if request.prompt_len > max(self.buckets):
            raise ValueError(
                f"Prompt of {request.prompt_len} events exceeds the largest bucket "
                f"({max(self.buckets)}); raise the engine's max_prompt_len."
            )
        if self.max_pending is not None and len(self.queue) >= self.max_pending:
            self._rejected += 1
            raise AdmissionRejected(
                f"admission queue full ({len(self.queue)}/{self.max_pending}); rejecting the new request"
            )
        request.admission_index = self._next_admission
        self._next_admission += 1
        if request.fork is not None and request.branch_index == 0:
            request.fork.session_admission_index = request.admission_index
        self.queue.append(request)
        self._max_depth = max(self._max_depth, len(self.queue))
        return request

    def note_malformed_reject(self) -> None:
        self._malformed_rejected += 1
        self._rejected += 1

    def requeue_front(self, request: Request) -> None:
        """Puts a health-quarantined request back at the FRONT of the queue
        for its retry, with its admission index (and the seed the caller
        fixed); ``max_pending`` does not apply, since it was admitted once."""
        self.queue.insert(0, request)
        self._health_requeued += 1
        self._max_depth = max(self._max_depth, len(self.queue))

    @property
    def pending(self) -> int:
        return len(self.queue)

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(f"No bucket holds a {prompt_len}-event prompt (buckets={self.buckets})")

    def group_size_for(self, n: int) -> int:
        for g in self.group_sizes:
            if g >= n:
                return g
        return max(self.group_sizes)

    def take_group(self, items: list) -> tuple[list, list]:
        """The largest group size that is full, else the smallest that fits the rest."""
        fit = [g for g in self.group_sizes if g <= len(items)]
        g = max(fit) if fit else self.group_size_for(len(items))
        return items[:g], items[g:]

    def plan_admissions(
        self, free_slots: list[int], now: float | None = None, max_padded_events: Optional[int] = None
    ) -> list[AdmissionGroup]:
        """Plans this boundary's prefill groups and dequeues them (strict FIFO;
        ``max_padded_events`` caps the bucket-padded prefill work, always
        taking at least one eligible unit). The queue is walked in units: one
        request, or one fork group's consecutive branches, which are taken
        whole or, when they do not fit the free slots, deferred whole with
        everything behind them; a fork group costs its bucket once and is an
        admission group of its own."""
        n_take = len(free_slots)
        if n_take == 0:
            return []
        units: list[list[Request]] = []
        i = 0
        while i < len(self.queue):
            run = [self.queue[i]]
            if run[0].fork is not None:
                while i + len(run) < len(self.queue) and self.queue[i + len(run)].fork is run[0].fork:
                    run.append(self.queue[i + len(run)])
            units.append(run)
            i += len(run)
        eligible, rest = [], []
        taken = 0
        budget_left = max_padded_events
        exhausted = False
        for unit in units:
            arrived = now is None or all(r.arrival_time <= now for r in unit)
            fits = taken + len(unit) <= n_take
            if not fits and len(unit) > 1 and arrived and not exhausted:
                exhausted = True
                self._fork_deferrals += 1
                rest.extend(unit)
                continue
            if fits and arrived and not exhausted:
                if budget_left is not None:
                    cost = self.bucket_for(unit[0].prompt_len)
                    if eligible and cost > budget_left:
                        exhausted = True
                        self._prefill_deferrals += 1
                        rest.extend(unit)
                        continue
                    budget_left -= cost
                eligible.append(unit)
                taken += len(unit)
            else:
                rest.extend(unit)
        if not eligible:
            return []
        self.queue = rest
        groups, slot_iter = [], iter(free_slots)
        by_bucket: dict[int, list[Request]] = {}
        for unit in eligible:
            bucket_len = self.bucket_for(unit[0].prompt_len)
            if unit[0].fork is None:
                by_bucket.setdefault(bucket_len, []).append(unit[0])
                continue
            groups.append(
                AdmissionGroup(
                    bucket_len=bucket_len,
                    group_size=self.group_size_for(len(unit)),
                    requests=unit,
                    slots=[next(slot_iter) for _ in unit],
                    fork=unit[0].fork,
                )
            )
            self._fork_groups += 1
            self._fork_branches += len(unit)
            self._prefill_dispatches += 1
            self._prefill_rows += 1  # one shared prompt
            self._prompt_events += unit[0].prompt_len
            self._padded_events += bucket_len
        for bucket_len in sorted(by_bucket):
            reqs = by_bucket[bucket_len]
            while reqs:
                take, reqs = self.take_group(reqs)
                groups.append(
                    AdmissionGroup(
                        bucket_len=bucket_len,
                        group_size=self.group_size_for(len(take)),
                        requests=take,
                        slots=[next(slot_iter) for _ in take],
                    )
                )
                self._prefill_dispatches += 1
                self._prefill_rows += len(take)
                for r in take:
                    self._prompt_events += r.prompt_len
                    self._padded_events += bucket_len
        return groups

    def note_spec_harvest(self, *, proposed: int, accepted: int, committed: int) -> None:
        """Accumulates one finished request's speculative-decoding totals (the
        engine calls this at harvest; the counters ride the boundary copy)."""
        self._spec_proposed += int(proposed)
        self._spec_accepted += int(accepted)
        self._spec_committed += int(committed)

    def padding_report(self) -> dict:
        padded = max(self._padded_events, 1)
        report = {
            "prompt_events": self._prompt_events,
            "padded_events": self._padded_events,
            "padding_waste_frac": round(1.0 - self._prompt_events / padded, 4),
            "buckets": list(self.buckets),
            "queue_depth": len(self.queue),
            "max_queue_depth": self._max_depth,
            "rejected_total": self._rejected,
            "malformed_rejected_total": self._malformed_rejected,
            "health_requeued_total": self._health_requeued,
            "prefill_deferrals": self._prefill_deferrals,
            "spec_proposed_events": self._spec_proposed,
            "spec_accepted_events": self._spec_accepted,
            "spec_committed_events": self._spec_committed,
            "spec_acceptance_rate": round(self._spec_accepted / max(self._spec_proposed, 1), 4),
            "prefill_dispatches": self._prefill_dispatches,
            "prefill_rows_computed": self._prefill_rows,
            "fork_groups_admitted": self._fork_groups,
            "fork_branches_admitted": self._fork_branches,
            "fork_deferrals": self._fork_deferrals,
        }
        if self.block_pool_stats is not None:
            report.update(self.block_pool_stats())
        return report
