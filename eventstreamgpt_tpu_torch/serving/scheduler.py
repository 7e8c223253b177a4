"""Host-side scheduling for the continuous-batching generation engine.

Counterpart: ``eventstreamgpt_tpu/serving/scheduler.py``: a bounded FIFO
queue with monotonically assigned admission indices (the engine derives
each request's random stream from its index), power-of-two prompt buckets,
admission groups of power-of-two sizes, and the padding/backpressure
accounting of ``padding_report``. Fork groups (paged-cache branched
rollouts) and speculative-decoding accounting are not ported yet.
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
class Request:
    """One generation request.

    ``prompt`` is a one-row `EventStreamBatch` ``(1, Lp, M)``. ``key``
    (an int) overrides the request's seed, which otherwise derives from the
    engine seed and the admission index.
    """

    prompt: EventStreamBatch
    max_new_events: int
    key: Optional[int] = None
    request_id: Any = None
    arrival_time: float = 0.0
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
    """One prefill dispatch: same-bucket requests onto specific slots."""

    bucket_len: int
    group_size: int  # the prefill program's row count (>= len(requests))
    requests: list
    slots: list


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
        taking at least one eligible request)."""
        n_take = len(free_slots)
        if n_take == 0:
            return []
        eligible, rest = [], []
        budget_left = max_padded_events
        exhausted = False
        for r in self.queue:
            arrived = now is None or r.arrival_time <= now
            if len(eligible) < n_take and arrived and not exhausted:
                if budget_left is not None:
                    cost = self.bucket_for(r.prompt_len)
                    if eligible and cost > budget_left:
                        exhausted = True
                        self._prefill_deferrals += 1
                        rest.append(r)
                        continue
                    budget_left -= cost
                eligible.append(r)
            else:
                rest.append(r)
        if not eligible:
            return []
        self.queue = rest
        by_bucket: dict[int, list[Request]] = {}
        for r in eligible:
            by_bucket.setdefault(self.bucket_for(r.prompt_len), []).append(r)
        groups, slot_iter = [], iter(free_slots)
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

    def padding_report(self) -> dict:
        padded = max(self._padded_events, 1)
        return {
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
            "prefill_dispatches": self._prefill_dispatches,
            "prefill_rows_computed": self._prefill_rows,
        }
