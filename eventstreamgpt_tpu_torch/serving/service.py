"""The online serving service: SLO lanes and budget-aware placement over engine replicas.

Counterpart: ``eventstreamgpt_tpu/serving/service.py`` (``ServiceResult``,
``latency_quantiles``, ``ServingService``), with an integer ``seed`` where
JAX takes a ``base_key``.

* **Lanes** (`serving.slo`): every request enters through a latency-class
  lane; a full lane rejects the new request (counted in `stats`).
* **Replicas**: N `GenerationEngine`s (on one card, each with its own
  programs, all on the current CUDA stream) drain the lanes. Placement is budget-aware: each pick goes to
  the replica with the least outstanding decode work (the ``max_new_events``
  of its resident and queued requests), ties to the lowest index.
* **Pipelined dispatch**: each replica runs the engine's
  ``issue_chunk`` / ``resolve_chunk`` hooks, so host placement overlaps the
  device's decode.
* **Prefill**: either each replica prefills locally under a per-boundary
  budget of bucket-padded events (``prefill_budget_events``), or a
  dedicated `serving.fleet.PrefillStream` prefills on its own engine and
  hands the slot state to the replica that the pick reserved a slot on.

Determinism: accepted request ``i`` runs with
``derive_request_seed(seed, i)``, bound into ``Request.key`` at accept time,
as a single engine with that ``seed`` derives it, so a request's seed does
not depend on its replica, slot, lane or prefill path. Its floats are bit for
bit the same only where the programs' shapes are the same (a product's bits
can change with the engine's slot count and the group width a prompt's
prefill runs at), and a bf16 model's events follow its floats.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence, Union

from ..data.types import EventStreamBatch
from ..generation.sampling import derive_request_seed
from ..reliability.preemption import Preempted
from .engine import GenerationEngine
from .errors import DeadlineExceeded, MalformedPromptRejected
from .fleet import _params_mismatch
from .scheduler import EngineResult, Request, check_prompt_finite
from .slo import DEFAULT_LANES, INTERACTIVE, LaneConfig, LaneQueues


@dataclasses.dataclass
class ServiceResult:
    """A finished service request: the engine result plus its routing, on
    the service's arrival-to-completion clock."""

    request_id: Any  # the caller's id (the service keys by admission index)
    lane: str
    replica: int  # -1 when the request never reached a replica (expiry)
    admission_index: int  # the service-wide accept index (the seed's)
    batch: Optional[EventStreamBatch]
    prompt_len: int
    n_events: int
    n_generated: int
    arrival_time: float
    completion_time: float
    error: Any = None  # a typed fault (`serving.errors`), or None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def latency(self) -> float:
        return self.completion_time - self.arrival_time


def latency_quantiles(results: Sequence[ServiceResult]) -> dict:
    """p50 and p95 latency in ms, a lane and overall."""
    out: dict = {}
    by_lane: dict[str, list[float]] = {}
    for r in results:
        by_lane.setdefault(r.lane, []).append(1000.0 * r.latency)
    for lane, xs in list(by_lane.items()) + [("overall", [1000.0 * r.latency for r in results])]:
        xs = sorted(xs)
        if not xs:
            continue
        out[lane] = {"p50_ms": xs[len(xs) // 2], "p95_ms": xs[min(int(len(xs) * 0.95), len(xs) - 1)]}
    return out


class ServingService:
    """SLO-aware serving over one or more engine replicas.

    Args:
        replicas: `GenerationEngine`s, idle, sharing ``max_len`` and the
            speculative configuration (and draft weights), none with an
            engine-level ``max_queue`` (the lanes own backpressure).
        lanes: the `LaneConfig`s; default ``interactive`` and ``batch``.
        seed: accepted request ``i`` without a ``key`` runs with
            ``derive_request_seed(seed, i)``: a single engine built with
            this ``seed`` serving the same requests in the same order gives
            the same events.
        prefill_budget_events: each replica's cap on bucket-padded prefill
            events a boundary (``None``: no cap).
        prefill_stream: a `serving.fleet.PrefillStream`, the dedicated
            prefill tier (exclusive with ``prefill_budget_events``).
        default_lane: the lane of requests submitted without one.
    """

    def __init__(
        self,
        replicas: Sequence[GenerationEngine],
        *,
        lanes: Sequence[LaneConfig] = DEFAULT_LANES,
        seed: int = 0,
        prefill_budget_events: Optional[int] = None,
        prefill_stream: Optional[Any] = None,
        default_lane: str = INTERACTIVE,
    ):
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("at least one engine replica is required")
        if len({id(e) for e in self.replicas}) != len(self.replicas):
            raise ValueError("replicas must be distinct engine instances")
        max_lens = {e.max_len for e in self.replicas}
        if len(max_lens) != 1:
            raise ValueError(
                f"replicas must share max_len (attention-width parity; the determinism contract) — got "
                f"{sorted(max_lens)}"
            )
        if len({e.spec_signature() for e in self.replicas}) != 1:
            raise ValueError(
                "replicas must share the speculative-decoding configuration (all spec with the same "
                "draft/K/tolerances/greedy, or none): committed results are draft-dependent, so a mixed set would "
                "make results depend on placement"
            )
        if self.replicas[0].spec is not None:
            for i, e in enumerate(self.replicas[1:], start=1):
                mismatch = _params_mismatch(self.replicas[0].draft_params, e.draft_params)
                if mismatch is not None:
                    raise ValueError(
                        f"replica {i}'s draft weights differ from replica 0's ({mismatch}) — committed results are "
                        "draft-dependent, so mixed drafts would make results depend on placement"
                    )
        for i, e in enumerate(self.replicas):
            if e.occupied or e.scheduler.pending or e.inflight_chunks:
                raise ValueError(f"replica {i} is not idle")
            if e.scheduler.max_pending is not None:
                raise ValueError(
                    f"replica {i} has an engine-level max_queue; the service's lanes own backpressure — construct "
                    "replicas without it"
                )
        self.max_len = self.replicas[0].max_len
        self.lanes = LaneQueues(lanes)
        if default_lane not in self.lanes.configs:
            raise ValueError(f"default_lane {default_lane!r} is not a configured lane")
        self.default_lane = default_lane
        if prefill_stream is not None and prefill_budget_events is not None:
            raise ValueError("a dedicated prefill stream replaces the budget-capped interleave; drop prefill_budget_events")
        self.prefill_budget_events = prefill_budget_events
        self.prefill_stream = prefill_stream
        if prefill_stream is not None:
            prefill_stream.attach(self.replicas)
        self.seed = int(seed)
        self._next_index = 0
        # admission index -> routing (lane, caller id, arrival, budget, replica once placed).
        self._meta: dict[int, dict] = {}
        # Outstanding decode work a replica (resident and queued budgets): the placement key.
        self._outstanding = [0] * len(self.replicas)
        self._last_step_progressed = False

    # ------------------------------------------------------------ admission
    def submit(self, request: Request, lane: Optional[str] = None, force: bool = False) -> bool:
        """Offers a request to a lane. True: accepted (an admission index and
        seed are bound); False: rejected by the lane's bound (counted; no
        index bound, so the accepted set's results are unchanged).
        ``force=True`` bypasses the lane's bound: the fleet's eviction replay
        and its release of held requests use it, since that work was
        accepted once already and bouncing it would drop it (the overshoot is
        bounded by the evicted service's in-flight count)."""
        lane = lane or self.default_lane
        if request.max_new_events < 1:
            raise ValueError("max_new_events must be >= 1")
        if request.prompt_len + request.max_new_events > self.max_len:
            raise ValueError(
                f"prompt ({request.prompt_len}) + budget ({request.max_new_events}) exceeds max_len ({self.max_len})"
            )
        if lane not in self.lanes.configs:
            raise KeyError(f"unknown lane {lane!r}")
        if self.replicas[0].validate_prompts and not request.prompt_validated:
            reason = check_prompt_finite(request.prompt)
            if reason is not None:
                self.lanes.rejected[lane] += 1
                raise MalformedPromptRejected(
                    f"request {request.request_id!r}: {reason} — rejected at the service door (no admission index "
                    "bound)"
                )
        cfg = self.lanes.configs[lane]
        if not force and cfg.max_pending is not None and self.lanes.depth(lane) >= cfg.max_pending:
            self.lanes.offer(request, lane)  # counts the reject, does not enqueue
            return False
        index = self._next_index
        self._next_index += 1
        internal = dataclasses.replace(request, request_id=index, prompt_validated=True)
        if internal.key is None:
            internal.key = derive_request_seed(self.seed, index)
        accepted = self.lanes.offer(internal, lane, force=force)
        assert accepted  # the bound was checked above (or force bypassed it)
        self._meta[index] = {"lane": lane, "request_id": request.request_id, "arrival": request.arrival_time,
                             "budget": request.max_new_events, "replica": None}  # fmt: skip
        return True

    def fork(
        self,
        prompt: EventStreamBatch,
        n_branches: int,
        max_new_events: int,
        *,
        lane: Optional[str] = None,
        key: Optional[int] = None,
        request_id=None,
        request_ids=None,
        arrival_time: float = 0.0,
    ) -> list[int]:
        """Accepts one prompt as ``n_branches`` copy-on-write branches (paged
        replicas only, `GenerationEngine.fork`) placed whole on ONE replica,
        the least loaded. The session seed is ``key`` or
        ``derive_request_seed(seed, i)`` for one freshly consumed admission
        index ``i``; branch ``j`` draws from ``derive_request_seed(session,
        j)``, as ``n_branches`` submissions of the prompt with those keys
        would. Results carry ``(request_id, j)``, or ``request_ids[j]`` (the
        fleet passes its own indices). Returns the branches' admission
        indices."""
        if not all(e.paged_kv for e in self.replicas):
            raise ValueError(
                "fork() needs every replica on the paged KV cache (paged_kv=True): branches share prefix blocks "
                "copy-on-write"
            )
        if self.prefill_stream is not None:
            raise NotImplementedError(
                "fork() does not serve behind a dedicated prefill stream (paged engines prefill locally — see "
                "GenerationEngine.prefill_compute)"
            )
        lane = lane or self.default_lane
        if lane not in self.lanes.configs:
            raise KeyError(f"unknown lane {lane!r}")
        n_branches = int(n_branches)
        if n_branches < 1:
            raise ValueError("n_branches must be >= 1")
        if request_ids is not None and len(request_ids) != n_branches:
            raise ValueError(f"request_ids has {len(request_ids)} entries for {n_branches} branches")
        if max_new_events < 1:
            raise ValueError("max_new_events must be >= 1")
        prompt_len = int(prompt.sequence_length)
        if prompt_len + max_new_events > self.max_len:
            raise ValueError(f"prompt ({prompt_len}) + budget ({max_new_events}) exceeds max_len ({self.max_len})")
        if self.replicas[0].validate_prompts:
            reason = check_prompt_finite(prompt)
            if reason is not None:
                self.lanes.rejected[lane] += 1
                raise MalformedPromptRejected(
                    f"fork request {request_id!r}: {reason} — rejected at the service door (no admission index bound)"
                )
        if key is None:
            key = derive_request_seed(self.seed, self._next_index)
            self._next_index += 1
        ri = min(range(len(self.replicas)), key=lambda i: (self._outstanding[i], i))
        indices = []
        for j in range(n_branches):
            index = self._next_index
            self._next_index += 1
            if request_ids is not None:
                rid = request_ids[j]
            else:
                rid = None if request_id is None else (request_id, j)
            self._meta[index] = {"lane": lane, "request_id": rid, "arrival": arrival_time, "budget": max_new_events,
                                 "replica": ri}  # fmt: skip
            indices.append(index)
        self._outstanding[ri] += n_branches * max_new_events
        self.replicas[ri].fork(prompt, n_branches, max_new_events, key=int(key), request_ids=indices,
                               arrival_time=arrival_time)  # fmt: skip
        return indices

    # ------------------------------------------------------------ placement
    def _place(self) -> None:
        """Budget-aware placement of lane picks onto the replicas. A
        replica's capacity is its free slots less its queued backlog; each
        pick goes to the replica with the least outstanding decode budget
        (ties: lowest index). With a prefill stream a pick also reserves one
        free slot of its replica and enqueues on the stream instead of the
        replica's own queue."""
        stream = self.prefill_stream
        if stream is None:
            capacity = [max(len(e.free_slots()) - e.scheduler.pending, 0) for e in self.replicas]
        else:
            free = [[s for s in e.free_slots() if s not in stream.reserved_slots(ri)]
                    for ri, e in enumerate(self.replicas)]  # fmt: skip
            free_iters = [iter(f) for f in free]
            capacity = [len(f) for f in free]
        for lane, req in self.lanes.pick(sum(capacity)):
            ri = min((i for i in range(len(self.replicas)) if capacity[i] > 0),
                     key=lambda i: (self._outstanding[i], i))  # fmt: skip
            self._meta[req.request_id]["replica"] = ri
            self._outstanding[ri] += req.max_new_events
            capacity[ri] -= 1
            if stream is None:
                self.replicas[ri].submit(req)
            else:
                stream.enqueue(req, ri, next(free_iters[ri]))

    def _wrap(self, er: EngineResult, ri: int) -> ServiceResult:
        meta = self._meta.pop(er.request_id)
        self._outstanding[ri] -= meta["budget"]
        return ServiceResult(request_id=meta["request_id"], lane=meta["lane"], replica=ri,
                             admission_index=er.request_id, batch=er.batch, prompt_len=er.prompt_len,
                             n_events=er.n_events, n_generated=er.n_generated, arrival_time=meta["arrival"],
                             completion_time=er.completion_time, error=er.error)  # fmt: skip

    def _expire(self, now: float) -> list[ServiceResult]:
        """Cancels lane-queued requests past their lane's ``deadline_s``, each
        completed with a typed `DeadlineExceeded`; placed requests are exempt
        and the cancelled indices are never reused."""
        out = []
        for lane, req in self.lanes.expire(now):
            meta = self._meta.pop(req.request_id)
            cfg = self.lanes.configs[lane]
            waited = now - meta["arrival"]
            error = DeadlineExceeded(
                f"request {meta['request_id']!r} expired after {waited:.3f}s queued in lane {lane!r} (deadline "
                f"{cfg.deadline_s}s)", lane=lane, deadline_s=cfg.deadline_s, waited_s=waited,
            )  # fmt: skip
            out.append(ServiceResult(request_id=meta["request_id"], lane=lane, replica=-1,
                                     admission_index=req.request_id, batch=None, prompt_len=req.prompt_len,
                                     n_events=0, n_generated=0, arrival_time=meta["arrival"], completion_time=now,
                                     error=error))  # fmt: skip
        return out

    # -------------------------------------------------------------- serving
    def run(
        self,
        requests: Sequence[Union[Request, tuple[Request, str]]] = (),
        *,
        use_arrival_times: bool = False,
        fetch_results: bool = True,
        shutdown: Optional[Any] = None,
    ) -> list[ServiceResult]:
        """Serves ``requests`` (each a `Request` or ``(Request, lane)``) to
        completion; results in admission order. Without
        ``use_arrival_times`` all are submitted first (lane bounds apply to
        the whole set); with it the sequence is a replay trace, each request
        offered to its lane when it arrives on the service's clock.
        Rejected requests are absent from the results (counted in `stats`).

        ``shutdown``, a `reliability.GracefulShutdown`: once it is requested
        (SIGTERM, SIGINT or `request()`), the loop admits nothing more (the
        trace's later arrivals are abandoned and lane backlogs stay
        unplaced), drains every resident slot (placed and reserved-prefill
        work completes), then raises `reliability.Preempted` with the
        completed results on ``results``; an entry-point script turns it into
        ``EXIT_PREEMPTED``."""
        trace = [r if isinstance(r, tuple) else (r, self.default_lane) for r in requests]
        if not use_arrival_times:
            for req, lane in trace:
                try:
                    self.submit(req, lane)
                except MalformedPromptRejected:
                    pass  # typed, counted at the door; the rest still serve
            trace = []
        results: list[ServiceResult] = []
        t0 = time.perf_counter()
        ptr = 0
        draining = False
        while True:
            draining = draining or (shutdown is not None and shutdown.requested)
            if not (self.resident_busy() if draining else ptr < len(trace) or self.busy()):
                break
            now = time.perf_counter() - t0
            while not draining and ptr < len(trace) and trace[ptr][0].arrival_time <= now:
                try:
                    self.submit(*trace[ptr])
                except MalformedPromptRejected:
                    pass
                ptr += 1
            results.extend(self.step(lambda: time.perf_counter() - t0, fetch_results, place=not draining))
            if not self._last_step_progressed:
                time.sleep(1e-3)  # waiting on arrivals
        results = sorted(results, key=lambda r: r.admission_index)
        if draining:
            raise Preempted(
                f"serving preempted: drained {len(results)} completed results; {self.lanes.pending} queued and "
                f"{len(trace) - ptr} unarrived requests abandoned", results=results,
            )  # fmt: skip
        return results

    def resident_busy(self) -> bool:
        """Work placed on a replica or reserved on the prefill stream."""
        if self.prefill_stream is not None and self.prefill_stream.pending:
            return True
        return any(e.occupied or e.scheduler.pending or e.inflight_chunks for e in self.replicas)

    def pending(self) -> int:
        """Requests accepted and not yet returned (queued, reserved or resident)."""
        return len(self._meta)

    def busy(self) -> bool:
        """Work anywhere: lane backlogs, the prefill stream or any replica."""
        return self.lanes.pending > 0 or self.resident_busy()

    def step(self, clock, fetch_results: bool = True, place: bool = True) -> list[ServiceResult]:
        """One scheduling round: expire stale queued requests, place lane
        picks, pump the prefill stream, and issue or resolve each replica's
        pipelined chunks. ``clock()`` gives the service time that stamps
        completions. Returns the requests finished this round;
        ``_last_step_progressed`` says whether anything moved. The stream is
        pumped in every round, one with an expiry too (JAX's ``step`` skips
        the pump there, holding placed requests a round longer).
        ``place=False`` is the drain of a graceful preemption: no lane pick
        is placed, and placed or resident work (reserved prefill-stream
        entries too) runs on to completion."""
        results: list[ServiceResult] = list(self._expire(clock()))
        if place:
            self._place()
        progressed = bool(results)
        if self.prefill_stream is not None:
            progressed = self.prefill_stream.pump() > 0 or progressed
        for ri, eng in enumerate(self.replicas):
            if self.prefill_stream is None:
                eng.plan_and_dispatch(max_padded_events=self.prefill_budget_events)
            if eng.occupied:
                eng.issue_chunk()
                progressed = True
            if eng.inflight_chunks and (eng.inflight_chunks >= eng.dispatch_depth or not eng.occupied):
                for er in eng.resolve_chunk(clock(), fetch_results):
                    results.append(self._wrap(er, ri))
                progressed = True
        self._last_step_progressed = progressed
        return results

    # ------------------------------------------------------------ accounting
    def stats(self) -> dict:
        """The lanes' counters, each replica's engine stats and the placement state."""
        report = self.lanes.report()
        report.update({"n_replicas": len(self.replicas), "prefill_budget_events": self.prefill_budget_events,
                       "outstanding_budget": list(self._outstanding),
                       "replicas": [e.stats() for e in self.replicas]})  # fmt: skip
        if self.prefill_stream is not None:
            report["prefill_stream"] = self.prefill_stream.stats()
        return report
