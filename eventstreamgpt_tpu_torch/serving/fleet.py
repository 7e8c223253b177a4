"""The serving fleet: a router tier over several `ServingService`s, with
the dedicated prefill stream and the weights check between engines.

Counterpart: ``eventstreamgpt_tpu/serving/fleet.py`` (``_params_mismatch``,
``PrefillStream``, ``FleetHealthConfig``, ``FleetResult``,
``ServingFleet``), with an integer ``seed`` where JAX takes a ``base_key``.
JAX's census hooks (``_census_programs``, ``_register_census``) are not
ported (``ROADMAP.md`` Queue 1, item 11).

* **Session-affinity routing** (`serving.router`): subject key to service
  through a consistent-hash ring, so a subject's requests land where its
  slot state lives; an eviction remaps only the evicted service's subjects.
* **Dedicated prefill stream** (`PrefillStream`): one prefill-only engine
  runs the bucketed prefill forwards (`GenerationEngine.prefill_compute`)
  and hands each group's slot state to its target decode engine
  (`GenerationEngine.admit_prefilled`), so the decode engines pay only the
  admission scatter. Every engine runs on the current CUDA stream: `pump`
  admits each handoff as soon as it is computed (JAX's order), before the
  decode engines issue their next chunks, so a stream of its own would give
  the prefill nothing to overlap.
* **Zero-downtime hot swap** (`ServingFleet.promote`): every engine holds a
  shadow copy of its weights (``hot_swap=True``); a promotion stages the
  new checkpoint in every shadow, probes each, then flips services one at a
  time: new routes to the flipping service are held at the fleet, its
  residents drain on the old weights, its drained engines flip in place
  (no capture, every weight at its address), and the held requests
  release. A failed probe or flip rolls the fleet back onto the old weights.
* **Replica health** (`FleetHealthConfig`): a dead, hung or sick service is
  evicted and its in-flight sessions replay on survivors from their bound
  seeds; `reliability.serving_faults` drives each path deterministically.

Determinism: accepted request ``i`` runs with ``derive_request_seed(seed,
i)``, bound at accept time before routing, as `ServingService` and a single
engine with that ``seed`` bind it. Where a request runs (which service,
replica or slot, which prefill path, before or after which swap, replayed
or not) does not change the seed it draws from. Its floats, and with them a
bf16 model's events, are bit for bit those of another run only where the
programs' shapes are the same (the engine's slot count, the prefill group's
width; `serving.service`): a service's requests equal that service alone
serving them, and an fp32 fleet equals one engine in events.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import TYPE_CHECKING, Any, Mapping, Optional, Sequence, Union

from ..data.types import EventStreamBatch
from ..generation.sampling import derive_request_seed
from ..reliability import serving_faults as _sfaults
from ..reliability.preemption import Preempted
from .engine import GenerationEngine
from .errors import MalformedPromptRejected, PromotionError, ReplicaDeadError, ReplicaHungError, SlotHealthError
from .router import ConsistentHashRouter
from .scheduler import Request, check_prompt_finite

if TYPE_CHECKING:  # the service imports `_params_mismatch` from here
    from .service import ServiceResult, ServingService


def _params_mismatch(a: dict, b: dict) -> Optional[str]:
    """The first difference between two engines' weights (``state_dict``s),
    or ``None`` (JAX's ``_params_mismatch``). Names, shapes and dtypes
    compare exactly; values by a per-tensor fp32 |sum| fingerprint with
    rtol 1e-4, since the port's engines copy their models (no two engines
    share a tensor). A fingerprint can collide in principle: it exists to
    catch two engines built from two checkpoints, not to prove equality."""
    if list(a) != list(b):
        return "parameter tree structures differ"
    for name, xa in a.items():
        xb = b[name]
        if tuple(xa.shape) != tuple(xb.shape) or xa.dtype != xb.dtype:
            return f"{name}: {tuple(xa.shape)}/{xa.dtype} vs {tuple(xb.shape)}/{xb.dtype}"
    for name, xa in a.items():
        xb = b[name]
        if xa.data_ptr() == xb.data_ptr():
            continue
        fa, fb = (float(x.detach().float().abs().sum()) for x in (xa, xb))
        if abs(fa - fb) > 1e-4 * max(1.0, abs(fa), abs(fb)):
            return f"{name}: weight fingerprints differ ({fa:.6g} vs {fb:.6g})"
    return None


class PrefillStream:
    """The dedicated prefill tier: one prefill-only engine feeding a
    service's decode engines (JAX's ``PrefillStream``).

    Admissions enqueue with a reserved (replica, slot) target
    (`ServingService._place`); `pump` groups them by (target, bucket), runs
    each group's `GenerationEngine.prefill_compute` on THIS engine and admits the handoff into its target's
    slots. The prefill engine must share ``max_len``, the bucket ladder, the
    sampling filter, the speculative configuration and the weights with
    every target (checked at `attach`; ``check_weights=False`` skips the
    weights), since the handoff equals a local prefill only when program,
    weights and seeds all match.
    """

    def __init__(self, engine: GenerationEngine, check_weights: bool = True):
        self.engine = engine
        self.check_weights = bool(check_weights)
        self._targets: Optional[list[GenerationEngine]] = None
        self._queue: deque[tuple[Request, int, int]] = deque()
        self._reserved: list[set] = []
        self._prompt_events = 0
        self._padded_events = 0
        self.prefilled_total = 0
        self.dispatches = 0

    def attach(self, replicas: Sequence[GenerationEngine]) -> None:
        if self._targets is not None:
            raise RuntimeError("prefill stream is already attached to a service")
        pf = self.engine
        for i, e in enumerate(replicas):
            if (pf.spec is None) != (e.spec is None):
                raise ValueError(
                    f"prefill replica spec={pf.spec is not None} != decode replica {i} spec={e.spec is not None} — "
                    "the handoff carries draft cache rows exactly when both tiers are speculative; build both "
                    "engines with the same SpecConfig (or neither)"
                )
            if pf.spec is not None:
                if e.spec_signature() != pf.spec_signature():
                    raise ValueError(
                        f"prefill replica spec signature {pf.spec_signature()} != decode replica {i} "
                        f"{e.spec_signature()} — the draft chain the handoff seeds must be the one the decode "
                        "replica extends (same k/tolerances/draft architecture)"
                    )
                if self.check_weights:
                    mismatch = _params_mismatch(pf.draft_params, e.draft_params)
                    if mismatch is not None:
                        raise ValueError(
                            f"prefill replica DRAFT weights != decode replica {i} draft weights ({mismatch}) — the "
                            "handed-off draft cache seed replays under the decode replica's draft model; build both "
                            "engines from the same draft checkpoint (or pass check_weights=False to own the "
                            "contract yourself)"
                        )
            if e is pf:
                raise ValueError(f"the prefill replica must be dedicated — it cannot also be decode replica {i}")
            if e.health_retries > 0:
                raise ValueError(
                    f"decode replica {i} has health_retries={e.health_retries}: health-sentinel retries re-queue on "
                    "the replica's OWN scheduler, which a dedicated prefill stream never drains — the retry would "
                    "hang the service. Behind a prefill stream, quarantined requests must fail loudly: set "
                    "health_retries=0 (the default)"
                )
            if e.max_len != pf.max_len:
                raise ValueError(
                    f"prefill replica max_len ({pf.max_len}) != decode replica {i} max_len ({e.max_len}) — the "
                    "handoff caches would not line up"
                )
            if e.scheduler.buckets != pf.scheduler.buckets:
                raise ValueError(
                    f"prefill replica buckets {pf.scheduler.buckets} != decode replica {i} buckets "
                    f"{e.scheduler.buckets} — bucketing must agree for the handoff to reproduce local prefill"
                )
            if (e.top_k, e.top_p) != (pf.top_k, pf.top_p):
                raise ValueError(
                    f"prefill replica sampling filter (top_k={pf.top_k}, top_p={pf.top_p}) != decode replica {i} "
                    f"(top_k={e.top_k}, top_p={e.top_p}) — the handed-off first event would be sampled under the "
                    "wrong filter"
                )
            if self.check_weights:
                mismatch = _params_mismatch(pf.params, e.params)
                if mismatch is not None:
                    raise ValueError(
                        f"prefill replica weights != decode replica {i} weights ({mismatch}) — the handoff is "
                        "bit-identical to local prefill only when program, weights, and keys all match; build both "
                        "engines from the same checkpoint (or pass check_weights=False to own the contract yourself)"
                    )
        self._targets = list(replicas)
        self._reserved = [set() for _ in replicas]

    # ------------------------------------------------------------- queueing
    @property
    def pending(self) -> int:
        return len(self._queue)

    def reserved_slots(self, replica_index: int) -> set:
        """Slots spoken for by queued prefills not yet admitted."""
        return self._reserved[replica_index]

    def enqueue(self, request: Request, replica_index: int, slot: int) -> None:
        if self._targets is None:
            raise RuntimeError("prefill stream is not attached to a service")
        if request.key is None:
            raise ValueError("prefill-stream requests must carry explicit keys (the service binds them at accept time)")
        self._reserved[replica_index].add(slot)
        self._queue.append((request, replica_index, slot))

    # ---------------------------------------------------------------- pump
    def pump(self) -> int:
        """Drains the queue: per-(target, bucket) groups, in the target's
        group widths, through the prefill engine's `prefill_compute` and
        into each target's reserved slots. Returns the requests admitted."""
        if not self._queue:
            return 0
        items = list(self._queue)
        self._queue.clear()
        by_target_bucket: dict[tuple[int, int], list[tuple[Request, int]]] = {}
        for req, ri, slot in items:
            b = self.engine.scheduler.bucket_for(req.prompt_len)
            by_target_bucket.setdefault((ri, b), []).append((req, slot))
        admitted = 0
        for ri, bucket_len in sorted(by_target_bucket):
            pairs = by_target_bucket[(ri, bucket_len)]
            target = self._targets[ri]
            while pairs:
                take, pairs = target.scheduler.take_group(pairs)
                gw = target.scheduler.group_size_for(len(take))
                handoff = self.engine.prefill_compute([r for r, _ in take], bucket_len, gw)
                target.admit_prefilled(handoff, [s for _, s in take])
                for r, s in take:
                    self._reserved[ri].discard(s)
                    self._prompt_events += r.prompt_len
                    self._padded_events += bucket_len
                admitted += len(take)
                self.dispatches += 1
        self.prefilled_total += admitted
        return admitted

    def stats(self) -> dict:
        padded = max(self._padded_events, 1)
        return {
            "prefilled_total": self.prefilled_total,
            "dispatches": self.dispatches,
            "pending": len(self._queue),
            "prompt_events": self._prompt_events,
            "padded_events": self._padded_events,
            "padding_waste_frac": round(1.0 - self._prompt_events / padded, 4),
        }


# ------------------------------------------------------------------ fleet
@dataclasses.dataclass(frozen=True)
class FleetHealthConfig:
    """Replica-health policy for the fleet's liveness monitor (JAX's).

    Args:
        boundary_timeout_s: the hung-dispatch watchdog's bound. A service
            whose scheduling round (one ``step``: dispatch and the blocking
            resolve of its oldest boundary) takes longer is declared hung
            (`ReplicaHungError`) and evicted. ``None`` disables the watchdog.
        watchdog_warmup_chunks: the watchdog engages only once every decode
            replica of a service has dispatched more than this many chunks
            (the first rounds build programs). The port also exempts every
            round in which an engine of the service captured a program,
            whenever it comes: the port captures a prefill (bucket, group
            width) or extraction key at its first use, which can be long
            after the warm-up, and a capture takes most of a second an engine
            on the card, which is slow but healthy (JAX compiles at its first
            dispatches, which the warm-up covers).
        max_consecutive_bad_chunks: a service whose rounds harvest
            health-quarantined slots (`SlotHealthError` results) this many
            times in a row is declared sick and evicted: one bad slot is a
            slot fault (quarantined, retried or failed), a streak means the
            replica's numerics are gone.
        auto_evict: evict from the run loop. ``False`` only records faults
            (`stats()["replica_faults"]`) and a death still raises; the
            operator calls `ServingFleet.evict_service`.
    """

    boundary_timeout_s: Optional[float] = None
    watchdog_warmup_chunks: int = 2
    max_consecutive_bad_chunks: int = 3
    auto_evict: bool = True

    def __post_init__(self):
        if self.boundary_timeout_s is not None and self.boundary_timeout_s <= 0:
            raise ValueError("boundary_timeout_s must be positive")
        if self.watchdog_warmup_chunks < 0:
            raise ValueError("watchdog_warmup_chunks must be >= 0")
        if self.max_consecutive_bad_chunks < 1:
            raise ValueError("max_consecutive_bad_chunks must be >= 1")


@dataclasses.dataclass
class FleetResult:
    """A finished fleet request: the engine result plus the fleet's routing
    (subject, service, weights version), on the fleet's clock."""

    request_id: Any  # the caller's id
    subject: Any
    service: str
    lane: str
    replica: int
    fleet_index: int  # the fleet-wide accept index (the seed's)
    weights_version: int  # the serving engine's checkpoint generation
    batch: Optional[EventStreamBatch]
    prompt_len: int
    n_events: int
    n_generated: int
    arrival_time: float
    completion_time: float
    error: Any = None  # a typed fault (`serving.errors`), or None; counted as completed
    # Times the request was replayed onto a survivor after an eviction; a
    # replay re-prefills from the bound seed.
    replays: int = 0

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def latency(self) -> float:
        return self.completion_time - self.arrival_time


def _captures(engines) -> int:
    """Program captures so far over ``engines`` (the chunk's and every keyed program's)."""
    return sum(v for e in engines for k, v in e.program_stats().items() if k.endswith("_captures"))


class ServingFleet:
    """Routes one shared request stream over several `ServingService`s with
    consistent-hash session affinity, and upgrades them in place (JAX's
    ``ServingFleet``).

    Args:
        services: ``{service_id: ServingService}``, or a sequence (ids
            ``svc0`` .. ``svcN-1``); all share ``max_len``.
        seed: accepted request ``i`` without a ``key`` runs with
            ``derive_request_seed(seed, i)``, wherever the router sends it,
            as one service or engine with this ``seed`` serving the accepted
            set in the same order binds it.
        health: the liveness policy (`FleetHealthConfig`). When set, the run
            loop evicts dead, hung or sick services (`evict_service`).
            ``None`` records nothing, evicts nothing, and a death raises.
        base_key: JAX's PRNG key; the port takes ``seed`` and refuses any
            other value than ``None``.
    """

    def __init__(
        self,
        services: Union[Mapping[str, "ServingService"], Sequence["ServingService"]],
        *,
        seed: int = 0,
        health: Optional[FleetHealthConfig] = None,
        base_key=None,
    ):
        if base_key is not None:
            raise ValueError(
                f"base_key={base_key!r} is not part of the PyTorch port's serving slice yet: the fleet takes an "
                "integer seed"
            )
        if not isinstance(services, Mapping):
            services = {f"svc{i}": s for i, s in enumerate(services)}
        self.services: dict[str, ServingService] = dict(services)
        if not self.services:
            raise ValueError("at least one service is required")
        if len({id(s) for s in self.services.values()}) != len(self.services):
            raise ValueError("services must be distinct instances")
        max_lens = {s.max_len for s in self.services.values()}
        if len(max_lens) != 1:
            raise ValueError(f"services must share max_len (the fleet parity contract) — got {sorted(max_lens)}")
        self.max_len = next(iter(max_lens))
        self.router = ConsistentHashRouter(self.services.keys())
        self.seed = int(seed)
        self._next_index = 0
        # fleet index -> routing (subject, service, caller id, arrival, the
        # keyed request and its lane for a replay, replays); the fleet
        # rewrites request_id to its own index, so a ServiceResult maps back.
        self._meta: dict[int, dict] = {}
        self._rejected_total = 0
        self._accepted_total = 0
        self._completed_total = 0
        # Hot-swap state machine (`promote`).
        self._promotion: Optional[dict] = None
        self._promotion_failed: Optional[str] = None
        self._holding: set[str] = set()
        self._held: dict[str, deque] = {sid: deque() for sid in self.services}
        self._held_peak = 0
        self._swap_history: list[dict] = []
        # Replica health: the policy, each service's bad-round streak, the
        # fault and eviction ledgers, and the evicted services, parked off
        # the ring and out of the loop (their engines, and the captured
        # programs they hold, stay referenced).
        self.health = health
        self._bad_streak: dict[str, int] = {sid: 0 for sid in self.services}
        self._replica_faults: list[dict] = []
        self._evictions: list[dict] = []
        self._evicted_services: dict[str, ServingService] = {}
        self._replayed_total = 0
        # Fault scope: every engine of service ``sid`` answers to ``sid``.
        for sid, svc in self.services.items():
            for eng in self._service_engines(svc):
                if eng.fault_scope is None:
                    eng.fault_scope = sid

    # ------------------------------------------------------------- routing
    def route(self, subject_key: Any) -> str:
        """The service that owns ``subject_key``'s session state."""
        return self.router.route(subject_key)

    def _request_seed(self, index: int) -> int:
        return derive_request_seed(self.seed, index)

    # ------------------------------------------------------------ admission
    def submit(self, subject_key: Any, request: Request, lane: Optional[str] = None) -> bool:
        """Routes and offers one request. True: accepted (a fleet index and
        seed are bound, and the request will complete: held through a swap
        window, never dropped); False: rejected by the target service's lane
        bound (no index bound, so the accepted set's results are unchanged).
        The finiteness check runs here, at the fleet's door, for every path
        (a held request reaches its service only after the flip)."""
        sid = self.route(subject_key)
        svc = self.services[sid]
        lane = lane or svc.default_lane
        if request.max_new_events < 1:
            raise ValueError("max_new_events must be >= 1")
        if request.prompt_len + request.max_new_events > self.max_len:
            raise ValueError(
                f"prompt ({request.prompt_len}) + budget ({request.max_new_events}) exceeds max_len ({self.max_len})"
            )
        if lane not in svc.lanes.configs:
            raise KeyError(f"unknown lane {lane!r} on service {sid!r}")
        if svc.replicas[0].validate_prompts and not request.prompt_validated:
            reason = check_prompt_finite(request.prompt)
            if reason is not None:
                self._rejected_total += 1
                raise MalformedPromptRejected(
                    f"request {request.request_id!r}: {reason} — rejected at the fleet door (no fleet index bound)"
                )
        index = self._next_index
        internal = dataclasses.replace(request, request_id=index, prompt_validated=True)
        if internal.key is None:
            internal.key = self._request_seed(index)
        if sid in self._holding:
            # Swap window: accept against the lane bound (the held backlog
            # counts toward it), hold at the fleet, release after the flip.
            cfg = svc.lanes.configs[lane]
            held_lane = sum(1 for _, ln in self._held[sid] if ln == lane)
            if cfg.max_pending is not None and svc.lanes.depth(lane) + held_lane >= cfg.max_pending:
                self._rejected_total += 1
                return False
            self._hold(sid, internal, lane)
        elif not svc.submit(internal, lane):
            self._rejected_total += 1
            return False
        self._next_index += 1
        self._accepted_total += 1
        self._meta[index] = {"subject": subject_key, "service": sid, "request_id": request.request_id,
                             "arrival": request.arrival_time, "request": internal, "lane": lane, "replays": 0}  # fmt: skip
        return True

    def _hold(self, sid: str, request: Request, lane: str) -> None:
        self._held[sid].append((request, lane))
        self._held_peak = max(self._held_peak, sum(len(q) for q in self._held.values()))

    def fork(
        self,
        subject_key: Any,
        prompt: EventStreamBatch,
        n_branches: int,
        max_new_events: int,
        *,
        lane: Optional[str] = None,
        key: Optional[int] = None,
        request_id=None,
        arrival_time: float = 0.0,
    ) -> list[int]:
        """Routes one prompt to ``subject_key``'s service and admits it there
        as ``n_branches`` copy-on-write branches (`ServingService.fork`, paged
        services). The session seed is ``key`` or the seed of one consumed
        fleet index; branch ``j`` draws from ``derive_request_seed(session,
        j)``. Each branch is kept as an ordinary keyed request, so a swap
        hold releases it, and an eviction replays it, as a submission of the
        prompt with that seed (the same events: the sharing is an admission
        optimisation). Results carry ``(request_id, j)``; returns the
        branches' fleet indices."""
        sid = self.route(subject_key)
        svc = self.services[sid]
        lane = lane or svc.default_lane
        n_branches = int(n_branches)
        if n_branches < 1:
            raise ValueError("n_branches must be >= 1")
        if max_new_events < 1:
            raise ValueError("max_new_events must be >= 1")
        prompt_len = int(prompt.sequence_length)
        if prompt_len + max_new_events > self.max_len:
            raise ValueError(f"prompt ({prompt_len}) + budget ({max_new_events}) exceeds max_len ({self.max_len})")
        if lane not in svc.lanes.configs:
            raise KeyError(f"unknown lane {lane!r} on service {sid!r}")
        if svc.replicas[0].validate_prompts:
            reason = check_prompt_finite(prompt)
            if reason is not None:
                self._rejected_total += 1
                raise MalformedPromptRejected(
                    f"fork request {request_id!r}: {reason} — rejected at the fleet door (no fleet index bound)"
                )
        if key is None:
            key = self._request_seed(self._next_index)
            self._next_index += 1
        session = int(key)
        indices, branches = [], []
        for j in range(n_branches):
            index = self._next_index
            self._next_index += 1
            internal = Request(prompt=prompt, max_new_events=max_new_events, key=derive_request_seed(session, j),
                               request_id=index, arrival_time=arrival_time, prompt_validated=True)  # fmt: skip
            self._meta[index] = {"subject": subject_key, "service": sid,
                                 "request_id": None if request_id is None else (request_id, j),
                                 "arrival": arrival_time, "request": internal, "lane": lane, "replays": 0}  # fmt: skip
            indices.append(index)
            branches.append(internal)
            self._accepted_total += 1
        if sid in self._holding:
            for internal in branches:
                self._hold(sid, internal, lane)
        else:
            svc.fork(prompt, n_branches, max_new_events, lane=lane, key=session, request_ids=indices,
                     arrival_time=arrival_time)  # fmt: skip
        return indices

    def _wrap(self, sr: "ServiceResult", sid: str) -> FleetResult:
        meta = self._meta.pop(sr.request_id)
        self._completed_total += 1
        version = self.services[sid].replicas[sr.replica].weights_version if sr.replica >= 0 else -1
        return FleetResult(request_id=meta["request_id"], subject=meta["subject"], service=sid, lane=sr.lane,
                           replica=sr.replica, fleet_index=sr.request_id, weights_version=version, batch=sr.batch,
                           prompt_len=sr.prompt_len, n_events=sr.n_events, n_generated=sr.n_generated,
                           arrival_time=meta["arrival"], completion_time=sr.completion_time, error=sr.error,
                           replays=meta["replays"])  # fmt: skip

    # ----------------------------------------------------- replica health
    def _note_replica_fault(self, sid: str, kind: str, reason: str, error=None) -> None:
        """Records a replica fault and, as the policy allows, evicts the
        service. Raises when nothing can be done: a death under
        ``auto_evict=False`` (stepping a dead service would re-raise every
        round), or the fleet's last service."""
        self._replica_faults.append({"service": sid, "kind": kind, "reason": reason})
        if self.health is not None and not self.health.auto_evict:
            if kind == "dead":
                raise error if error is not None else ReplicaDeadError(
                    f"service {sid!r} is dead ({reason}) and auto_evict is off — call evict_service yourself or "
                    "enable auto_evict"
                )
            return
        if len(self.services) == 1:
            raise error if error is not None else ReplicaDeadError(
                f"the last service {sid!r} is {kind} ({reason}); no survivors to evict onto — the fleet is down"
            )
        self.evict_service(sid, reason=f"{kind}: {reason}")

    def evict_service(self, sid: str, reason: str = "operator eviction") -> int:
        """Evicts a service and replays its in-flight sessions on the
        survivors; returns the number replayed. The router drops the
        service's vnodes (only its subjects remap, to survivors); every
        request the fleet accepted for it and has not completed (lane-queued,
        held, resident) is re-routed and re-submitted from its bound seed
        with ``force=True`` (bouncing accepted work on a full lane would drop
        it), or joins a holding survivor's held queue. The evicted service is
        parked in ``stats()["evicted_services"]`` and never stepped again;
        its engines stay referenced."""
        if sid not in self.services:
            raise KeyError(f"service {sid!r} is not part of the fleet")
        self.router.remove_service(sid)
        self._evicted_services[sid] = self.services.pop(sid)
        self._bad_streak.pop(sid, None)
        self._holding.discard(sid)
        self._held.pop(sid, None)  # its entries are in _meta, replayed below
        p = self._promotion
        if p is not None:
            if p["draining"] == sid:
                p["draining"] = None
            if sid in p["flipped"]:
                p["flipped"].remove(sid)
            rb = p["rollback"]
            if rb is not None:
                if rb["unflipping"] == sid:
                    rb["unflipping"] = None
                if sid in rb["to_unflip"]:
                    rb["to_unflip"].remove(sid)
        replayed = 0
        for i in sorted(i for i, m in self._meta.items() if m["service"] == sid):
            meta = self._meta[i]
            new_sid = self.route(meta["subject"])
            replay = dataclasses.replace(meta["request"], admission_index=-1, health_retries=0)
            if new_sid in self._holding:
                self._hold(new_sid, replay, meta["lane"])  # released with the survivor's held routes
            else:
                accepted = self.services[new_sid].submit(replay, meta["lane"], force=True)
                assert accepted  # force bypasses the lane bound
            meta["service"] = new_sid
            meta["replays"] += 1
            replayed += 1
        self._replayed_total += replayed
        self._evictions.append({"service": sid, "reason": reason, "replayed": replayed})
        return replayed

    # ------------------------------------------------------------ hot swap
    def promote(self, new_params, at_time: Optional[float] = None, new_draft_params=None) -> None:
        """Fleet-wide zero-downtime checkpoint promotion (JAX's state
        machine). ``new_params`` (a ``state_dict``) is staged in every
        engine's shadow (decode and prefill engines; all ``hot_swap``), each
        engine's `probe_shadow` gates it, then services flip one at a time
        in sorted order: routes to the flipping service are held at the
        fleet, its residents drain on the old weights, its engines flip once
        ``busy()`` is false (the prefill engine too), and the held requests
        release. A failed load, probe or flip rolls back: flipped services
        drain and flip back (their shadows hold the old weights), every
        shadow is dropped, held routes release onto the old weights.

        Called idle (no ``at_time``, nothing in flight) it runs to the end
        at once and raises `PromotionError` on a rollback; otherwise it arms
        and `run`'s loop drives it from ``at_time`` on (a rollback then shows
        in `swap_report` and ``stats()["last_promotion_error"]``). A fleet of
        speculative engines must pass ``new_draft_params``: each engine stages
        both and flips both at once."""
        if self._promotion is not None:
            raise RuntimeError("a promotion is already in flight")
        any_spec = False
        for sid, svc in self.services.items():
            for eng in self._service_engines(svc):
                if not eng.hot_swap:
                    raise RuntimeError(
                        f"service {sid!r} has an engine without hot_swap=True; the fleet cannot promote without "
                        "shadow buffers"
                    )
                any_spec = any_spec or eng.spec is not None
        if any_spec and new_draft_params is None:
            raise ValueError(
                "this fleet serves speculative engines: promote(new_params, new_draft_params=...) so draft and "
                "target swap atomically"
            )
        if not any_spec and new_draft_params is not None:
            raise ValueError("new_draft_params on a fleet with no speculative engines")
        self._promotion = {"params": new_params, "draft_params": new_draft_params, "at_time": at_time,
                           "loaded": False, "verified": False, "draining": None, "flipped": [], "held_released": 0,
                           "rollback": None}  # fmt: skip
        self._promotion_failed = None
        if at_time is None and not self._any_busy():
            while self._promotion is not None:
                self._advance_promotion()
            if self._promotion_failed is not None:
                raise PromotionError(self._promotion_failed)

    @staticmethod
    def _service_engines(svc: "ServingService") -> list[GenerationEngine]:
        engines = list(svc.replicas)
        if svc.prefill_stream is not None:
            engines.append(svc.prefill_stream.engine)
        return engines

    def _advance_promotion(self) -> None:
        p = self._promotion
        if p is None:
            return
        if p["rollback"] is not None:
            self._advance_rollback()
            return
        if not p["loaded"]:
            try:
                for svc in self.services.values():
                    for eng in self._service_engines(svc):
                        eng.load_shadow(p["params"], new_draft_params=p["draft_params"] if eng.spec is not None else None)
            except Exception as e:
                self._start_rollback(f"shadow load failed: {e}")
                return
            p["loaded"] = True
        if not p["verified"]:
            # The gate: a finite-output probe of every engine's staged weights
            # before any flip; a bad checkpoint never serves a step.
            for sid in sorted(self.services):
                for eng in self._service_engines(self.services[sid]):
                    reason = eng.probe_shadow()
                    if reason is not None:
                        self._start_rollback(f"shadow verification failed on service {sid!r}: {reason}")
                        return
            p["verified"] = True
        if p["draining"] is None:
            remaining = [sid for sid in sorted(self.services) if sid not in p["flipped"]]
            if not remaining:
                self._swap_history.append({"status": "promoted", "services": list(p["flipped"]),
                                           "held_released": p["held_released"]})  # fmt: skip
                self._promotion = None
                return
            p["draining"] = remaining[0]
            self._holding.add(p["draining"])
        sid = p["draining"]
        svc = self.services[sid]
        if svc.busy():
            return  # residents still draining on the old weights
        flipped: list[GenerationEngine] = []
        try:
            _sfaults.maybe_fail_flip(sid)
            for eng in self._service_engines(svc):
                eng.flip()
                flipped.append(eng)
        except Exception as e:
            # Flip this service's flipped engines straight back (their
            # shadows hold the old weights), then roll the promotion back.
            for eng in flipped:
                eng.flip()
            self._start_rollback(f"flip failed on service {sid!r}: {e}")
            return
        p["flipped"].append(sid)
        self._holding.discard(sid)
        self._release_held(sid)
        p["draining"] = None

    def _release_held(self, sid: str) -> None:
        """Releases a service's held routes, forced past the lane bound: they
        were accepted, and an eviction replay may have overshot the lane
        meanwhile."""
        svc = self.services[sid]
        p = self._promotion
        held = self._held[sid]
        while held:
            req, lane = held.popleft()
            accepted = svc.submit(req, lane, force=True)
            assert accepted  # force bypasses the lane bound
            if p is not None:
                p["held_released"] += 1

    def _start_rollback(self, reason: str) -> None:
        """Arms the rollback: services already flipped drain and flip back,
        every shadow is then dropped and held routes release onto the old
        weights; the draining service, never flipped, releases at once."""
        p = self._promotion
        p["rollback"] = {"reason": reason, "to_unflip": list(p["flipped"]), "unflipping": None}
        if p["draining"] is not None:
            sid = p["draining"]
            self._holding.discard(sid)
            self._release_held(sid)
            p["draining"] = None

    def _advance_rollback(self) -> None:
        p = self._promotion
        rb = p["rollback"]
        if rb["unflipping"] is None:
            if not rb["to_unflip"]:
                for svc in self.services.values():
                    for eng in self._service_engines(svc):
                        eng.drop_shadow()
                for sid in sorted(self.services):
                    if self._held[sid]:
                        self._release_held(sid)
                self._holding.clear()
                self._swap_history.append({"status": "rolled_back", "reason": rb["reason"], "services": [],
                                           "held_released": p["held_released"]})  # fmt: skip
                self._promotion_failed = rb["reason"]
                self._promotion = None
                return
            rb["unflipping"] = rb["to_unflip"][0]
            self._holding.add(rb["unflipping"])
        sid = rb["unflipping"]
        svc = self.services[sid]
        if svc.busy():
            return  # residents draining on the new weights they started on
        for eng in self._service_engines(svc):
            eng.flip()  # the shadow holds the old weights: flip back
        rb["to_unflip"].remove(sid)
        rb["unflipping"] = None
        self._holding.discard(sid)
        self._release_held(sid)

    def swap_report(self) -> dict:
        """The zero-drop scoreboard: accepted minus completed minus what is
        physically in flight (the held queues plus each service's
        `ServingService.pending`, not the fleet's own ledger, which moves in
        lockstep with the counters) must be zero, so a request the fleet
        accepted and no queue holds reads as dropped."""
        held_now = sum(len(q) for q in self._held.values())
        in_flight = held_now + sum(s.pending() for s in self.services.values())
        return {
            "promotions": len(self._swap_history),
            "swap_history": list(self._swap_history),
            "swap_dropped_requests": self._accepted_total - self._completed_total - in_flight,
            "in_flight": in_flight,
            "held_now": held_now,
            "held_peak": self._held_peak,
        }

    # -------------------------------------------------------------- serving
    def _any_busy(self) -> bool:
        return any(s.busy() for s in self.services.values()) or any(self._held.values())

    def run(
        self,
        items: Sequence[tuple] = (),
        *,
        use_arrival_times: bool = False,
        shutdown: Optional[Any] = None,
    ) -> list[FleetResult]:
        """Serves ``items``, each ``(subject, Request)`` or ``(subject,
        Request, lane)``, to completion across the fleet; results in fleet
        index order. Each round submits the requests that have arrived
        (``use_arrival_times``: a replay trace on the fleet's clock; else all
        at once), advances an armed promotion, and gives each service one
        `ServingService.step`. With ``health``, a service whose step raises
        `ReplicaDeadError`, whose round outlasts ``boundary_timeout_s``
        (warm-up and capture rounds exempt) or that harvests quarantined
        slots ``max_consecutive_bad_chunks`` rounds in a row is evicted and
        its sessions replay on survivors. ``shutdown`` (a
        `reliability.GracefulShutdown`) drains resident slots and raises
        `reliability.Preempted` with the completed results."""
        trace = [it if len(it) == 3 else (*it, None) for it in items]
        if not use_arrival_times:
            for subject, req, lane in trace:
                try:
                    self.submit(subject, req, lane)
                except MalformedPromptRejected:
                    pass  # typed, counted at the fleet door; the rest serve
            trace = []
        results: list[FleetResult] = []
        t0 = time.perf_counter()
        ptr = 0
        draining = False
        hc = self.health
        while True:
            draining = draining or (shutdown is not None and shutdown.requested)
            if draining:
                if not any(s.resident_busy() for s in self.services.values()):
                    break
            elif not (ptr < len(trace) or self._any_busy() or self._promotion is not None):
                break
            now = time.perf_counter() - t0
            if not draining:
                while ptr < len(trace) and trace[ptr][1].arrival_time <= now:
                    try:
                        self.submit(*trace[ptr])
                    except MalformedPromptRejected:
                        pass
                    ptr += 1
                if self._promotion is not None and (self._promotion["at_time"] is None
                                                    or now >= self._promotion["at_time"]):  # fmt: skip
                    self._advance_promotion()
            progressed = False
            for sid in sorted(self.services):
                svc = self.services[sid]
                watch = hc is not None and hc.boundary_timeout_s is not None
                captured = _captures(self._service_engines(svc)) if watch else 0
                t_step = time.perf_counter()
                try:
                    step_results = svc.step(lambda: time.perf_counter() - t0, place=not draining)
                except ReplicaDeadError as e:
                    if hc is None:
                        raise
                    self._note_replica_fault(sid, "dead", str(e), error=e)
                    progressed = True
                    continue
                step_s = time.perf_counter() - t_step
                results.extend(self._wrap(sr, sid) for sr in step_results)
                progressed = progressed or svc._last_step_progressed
                if hc is None:
                    continue
                warm = all(e._dispatched_chunks > hc.watchdog_warmup_chunks for e in svc.replicas)
                if (watch and warm and step_s > hc.boundary_timeout_s
                        and _captures(self._service_engines(svc)) == captured):  # fmt: skip
                    self._note_replica_fault(
                        sid, "hung", f"scheduling round took {step_s:.3f}s > boundary_timeout_s={hc.boundary_timeout_s}s",
                        error=ReplicaHungError(f"service {sid!r} exceeded the boundary-readback timeout ({step_s:.3f}s)"),
                    )  # fmt: skip
                    progressed = True
                    continue
                # Only quarantined slots count toward the streak (a deadline
                # expiry is policy, not sickness).
                if any(isinstance(sr.error, SlotHealthError) for sr in step_results):
                    self._bad_streak[sid] += 1
                    if self._bad_streak[sid] >= hc.max_consecutive_bad_chunks:
                        self._note_replica_fault(
                            sid, "sick", f"{self._bad_streak[sid]} consecutive rounds harvested health-quarantined slots"
                        )
                        progressed = True
                elif svc._last_step_progressed:
                    self._bad_streak[sid] = 0
            if not progressed:
                time.sleep(1e-3)  # waiting on arrivals or a drain
        results = sorted(results, key=lambda r: r.fleet_index)
        if draining:
            raise Preempted(
                f"fleet preempted: drained {len(results)} completed results; {sum(len(q) for q in self._held.values())} "
                f"held and {sum(s.lanes.pending for s in self.services.values())} queued requests abandoned",
                results=results,
            )
        return results

    # ------------------------------------------------------------ accounting
    def stats(self) -> dict:
        return {
            "n_services": len(self.services),
            "service_ids": list(self.router.service_ids),
            "accepted_total": self._accepted_total,
            "completed_total": self._completed_total,
            "rejected_total": self._rejected_total,
            "replica_faults": list(self._replica_faults),
            "evictions": list(self._evictions),
            "evicted_services": sorted(self._evicted_services),
            "sessions_replayed_total": self._replayed_total,
            "last_promotion_error": self._promotion_failed,
            "swap": self.swap_report(),
            "services": {sid: s.stats() for sid, s in self.services.items()},
        }
