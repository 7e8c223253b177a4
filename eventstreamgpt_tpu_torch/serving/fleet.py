"""The dedicated prefill stream, and the weights check between engines.

Counterpart: the first part of ``eventstreamgpt_tpu/serving/fleet.py``
(``_params_mismatch`` and ``PrefillStream``); the router tier
(``ServingFleet``) is not ported yet.

`PrefillStream` is the prefill tier of a `serving.service.ServingService`:
one prefill-only engine runs the bucketed prefill forwards
(`GenerationEngine.prefill_compute`) and hands each group's slot state to
its target decode engine (`GenerationEngine.admit_prefilled`), so the decode
engines pay only the admission scatter. Every engine runs on the current
CUDA stream: `pump` admits each handoff as soon as it is computed (JAX's
order), before the decode engines issue their next chunks, so a stream of
its own would give the prefill nothing to overlap.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

from .engine import GenerationEngine
from .scheduler import Request


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

