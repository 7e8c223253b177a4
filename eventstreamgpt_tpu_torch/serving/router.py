"""Consistent-hash session-affinity routing for the serving fleet.

Counterpart: ``eventstreamgpt_tpu/serving/router.py``, byte for byte in its
ring (the committed ``tests/fixtures/router_assignment.json`` pins both).

The fleet (`serving.fleet.ServingFleet`) serves one shared request stream
over several `ServingService`s. Routing is **session affinity by
subject**: a subject's requests land on the service that holds its slot
state. The router is a consistent-hash ring with virtual nodes:

* **Stable across process restarts**: placement hashes are
  ``sha256``-derived, never Python's process-salted ``hash()``, so the same
  subject maps to the same service on every host and interpreter.
* **Invariant to enumeration order**: the ring is built from the sorted
  ``(point, service_id)`` set, so any iteration order of the same service
  set gives the same ring.
* **Minimal movement on resize**: adding one service to an ``N``-service
  ring remaps only ~``1/(N+1)`` of subjects, every one of them **to the new
  service**; removing one remaps only its own subjects, to survivors.
* **Deterministic, content-irrelevant**: placement is a pure function of
  (subject key, service-id set). The fleet binds request seeds at accept
  time, before routing, so *where* a request runs never changes *what* it
  produces.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Any, Iterable, Sequence

__all__ = ["ConsistentHashRouter", "stable_hash"]

# 64-bit points are plenty for collision-free rings at fleet scale and keep
# the fixture human-diffable.
_POINT_BYTES = 8


def stable_hash(key: Any, salt: str = "") -> int:
    """A process-stable 64-bit hash of ``key``'s string form.

    ``str(key)`` is the canonical subject spelling (the ingest path keys
    subjects by their raw string id); sha256 so the value is identical on
    every platform/restart — the affinity map must outlive any one process.
    """
    data = f"{salt}\x00{key}".encode("utf-8", errors="surrogatepass")
    return int.from_bytes(hashlib.sha256(data).digest()[:_POINT_BYTES], "big")


class ConsistentHashRouter:
    """Consistent-hash ring: subject key → service id.

    Args:
        service_ids: the service identifiers (any strings; the fleet uses
            ``"svc{i}"``). Order is irrelevant — the ring is a pure
            function of the *set*.
        n_vnodes: virtual nodes per service. More vnodes ⇒ smoother load
            split and a tighter ~1/N movement bound on resize; 64 keeps
            the ring tiny while holding the bound well inside 2/N.
    """

    def __init__(self, service_ids: Iterable[str], n_vnodes: int = 64):
        if n_vnodes < 1:
            raise ValueError(f"n_vnodes must be >= 1, got {n_vnodes}")
        self.n_vnodes = int(n_vnodes)
        ids = list(service_ids)
        if not ids:
            raise ValueError("at least one service id is required")
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate service ids: {ids}")
        self._ids: set[str] = set()
        self._points: list[int] = []  # sorted ring points
        self._owners: list[str] = []  # parallel: owner of each point
        for sid in ids:
            self.add_service(sid)

    # ------------------------------------------------------------ membership
    @property
    def service_ids(self) -> tuple[str, ...]:
        return tuple(sorted(self._ids))

    def add_service(self, service_id: str) -> None:
        """Inserts ``service_id``'s vnodes; existing points are untouched,
        so only subjects on the stolen arcs remap (all to the new id)."""
        if service_id in self._ids:
            raise ValueError(f"service {service_id!r} already on the ring")
        self._ids.add(service_id)
        for v in range(self.n_vnodes):
            point = stable_hash(f"{service_id}#{v}", salt="vnode")
            i = bisect.bisect_left(self._points, point)
            # Point collisions across distinct (service, vnode) pairs are
            # ~2^-64 per pair; break deterministically by owner id anyway so
            # the ring is a pure function of the set even then.
            while i < len(self._points) and self._points[i] == point:
                if self._owners[i] > service_id:
                    break
                i += 1
            self._points.insert(i, point)
            self._owners.insert(i, service_id)

    def remove_service(self, service_id: str) -> None:
        """Removes ``service_id``'s vnodes; its arcs fall to the ring
        successors (only that service's subjects remap)."""
        if service_id not in self._ids:
            raise KeyError(f"service {service_id!r} is not on the ring")
        if len(self._ids) == 1:
            raise ValueError("cannot remove the last service")
        self._ids.discard(service_id)
        keep = [(p, o) for p, o in zip(self._points, self._owners) if o != service_id]
        self._points = [p for p, _ in keep]
        self._owners = [o for _, o in keep]

    # --------------------------------------------------------------- routing
    def route(self, subject_key: Any) -> str:
        """The service owning ``subject_key``: the first ring point at or
        after the subject's hash (wrapping)."""
        h = stable_hash(subject_key, salt="subject")
        i = bisect.bisect_left(self._points, h)
        if i == len(self._points):
            i = 0
        return self._owners[i]

    def assignment(self, subject_keys: Sequence[Any]) -> dict[str, str]:
        """``{str(subject): service_id}`` for a batch of subjects — the
        fixture format the hash-stability regression test pins."""
        return {str(k): self.route(k) for k in subject_keys}
