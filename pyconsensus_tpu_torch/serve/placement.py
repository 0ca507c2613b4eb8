"""Consistent-hash session placement, a copy of
``pyconsensus_tpu/serve/placement.py`` (host code: every key lands on the
same worker in both packages).

The fleet routes every session (and, for load spread, every stateless
request) through one :class:`HashRing`: worker names own arcs of a
2^64 hash circle via ``vnodes`` virtual points each, and a key maps to
the first worker point clockwise of the key's hash. The property that
makes this the right structure for failover — and the one the tests
pin — is **placement stability**: removing a worker moves ONLY the keys
that worker owned (they redistribute to the clockwise successors of its
vnodes); every other key keeps its owner bit-for-bit. A modulo scheme
(``hash(key) % n_workers``) would reshuffle ~``(n-1)/n`` of all
sessions on every membership change, turning one worker death into a
fleet-wide migration storm.

Hashing is SHA-256 (first 8 bytes, big-endian) — deterministic across
processes, platforms, and Python hash randomization, so a router
restart or a second router instance computes identical placements
(Python's builtin ``hash`` is salted per process and would not).

All methods are thread-safe; mutation (``add``/``remove``) rebuilds the
sorted vnode table under the lock — membership changes are rare
(a failover), lookups are the hot path (one bisect).
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Iterable, List, Tuple

from ..faults import PlacementError

__all__ = ["HashRing", "DEFAULT_VNODES"]

#: virtual points per worker. 64 keeps the max/mean ownership ratio of a
#: 3-worker ring under ~1.25 while the full table stays tiny (192
#: entries); raising it flattens the distribution further at pure
#: memory/rebuild cost (lookups stay one bisect).
DEFAULT_VNODES = 64


def _hash64(data: str) -> int:
    return int.from_bytes(
        hashlib.sha256(data.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over worker names (see module docstring)."""

    def __init__(self, workers: Iterable[str] = (),
                 vnodes: int = DEFAULT_VNODES) -> None:
        if int(vnodes) < 1:
            raise PlacementError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._lock = threading.Lock()
        self._workers: set = set()
        self._points: List[Tuple[int, str]] = []   # sorted (hash, worker)
        self._hashes: List[int] = []               # bisect view of points
        for w in workers:
            self.add(w)

    # -- membership -----------------------------------------------------

    def add(self, worker: str) -> None:
        worker = str(worker)
        with self._lock:
            if worker in self._workers:
                return
            self._workers.add(worker)
            self._rebuild()

    def remove(self, worker: str) -> None:
        """Drop ``worker`` from the ring (a failover). Unknown names are
        a no-op — a double-remove during a racy double-declare-dead must
        not fault the takeover path."""
        with self._lock:
            self._workers.discard(str(worker))
            self._rebuild()

    def _rebuild(self) -> None:
        points = []
        for w in self._workers:
            for v in range(self.vnodes):
                # tie-break equal hashes by worker name so the table is
                # fully deterministic (astronomically unlikely, but a
                # nondeterministic router is not worth the risk)
                points.append((_hash64(f"{w}#{v}"), w))
        points.sort()
        self._points = points
        self._hashes = [h for h, _ in points]

    def workers(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._workers))

    def __len__(self) -> int:
        with self._lock:
            return len(self._workers)

    def __contains__(self, worker: str) -> bool:
        with self._lock:
            return str(worker) in self._workers

    # -- lookup ---------------------------------------------------------

    def owner(self, key: str) -> str:
        """The worker owning ``key`` — the first vnode clockwise of the
        key's hash. Raises :class:`PlacementError` (PYC503) on an empty
        ring: with zero workers there is no honest ``retry_after_s`` to
        offer, only an operator problem to surface."""
        with self._lock:
            if not self._points:
                raise PlacementError(
                    "placement ring is empty — no alive workers",
                    key=str(key))
            i = bisect.bisect_right(self._hashes, _hash64(str(key)))
            return self._points[i % len(self._points)][1]

    def preference(self, key: str, n: int = None) -> list:
        """The first ``n`` DISTINCT workers clockwise of ``key`` — the
        spillover order for stateless requests (owner first; a full
        owner queue tries the next arc, mirroring how the key would move
        if the owner died). Raises :class:`PlacementError` when empty."""
        with self._lock:
            if not self._points:
                raise PlacementError(
                    "placement ring is empty — no alive workers",
                    key=str(key))
            want = len(self._workers) if n is None else min(
                int(n), len(self._workers))
            i = bisect.bisect_right(self._hashes, _hash64(str(key)))
            out: list = []
            for step in range(len(self._points)):
                w = self._points[(i + step) % len(self._points)][1]
                if w not in out:
                    out.append(w)
                    if len(out) >= want:
                        break
            return out

    def moved_keys(self, keys: Iterable[str], removed: str) -> list:
        """Of ``keys``, those whose owner changes when ``removed``
        leaves the ring — by construction exactly the keys ``removed``
        owns now (the placement-stability property; exposed so tests
        and the fleet's takeover path share one definition)."""
        return [k for k in keys if self.owner(k) == str(removed)]
