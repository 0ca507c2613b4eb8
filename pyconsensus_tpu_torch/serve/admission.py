"""Admission control: token-bucket rate limits and deadline shedding,
plus the fleet's cluster-capacity view
(``pyconsensus_tpu/serve/admission.py``).

Overload behavior is DETERMINISTIC by design: a request that cannot be
served within policy is refused at the front door (or shed at dispatch
when its deadline has already passed) with a structured
``ServiceOverloadError`` (stable code PYC401, ``context["reason"]``
naming the policy) — never absorbed into unbounded queue growth or a
deadline-less hang. The bounded queue itself lives in ``queue.py``; this
module owns the per-tenant rate policy and the drain flag.

:class:`ClusterCapacity` extends the same discipline to a fleet: it
tracks which workers are alive and how much bounded-queue headroom each
contributes, so a cluster-wide shed can quote an honest
``retry_after_s`` that scales with how much of the fleet survives (half
the workers → roughly twice the drain time for the same backlog), and a
takeover window is a first-class, deadline-bounded state the router can
quote to clients instead of guessing.
"""

from __future__ import annotations

import threading
import time

from .. import obs
from ..faults import ServiceOverloadError

__all__ = ["TokenBucket", "AdmissionController", "ClusterCapacity"]


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second refill, ``burst``
    capacity. ``try_take`` is O(1) and lock-free within the controller's
    lock (refill is computed lazily from elapsed time, no timer
    thread)."""

    def __init__(self, rate: float, burst: float) -> None:
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._stamp = time.monotonic()

    def try_take(self, n: float = 1.0) -> bool:
        now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._stamp) * self.rate)
        self._stamp = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (retry hint)."""
        return max(0.0, (n - self.tokens) / self.rate)


class AdmissionController:
    """Per-tenant token buckets + the drain flag, consulted by
    ``ConsensusService.submit`` BEFORE the request touches the queue —
    over-rate traffic never occupies queue capacity."""

    def __init__(self, rate: float = 0.0, burst: float = 0.0) -> None:
        #: rate <= 0 disables rate limiting (the bounded queue still
        #: backstops admission)
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else max(1.0, float(rate))
        self._buckets: dict = {}
        self._lock = threading.Lock()
        self._draining = False
        self._shed = obs.counter(
            "pyconsensus_serve_shed_total",
            "requests refused/shed by admission policy",
            labels=("reason",))

    # -- drain ----------------------------------------------------------

    def start_drain(self) -> None:
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    # -- admission ------------------------------------------------------

    def admit(self, tenant: str) -> None:
        """Raise ``ServiceOverloadError`` when ``tenant`` is over rate
        or the service is draining; otherwise consume one token."""
        if self._draining:
            self._shed.inc(reason="draining")
            raise ServiceOverloadError(
                "service is draining for shutdown", reason="draining",
                tenant=tenant)
        if self.rate <= 0:
            return
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = TokenBucket(self.rate,
                                                             self.burst)
            if not bucket.try_take():
                retry = bucket.retry_after()
                self._shed.inc(reason="rate_limited")
                raise ServiceOverloadError(
                    f"tenant {tenant!r} over rate "
                    f"({self.rate:g} req/s, burst {self.burst:g})",
                    reason="rate_limited", tenant=tenant,
                    retry_after_s=retry)

    def record_shed(self, reason: str) -> None:
        """Count a shed decided elsewhere (deadline at dispatch,
        queue_full in the queue) under the same metric."""
        self._shed.inc(reason=reason)


class ClusterCapacity:
    """The fleet's shedding arithmetic: who is alive, how much
    bounded-queue headroom survives, how long the current takeover
    window has left. Pure bookkeeping — the ROUTER decides and raises;
    this view makes its ``retry_after_s`` quotes honest instead of a
    constant someone guessed.

    ``base_retry_s`` calibrates the healthy-fleet retry hint; a cluster
    shed scales it by ``registered/alive`` (fewer survivors drain the
    same offered load proportionally slower) and adds any remaining
    takeover window (a retry during takeover that lands before the
    standby finishes would only be refused again)."""

    def __init__(self, base_retry_s: float = 0.25) -> None:
        self.base_retry_s = float(base_retry_s)
        self._lock = threading.Lock()
        self._workers: dict = {}       # name -> {"alive": bool, "slots"}
        self._takeover_until = 0.0
        self._takeovers = 0            # concurrently open windows
        self._gauge = obs.gauge(
            "pyconsensus_fleet_workers",
            "alive workers in the consensus serve fleet")
        self._queue_gauge = obs.gauge(
            "pyconsensus_fleet_worker_queue_depth",
            "queued requests per fleet worker", labels=("worker",))

    # -- membership -----------------------------------------------------

    def register(self, worker: str, queue_slots: int) -> None:
        with self._lock:
            self._workers[str(worker)] = {"alive": True,
                                          "slots": int(queue_slots)}
            self._gauge.set(self._alive_locked())

    def mark_dead(self, worker: str) -> None:
        with self._lock:
            if str(worker) in self._workers:
                self._workers[str(worker)]["alive"] = False
            self._gauge.set(self._alive_locked())

    def forget(self, worker: str) -> None:
        """Remove ``worker`` from the capacity view entirely — the
        graceful-drain exit. A DEATH keeps its tombstone:
        the dead fraction scales retry hints because the fleet is
        degraded below its intended size. A DRAINED worker left on
        purpose (the autoscaler shrank the fleet), so its tombstone
        must not inflate ``registered/alive`` forever — the smaller
        fleet IS the intended size, and its retry hints should read
        healthy."""
        with self._lock:
            self._workers.pop(str(worker), None)
            self._gauge.set(self._alive_locked())

    def _alive_locked(self) -> int:
        return sum(1 for w in self._workers.values() if w["alive"])

    @property
    def alive(self) -> int:
        with self._lock:
            return self._alive_locked()

    @property
    def registered(self) -> int:
        with self._lock:
            return len(self._workers)

    def alive_slots(self) -> int:
        """Bounded-queue capacity the surviving workers contribute.
        Quoted in cluster-full sheds and the fleet status snapshot so
        clients and operators see how much headroom died with the
        worker (enforcement stays per-queue: the router spills over the
        ring and sheds only when every surviving queue refused)."""
        with self._lock:
            return sum(w["slots"] for w in self._workers.values()
                       if w["alive"])

    def observe_queue_depth(self, worker: str, depth: int) -> None:
        """Feed the per-worker queue gauge (the router samples depths
        on its heartbeat scan)."""
        self._queue_gauge.set(int(depth), worker=str(worker))

    # -- takeover window ------------------------------------------------

    def begin_takeover(self, window_s: float) -> None:
        """Open (or extend) the takeover window: until it closes, fleet
        sheds fold the remaining window into their retry hints. Windows
        nest — two workers dying near-simultaneously each open one, and
        the window closes only when the LAST takeover ends (the first
        to finish must not collapse a window still in flight)."""
        with self._lock:
            self._takeovers += 1
            self._takeover_until = max(self._takeover_until,
                                       time.monotonic() + float(window_s))

    def end_takeover(self) -> None:
        with self._lock:
            self._takeovers = max(0, self._takeovers - 1)
            if self._takeovers == 0:
                self._takeover_until = 0.0

    def takeover_remaining(self) -> float:
        with self._lock:
            return max(0.0, self._takeover_until - time.monotonic())

    # -- the honest retry hint ------------------------------------------

    def shed_retry_after(self) -> float:
        """``retry_after_s`` for a cluster-wide shed: the healthy-fleet
        base scaled by the dead fraction's lost drain rate, plus
        whatever remains of the takeover window. With zero alive
        workers there is no honest hint — the caller should be raising
        ``PlacementError``, not shedding."""
        with self._lock:
            alive = self._alive_locked()
            scale = (len(self._workers) / alive) if alive else 1.0
            window = max(0.0, self._takeover_until - time.monotonic())
        return round(self.base_retry_s * scale + window, 6)
