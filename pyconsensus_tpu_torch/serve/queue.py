"""Bounded request queue and the request record
(``pyconsensus_tpu/serve/queue.py``).

``ResolveRequest`` is the unit of work the service moves: the caller's
inputs plus everything admission and the batcher derive once at submit
time (true shape, bucket, static params, the batch key). The queue is a
strictly BOUNDED FIFO with condition-variable handoff — a full queue is
an admission decision (``ServiceOverloadError``), never silent growth:
unbounded queues turn overload into latency collapse and OOM, the two
failure modes a shedding service exists to prevent.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

from .. import obs
from ..faults import ServiceOverloadError

__all__ = ["ResolveRequest", "RequestQueue"]


def _now() -> float:
    return time.monotonic()


@dataclass(eq=False)        # identity semantics: fields hold arrays
class ResolveRequest:
    """One queued resolution. Exactly one of ``reports`` / ``session``
    is set; everything below ``future`` is derived at admission."""

    reports: object = None                 # (R, E) float ndarray
    event_bounds: object = None            # Oracle event_bounds list
    reputation: object = None              # (R,) prior or None
    session: Optional[str] = None          # named market session instead
    oracle_kwargs: dict = field(default_factory=dict)
    backend: str = "torch"
    tenant: str = "default"
    #: absolute monotonic shed deadline (None = the config default)
    deadline: Optional[float] = None
    future: Future = field(default_factory=Future)
    submitted_at: float = field(default_factory=_now)
    # -- derived at admission ------------------------------------------
    shape: Optional[tuple] = None          # true (R, E)
    bucket: Optional[tuple] = None         # (rows, events) or None=direct
    params: object = None                  # ConsensusParams (bucket path)
    batch_key: object = None               # coalescing key
    dispatch_path: str = "direct"          # "bucket" | "direct" | "session"
    scaled: object = None                  # parsed event-bounds vectors
    mins: object = None
    maxs: object = None
    quarantined_rows: object = None        # ±Inf rows zeroed at admission

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else _now()) > self.deadline)

    def shed(self, reason: str, **ctx) -> None:
        """Resolve the caller's future with the structured overload
        error (idempotent — a raced future is left alone)."""
        if not self.future.done():
            self.future.set_exception(ServiceOverloadError(
                f"request shed: {reason}", reason=reason,
                tenant=self.tenant, **ctx))


class RequestQueue:
    """Bounded FIFO with blocking take — the single producer/consumer
    handoff point between ``submit`` and the batcher thread."""

    def __init__(self, max_depth: int) -> None:
        if int(max_depth) < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = int(max_depth)
        self._items: list = []
        self._cond = threading.Condition()
        self._closed = False
        self._depth_gauge = obs.gauge(
            "pyconsensus_serve_queue_depth",
            "requests waiting in the service queue")

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def put(self, req: ResolveRequest) -> None:
        """Enqueue or raise ``ServiceOverloadError`` — the bounded-queue
        admission decision. Never blocks the submitter."""
        with self._cond:
            if self._closed:
                raise ServiceOverloadError(
                    "service is draining for shutdown", reason="draining",
                    tenant=req.tenant)
            if len(self._items) >= self.max_depth:
                raise ServiceOverloadError(
                    f"request queue full ({self.max_depth})",
                    reason="queue_full", tenant=req.tenant,
                    queue_depth=len(self._items))
            self._items.append(req)
            self._depth_gauge.set(len(self._items))
            self._cond.notify()

    def take(self, timeout: Optional[float] = None):
        """Pop the oldest request, blocking up to ``timeout`` seconds.
        Returns None on timeout or when closed-and-empty."""
        deadline = None if timeout is None else _now() + timeout
        with self._cond:
            while not self._items:
                if self._closed:
                    return None
                remaining = (None if deadline is None
                             else deadline - _now())
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            req = self._items.pop(0)
            self._depth_gauge.set(len(self._items))
            return req

    def take_matching(self, batch_key, limit: int) -> list:
        """Pop up to ``limit`` queued requests whose ``batch_key``
        matches — the coalescing scan. Non-blocking; preserves FIFO
        order among both taken and left-behind requests."""
        out: list = []
        with self._cond:
            kept = []
            for req in self._items:
                if len(out) < limit and req.batch_key == batch_key:
                    out.append(req)
                else:
                    kept.append(req)
            self._items = kept
            self._depth_gauge.set(len(self._items))
        return out

    def close(self) -> None:
        """Stop accepting; wake any blocked taker. Queued requests stay
        takeable (graceful drain processes them)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def drain_pending(self) -> list:
        """Remove and return everything still queued (shutdown
        without drain sheds them)."""
        with self._cond:
            items, self._items = self._items, []
            self._depth_gauge.set(0)
            return items
