"""Windowed SLO monitor (``pyconsensus_tpu/obs/slo.py``, copied: the
window math is host Python over registry snapshots).

The metrics registry is cumulative — counters only ever grow — but an
SLO ("p99 under 50 ms", "shed ratio under 1%") is a statement about a
recent *window*, and the autoscaler (``serve/autoscale.py``) needs
exactly that windowed signal. :class:`SloMonitor` keeps a bounded ring
of registry samples and differences them:

- **windowed request rate** (req/s) and **shed ratio** from the
  ``pyconsensus_serve_requests_total`` / ``pyconsensus_serve_shed_total``
  counter deltas;
- **p50/p99 latency** from the ``pyconsensus_serve_request_seconds``
  histogram's *bucket-count deltas* over the window (the cumulative
  histogram would average in every request since process start);
- **queue depth** from the ``pyconsensus_serve_queue_depth`` gauge.

Targets are declarative (``ServeConfig.slo_*`` fields, or a plain dict);
every second the window spends in violation of a target accumulates into
``pyconsensus_slo_violation_seconds{slo=<target>}`` — the accounting
counter the autoscaler consumes.

The monitor reads *snapshots*, not live metric objects, so the same
window math runs over the local registry, a fleet's merged cluster view
(``ConsensusFleet.merged_snapshot``), or hand-built fixtures in tests.
``sample(now=...)`` takes an explicit clock for deterministic fixtures;
production sampling uses ``time.monotonic`` (the summary is
serialized with ``sort_keys=True`` and never digested).
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["SloMonitor", "quantile_from_counts", "targets_from_config",
           "TARGET_KEYS"]

#: recognized target names — ``slo_violation_seconds``' label vocabulary
TARGET_KEYS = ("p50_ms", "p99_ms", "shed_ratio", "queue_depth")


def quantile_from_counts(edges: List[float], counts: List[int],
                         q: float) -> Optional[float]:
    """Nearest-rank quantile over cumulative histogram buckets: the
    upper edge of the bucket where the rank lands (``+Inf`` for the
    overflow bucket, ``None`` for an empty window) — the conservative
    read (a true p99 is never above the reported edge's bound)."""
    total = sum(int(c) for c in counts)
    if total <= 0:
        return None
    rank = max(1, math.ceil(q * total))
    cum = 0
    for i, c in enumerate(counts):
        cum += int(c)
        if cum >= rank:
            return float(edges[i]) if i < len(edges) else math.inf
    return math.inf


def targets_from_config(cfg) -> Dict[str, float]:
    """Extract the declarative SLO targets from a ``ServeConfig`` (its
    ``slo_p50_ms``/``slo_p99_ms``/``slo_shed_ratio``/``slo_queue_depth``
    fields; 0 = target disabled). Returns ``{}`` when no SLO is
    declared, so callers can gate the monitor on truthiness."""
    out: Dict[str, float] = {}
    for key in TARGET_KEYS:
        v = getattr(cfg, "slo_" + key, 0.0)
        if v:
            out[key] = float(v)
    return out


def _counter_series(snap: dict, name: str) -> Dict[str, float]:
    """Per-series counter values — the window math differences each
    labeled series independently: a worker joining or
    leaving mid-window must not bend the cluster-wide delta."""
    entry = snap.get(name)
    if not entry:
        return {}
    series = entry.get("series") or {}
    return {k: float(series[k]) for k in series}


def _delta_counter(first: Dict[str, float],
                   last: Dict[str, float]) -> float:
    """Windowed counter delta, summed over per-series deltas:

    - series present in both samples: ``last - first``, and a NEGATIVE
      per-series delta means the series' process restarted (counter
      reset to 0) — charge ``last`` (requests since the reset), the
      Prometheus ``rate()`` convention;
    - series born inside the window (absent from ``first``): the whole
      cumulative value is window-local (a fresh worker's counters start
      at 0 when it joins) — charge ``last``;
    - series gone by ``last`` (worker drained/died): contributes 0 —
      conservative, never negative, never a phantom rate.
    """
    d = 0.0
    # sorted: float accumulation order must not depend on dict order
    for k in sorted(last):
        cur = float(last[k])
        step = cur - float(first.get(k, 0.0))
        d += cur if step < 0 else step
    return d


def _last_gauge(snap: dict, name: str) -> Optional[float]:
    entry = snap.get(name)
    if not entry:
        return None
    series = entry.get("series") or {}
    if not series:
        return None
    # gauges in a merged cluster snapshot are per-worker — depth is the
    # cluster total
    return float(sum(float(series[k]) for k in sorted(series)))


def _hist_series(snap: dict, name: str):
    """(edges, per-series bucket counts) of a histogram snapshot entry.
    Series stay separate until the WINDOW delta is taken — collapsing
    first would let a disappearing series (worker drain/death) drive
    bucket deltas negative."""
    entry = snap.get(name)
    if not entry:
        return None, None
    edges = entry.get("edges")
    series = entry.get("series") or {}
    if edges is None or not series:
        return None, None
    n = len(edges) + 1
    out: Dict[str, List[int]] = {}
    for k in series:
        counts = series[k].get("counts")
        if not counts or len(counts) != n:
            continue
        out[k] = [int(c) for c in counts]
    return list(edges), (out or None)


def _delta_hist(first: Optional[Dict[str, List[int]]],
                last: Dict[str, List[int]], n: int) -> List[int]:
    """Windowed bucket-count deltas, per series then summed — the same
    membership rules as :func:`_delta_counter` (born-inside-window
    series charge their full counts; a reset series charges its
    post-reset counts; a vanished series charges nothing)."""
    total = [0] * n
    first = first or {}
    for k in sorted(last):
        cur = last[k]
        prev = first.get(k)
        if prev is None or len(prev) != len(cur) or any(
                int(b) < int(a) for a, b in zip(prev, cur)):
            delta = [int(c) for c in cur]
        else:
            delta = [int(b) - int(a) for a, b in zip(prev, cur)]
        for i, c in enumerate(delta):
            total[i] += c
    return total


class SloMonitor:
    """Ring-buffer time-series over registry snapshots with declarative
    targets. Thread-safe; :meth:`run_in_thread` starts the production
    sampler, tests drive :meth:`sample` with explicit clocks."""

    def __init__(self, targets: Optional[Dict[str, float]] = None,
                 window_s: float = 10.0,
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 max_samples: int = 4096,
                 latency_metric: str =
                 "pyconsensus_serve_request_seconds") -> None:
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        unknown = sorted(set(targets or ()) - set(TARGET_KEYS))
        if unknown:
            raise ValueError(f"unknown SLO target(s) {unknown}; "
                             f"known: {TARGET_KEYS}")
        self.targets = dict(targets or {})
        self.window_s = float(window_s)
        self.latency_metric = latency_metric
        self._snapshot_fn = snapshot_fn
        self._samples: "collections.deque[dict]" = collections.deque(
            maxlen=int(max_samples))
        self._violation_s: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _snapshot(self) -> dict:
        if self._snapshot_fn is not None:
            return self._snapshot_fn()
        from . import REGISTRY                  # late: obs exports slo

        return REGISTRY.snapshot()

    # -- sampling ----------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> dict:
        """Take one registry sample, update the windowed view, and charge
        any violated target's ``slo_violation_seconds`` with the time
        since the previous sample. Returns the current window summary."""
        t = time.monotonic() if now is None else float(now)
        snap = self._snapshot()
        edges, counts = _hist_series(snap, self.latency_metric)
        rec = {
            "t": t,
            "requests": _counter_series(
                snap, "pyconsensus_serve_requests_total"),
            "shed": _counter_series(
                snap, "pyconsensus_serve_shed_total"),
            "queue_depth": _last_gauge(
                snap, "pyconsensus_serve_queue_depth"),
            "edges": edges,
            "counts": counts,
        }
        with self._lock:
            prev_t = self._samples[-1]["t"] if self._samples else None
            self._samples.append(rec)
            win = self._window_locked()
            if prev_t is not None and t > prev_t:
                self._charge_locked(win, t - prev_t)
        return win

    def _charge_locked(self, win: dict, dt: float) -> None:
        violated = []
        for key in TARGET_KEYS:
            target = self.targets.get(key)
            if not target:
                continue
            observed = win.get(key)
            if observed is None:
                continue
            if float(observed) > float(target):
                violated.append(key)
        if not violated:
            return
        from . import counter                   # late: obs exports slo

        c = counter("pyconsensus_slo_violation_seconds",
                    "cumulative seconds the windowed view spent in "
                    "violation of a declared SLO target (the "
                    "autoscaler's signal)", labels=("slo",))
        for key in violated:
            self._violation_s[key] = self._violation_s.get(key, 0.0) + dt
            c.inc(dt, slo=key)

    # -- windowed view -----------------------------------------------------

    def _window_locked(self) -> dict:
        if not self._samples:
            return {"samples": 0}
        last = self._samples[-1]
        first = last
        for rec in self._samples:       # deque is time-ordered
            if rec["t"] >= last["t"] - self.window_s:
                first = rec
                break
        dt = last["t"] - first["t"]
        single = first is last
        d_req = 0.0 if single else _delta_counter(
            first["requests"], last["requests"])
        d_shed = 0.0 if single else _delta_counter(
            first["shed"], last["shed"])
        out: dict = {
            "samples": len(self._samples),
            "window_s": round(min(self.window_s, max(dt, 0.0)), 3),
            "request_rate_rps": round(d_req / dt, 3) if dt > 0 else None,
            "shed_ratio": round(d_shed / d_req, 4) if d_req > 0 else
            (1.0 if d_shed > 0 else None),
            "queue_depth": last["queue_depth"],
            "p50_ms": None,
            "p99_ms": None,
        }
        if last["counts"] is not None:
            if (not single and last["edges"] == first["edges"]):
                # per-series bucket deltas: a series born inside the
                # window (new worker, or a latency metric the earliest
                # sample predates) charges its full — window-local —
                # counts; a vanished or reset series never drives a
                # bucket delta negative
                delta = _delta_hist(first["counts"], last["counts"],
                                    len(last["edges"]) + 1)
            else:
                # a single sample or a changed bucket layout: the
                # cumulative distribution is the best available read —
                # better than reporting nothing
                delta = _delta_hist(None, last["counts"],
                                    len(last["edges"]) + 1)
            for q, key in ((0.50, "p50_ms"), (0.99, "p99_ms")):
                v = quantile_from_counts(last["edges"], delta, q)
                if v is not None:
                    out[key] = round(v * 1e3, 3) if v != math.inf \
                        else math.inf
        return out

    def window(self) -> dict:
        """The current windowed view (no sampling side effects)."""
        with self._lock:
            return self._window_locked()

    def summary(self) -> dict:
        """JSON-ready block for the loadgen summary and the serve CLI:
        the windowed view plus declared targets and accumulated
        per-target violation seconds."""
        with self._lock:
            win = self._window_locked()
            win["targets"] = {k: self.targets[k]
                              for k in sorted(self.targets)}
            win["violation_s"] = {
                k: round(self._violation_s[k], 3)
                for k in sorted(self._violation_s)}
            if win["p99_ms"] == math.inf:       # JSON has no Infinity
                win["p99_ms"] = "overflow"
            if win["p50_ms"] == math.inf:
                win["p50_ms"] = "overflow"
            return win

    # -- production sampler ------------------------------------------------

    def run_in_thread(self, interval_s: float = 0.25) -> "SloMonitor":
        """Start the daemon sampling loop (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, args=(float(interval_s),),
                name="slo-monitor", daemon=True)
            self._thread.start()
        return self

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.sample()
            except Exception:           # noqa: BLE001 — telemetry must
                pass                    # never take the service down

    def stop(self) -> None:
        """Stop the sampler thread and take one final sample."""
        with self._lock:
            th, self._thread = self._thread, None
        if th is None:
            return
        self._stop.set()
        th.join(timeout=5.0)
        try:
            self.sample()
        except Exception:               # noqa: BLE001
            pass
