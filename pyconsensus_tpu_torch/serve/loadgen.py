"""Closed- and open-loop load generator for the consensus service and
the fleet (``pyconsensus_tpu/serve/loadgen.py``; the serve command line
drives it, ``python -m pyconsensus_tpu_torch.serve.loadgen`` runs it on
one service).

Closed loop: ``concurrency`` workers each keep exactly one request in
flight, the steady-state throughput probe (offered load adapts to
service speed, so the numbers measure the pipeline, not a backlog). Open
loop: requests arrive on a fixed schedule regardless of completions, the
overload probe (offered load is the independent variable, so shed rates
mean something); a :class:`RateTrace` varies the rate by segment.

With ``slo=`` an ``obs.SloMonitor`` samples on a background thread for
the run, and its ``summary()`` (the windowed rates, quantiles, targets
and violation seconds) lands in the stats under ``"slo"``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

__all__ = ["LoadGenerator", "RateTrace", "summarize",
           "mean_batch_occupancy", "device_block", "kernel_path_block",
           "quantile", "RETRYABLE_CODES"]


class RateTrace:
    """A trace-driven open-loop arrival schedule:
    piecewise-constant rate segments ``[[duration_s, rps], ...]``,
    loadable from JSON, with the two canonical shapes the elastic-fleet
    work needs as constructors — a smooth :meth:`diurnal` cycle (does
    the loop track a slow swing without flapping?) and a
    :meth:`flash_crowd` step (does it absorb a synchronized storm and
    then give the capacity back?).

    The ARRIVAL SCHEDULE is a pure function of the segments — two runs
    of the same trace offer identical load at identical offsets; all
    remaining run-to-run variation comes from the generator's seeded
    matrix corpus and the service itself. That is what makes
    elastic-vs-static comparisons and chaos runs reproducible."""

    def __init__(self, segments) -> None:
        self.segments = []
        for seg in segments:
            dur, rps = float(seg[0]), float(seg[1])
            if dur <= 0 or rps < 0:
                raise ValueError(
                    f"trace segment needs duration_s > 0 and rps >= 0, "
                    f"got {seg!r}")
            self.segments.append((dur, rps))
        if not self.segments:
            raise ValueError("a rate trace needs at least one segment")

    # -- canonical shapes ----------------------------------------------

    @classmethod
    def diurnal(cls, base_rps: float, peak_rps: float,
                period_s: float, steps: int = 8) -> "RateTrace":
        """One sinusoidal day quantized to ``steps`` flat segments:
        base at the trough, ``peak_rps`` at the crest."""
        import math as _math

        mid = (float(base_rps) + float(peak_rps)) / 2.0
        amp = (float(peak_rps) - float(base_rps)) / 2.0
        dur = float(period_s) / int(steps)
        return cls([(dur,
                     mid + amp * _math.sin(2 * _math.pi * (i + 0.5)
                                           / steps - _math.pi / 2))
                    for i in range(int(steps))])

    @classmethod
    def flash_crowd(cls, base_rps: float, burst_rps: float,
                    warm_s: float, burst_s: float,
                    cool_s: float) -> "RateTrace":
        """Steady base load, a synchronized storm, then quiet — the
        cartel-burst shape of a chaos run."""
        return cls([(warm_s, base_rps), (burst_s, burst_rps),
                    (cool_s, base_rps)])

    # -- JSON round-trip -----------------------------------------------

    @classmethod
    def from_json(cls, source) -> "RateTrace":
        """Load from a JSON text or a path to one. Accepts the bare
        segment list or ``{"segments": [...]}``."""
        import json as _json
        import os as _os

        text = source
        if isinstance(source, (bytes, str)) and _os.path.exists(source):
            with open(source, "r", encoding="utf-8") as fh:
                text = fh.read()
        data = _json.loads(text)
        if isinstance(data, dict):
            data = data["segments"]
        return cls(data)

    def to_json(self) -> str:
        import json as _json

        return _json.dumps({"segments": [[d, r]
                                         for d, r in self.segments]})

    # -- the schedule --------------------------------------------------

    @property
    def duration_s(self) -> float:
        return sum(d for d, _ in self.segments)

    @property
    def n_requests(self) -> int:
        return sum(int(round(d * r)) for d, r in self.segments)

    def arrivals(self):
        """The deterministic arrival offsets (seconds from trace
        start), evenly spaced within each segment."""
        out, t = [], 0.0
        for dur, rps in self.segments:
            n = int(round(dur * rps))
            for i in range(n):
                out.append(t + i / rps)
            t += dur
        return out

    def describe(self) -> dict:
        """JSON-ready shape summary for loadgen artifacts."""
        return {"segments": [[round(d, 3), round(r, 3)]
                             for d, r in self.segments],
                "duration_s": round(self.duration_s, 3),
                "requests": self.n_requests,
                "peak_rps": round(max(r for _, r in self.segments), 3)}


def kernel_path_block(snapshot=None):
    """Dispatch counts by kernel family, the
    ``pyconsensus_kernel_path_total`` breakdown of ``snapshot`` (None:
    this process's registry; a fleet's merged snapshot sums its
    workers') ({} before any counted dispatch; ``cuda`` counts the
    ``bucket_cuda`` class and the fused resolutions, ``plain`` the padded
    buckets). The one copy of the registry extraction, shared by the
    command-line summaries."""
    import json as _json

    from .. import obs

    if snapshot is None:
        snapshot = obs.REGISTRY.snapshot()
    series = snapshot.get(
        "pyconsensus_kernel_path_total", {}).get("series", {})
    out = {}
    for skey, v in series.items():
        labels = _json.loads(skey) if skey else {}
        path = labels.get("path", "?")
        out[path] = out.get(path, 0) + int(v)
    return out


def device_block(service) -> dict:
    """The mesh-interpretability columns of a serve summary: how many
    devices the serving mesh spans and the mean co-batched occupancy PER
    DEVICE LANE SLOT (with the lane axis split over the mesh's batch
    dimension, a dispatch occupying all 8 lanes of a 2x4 mesh runs 4
    requests per event group). A fleet has no mesh: one device, its
    workers' mean occupancy."""
    from ..parallel.mesh import mesh_shape

    n = getattr(service, "n_devices", 1)
    n_batch = mesh_shape(getattr(service, "mesh", None))[0]
    occ = mean_batch_occupancy()
    return {
        "n_devices": int(n),
        "mesh_batch_lanes": n_batch,
        "per_device_occupancy": (None if occ is None
                                 else round(occ / n_batch, 3)),
    }


def mean_batch_occupancy():
    """Mean requests per bucketed dispatch since the last ``obs.reset``
    (None before any dispatch) — read from the
    ``pyconsensus_serve_batch_occupancy`` histogram. The ONE copy of
    the registry-schema-dependent extraction, shared by the CLI
    summaries."""
    from .. import obs

    series = obs.REGISTRY.snapshot().get(
        "pyconsensus_serve_batch_occupancy", {}).get("series", {})
    if not series:
        return None
    ser = next(iter(series.values()))
    return ser["sum"] / ser["count"] if ser["count"] else None


def quantile(sorted_vals, q: float):
    """Nearest-rank quantile of an ALREADY-SORTED sequence (None when
    empty), the one latency-quantile definition of the summaries."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def summarize(latencies, errors, wall_s: float, n_requests: int,
              retried: int = 0, abandoned: int = 0) -> dict:
    """The shared stats block: throughput + latency quantiles + error
    counts (stable keys, the reference's), plus the client-retry
    accounting: ``retried`` counts
    retry ATTEMPTS issued after honest ``retry_after_s`` sheds,
    ``abandoned`` counts requests that exhausted their retry budget on
    retryable errors — the number that is actually client-visible loss
    in a fleet chaos run (a shed that a bounded retry absorbed is not
    loss)."""
    lat = sorted(latencies)
    return {
        "requests": int(n_requests),
        "succeeded": len(lat),
        "failed": int(sum(errors.values())),
        "errors": dict(errors),
        "retried": int(retried),
        "abandoned": int(abandoned),
        "wall_s": round(wall_s, 4),
        "throughput_rps": round(len(lat) / wall_s, 4) if wall_s > 0 else None,
        "latency_p50_ms": (None if not lat
                           else round(1e3 * quantile(lat, 0.50), 3)),
        "latency_p99_ms": (None if not lat
                           else round(1e3 * quantile(lat, 0.99), 3)),
        "latency_max_ms": (None if not lat
                           else round(1e3 * lat[-1], 3)),
    }


#: error codes a polite client retries: load-policy sheds (PYC401) and
#: the fleet's transient worker-loss family (PYC501 worker lost, PYC502
#: failover in progress). PYC503 (no placeable worker) is deliberately
#: absent — retrying an empty fleet cannot succeed.
RETRYABLE_CODES = ("PYC401", "PYC501", "PYC502")


class LoadGenerator:
    """Drives a :class:`~pyconsensus_tpu_torch.serve.ConsensusService`
    (or a :class:`~pyconsensus_tpu_torch.serve.fleet.ConsensusFleet`: the
    same ``submit(reports=..., tenant=...)`` surface).

    Parameters
    ----------
    service : ConsensusService or ConsensusFleet
    shapes : sequence of (R, E)
        Request shapes, cycled per request (>= 2 distinct bucket targets
        exercise the cache the way real mixed traffic does).
    na_frac : float
        NaN non-report fraction of the synthetic matrices.
    seed : int
        Matrix-corpus seed — the corpus is generated once up front so
        generation cost never pollutes the latency numbers. Also seeds
        the deterministic retry jitter.
    oracle_kwargs : dict
        Forwarded to every ``submit`` (algorithm, iterations, ...).
    max_retries : int
        Bounded client-retry budget per request on RETRYABLE sheds
        (``RETRYABLE_CODES`` — PYC401/PYC501/PYC502). Each retry waits
        the shed's honest ``retry_after_s`` hint, floored by the
        deterministic jittered backoff of ``faults.retry`` (keyed on
        ``(seed, request, attempt)`` — reproducible runs, decorrelated
        clients) and capped at ``retry_cap_s``. 0 disables retries.
    retry_cap_s : float
        Upper bound of any single retry wait — the budget stays bounded
        even against a pathological hint.
    slo : obs.SloMonitor, optional
        A windowed SLO monitor sampled on a background thread for the
        duration of the run; its ``summary()`` lands in the stats dict
        under ``"slo"``.
    """

    def __init__(self, service, shapes=((12, 48), (24, 96)),
                 na_frac: float = 0.1, seed: int = 0,
                 tenant: str = "loadgen", oracle_kwargs=None,
                 max_retries: int = 0, retry_cap_s: float = 2.0,
                 slo=None) -> None:
        self.service = service
        self.slo = slo
        self.shapes = [tuple(s) for s in shapes]
        self.tenant = tenant
        self.oracle_kwargs = dict(oracle_kwargs or {})
        self.max_retries = int(max_retries)
        self.retry_cap_s = float(retry_cap_s)
        self.seed = int(seed)
        rng = np.random.default_rng(seed)
        self._corpus = []
        for R, E in self.shapes:
            m = rng.choice([0.0, 1.0], size=(R, E))
            if na_frac > 0:
                m[rng.random((R, E)) < na_frac] = np.nan
            self._corpus.append(m)

    def _submit(self, i: int):
        return self.service.submit(
            reports=self._corpus[i % len(self._corpus)],
            tenant=self.tenant, **self.oracle_kwargs)

    def _retry_delay(self, exc, i: int, attempt: int) -> float:
        """One bounded retry wait: honor the shed's honest
        ``retry_after_s`` (retrying earlier would just be refused
        again), floored by the deterministic jittered backoff so a
        thousand shed clients do not stampede back in lockstep."""
        from ..faults.retry import _sleep_for

        hint = 0.0
        ctx = getattr(exc, "context", None)
        if isinstance(ctx, dict):
            try:
                hint = float(ctx.get("retry_after_s") or 0.0)
            except (TypeError, ValueError):
                hint = 0.0
        jitter = _sleep_for(attempt, 0.02, self.retry_cap_s,
                            self.seed, f"req{i}")
        return min(self.retry_cap_s, max(hint, jitter))

    def _one_request(self, i: int, timeout_s: float,
                     first_error=None) -> tuple:
        """Issue request ``i`` with the bounded retry policy. Returns
        ``(latency_or_None, error_name_or_None, retried, abandoned)``.
        ``first_error`` seeds the loop with an already-observed failure
        (the open-loop deferral path)."""
        attempt, retried = 0, 0
        t0 = time.monotonic()
        exc = first_error
        while True:
            if exc is None:
                try:
                    fut = self._submit(i)
                    fut.result(timeout=timeout_s)
                    return time.monotonic() - t0, None, retried, 0
                except Exception as e:  # noqa: BLE001 — tallied below
                    exc = e
            code = getattr(exc, "error_code", None)
            name = code or type(exc).__name__
            if code not in RETRYABLE_CODES:
                return None, name, retried, 0
            if attempt >= self.max_retries:
                return (None, name, retried,
                        1 if self.max_retries > 0 else 0)
            time.sleep(self._retry_delay(exc, i, attempt))
            attempt += 1
            retried += 1
            exc = None

    # -- closed loop ----------------------------------------------------

    def run_closed(self, n_requests: int, concurrency: int = 8,
                   timeout_s: float = 120.0) -> dict:
        """``concurrency`` workers, one request in flight each, until
        ``n_requests`` have been issued. Returns the summary dict."""
        lock = threading.Lock()
        counter = [0]
        latencies: list = []
        errors: dict = {}
        tallies = {"retried": 0, "abandoned": 0}

        def worker():
            while True:
                with lock:
                    if counter[0] >= n_requests:
                        return
                    i = counter[0]
                    counter[0] += 1
                lat, err, retried, abandoned = self._one_request(
                    i, timeout_s)
                with lock:
                    tallies["retried"] += retried
                    tallies["abandoned"] += abandoned
                    if err is not None:
                        errors[err] = errors.get(err, 0) + 1
                    else:
                        latencies.append(lat)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(1, concurrency))]
        self._slo_start()
        t0 = time.monotonic()
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            self._slo_stop()
        stats = summarize(latencies, errors, time.monotonic() - t0,
                          n_requests, **tallies)
        return self._with_slo(stats)

    # -- the SLO monitor ------------------------------------------------

    def _slo_start(self) -> None:
        if self.slo is not None:
            self.slo.run_in_thread()

    def _slo_stop(self) -> None:
        if self.slo is not None:
            self.slo.stop()

    def _with_slo(self, stats: dict) -> dict:
        if self.slo is not None:
            stats["slo"] = self.slo.summary()
        return stats

    # -- open loop ------------------------------------------------------

    def run_open(self, n_requests: int, rate_rps: float,
                 timeout_s: float = 120.0) -> dict:
        """Fixed-schedule arrivals at ``rate_rps`` regardless of
        completions — admission errors (``ServiceOverloadError``) are
        tallied per error code, which is the point of the probe. With a
        retry budget, retryable failures are DEFERRED past the arrival
        schedule (an inline retry would stall the fixed-rate clock that
        makes offered load the independent variable) and retried
        sequentially in the drain phase."""
        if rate_rps <= 0:
            raise ValueError("rate_rps must be positive")
        latencies: list = []
        errors: dict = {}
        futures: list = []
        deferred: list = []            # (i, first exception)
        tallies = {"retried": 0, "abandoned": 0}

        def tally(err, lat, retried=0, abandoned=0):
            tallies["retried"] += retried
            tallies["abandoned"] += abandoned
            if err is not None:
                errors[err] = errors.get(err, 0) + 1
            else:
                latencies.append(lat)

        interval = 1.0 / rate_rps
        self._slo_start()
        t0 = time.monotonic()
        for i in range(n_requests):
            target = t0 + i * interval
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            start = time.monotonic()
            try:
                fut = self._submit(i)
            except Exception as exc:  # noqa: BLE001 — shed at admission
                code = getattr(exc, "error_code", None)
                if self.max_retries > 0 and code in RETRYABLE_CODES:
                    deferred.append((i, exc))
                else:
                    tally(code or type(exc).__name__, None)
                continue
            futures.append((i, start, fut))
        for i, start, fut in futures:
            try:
                fut.result(timeout=timeout_s)
            except Exception as exc:  # noqa: BLE001
                code = getattr(exc, "error_code", None)
                if self.max_retries > 0 and code in RETRYABLE_CODES:
                    deferred.append((i, exc))
                else:
                    tally(code or type(exc).__name__, None)
            else:
                tally(None, time.monotonic() - start)
        for i, exc in deferred:
            lat, err, retried, abandoned = self._one_request(
                i, timeout_s, first_error=exc)
            tally(err, lat, retried, abandoned)
        self._slo_stop()
        stats = summarize(latencies, errors, time.monotonic() - t0,
                          n_requests, **tallies)
        return self._with_slo(stats)

    # -- trace-driven open loop -----------------------------------------

    def run_trace(self, trace: "RateTrace",
                  timeout_s: float = 120.0) -> dict:
        """Open-loop arrivals on a :class:`RateTrace` schedule — the
        elastic-fleet probe. Identical semantics to
        :meth:`run_open` (fixed schedule, sheds tallied, retryable
        failures deferred to a sequential drain phase) except the
        offered rate varies by segment, so a run can carry a diurnal
        swing or a flash crowd through an autoscaled fleet. The trace
        shape lands in the stats under ``"trace"``."""
        offsets = trace.arrivals()
        latencies: list = []
        errors: dict = {}
        futures: list = []
        deferred: list = []
        tallies = {"retried": 0, "abandoned": 0}

        def tally(err, lat, retried=0, abandoned=0):
            tallies["retried"] += retried
            tallies["abandoned"] += abandoned
            if err is not None:
                errors[err] = errors.get(err, 0) + 1
            else:
                latencies.append(lat)

        self._slo_start()
        t0 = time.monotonic()
        for i, offset in enumerate(offsets):
            delay = (t0 + offset) - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            start = time.monotonic()
            try:
                fut = self._submit(i)
            except Exception as exc:  # noqa: BLE001 — shed at admission
                code = getattr(exc, "error_code", None)
                if self.max_retries > 0 and code in RETRYABLE_CODES:
                    deferred.append((i, exc))
                else:
                    tally(code or type(exc).__name__, None)
                continue
            futures.append((i, start, fut))
        for i, start, fut in futures:
            try:
                fut.result(timeout=timeout_s)
            except Exception as exc:  # noqa: BLE001
                code = getattr(exc, "error_code", None)
                if self.max_retries > 0 and code in RETRYABLE_CODES:
                    deferred.append((i, exc))
                else:
                    tally(code or type(exc).__name__, None)
            else:
                tally(None, time.monotonic() - start)
        for i, exc in deferred:
            lat, err, retried, abandoned = self._one_request(
                i, timeout_s, first_error=exc)
            tally(err, lat, retried, abandoned)
        self._slo_stop()
        stats = summarize(latencies, errors, time.monotonic() - t0,
                          len(offsets), **tallies)
        stats["trace"] = trace.describe()
        return self._with_slo(stats)


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from .service import ConsensusService, ServeConfig

    ap = argparse.ArgumentParser(
        description="load-generate an in-process consensus service")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the service's device (the card by default)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--concurrency", type=int, default=8,
                    help="closed-loop workers (ignored with --rate)")
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop arrival rate (req/s); omit for "
                         "closed loop")
    ap.add_argument("--trace", default=None,
                    help="trace-driven open loop: a JSON rate trace "
                         "(path or literal; [[duration_s, rps], ...]) "
                         "— overrides --rate/--requests")
    ap.add_argument("--shapes", default="12x48,24x96",
                    help="comma-separated RxE request shapes")
    ap.add_argument("--na-frac", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--retries", type=int, default=0,
                    help="bounded client retries on PYC401/PYC5xx sheds "
                         "(honoring retry_after_s; 0 disables)")
    ap.add_argument("--no-warmup", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available; pass "
                 "--device cpu to run on the CPU")

    shapes = [tuple(int(x) for x in s.split("x"))
              for s in args.shapes.split(",")]
    cfg = ServeConfig(batch_window_ms=args.window_ms,
                      max_batch=args.max_batch)
    svc = ConsensusService(cfg, device=args.device)
    gen = LoadGenerator(svc, shapes=shapes, na_frac=args.na_frac,
                        seed=args.seed, max_retries=args.retries)
    if not args.no_warmup:
        svc.warm_buckets(svc.buckets_for(shapes))
    svc.start(warmup=False)
    if args.trace:
        stats = gen.run_trace(RateTrace.from_json(args.trace))
    elif args.rate:
        stats = gen.run_open(args.requests, args.rate)
    else:
        stats = gen.run_closed(args.requests, args.concurrency)
    svc.close(drain=True)
    stats.update(device_block(svc))
    stats["kernel_paths"] = kernel_path_block() or None
    # sort_keys: two identical runs print identical key orders
    print(json.dumps(stats, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
