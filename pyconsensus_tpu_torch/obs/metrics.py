"""Metrics registry: Prometheus-style counters, gauges, and fixed-bucket
histograms with labeled series (a copy of ``pyconsensus_tpu/obs/
metrics.py``, which is backend-neutral).

Design constraints, in order:

- **zero dependencies** — plain stdlib; the Prometheus *text exposition
  format* is emitted (``MetricsRegistry.render_prom``), not the client
  library wire protocol, so nothing needs to be installed to scrape a
  file written from it;
- **host-side only** — metric mutation is Python dict arithmetic on host
  values; an emission site never reads a device tensor (that would be a
  host sync the resolution does not otherwise pay);
- **cheap enough to leave on** — one lock acquire + dict update per
  emission; no I/O until a sink is rendered. There is deliberately no
  global on/off switch: conditional telemetry rots, and every call site
  here is O(R)-or-smaller host work per *resolution* (never per element).

Metric names and labels are the JAX package's, so one dashboard reads
both; a label value that names an implementation takes the port's name
(the kernel family ``cuda``, the plain path ``plain``, the backend
``torch``). Names follow Prometheus conventions (``_total`` counters,
``_seconds`` durations, base units).
"""

from __future__ import annotations

import json
import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DURATION_BUCKETS", "ITERATION_BUCKETS", "MAGNITUDE_BUCKETS"]

#: span/phase durations, seconds — log-ish spacing from sub-ms host work
#: to the minutes a cold multi-chip compile can take
DURATION_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
#: reputation-redistribution iteration counts (Fibonacci-ish — the loop
#: converges geometrically, so resolution at the low end matters most)
ITERATION_BUCKETS = (1.0, 2.0, 3.0, 4.0, 5.0, 8.0, 13.0, 21.0, 34.0)
#: reputation-mass / residual magnitudes (dimensionless, [0, 1] mass)
MAGNITUDE_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.05, 0.1, 0.25, 0.5,
                     1.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label(value: str) -> str:
    """Prometheus text-format label-value escaping (backslash first)."""
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(v: float) -> str:
    """Float rendering matching Prometheus text conventions: integers
    without a trailing .0, +Inf spelled that way."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:                              # NaN
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared series bookkeeping: one value slot per label-value tuple.

    ``label_names`` is fixed at registration; every emission must supply
    exactly those labels (a typo'd label name is a programming error worth
    raising on, not a series silently split in two).
    """

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = ()) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._series: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name} declared labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[ln]) for ln in self.label_names)

    def _series_name(self, key: Tuple[str, ...],
                     extra: Sequence[Tuple[str, str]] = ()) -> str:
        pairs = list(zip(self.label_names, key)) + list(extra)
        if not pairs:
            return self.name
        body = ",".join(f'{ln}="{_escape_label(lv)}"' for ln, lv in pairs)
        return f"{self.name}{{{body}}}"

    def series(self) -> Dict[Tuple[str, ...], object]:
        with self._lock:
            return dict(self._series)


class Counter(_Metric):
    """Monotonically-increasing accumulator (``inc`` only)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {amount})")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def render(self) -> List[str]:
        with self._lock:
            return [f"{self._series_name(k)} {_fmt(v)}"
                    for k, v in sorted(self._series.items())]


class Gauge(_Metric):
    """Set-to-current-value metric (last write wins)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels) -> Optional[float]:
        key = self._key(labels)
        with self._lock:
            v = self._series.get(key)
            return None if v is None else float(v)

    def render(self) -> List[str]:
        with self._lock:
            return [f"{self._series_name(k)} {_fmt(v)}"
                    for k, v in sorted(self._series.items())]


class Histogram(_Metric):
    """Fixed-bucket histogram: cumulative ``le`` buckets plus ``_sum`` /
    ``_count``, per labeled series — the Prometheus histogram model. The
    bucket edges are fixed at registration (upper bounds, ascending; an
    implicit ``+Inf`` bucket is always appended), so ``observe`` is one
    bisect + three adds and exposition needs no re-aggregation."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DURATION_BUCKETS) -> None:
        super().__init__(name, help, label_names)
        edges = tuple(float(b) for b in buckets)
        if not edges:
            raise ValueError(f"histogram {self.name} needs >= 1 bucket edge")
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram {self.name} bucket edges must be "
                             f"strictly ascending, got {edges}")
        if edges[-1] == math.inf:           # +Inf is implicit
            edges = edges[:-1]
        self.buckets = edges

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        key = self._key(labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = {"counts": [0] * (len(self.buckets) + 1),
                      "sum": 0.0, "count": 0}
                self._series[key] = st
            i = 0
            for i, edge in enumerate(self.buckets):   # noqa: B007
                if v <= edge:
                    break
            else:
                i = len(self.buckets)
            st["counts"][i] += 1
            st["sum"] += v
            st["count"] += 1

    def value(self, **labels) -> Optional[dict]:
        key = self._key(labels)
        with self._lock:
            st = self._series.get(key)
            return None if st is None else {"sum": st["sum"],
                                            "count": st["count"]}

    def absorb(self, counts: Sequence[int], sum: float, count: int,
               **labels) -> None:
        """Fold an already-bucketed series (another registry's snapshot)
        into this one, the merge primitive of the fleet's metric view.
        ``counts`` must match this histogram's bucket layout
        (len(edges) + 1, the trailing +Inf bucket included)."""
        counts = [int(c) for c in counts]
        if len(counts) != len(self.buckets) + 1:
            raise ValueError(
                f"histogram {self.name} has {len(self.buckets) + 1} "
                f"buckets (+Inf included); cannot absorb {len(counts)}")
        key = self._key(labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = {"counts": [0] * (len(self.buckets) + 1),
                      "sum": 0.0, "count": 0}
                self._series[key] = st
            for i, c in enumerate(counts):
                st["counts"][i] += c
            st["sum"] += float(sum)
            st["count"] += int(count)

    def render(self) -> List[str]:
        lines: List[str] = []
        with self._lock:
            for key, st in sorted(self._series.items()):
                cum = 0
                for edge, c in zip(self.buckets, st["counts"]):
                    cum += c
                    lines.append(
                        f"{self._series_name(key, [('le', _fmt(edge))])}"
                        .replace(self.name + "{", self.name + "_bucket{")
                        + f" {cum}")
                cum += st["counts"][-1]
                lines.append(
                    f"{self._series_name(key, [('le', '+Inf')])}"
                    .replace(self.name + "{", self.name + "_bucket{")
                    + f" {cum}")
                base = self._series_name(key)
                if key:
                    lines.append(base.replace(self.name + "{",
                                              self.name + "_sum{")
                                 + f" {_fmt(st['sum'])}")
                    lines.append(base.replace(self.name + "{",
                                              self.name + "_count{")
                                 + f" {st['count']}")
                else:
                    lines.append(f"{self.name}_sum {_fmt(st['sum'])}")
                    lines.append(f"{self.name}_count {st['count']}")
        return lines


class MetricsRegistry:
    """Process-wide named-metric table. ``counter``/``gauge``/``histogram``
    are get-or-create: repeat registration with the same (kind, labels)
    returns the existing metric — library code can declare its metrics at
    the call site without import-order coordination — while a conflicting
    redeclaration raises (two call sites disagreeing about a metric's
    shape is a bug, not a merge)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str,
                       label_names: Sequence[str], **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) \
                        or m.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.label_names}; "
                        f"conflicting redeclaration as {cls.kind} "
                        f"with labels {tuple(label_names)}")
                if "buckets" in kw:
                    # histogram shape includes its edges: a silent merge
                    # of two bucket layouts would pile one call site's
                    # scale into the other's lowest/highest bucket
                    want = tuple(float(b) for b in kw["buckets"])
                    if want and want[-1] == math.inf:
                        want = want[:-1]
                    if m.buckets != want:
                        raise ValueError(
                            f"metric {name!r} already registered with "
                            f"buckets {m.buckets}; conflicting "
                            f"redeclaration with {want}")
                return m
            m = cls(name, help, label_names, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DURATION_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def value(self, name: str, **labels):
        """Convenience lookup for consumers that must *fail soft* when a
        metric was never emitted: returns None for an unknown metric or an
        unseen label combination instead of raising."""
        m = self.get(name)
        if m is None:
            return None
        try:
            return m.value(**labels)
        except ValueError:
            return None

    def render_prom(self) -> str:
        """The full registry in Prometheus text exposition format v0.0.4
        (HELP/TYPE headers + one line per series; histograms expand to
        cumulative ``_bucket``/``_sum``/``_count``). Ends with a newline,
        as scrapers expect."""
        out: List[str] = []
        for m in self.metrics():
            series = m.render()
            if not series:
                continue
            if m.help:
                out.append(f"# HELP {m.name} "
                           f"{m.help.replace(chr(10), ' ')}")
            out.append(f"# TYPE {m.name} {m.kind}")
            out.extend(series)
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> dict:
        """JSON-ready nested dict of every series' current value — the
        programmatic mirror of ``render_prom``."""
        out: dict = {}
        for m in self.metrics():
            entry: dict = {"kind": m.kind, "labels": list(m.label_names),
                           "series": {}}
            for key, v in m.series().items():
                skey = json.dumps(dict(zip(m.label_names, key)),
                                  sort_keys=True) if key else ""
                if m.kind == "histogram":
                    # counts + edges keep the buckets; sum/count are
                    # what most readers want
                    entry["series"][skey] = {"sum": v["sum"],
                                             "count": v["count"],
                                             "counts": list(v["counts"])}
                else:
                    entry["series"][skey] = v
            if m.kind == "histogram":
                entry["edges"] = list(m.buckets)
            out[m.name] = entry
        return out

    def merge_snapshot(self, snap: dict, **extra_labels) -> None:
        """Fold another registry's :meth:`snapshot` into this one, every
        series widened by ``extra_labels`` (the fleet passes
        ``worker=<name>``). Counters add, gauges take the snapshot value,
        histograms absorb bucket counts (a snapshot without
        ``counts``/``edges`` cannot be re-bucketed and is skipped). A
        metric that already carries one of the extra labels keeps its own
        value. Iteration is sorted throughout, so the merged registry does
        not depend on dict order."""
        extra_names = tuple(sorted(extra_labels))
        extra_vals = {ln: str(extra_labels[ln]) for ln in extra_names}
        for name in sorted(snap):
            entry = snap[name]
            kind = entry.get("kind")
            own_names = tuple(entry.get("labels") or ())
            add_names = tuple(ln for ln in extra_names
                              if ln not in own_names)
            label_names = own_names + add_names
            if kind == "histogram":
                edges = entry.get("edges")
                if not edges:
                    continue
                m = self.histogram(name, labels=label_names, buckets=edges)
            elif kind == "counter":
                m = self.counter(name, labels=label_names)
            elif kind == "gauge":
                m = self.gauge(name, labels=label_names)
            else:
                continue
            series = entry.get("series") or {}
            for skey in sorted(series):
                v = series[skey]
                labels = dict(json.loads(skey)) if skey else {}
                labels.update({ln: extra_vals[ln] for ln in add_names})
                if kind == "histogram":
                    if "counts" not in v:
                        continue
                    m.absorb(v["counts"], v["sum"], v["count"], **labels)
                elif kind == "counter":
                    m.inc(float(v), **labels)
                else:
                    m.set(float(v), **labels)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
