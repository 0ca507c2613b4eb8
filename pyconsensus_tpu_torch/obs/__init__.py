"""pyconsensus_tpu_torch.obs — the span tracer, the metrics registry and
the sinks of ``pyconsensus_tpu/obs``, on torch.

Quick use::

    from pyconsensus_tpu_torch import obs

    with obs.span("resolve", algorithm="sztorc") as sp:
        out = sharded_consensus(x, params=p)
        sp.observe(out)                   # wait for the card inside the span
    obs.counter("my_total").inc()
    print(obs.report())                   # human span tree
    print(obs.render_prom())              # Prometheus text exposition
    obs.write_jsonl("trace.jsonl", obs.events())

Rules of engagement:

- **host-side only.** Spans and metrics are Python on host values. An
  emission site reads nothing back from the device; a span waits for the
  card only for values observed into it.
- **process-wide singletons.** ``REGISTRY`` and ``TRACER`` are the
  default sinks so library code needs no plumbing; ``reset()`` clears
  both. Private ``MetricsRegistry`` / ``Tracer`` instances are supported
  for isolation.
- **the reference's catalog.** Metric and span names, and every label,
  are the JAX package's; a label value that names an implementation
  takes the port's name (``cuda`` for the kernel family, ``plain`` for
  the plain path, ``torch`` for the backend).
- **over the registry.** ``SloMonitor`` (``obs/slo.py``) windows
  snapshots into rates, quantiles and violation seconds;
  ``FlightRecorder`` (``obs/flightrec.py``) dumps recent spans and metric
  deltas to a bounded on-disk ring; ``start_metrics_server``
  (``obs/httpd.py``) serves ``render_prom`` (or a fleet's merged view) on
  ``GET /metrics``.
"""

from __future__ import annotations

from .compilemon import install_compile_monitor
from .flightrec import FlightRecorder, read_flight_dir
from .httpd import MetricsServer, start_metrics_server
from .metrics import (DURATION_BUCKETS, ITERATION_BUCKETS, MAGNITUDE_BUCKETS,
                      Counter, Gauge, Histogram, MetricsRegistry)
from .sinks import (merge_jsonl, read_jsonl, span_tree, trace_forest,
                    write_jsonl, write_prom)
from .slo import SloMonitor, quantile_from_counts, targets_from_config
from .tracer import Span, Tracer

__all__ = [
    "REGISTRY", "TRACER",
    "span", "trace_root", "span_under", "trace_context", "observe", "current_span", "counter", "gauge",
    "histogram", "events", "report", "render_prom", "value", "reset",
    "write_jsonl", "read_jsonl", "merge_jsonl", "span_tree", "trace_forest",
    "write_prom", "install_compile_monitor",
    "SloMonitor", "quantile_from_counts", "targets_from_config",
    "FlightRecorder", "read_flight_dir",
    "MetricsServer", "start_metrics_server",
    "MetricsRegistry", "Tracer", "Span", "Counter", "Gauge", "Histogram",
    "DURATION_BUCKETS", "ITERATION_BUCKETS", "MAGNITUDE_BUCKETS",
]

#: process-wide metrics registry (the default sink for library code)
REGISTRY = MetricsRegistry()
#: process-wide tracer; finished spans also feed
#: ``pyconsensus_phase_seconds{phase=...}`` in REGISTRY
TRACER = Tracer(registry=REGISTRY)


def span(name: str, **attrs):
    """Open a span on the process-wide tracer (context manager)."""
    return TRACER.span(name, **attrs)


def trace_root(name: str, trace_id: str, **attrs):
    """Open a span rooting a trace: ``trace_id`` from the request's
    deterministic identity, never ``uuid``/``time``."""
    return TRACER.trace_root(name, trace_id, **attrs)


def span_under(name: str, ctx, **attrs):
    """Open a span under an explicit wire-propagated trace context
    (``None``: a plain span)."""
    return TRACER.span_under(name, ctx, **attrs)


def trace_context():
    """The current span's propagation context (``None`` when untraced):
    what the RPC client puts in the envelope."""
    return TRACER.context()


def observe(value):
    """Attach a device value to the current span's completion barrier."""
    return TRACER.observe(value)


def current_span():
    return TRACER.current()


def counter(name: str, help: str = "", labels=()):
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels=()):
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels=(),
              buckets=DURATION_BUCKETS):
    return REGISTRY.histogram(name, help, labels, buckets)


def value(name: str, **labels):
    """Fail-soft metric lookup (None when never emitted) — see
    ``MetricsRegistry.value``."""
    return REGISTRY.value(name, **labels)


def events():
    return TRACER.events()


def report(max_spans: int = 200) -> str:
    return TRACER.report(max_spans=max_spans)


def render_prom() -> str:
    return REGISTRY.render_prom()


def reset() -> None:
    """Clear the process-wide tracer and registry."""
    TRACER.reset()
    REGISTRY.reset()
