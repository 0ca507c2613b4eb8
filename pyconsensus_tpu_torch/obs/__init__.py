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
"""

from __future__ import annotations

from .metrics import (DURATION_BUCKETS, ITERATION_BUCKETS, MAGNITUDE_BUCKETS,
                      Counter, Gauge, Histogram, MetricsRegistry)
from .sinks import read_jsonl, span_tree, trace_forest, write_jsonl, \
    write_prom
from .tracer import Span, Tracer

__all__ = [
    "REGISTRY", "TRACER",
    "span", "trace_root", "observe", "current_span", "counter", "gauge",
    "histogram", "events", "report", "render_prom", "value", "reset",
    "write_jsonl", "read_jsonl", "span_tree", "trace_forest", "write_prom",
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
