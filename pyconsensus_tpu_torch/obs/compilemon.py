"""Build observability (``pyconsensus_tpu/obs/compilemon.py``).

The reference watches XLA: ``instrument_jit`` counts a jitted entry
point's retraces and ``install_compile_monitor`` feeds the global
``jax.monitoring`` compile events into two counters. The port traces
nothing and compiles nothing for each key; its one compile is the kernel
libraries (``ops/build.py``). So :func:`install_compile_monitor` feeds
the same two counters from the build's listener:

- ``pyconsensus_jax_compile_events_total{event}`` — one per ``nvcc`` run
  of a source (``event="nvcc"``), per library installed from a verified
  kernel-store entry (``"store_adopt"``) and per library loaded into this
  process (``"library_load"``);
- ``pyconsensus_jax_compile_seconds_total{event}`` — their seconds.

``instrument_jit`` has no counterpart: the per-key count it kept is
``pyconsensus_serve_builds_total{entry}`` of the executable cache.
"""

from __future__ import annotations

__all__ = ["install_compile_monitor", "COMPILE_EVENTS"]

#: the event label values the monitor emits
COMPILE_EVENTS = ("nvcc", "store_adopt", "library_load")

_installed: list = [None]


def install_compile_monitor(registry=None) -> bool:
    """Register the build listener feeding the compile-event counters of
    ``registry`` (the process-wide one when omitted). Idempotent: a
    second call keeps the first listener. Returns True once a listener
    is active."""
    if _installed[0] is not None:
        return True
    if registry is None:
        from . import REGISTRY as registry          # noqa: N813
    from ..ops import build

    def _listener(event: str, source: str, seconds: float) -> None:
        # resolved at each event, so an obs.reset() between builds feeds
        # the fresh registry
        registry.counter(
            "pyconsensus_jax_compile_events_total",
            "kernel-library builds, store adoptions and loads observed "
            "process-wide", labels=("event",)).inc(1.0, event=event)
        registry.counter(
            "pyconsensus_jax_compile_seconds_total",
            "cumulative seconds of kernel-library builds, store "
            "adoptions and loads", labels=("event",)).inc(
                max(float(seconds), 0.0), event=event)

    build.add_listener(_listener)
    _installed[0] = _listener
    return True
