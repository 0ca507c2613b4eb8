"""Jittered-exponential-backoff retry with a deadline
(``pyconsensus_tpu/faults/retry.py``).

Transient infrastructure faults (a shared filesystem hiccup mid-chunk
write, an NFS ESTALE on a checkpoint read) should cost a bounded delay,
not a crashed sweep. :func:`retry_call` / the :func:`retry` decorator
wrap a callable with capped exponential backoff:

- deterministic jitter: the sleep for attempt *k* is
  ``min(max_delay, base_delay * 2**k) * (0.5 + u/2)`` with ``u`` drawn
  from a PRNG keyed on ``(jitter_seed, label, attempt)`` — reproducible
  in tests, decorrelated across workers that pass distinct seeds (e.g.
  their host id);
- a wall-clock ``deadline``: when the *next* sleep would overrun it, the
  last exception is re-raised instead — a stuck filesystem fails the
  operation in bounded time rather than hanging a host;
- selective: only ``retry_on`` exception classes are retried. The
  structured taxonomy (.errors) is deliberately NOT in the default set —
  a corrupted checkpoint or malformed input does not become valid by
  retrying; recovery for those is re-computation or a clear error, and
  :class:`..plan.SimulatedCrash` (a BaseException) always propagates,
  exactly like the SIGKILL it stands in for.

Every retry increments ``pyconsensus_retries_total{label}``; exhaustion
increments ``pyconsensus_retries_exhausted_total{label}``.

It is for host infrastructure (files, sockets). No kernel launch is ever
wrapped in it: a launch that fails is a fault of the build or the card,
which the caller must see, and retrying it could hide that.
"""

from __future__ import annotations

import functools
import time
import zlib
from typing import Optional, Tuple

import numpy as np

from .. import obs

__all__ = ["retry", "retry_call"]


def _sleep_for(attempt: int, base_delay: float, max_delay: float,
               jitter_seed: int, label: str) -> float:
    u = np.random.default_rng(
        [int(jitter_seed), zlib.crc32(label.encode()), attempt]).random()
    return min(float(max_delay), float(base_delay) * (2.0 ** attempt)) \
        * (0.5 + 0.5 * u)


def retry_call(fn, *args, retries: int = 4, base_delay: float = 0.05,
               max_delay: float = 2.0, deadline: Optional[float] = None,
               retry_on: Tuple = (OSError,), jitter_seed: int = 0,
               label: str = "", on_retry=None, **kwargs):
    """Call ``fn(*args, **kwargs)`` with up to ``retries`` retries on
    ``retry_on`` exceptions (``retries=4`` means at most 5 attempts).
    ``deadline`` bounds the TOTAL wall-clock budget in seconds from the
    first attempt; ``on_retry(attempt, exc)`` is an optional observer
    hook (logging). Raises the last exception on exhaustion."""
    label = label or getattr(fn, "__name__", "call")
    start = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:
            if attempt >= int(retries):
                obs.counter(
                    "pyconsensus_retries_exhausted_total",
                    "retry_call giving up after exhausting its budget",
                    labels=("label",)).inc(label=label)
                raise
            delay = _sleep_for(attempt, base_delay, max_delay,
                               jitter_seed, label)
            if deadline is not None and (
                    time.monotonic() - start + delay > float(deadline)):
                obs.counter(
                    "pyconsensus_retries_exhausted_total",
                    "retry_call giving up after exhausting its budget",
                    labels=("label",)).inc(label=label)
                raise
            obs.counter(
                "pyconsensus_retries_total",
                "transient-failure retries by operation label",
                labels=("label",)).inc(label=label)
            if on_retry is not None:
                on_retry(attempt, exc)
            time.sleep(delay)
            attempt += 1


def retry(**cfg):
    """Decorator form of :func:`retry_call` — configuration is fixed at
    decoration time::

        @retry(retries=3, retry_on=(OSError,), label="chunk-write")
        def write_chunk(...): ...
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, *args, **cfg, **kwargs)
        return wrapper
    return deco
