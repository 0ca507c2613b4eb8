"""Phase timers and the profiler hook (``pyconsensus_tpu/utils/
profiling.py``).

:class:`PhaseTimer` is a thin shim over :mod:`pyconsensus_tpu_torch.obs`:
each phase is a tracer span, and its accumulating ``totals()`` /
``means()`` / ``report()`` read the spans' durations. :func:`trace` wraps
``torch.profiler.profile`` (CPU activity, and CUDA activity where a card
is present) and writes a Chrome / Perfetto trace into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

from .. import obs

__all__ = ["PhaseTimer", "trace"]


class PhaseTimer:
    """Accumulating named-phase wall-clock timer; each ``phase`` opens an
    ``obs`` span.

    >>> timer = PhaseTimer()
    >>> with timer.phase("pca"):
    ...     ...
    >>> timer.totals()
    {'pca': 0.0123}

    ``block=True`` (the default) waits at the phase's exit for every value
    the body handed to :meth:`observe` (the span synchronises each CUDA
    device among them), so a phase waits only on what it observed.
    """

    def __init__(self) -> None:
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._pending: List = []
        self._span = None

    def observe(self, value):
        """Mark a value the current phase waits on before its clock stops;
        every observed value is waited on. Outside a phase only the last
        value is kept (nothing would drain more)."""
        if self._span is not None:
            self._pending.append(value)
            self._span.observe(value)
        else:
            self._pending = [value]
        return value

    @contextlib.contextmanager
    def phase(self, name: str, block: bool = True) -> Iterator[None]:
        outer_span, outer_pending = self._span, self._pending
        self._pending = []
        sp = None
        try:
            with obs.span(name, timer="PhaseTimer") as sp:
                self._span = sp
                try:
                    yield
                finally:
                    if not block:
                        # the span must not wait either
                        sp._pending = []
                    self._span = outer_span
                    self._pending = outer_pending
        finally:
            # the span stamped its duration after waiting; reuse it so the
            # totals and the tracer never disagree (also when the body
            # raised)
            if sp is not None and sp.duration_s is not None:
                self._totals[name] = (self._totals.get(name, 0.0)
                                      + sp.duration_s)
                self._counts[name] = self._counts.get(name, 0) + 1

    def totals(self) -> Dict[str, float]:
        return dict(self._totals)

    def means(self) -> Dict[str, float]:
        return {k: v / self._counts[k] for k, v in self._totals.items()}

    def report(self) -> str:
        lines = [f"  {name:24s} {total * 1e3:10.3f} ms "
                 f"({self._counts[name]} call(s))"
                 for name, total in sorted(self._totals.items(),
                                           key=lambda kv: -kv[1])]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the body with ``torch.profiler`` and write a Chrome /
    Perfetto trace (``trace-<pid>-<ns>.json``) into ``log_dir``; a no-op
    when ``log_dir`` is None, so a ``--profile`` flag threads straight
    through. CUDA activity is recorded where a card is present."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
