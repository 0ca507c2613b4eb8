"""Span tracer: nested, exception-safe phase spans with device-time
attribution (``pyconsensus_tpu/obs/tracer.py`` on torch).

The model is a Dapper-style span tree flattened to an event list: every
``span(...)`` context manager opens a child of the innermost open span on
the *current thread*, and closing it appends one finished-span record to
the tracer. Library code emits spans without plumbing a timer object
through call signatures — the process-wide default tracer lives in
``pyconsensus_tpu_torch.obs`` — and each thread gets its own span stack
(``threading.local``), so cross-thread nesting can never corrupt the
tree.

Device-time attribution: CUDA launches are asynchronous, so a span that
merely *launches* device work would charge the compute to whichever
later span happens to wait. ``Span.observe(value)`` marks values the
span must wait on; span exit synchronises each distinct CUDA device
among ALL of them (``torch.cuda.synchronize``, once a device). numpy
values, Python scalars and CPU tensors need no wait. A span into which
nothing was observed never synchronises: spans cost a resolution no host
sync unless a caller asks for one.

Multi-process: every span is tagged with the ``torch.distributed`` rank
(0 when no process group is initialised), so merged JSONL from several
processes still reconstructs per-process trees.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

__all__ = ["Span", "Tracer"]

_ids = itertools.count(1)
_ids_lock = threading.Lock()


def _next_id() -> int:
    with _ids_lock:
        return next(_ids)


def _process_index() -> int:
    """The ``torch.distributed`` rank when a process group is initialised,
    else 0. Read at each span: a group may be initialised after the first
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _cuda_devices(values: list) -> list:
    """The distinct CUDA devices of the tensors among ``values`` (lists,
    tuples and dict values are walked), in first-seen order. Anything
    whose ``device`` is not a CUDA ``torch.device`` needs no wait."""
    import torch

    devices: list = []
    stack = list(reversed(values))
    while stack:
        v = stack.pop()
        if isinstance(v, dict):
            stack.extend(reversed(list(v.values())))
        elif isinstance(v, (list, tuple)):
            stack.extend(reversed(v))
        else:
            dev = getattr(v, "device", None)
            if (isinstance(dev, torch.device) and dev.type == "cuda"
                    and dev not in devices):
                devices.append(dev)
    return devices


def _block_all(values: list) -> None:
    """Wait for every observed value: ``torch.cuda.synchronize`` once for
    each distinct CUDA device among them. A launch that failed
    asynchronously raises here."""
    if not values:
        return
    devices = _cuda_devices(values)
    if devices:
        import torch

        for dev in devices:
            torch.cuda.synchronize(dev)


class Span:
    """One finished-or-open phase. Attributes are small JSON-able values
    (strings/numbers/bools); anything else is stringified at export.

    ``trace_id`` names the end-to-end request this span belongs to
    (inherited from the parent span, or set explicitly at the trace root
    from the request's deterministic identity). ``source`` is the
    emitting tracer's label; ``parent_src`` is set when the parent span
    lives in ANOTHER source, and the span is then a root of its local
    tree."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "depth",
                 "process_index", "start_wall_s", "duration_s", "status",
                 "error", "trace_id", "source", "parent_src", "_t0",
                 "_pending")

    def __init__(self, name: str, attrs: Dict[str, object], parent_id: int,
                 depth: int, trace_id: Optional[str] = None,
                 source: str = "main",
                 parent_src: Optional[str] = None) -> None:
        self.name = name
        self.attrs = attrs
        self.span_id = _next_id()
        self.parent_id = parent_id          # 0 = root
        self.depth = depth
        self.process_index = _process_index()
        self.start_wall_s = time.time()
        self.duration_s: Optional[float] = None
        self.status = "open"
        self.error: Optional[str] = None
        self.trace_id = trace_id
        self.source = source
        self.parent_src = parent_src
        self._t0 = time.perf_counter()
        self._pending: list = []

    def observe(self, value):
        """Mark a (possibly asynchronous) device value this span must wait
        on before its clock stops. May be called any number of times; ALL
        observed values are waited on at exit. Returns ``value`` so call
        sites can wrap an expression in place."""
        self._pending.append(value)
        return value

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def to_dict(self) -> dict:
        attrs = {}
        for k, v in self.attrs.items():
            attrs[str(k)] = (v if isinstance(v, (str, int, float, bool))
                             or v is None else str(v))
        out = {
            "type": "span",
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "depth": self.depth,
            "process_index": self.process_index,
            "source": self.source,
            "start_s": self.start_wall_s,
            "duration_s": self.duration_s,
            "status": self.status,
            "error": self.error,
            "attrs": attrs,
        }
        # trace context only when traced
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.parent_src is not None:
            out["parent_src"] = self.parent_src
        return out


class Tracer:
    """Thread-aware span collector. ``registry`` (a
    :class:`~pyconsensus_tpu_torch.obs.metrics.MetricsRegistry`) is
    optional; when given, every finished span also observes
    ``pyconsensus_phase_seconds{phase=<name>}`` so phase durations show up
    in the Prometheus exposition with zero extra call-site code."""

    #: completed-span ring bound — a long run must not grow host memory
    #: without bound; the metrics registry keeps the aggregates, the span
    #: ring keeps the most recent trees for report()/JSONL
    MAX_SPANS = 100_000

    def __init__(self, registry=None, max_spans: Optional[int] = None,
                 source: str = "main") -> None:
        self._registry = registry
        #: this tracer's identity in merged multi-process trace logs: a
        #: deterministic label, never pid/uuid, so trace artifacts are
        #: diffable across runs
        self.source = str(source)
        self._max_spans = int(max_spans if max_spans is not None
                              else self.MAX_SPANS)
        self._local = threading.local()
        self._lock = threading.Lock()
        # deque(maxlen): O(1) eviction under the lock
        self._finished: "collections.deque[Span]" = collections.deque(
            maxlen=self._max_spans)
        self._dropped = 0

    # -- emission ----------------------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def span(self, name: str, **attrs) -> Iterator[Span]:
        """Open a child span of the innermost open span on this thread.
        Exception-safe: an exception inside the body marks the span
        ``status="error"`` (with the exception repr) and re-raises; the
        span is recorded either way, and the stack is always popped.
        The child inherits its parent's ``trace_id``."""
        return self._open(name, attrs)

    def trace_root(self, name: str, trace_id: str, **attrs
                   ) -> Iterator[Span]:
        """Open a span that ROOTS a trace: ``trace_id`` must come from the
        request's deterministic identity (a routing key, a session round),
        not ``uuid``/``time``. Nests normally under any open local span;
        descendants inherit the id."""
        return self._open(name, attrs, trace_id=str(trace_id))

    def span_under(self, name: str, ctx: Optional[dict], **attrs
                   ) -> Iterator[Span]:
        """Open a span whose parent is an explicit trace context
        (``{"trace_id", "src", "span_id"}`` from :meth:`context`, the form
        that crosses the wire) instead of this thread's stack: the
        worker side of an RPC. ``ctx=None`` is a plain :meth:`span`."""
        if not ctx:
            return self._open(name, attrs)
        src = str(ctx.get("src") or "")
        parent_id = int(ctx.get("span_id") or 0)
        trace_id = ctx.get("trace_id")
        return self._open(
            name, attrs,
            trace_id=str(trace_id) if trace_id is not None else None,
            parent_override=(src, parent_id))

    def context(self) -> Optional[dict]:
        """The current span's propagation context, or ``None`` when no
        span is open or it is untraced (an untraced RPC envelope then
        carries no trace key)."""
        sp = self.current()
        if sp is None or sp.trace_id is None:
            return None
        return {"trace_id": sp.trace_id, "src": self.source,
                "span_id": sp.span_id}

    @contextlib.contextmanager
    def _open(self, name: str, attrs: dict,
              trace_id: Optional[str] = None,
              parent_override: Optional[tuple] = None) -> Iterator[Span]:
        stack = self._stack()
        parent = stack[-1] if stack else None
        if parent_override is not None:
            # a parent in another source roots this source's local tree
            # (``parent_src``); ``trace_forest`` joins the two over
            # merged logs
            src, pid = parent_override
            remote = src != self.source
            sp = Span(name, dict(attrs), pid, 0 if remote else 1,
                      trace_id=trace_id, source=self.source,
                      parent_src=src if remote else None)
        else:
            if trace_id is None and parent is not None:
                trace_id = parent.trace_id
            sp = Span(name, dict(attrs),
                      parent.span_id if parent is not None else 0,
                      parent.depth + 1 if parent is not None else 0,
                      trace_id=trace_id, source=self.source)
        stack.append(sp)
        try:
            yield sp
            sp.status = "ok"
        except BaseException as exc:
            sp.status = "error"
            sp.error = repr(exc)
            raise
        finally:
            try:
                _block_all(sp._pending)
            except BaseException as exc:
                # an observed launch that failed ASYNCHRONOUSLY surfaces
                # here — the span must not be recorded green for the
                # phase that crashed; a body exception's status wins (it
                # came first)
                if sp.status != "error":
                    sp.status = "error"
                    sp.error = repr(exc)
                raise
            finally:
                sp._pending = []
                sp.duration_s = time.perf_counter() - sp._t0
                stack.pop()
                self._record(sp)

    def observe(self, value):
        """``Span.observe`` on the current span; a no-op pass-through when
        no span is open (library code needn't care whether a caller
        traced it)."""
        sp = self.current()
        if sp is not None:
            return sp.observe(value)
        return value

    def _record(self, sp: Span) -> None:
        with self._lock:
            if len(self._finished) == self._max_spans:
                self._dropped += 1          # deque(maxlen) evicts oldest
            self._finished.append(sp)
        if self._registry is not None:
            self._registry.histogram(
                "pyconsensus_phase_seconds",
                "wall-clock span durations (device time attributed via "
                "observed-value blocking)",
                labels=("phase",)).observe(sp.duration_s, phase=sp.name)

    # -- export ------------------------------------------------------------

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def events(self) -> List[dict]:
        """Finished spans as JSON-ready dicts, in finish order (children
        before parents — a JSONL reader rebuilds the tree from
        parent_id)."""
        return [sp.to_dict() for sp in self.spans()]

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def report(self, max_spans: int = 200) -> str:
        """Human tree: one line per span, indented by nesting, slowest
        roots first. ``max_spans`` caps the output (the metrics registry
        carries the aggregates)."""
        spans = self.spans()
        known = {sp.span_id for sp in spans}
        by_parent: Dict[int, List[Span]] = {}
        for sp in spans:
            # a child whose parent was evicted from the ring (or is still
            # open) becomes a root (matching sinks.span_tree) instead of
            # silently vanishing from the report; so does one whose
            # parent lives in another source
            parent = sp.parent_id if (sp.parent_src is None
                                      and sp.parent_id in known) else 0
            by_parent.setdefault(parent, []).append(sp)
        lines: List[str] = []

        def emit(sp: Span, indent: int) -> None:
            if len(lines) >= max_spans:
                return
            ms = (sp.duration_s or 0.0) * 1e3
            attrs = " ".join(f"{k}={v}" for k, v in sorted(
                sp.to_dict()["attrs"].items()))
            flag = "" if sp.status == "ok" else f" [{sp.status}]"
            lines.append(f"{'  ' * indent}{sp.name:<{max(1, 40 - 2 * indent)}}"
                         f" {ms:10.3f} ms{flag}"
                         + (f"  ({attrs})" if attrs else ""))
            for child in sorted(by_parent.get(sp.span_id, []),
                                key=lambda s: s.start_wall_s):
                emit(child, indent + 1)

        roots = sorted(by_parent.get(0, []),
                       key=lambda s: -(s.duration_s or 0.0))
        for root in roots:
            emit(root, 0)
        if len(spans) > max_spans:
            lines.append(f"... ({len(spans) - max_spans} more spans; "
                         f"aggregates in the metrics registry)")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._finished.clear()
            self._dropped = 0
        self._local = threading.local()

    def __repr__(self) -> str:
        return (f"Tracer(spans={len(self._finished)}, "
                f"dropped={self._dropped}, max_spans={self._max_spans})")
