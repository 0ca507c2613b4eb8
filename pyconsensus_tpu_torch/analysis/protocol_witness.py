"""Runtime protocol witness — the dynamic mirror of CL901.

:mod:`.protocol` proves a static happens-before order over the
durability events of each replicated operation (journal before ship
before ack, commit before ship before ack, ...); this module checks the
property the proof is *about*: the event orders the serving code
actually executes. A :class:`ProtocolWitness` monkeypatches two layers
while installed:

- **operation boundaries** — ``DurableSession.append``/``resolve`` and
  ``FleetWorkerProcess.append``/``submit_session``/``create_session``
  push a per-thread operation frame; a successful return appends the
  terminal ``ack`` event (the return IS the acknowledgment: the reply
  frame or Future resolution is built from it), an exception records
  the operation ``ok=False`` with no ack;
- **durability events** — ``ReplicationLog.journal_block`` /
  ``commit_round`` and ``LogShipper.ship_file`` record ``journal`` /
  ``commit`` / ``ship`` into the innermost active frame on their
  thread, *after* the call returns (an event that raised never
  happened, exactly as the static walk's success path assumes).

Nested operations fold their events (minus their own ack — an inner
return is not the outer reply) into the enclosing frame, so
``worker.append`` observes the ``journal`` its inner
``session.append`` performed, matching the static walk's
interprocedural inlining. Frames are thread-local: the microbatcher
thread's ``resolve`` can never leak its ``commit`` into an RPC
thread's ``append``.

:meth:`ProtocolWitness.check` then joins observed against static: for
every successfully-acked operation and every static edge ``a -> b`` of
its kind, if both events were observed, every ``a`` must precede every
``b``. Edges whose events did not occur are vacuous — the dedupe
fast-path acks without journaling, an in-process worker never ships —
so the check constrains order, not coverage. On contradiction the full
witness is dumped as JSON and :class:`ProtocolWitnessViolation` (an
``AssertionError``) carries the operation, the violated edge, and the
dump path.

The port's transport, fleet, state-plane and autoscale suites run under
the witness through module-level autouse fixtures, and ``chip_smoke.py
--only witness`` installs it around a fleet on the card. Workers in
*other processes* are outside any witness installed here; the
in-process ``FleetWorkerProcess`` tests cover the worker-side
orderings.

Overhead: one thread-local list append per durability event; nothing
in the serving path imports this module.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import pathlib
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["ProtocolWitness", "ProtocolWitnessViolation",
           "static_protocol_graph", "protocol_witnessed"]

#: real constructor bound at import time so the witness's own state
#: lock is never itself a (lock-)witnessed proxy when both witnesses
#: are installed in the same test
_REAL_LOCK = threading.Lock

#: (module, class, method, event kind) — durability events, recorded
#: into the innermost active frame after the call returns
_EVENT_SHIMS: Tuple[Tuple[str, str, str, str], ...] = (
    ("pyconsensus_tpu_torch.serve.failover",
     "ReplicationLog", "journal_block", "journal"),
    ("pyconsensus_tpu_torch.serve.failover",
     "ReplicationLog", "commit_round", "commit"),
    ("pyconsensus_tpu_torch.serve.transport.shipping",
     "LogShipper", "ship_file", "ship"),
)

#: (module, class, method, op kind) — operation boundaries; kinds match
#: :data:`..protocol.PROTOCOL_OPS` so the two sides join by name
_OP_SHIMS: Tuple[Tuple[str, str, str, str], ...] = (
    ("pyconsensus_tpu_torch.serve.failover",
     "DurableSession", "append", "session.append"),
    ("pyconsensus_tpu_torch.serve.failover",
     "DurableSession", "resolve", "session.resolve"),
    ("pyconsensus_tpu_torch.serve.transport.worker",
     "FleetWorkerProcess", "append", "worker.append"),
    ("pyconsensus_tpu_torch.serve.transport.worker",
     "FleetWorkerProcess", "submit_session", "worker.submit_session"),
    ("pyconsensus_tpu_torch.serve.transport.worker",
     "FleetWorkerProcess", "create_session", "worker.create_session"),
)


class ProtocolWitnessViolation(AssertionError):
    """An observed per-operation event order contradicts the static
    happens-before graph. ``op`` is the operation kind, ``edge`` the
    violated ``(before, after)`` pair, ``events`` the observed
    sequence, ``dump_path`` where the full witness JSON landed."""

    def __init__(self, message: str, op: str = "",
                 edge: Optional[Tuple[str, str]] = None,
                 events: Optional[List[str]] = None,
                 dump_path: Optional[str] = None):
        super().__init__(message)
        self.op = op
        self.edge = edge
        self.events = events or []
        self.dump_path = dump_path


class ProtocolWitness:
    """Records the observed durability-event order of every replicated
    operation while installed.

    Use as a context manager (:func:`protocol_witnessed`) or
    install/uninstall explicitly; :meth:`check` validates against the
    static graph, :meth:`dump` persists. :meth:`op` opens an explicit
    operation frame — what the reordered-mock regression test uses to
    scope events that don't flow through a patched boundary."""

    def __init__(self):
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        #: completed operation records, in completion order
        self.ops: List[dict] = []
        #: events observed with no operation frame open on their thread
        self.unscoped: Dict[str, int] = {}
        self._installed = False
        self._saved: List[Tuple[type, str, object]] = []

    # -- recording ------------------------------------------------------

    def _frames(self) -> List[dict]:
        frames = getattr(self._tls, "frames", None)
        if frames is None:
            frames = self._tls.frames = []
        return frames

    def _record(self, kind: str) -> None:
        frames = self._frames()
        if frames:
            frames[-1]["events"].append(kind)
            return
        with self._mu:
            self.unscoped[kind] = self.unscoped.get(kind, 0) + 1

    @contextlib.contextmanager
    def op(self, kind: str):
        """Open an operation frame: durability events on this thread
        record into it; clean exit appends the terminal ``ack``."""
        frames = self._frames()
        frame = {"kind": kind, "events": []}
        frames.append(frame)
        ok = False
        try:
            yield frame
            ok = True
        finally:
            frames.pop()
            events = list(frame["events"])
            if frames:
                # fold into the enclosing operation, WITHOUT this op's
                # ack — the inner return is not the outer reply
                frames[-1]["events"].extend(events)
            rec = {"kind": kind, "ok": ok,
                   "events": events + (["ack"] if ok else []),
                   "thread": threading.current_thread().name}
            with self._mu:
                self.ops.append(rec)

    # -- patching -------------------------------------------------------

    def _wrap_event(self, real, kind: str):
        w = self

        @functools.wraps(real)
        def wrapper(*args, **kwargs):
            result = real(*args, **kwargs)
            w._record(kind)
            return result

        return wrapper

    def _wrap_op(self, real, kind: str):
        w = self

        @functools.wraps(real)
        def wrapper(*args, **kwargs):
            with w.op(kind):
                return real(*args, **kwargs)

        return wrapper

    def install(self) -> "ProtocolWitness":
        if self._installed:
            return self
        for shims, wrap in ((_EVENT_SHIMS, self._wrap_event),
                            (_OP_SHIMS, self._wrap_op)):
            for modname, clsname, method, kind in shims:
                cls = getattr(importlib.import_module(modname), clsname)
                real = cls.__dict__[method]
                self._saved.append((cls, method, real))
                setattr(cls, method, wrap(real, kind))
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for cls, method, real in self._saved:
            setattr(cls, method, real)
        self._saved = []
        self._installed = False

    # -- validation -----------------------------------------------------

    def report(self) -> dict:
        """The witness as JSON-ready data (the dump format)."""
        with self._mu:
            return {"ops": [dict(r) for r in self.ops],
                    "unscoped": dict(sorted(self.unscoped.items()))}

    def dump(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.report(), indent=2) + "\n",
                        encoding="utf-8")
        return path

    def check(self, static: Optional[dict] = None,
              dump_path=None) -> dict:
        """Assert every successfully-acked operation's observed event
        sequence is consistent with the static happens-before graph
        (``static``: a :func:`..protocol.happens_before` dict; computed
        fresh when omitted). For an edge ``a -> b`` both of whose
        events occurred, every ``a`` must precede every ``b``;
        operations that raised (no ack) are unconstrained — the static
        order is a promise about what an ack means. Returns the report
        on success; dumps it and raises
        :class:`ProtocolWitnessViolation` on failure."""
        if static is None:
            static = static_protocol_graph()
        specs = static.get("ops", {})
        with self._mu:     # snapshot: other threads may still record
            records = [dict(r) for r in self.ops]
        for rec in records:
            spec = specs.get(rec["kind"])
            if spec is None or not rec["ok"]:
                continue
            ev = rec["events"]
            for a, b in spec.get("edges", []):
                if a not in ev or b not in ev:
                    continue
                last_a = max(i for i, e in enumerate(ev) if e == a)
                first_b = min(i for i, e in enumerate(ev) if e == b)
                if first_b < last_a:
                    dumped = None
                    if dump_path is not None:
                        dumped = str(self.dump(dump_path))
                    raise ProtocolWitnessViolation(
                        f"operation {rec['kind']!r} observed event "
                        f"order {ev} contradicts the static "
                        f"happens-before edge {a!r} -> {b!r} "
                        f"({spec.get('function', '?')})"
                        + (f" (witness dumped to {dumped})"
                           if dumped else ""),
                        op=rec["kind"], edge=(a, b), events=list(ev),
                        dump_path=dumped)
        return self.report()


_STATIC_CACHE: Optional[dict] = None


def static_protocol_graph(refresh: bool = False) -> dict:
    """The static per-operation happens-before graph for the installed
    package, computed once per process."""
    global _STATIC_CACHE
    if _STATIC_CACHE is None or refresh:
        from .protocol import happens_before

        _STATIC_CACHE = happens_before()
    return _STATIC_CACHE


@contextlib.contextmanager
def protocol_witnessed(static: Optional[dict] = None, check: bool = True,
                       dump_path=None):
    """Install a fresh :class:`ProtocolWitness` for the block; on clean
    exit, :meth:`~ProtocolWitness.check` it. The witness is always
    uninstalled, even on error."""
    w = ProtocolWitness()
    w.install()
    try:
        yield w
    finally:
        w.uninstall()
    if check:
        w.check(static=static, dump_path=dump_path)
