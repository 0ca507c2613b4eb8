"""Runtime lock witness — the dynamic mirror of CL801.

:mod:`.concurrency` proves the static may-hold-before graph acyclic;
this module checks the property the proof is *about*: the acquisition
orders threads actually execute. A :class:`LockWitness` monkeypatches
the ``threading`` lock constructors while installed; any lock whose
construction site lies inside the pyconsensus_tpu_torch package is
replaced with a recording proxy (everything else — stdlib ``queue``
mutexes, torch internals, the JAX reference package beside it, the
witnesses' own state — is left untouched, keyed by the constructor's
caller frame). Each successful acquisition of ``B`` while the acquiring
thread holds ``A`` records the observed edge ``A -> B``, keyed by the
locks' **creation sites** (``path:line``) — exactly the identity
:func:`..concurrency.lock_order_edges` emits for the static graph, so
the two sides join on the ``self._lock = threading.Lock()`` line itself.

:meth:`LockWitness.check` then asserts

1. the observed edge relation is acyclic (two threads interleaving a
   cyclic order deadlock — observing the cycle means the schedule that
   hangs exists, even if this run got lucky), and
2. the union of observed and static edges is acyclic — an observed
   ``B -> A`` whose reverse the static graph knows about means runtime
   behavior contradicts the documented order, the exact drift CL801's
   pragma-declared total orders are meant to pin.

On violation the full witness (lock table, edges, the offending cycle)
is dumped as JSON for offline diff against ``lock_order_edges()``, and
:class:`WitnessViolation` (an ``AssertionError``) carries the dump
path. The port's fleet, serve, session, economy, state-plane and
autoscale suites run under the witness through module-level autouse
fixtures, and ``chip_smoke.py --only witness`` installs it, before the
package is imported, around a fleet on the card.

The witness also keeps the set of locks acquired at least once
(``taken`` in the report): which lock a run actually exercised, not
only which it built.

Overhead: one dict-membership probe per acquisition and one per nested
acquisition (the global mutex is only taken the first time a lock is
acquired or an edge is seen), zero for locks constructed outside the
package. The witness is test machinery; nothing in the serving path
imports it.

This module imports only the standard library, so it can be loaded from
its file (``importlib.util.spec_from_file_location``) BEFORE the
package: importing any part of the package runs its ``__init__``, which
builds the module-level locks (``ops/build.py _LOCK``,
``serve/service.py _LINALG_LOCK``) that a witness installed afterwards
can no longer see. :func:`static_lock_graph` is the one function that
needs the package loaded normally.
"""

from __future__ import annotations

import contextlib
import json
import linecache
import os
import pathlib
import sys
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["LockWitness", "WitnessViolation", "static_lock_graph",
           "load_witness", "witnessed"]

#: the constructors patched while a witness is installed — the same set
#: :mod:`.concurrency` treats as lock definitions (_LOCK_CONSTRUCTORS)
_PATCHED = ("Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore")

#: unpatched originals, bound at import time so a witness's own state
#: lock (and proxies' inner locks) can never be witnessed recursively
_REAL = {name: getattr(threading, name) for name in _PATCHED}

#: the package directory WITH its trailing separator: without it the
#: prefix ``.../pyconsensus_tpu`` would also match a sibling package
#: whose name merely starts the same (``.../pyconsensus_tpu_torch/...``)
_PKG_DIR = str(pathlib.Path(__file__).resolve().parents[1]) + os.sep


#: this directory: the witnesses' own state locks are never witnessed,
#: whichever was imported first
_SELF_DIR = str(pathlib.Path(__file__).resolve().parent) + os.sep


def _in_package(filename: str, pkg_dir: str) -> bool:
    """Whether a constructor's frame file lies inside ``pkg_dir`` (a
    directory path, with or without its trailing separator)."""
    if not pkg_dir.endswith(os.sep):
        pkg_dir += os.sep
    return filename.startswith(pkg_dir)


def _constructs_here(filename: str, lineno: int, kind: str) -> bool:
    """Whether the source line calls the ``kind`` constructor itself.
    An extension module building a lock of its own (numpy's random
    generators do, inside ``np.random.default_rng(...)``) has no Python
    frame, so its construction would be charged to the package line
    that called into it; such a lock is not the package's."""
    return f"{kind}(" in linecache.getline(filename, lineno)


class WitnessViolation(AssertionError):
    """The observed acquisition order is cyclic, or contradicts the
    static may-hold-before graph. ``cycle`` is the offending lock-key
    sequence; ``dump_path`` is where the full witness JSON landed."""

    def __init__(self, message: str, cycle: Optional[List[str]] = None,
                 dump_path: Optional[str] = None):
        super().__init__(message)
        self.cycle = cycle or []
        self.dump_path = dump_path


#: :func:`.rules.default_scan_root`, computed here so that this module
#: imports only the standard library
_SCAN_ROOT = pathlib.Path(__file__).resolve().parents[2]


def _rel(filename: str) -> str:
    """Repo-relative posix path, with :func:`scan_targets`'s fallback
    (bare filename) so runtime keys match static keys byte-for-byte."""
    p = pathlib.Path(filename)
    try:
        return p.resolve().relative_to(_SCAN_ROOT).as_posix()
    except (ValueError, OSError):
        return p.name


class _WitnessedLock:
    """Recording proxy over a real Lock/RLock/Semaphore. Forwards the
    full lock protocol (including the ``_acquire_restore`` family
    ``threading.Condition`` needs when handed an RLock)."""

    def __init__(self, witness: "LockWitness", key: str, inner):
        self._w = witness
        self._key = key
        self._inner = inner

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._w._on_acquire(self._key)
        return got

    def release(self):
        self._inner.release()
        self._w._on_release(self._key)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition-compatibility when a witnessed lock backs a Condition:
    # wait() parks through these, so held-state must track them too.
    # threading.Condition binds these names when the lock HAS them and
    # falls back to acquire/release shims otherwise — a proxy over a
    # plain Lock must provide the same shims itself, or advertising
    # the names would crash the stdlib-supported Condition(Lock()) form
    # only while the witness is installed.
    def _acquire_restore(self, state):
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        self._w._on_acquire(self._key)

    def _release_save(self):
        inner = self._inner
        if hasattr(inner, "_release_save"):
            state = inner._release_save()
        else:
            inner.release()
            state = None
        self._w._on_release(self._key)
        return state

    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        # the stdlib's own plain-lock heuristic
        if inner.acquire(blocking=False):
            inner.release()
            return False
        return True

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<witnessed {self._inner!r} @ {self._key}>"


class _WitnessedCondition(_WitnessedLock):
    """A Condition proxy: ``wait()`` releases the condition's own lock
    while parked, so the held stack must drop the key for the duration
    (otherwise every lock taken by *other* code during the wait would
    fabricate an edge from a lock this thread no longer holds)."""

    def wait(self, timeout=None):
        self._w._on_release(self._key)
        try:
            return self._inner.wait(timeout)
        finally:
            self._w._on_acquire(self._key)

    def wait_for(self, predicate, timeout=None):
        self._w._on_release(self._key)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._w._on_acquire(self._key)


class LockWitness:
    """Records actual lock-acquisition order per thread while installed.

    Use as a context manager (:func:`witnessed`) or install/uninstall
    explicitly; :meth:`check` validates, :meth:`dump` persists."""

    def __init__(self):
        self._mu = _REAL["Lock"]()
        self._tls = threading.local()
        #: creation-site key -> key (the static lock table supplies
        #: display names at check time; the witness only knows sites)
        self.locks: Dict[str, str] = {}
        #: (a_key, b_key) -> first-observation record
        self.edges: Dict[Tuple[str, str], Dict[str, str]] = {}
        #: creation-site keys acquired at least once while recording
        self.taken: Dict[str, None] = {}
        self._installed = False
        self._saved: Dict[str, object] = {}

    # -- recording ------------------------------------------------------

    def _held(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _on_acquire(self, key: str) -> None:
        if key not in self.taken:         # GIL-atomic probe: fast path
            with self._mu:
                self.taken.setdefault(key, None)
        held = self._held()
        for h in held:
            if h == key:
                continue
            pair = (h, key)
            if pair in self.edges:        # GIL-atomic probe: fast path
                continue
            with self._mu:
                self.edges.setdefault(pair, {
                    "thread": threading.current_thread().name})
        held.append(key)

    def _on_release(self, key: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == key:
                del held[i]
                return
        # released by a thread that never recorded the acquire (handoff
        # idiom, or acquired before install) — nothing to unwind

    # -- construction-site patching ------------------------------------

    def _make_ctor(self, kind: str):
        real = _REAL[kind]
        proxy_cls = (_WitnessedCondition if kind == "Condition"
                     else _WitnessedLock)

        def ctor(*args, **kwargs):
            inner = real(*args, **kwargs)
            frame = sys._getframe(1)
            filename = frame.f_code.co_filename
            if (not _in_package(filename, _PKG_DIR)
                    or filename.startswith(_SELF_DIR)
                    or not _constructs_here(filename, frame.f_lineno,
                                            kind)):
                return inner              # not ours: zero overhead
            key = f"{_rel(filename)}:{frame.f_lineno}"
            with self._mu:
                self.locks.setdefault(key, key)
            return proxy_cls(self, key, inner)

        return ctor

    def install(self) -> "LockWitness":
        if self._installed:
            return self
        self._saved = {k: getattr(threading, k) for k in _PATCHED}
        for kind in _PATCHED:
            setattr(threading, kind, self._make_ctor(kind))
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for kind, orig in self._saved.items():
            setattr(threading, kind, orig)
        self._installed = False

    # -- validation -----------------------------------------------------

    def report(self) -> dict:
        """The witness as JSON-ready data (the dump format)."""
        with self._mu:
            return {
                "locks": dict(sorted(self.locks.items())),
                "taken": sorted(self.taken),
                "edges": [{"from": a, "to": b, **info}
                          for (a, b), info in sorted(self.edges.items())],
            }

    def dump(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.report(), indent=2) + "\n",
                        encoding="utf-8")
        return path

    def check(self, static: Optional[dict] = None,
              dump_path=None) -> dict:
        """Assert the observed order is acyclic and (when ``static`` —
        a :func:`..concurrency.lock_order_edges` dict — is given)
        stays acyclic when unioned with the static may-hold-before
        edges. Returns the report on success; dumps it and raises
        :class:`WitnessViolation` on failure."""
        names = dict(static.get("locks", {})) if static else {}

        def render(key: str) -> str:
            return f"{names[key]} ({key})" if key in names else key

        with self._mu:     # snapshot: a draining thread may still record
            observed = sorted(self.edges)
        cycle = _find_cycle(observed)
        kind = "observed lock-acquisition order is cyclic"
        if cycle is None and static is not None:
            # only a union cycle that observation CONTRIBUTED to is the
            # witness's business: an observed edge (a, b) whose reverse
            # path b ->* a exists through the combined graph. A cycle
            # purely among static edges is CL801's finding, not runtime
            # drift — the witness must not blame behavior that never
            # happened.
            combined = sorted(set(observed)
                              | {(a, b) for a, b in static["edges"]})
            adj: Dict[str, List[str]] = {}
            for a, b in combined:
                adj.setdefault(a, []).append(b)
            for a, b in observed:
                back = _find_path(adj, b, a)
                if back is not None:
                    cycle = [a] + back
                    kind = ("observed acquisition order contradicts the "
                            "static may-hold-before graph")
                    break
        if cycle is None:
            return self.report()
        dumped = None
        if dump_path is not None:
            dumped = str(self.dump(dump_path))
        chain = " -> ".join(render(k) for k in cycle)
        raise WitnessViolation(
            f"{kind}: {chain}"
            + (f" (witness dumped to {dumped})" if dumped else ""),
            cycle=cycle, dump_path=dumped)


def _find_cycle(edges) -> Optional[List[str]]:
    """First cycle in the edge list as ``[a, b, ..., a]``, or None."""
    graph: Dict[str, List[str]] = {}
    for a, b in edges:
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {v: WHITE for v in graph}
    for root in sorted(graph):
        if color[root] != WHITE:
            continue
        path: List[str] = []
        stack: List[Tuple[str, int]] = [(root, 0)]
        while stack:
            node, idx = stack[-1]
            if idx == 0:
                color[node] = GRAY
                path.append(node)
            succ = graph[node]
            if idx < len(succ):
                stack[-1] = (node, idx + 1)
                nxt = succ[idx]
                if color[nxt] == GRAY:
                    return path[path.index(nxt):] + [nxt]
                if color[nxt] == WHITE:
                    stack.append((nxt, 0))
            else:
                color[node] = BLACK
                path.pop()
                stack.pop()
    return None


def _find_path(adj: Dict[str, List[str]], src: str,
               dst: str) -> Optional[List[str]]:
    """Shortest ``[src, ..., dst]`` node path through ``adj``, or
    None. BFS with parent pointers; the graphs here are tiny."""
    if src == dst:
        return [src]
    parent = {src: None}
    frontier = [src]
    while frontier:
        nxt = []
        for v in frontier:
            for w in adj.get(v, ()):
                if w in parent:
                    continue
                parent[w] = v
                if w == dst:
                    path = [w]
                    while parent[path[-1]] is not None:
                        path.append(parent[path[-1]])
                    return path[::-1]
                nxt.append(w)
        frontier = nxt
    return None


def load_witness(path) -> dict:
    """Round-trip a dumped witness back to its report dict."""
    return json.loads(pathlib.Path(path).read_text(encoding="utf-8"))


_STATIC_CACHE: Optional[dict] = None


def static_lock_graph(refresh: bool = False) -> dict:
    """The static lock table + may-hold-before edges for the installed
    package, computed once per process (the whole-package pass costs
    seconds)."""
    global _STATIC_CACHE
    if _STATIC_CACHE is None or refresh:
        from .concurrency import lock_order_edges

        _STATIC_CACHE = lock_order_edges()
    return _STATIC_CACHE


@contextlib.contextmanager
def witnessed(static: Optional[dict] = None, check: bool = True,
              dump_path=None):
    """Install a fresh :class:`LockWitness` for the block; on clean
    exit, :meth:`~LockWitness.check` it (against ``static`` when
    given). The witness is always uninstalled, even on error."""
    w = LockWitness()
    w.install()
    try:
        yield w
    finally:
        w.uninstall()
    if check:
        w.check(static=static, dump_path=dump_path)
