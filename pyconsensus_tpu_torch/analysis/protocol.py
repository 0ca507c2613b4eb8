"""Layer 5: distributed-protocol analysis (CL901-905).

The fleet's fault tolerance rests on ORDERING invariants: a worker acks
an append only after the journal write *then* the ship complete, a
resolve commits *then* ships, and any failure between durability and
ack fences the session or unlinks the record. The code that keeps them
is ``serve/transport/{rpc,worker,supervisor,shipping}.py``,
``serve/failover.py``, ``serve/fleet.py`` and ``serve/stateplane.py``.
This layer makes "acknowledged => durable or fenced" a lint-enforced
property. Its runtime mirror is :mod:`.protocol_witness`, as
:mod:`.witness` mirrors CL801.

Model
-----

**Protocol events** are call-site classified, interprocedurally:

- *journal* — ``.journal_block(...)``, or any call forwarding an
  ``append_id=`` keyword (the idempotency token travels WITH the
  journaling mutation; a call that threads it is the durability hop
  from the caller's perspective);
- *commit*  — ``.commit_round(...)`` (the ledger checkpoint);
- *ship*    — ``.ship_file(...)`` and anything that transitively calls
  it (``_ship_session``);
- *ack*     — ``Future.set_result(...)``, or a ``send_msg`` whose
  payload literal carries a ``"result"``/``"error"`` key (the RPC
  reply frame), or — for methods registered in a server dispatch table
  (a ``handlers()`` dict or an ``RpcServer({...})`` literal) — a
  ``return`` with a value (returning from a dispatch handler IS the
  ack: the frame goes out the moment the handler returns);
- *fence*   — ``.fence(...)`` or a ``self._fenced = ...`` store;
- *unlink*  — ``.unlink(...)`` (withdrawing a journal record).

journal/commit/ship/fence/unlink summaries grow to a fixpoint over the
package call graph (resolved the :mod:`.concurrency` way); *ack* stays
strictly lexical — an ack belongs to the function that replies, and
propagating it through helpers would blame callers for their callees'
replies.

Rules
-----

- **CL901 — durability ordering.** A flow-sensitive happens-before
  walk (branch-forked may-analysis; loop bodies model one request) over
  every function: an ack event after which a journal/commit/ship event
  is still reachable ON THE SAME PATH is a reply the crash right after
  it can orphan — the finding names both events. A ship observed
  before the journal/commit it must follow is the same reorder one hop
  earlier. And every ``except`` handler of a try whose body performs
  (or follows) durability must re-raise, fence the session, or unlink
  the record — swallowing an exception between durability and ack
  serves on with disks that disagree. Handlers nested inside another
  handler (best-effort cleanup, e.g. the fence call itself) are exempt.
- **CL902 — RPC surface drift.** Three surfaces extracted and diffed
  in all directions: the client method table (string literals fed to
  ``.call``/``._call_data``/``._rpc_future``, plus ``retry_call``-
  wrapped ``.call``), the server dispatch tables, and the
  ``Transport`` handle surface (public methods of every ``WorkerBase``
  subclass, pairwise). A method added to one side can't silently no-op.
- **CL903 — error-taxonomy soundness.** Every class defining an
  ``error_code`` must be in the ``ERROR_CODES`` registry (and vice
  versa), codes must be unique, every registered class must stay
  marshalable as ``cls(message, **context)`` (no extra required
  ``__init__`` params — ``wire.unmarshal_error`` reconstructs with
  exactly that shape), raise sites must use registered classes, and
  ``RETRYABLE_CODES`` must agree with the per-code retry semantics:
  every retryable code is somewhere raised with an honest
  ``retry_after_s=``, and every code raised with one is in the tuple.
- **CL904 — idempotency coverage.** A function that accepts the
  ``append_id`` token must USE it — forward it into a call or test it
  against the dedupe set; accepting and dropping it silently turns a
  retried append into a double fold. On whole-package scans the
  journal side must be matched by the replay side: an
  ``append_id in <dedupe set>`` membership guard and a
  ``.add(append_id)`` seeding call must both exist somewhere, or
  replay cannot recognize the records the journal deduplicates.
- **CL905 — retry-scope.** ``retry_call``/``@retry`` may only retry
  transient ``OSError`` surfaces: a ``retry_on=`` naming a taxonomy
  class (or ``Exception``/``BaseException``) retries a structured
  refusal that cannot become valid; a retry reached after the
  durability point replays a side effect; a retry inside a handler
  that fences is retrying across a fence.

``# consensus-lint: disable=CL90x — rationale`` suppresses in place.
:func:`happens_before` exports the static per-operation event graph
(the shape :mod:`.protocol_witness` validates observed orders against).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, NamedTuple, Optional, Set, Tuple

from .findings import Finding
from .rules import _dotted, _line_directives, _Module, scan_targets
from .concurrency import _FuncInfo, _Package

#: rule ID -> (severity, one-line description)
PROTOCOL_RULES = {
    "CL901": ("error", "durability ordering: an ack/reply/Future "
                       "resolution precedes the journal write or ship "
                       "on some path, a ship precedes its journal/"
                       "commit, or an exception path between durability "
                       "and ack neither re-raises, fences the session, "
                       "nor unlinks the record"),
    "CL902": ("error", "RPC surface drift: client method table, server "
                       "dispatch table, and WorkerBase handle surfaces "
                       "disagree (a method on one side silently no-ops "
                       "on the other)"),
    "CL903": ("error", "error-taxonomy drift: unregistered error_code "
                       "class / dead registry entry / duplicate code / "
                       "non-marshalable __init__ / RETRYABLE_CODES "
                       "inconsistent with retry_after_s raise sites"),
    "CL904": ("error", "idempotency gap: the append_id token is "
                       "accepted but dropped, or the journal side has "
                       "no matching replay dedupe guard/seeding"),
    "CL905": ("error", "retry-scope violation: retry_call/@retry "
                       "retries a taxonomy error or blanket Exception, "
                       "runs after the durability point, or runs "
                       "inside a fencing handler"),
}

#: call tails with a fixed protocol-event meaning (receiver-independent:
#: the names are unique to the replication/transport layer)
_JOURNAL_TAILS = {"journal_block"}
_COMMIT_TAILS = {"commit_round"}
_SHIP_TAILS = {"ship_file"}
_FENCE_TAILS = {"fence"}
_UNLINK_TAILS = {"unlink"}
_ACK_TAILS = {"set_result"}

#: client-side RPC invocation tails whose first string argument names a
#: method (CL902 client table)
_CLIENT_CALL_TAILS = {"call", "_call_data", "_rpc_future"}

#: retry_on= entries that retry everything, not a transient surface
_BLANKET_RETRY = {"Exception", "BaseException", "ConsensusError"}

#: qualname -> witness operation kind (the static half of the
#: happens-before graph :mod:`.protocol_witness` joins against)
PROTOCOL_OPS = {
    "session.append": ("DurableSession", "append"),
    "session.resolve": ("DurableSession", "resolve"),
    "worker.append": ("FleetWorkerProcess", "append"),
    "worker.submit_session": ("FleetWorkerProcess", "submit_session"),
    "worker.create_session": ("FleetWorkerProcess", "create_session"),
}


def _tail(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _scope_walk(node: ast.AST) -> Iterable[ast.AST]:
    """Walk without descending into nested defs/classes (their events
    belong to their own scope); lambda bodies stay in this scope."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            stack.append(child)


def _resolve_callee(pkg: _Package, info: _FuncInfo,
                    node: ast.Call) -> Optional[_FuncInfo]:
    """The scanned function a call lands in, or None — Name via module
    scope, ``self``/``cls``/``super()`` via the MRO, ``ClassName.m`` via
    the class scope, unique-method-name fallback last (the Layer 4
    resolution order)."""
    fn = node.func
    if isinstance(fn, ast.Name):
        target = pkg.func_scope.get(info.mod.path, {}).get(fn.id)
        return pkg.infos.get(target) if target is not None else None
    if not isinstance(fn, ast.Attribute):
        return None
    if isinstance(fn.value, ast.Call) \
            and _dotted(fn.value.func) == "super" \
            and info.cls is not None:
        for c in pkg.mro(info.cls)[1:]:
            if fn.attr in c.methods:
                return pkg.infos.get(c.methods[fn.attr])
        return None
    root = _dotted(fn.value)
    if root in ("self", "cls") and info.cls is not None:
        for c in pkg.mro(info.cls):
            if fn.attr in c.methods:
                return pkg.infos.get(c.methods[fn.attr])
        return None
    cinfo = pkg.resolve_class(info.mod, root) if root else None
    if cinfo is not None:
        for c in pkg.mro(cinfo):
            if fn.attr in c.methods:
                return pkg.infos.get(c.methods[fn.attr])
        return None
    target = pkg.unique_method(fn.attr)
    if target is not None:
        return pkg.infos.get(target)
    return None


def _direct_kinds(node: ast.Call) -> Set[str]:
    """Receiver-independent event classification of one call site."""
    tail = _tail(node)
    kinds: Set[str] = set()
    if tail in _JOURNAL_TAILS:
        kinds.add("journal")
    if tail in _COMMIT_TAILS:
        kinds.add("commit")
    if tail in _SHIP_TAILS:
        kinds.add("ship")
    if tail in _FENCE_TAILS:
        kinds.add("fence")
    if tail in _UNLINK_TAILS:
        kinds.add("unlink")
    if tail in _ACK_TAILS:
        kinds.add("ack")
    if tail == "send_msg" and len(node.args) >= 2 \
            and isinstance(node.args[1], ast.Dict):
        for key in node.args[1].keys:
            if isinstance(key, ast.Constant) \
                    and key.value in ("result", "error"):
                kinds.add("ack")
                break
    for kw in node.keywords:
        if kw.arg == "append_id" and not (
                isinstance(kw.value, ast.Constant)
                and kw.value.value is None):
            kinds.add("journal")
            break
    return kinds


#: summary kinds that propagate interprocedurally (ack never does: the
#: ack belongs to the lexical replier)
_SUMMARY_KINDS = ("journal", "commit", "ship", "fence", "unlink")


def _grow_protocol_summaries(pkg: _Package) -> Dict[ast.AST, Set[str]]:
    """Per-function event summaries (journal/commit/ship/fence/unlink)
    grown to a fixpoint through resolvable calls."""
    summaries: Dict[ast.AST, Set[str]] = {}
    calls: Dict[ast.AST, List[Optional[_FuncInfo]]] = {}
    for fn, info in pkg.infos.items():
        direct: Set[str] = set()
        callees: List[Optional[_FuncInfo]] = []
        for node in _scope_walk(fn):
            if isinstance(node, ast.Call):
                direct |= _direct_kinds(node) & set(_SUMMARY_KINDS)
                callees.append(_resolve_callee(pkg, info, node))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and t.attr == "_fenced":
                        direct.add("fence")
        summaries[fn] = direct
        calls[fn] = callees
    for _ in range(16):
        changed = False
        for fn in pkg.infos:
            for callee in calls[fn]:
                if callee is None:
                    continue
                extra = summaries.get(callee.fn, set()) - summaries[fn]
                if extra:
                    summaries[fn] |= extra
                    changed = True
        if not changed:
            break
    return summaries


def _reply_methods(pkg: _Package) -> Tuple[Set[ast.AST], List[dict]]:
    """Dispatch-handler methods + server tables. A server table is a
    dict literal mapping string method names to ``self.<m>`` handlers —
    either returned from a function named ``handlers`` or passed to an
    ``RpcServer(...)`` construction. Returns (handler fn nodes,
    [{method: (mod, key lineno, class qual)} tables])."""
    reply: Set[ast.AST] = set()
    tables: List[dict] = []

    def harvest(d: ast.Dict, info: _FuncInfo) -> None:
        table: dict = {}
        for key, value in zip(d.keys, d.values):
            if not (isinstance(key, ast.Constant)
                    and isinstance(key.value, str)):
                continue
            table[key.value] = (info.mod, key.lineno,
                                info.cls.qual if info.cls else "")
            if isinstance(value, ast.Attribute) \
                    and isinstance(value.value, ast.Name) \
                    and value.value.id == "self" and info.cls is not None:
                for c in pkg.mro(info.cls):
                    if value.attr in c.methods:
                        reply.add(c.methods[value.attr])
                        break
        if table:
            tables.append(table)

    for fn, info in pkg.infos.items():
        for node in _scope_walk(fn):
            if isinstance(node, ast.Return) and fn.name == "handlers" \
                    and isinstance(node.value, ast.Dict):
                harvest(node.value, info)
            elif isinstance(node, ast.Call) \
                    and _tail(node) == "RpcServer" and node.args \
                    and isinstance(node.args[0], ast.Dict):
                harvest(node.args[0], info)
    return reply, tables


# -- CL901: the flow-sensitive happens-before walk --------------------------


class _Event(NamedTuple):
    kind: str
    line: int
    label: str


class _PathState:
    """May-have-happened event sets along one path. Forked at branches,
    merged at joins — sets only grow, so the analysis is monotone."""

    __slots__ = ("acks", "durs")

    def __init__(self, acks=None, durs=None):
        self.acks: Dict[int, _Event] = dict(acks or {})
        self.durs: Dict[int, _Event] = dict(durs or {})

    def fork(self) -> "_PathState":
        return _PathState(self.acks, self.durs)


def _merge(*states: Optional[_PathState]) -> Optional[_PathState]:
    live = [s for s in states if s is not None]
    if not live:
        return None
    out = live[0].fork()
    for s in live[1:]:
        out.acks.update(s.acks)
        out.durs.update(s.durs)
    return out


class _FlowWalk:
    """One ordering walk over a function: emits CL901 ordering findings
    and the flow-dependent half of CL905. ``terms`` collect the states
    at value-returning exits of dispatch handlers (the return IS the
    ack) so a ``finally`` that ships after the reply is still seen."""

    def __init__(self, pkg: _Package, info: _FuncInfo,
                 summaries: Dict[ast.AST, Set[str]],
                 reply: Set[ast.AST], emit) -> None:
        self.pkg = pkg
        self.info = info
        self.summaries = summaries
        self.is_reply = info.fn in reply
        self.emit = emit

    # -- event classification ------------------------------------------

    def _kinds(self, node: ast.Call) -> Set[str]:
        kinds = set(_direct_kinds(node))
        if not kinds & {"journal", "commit", "ship"}:
            callee = _resolve_callee(self.pkg, self.info, node)
            if callee is not None:
                kinds |= self.summaries.get(callee.fn, set()) \
                    & {"journal", "commit", "ship"}
        return kinds

    def _label(self, node: ast.AST) -> str:
        lines = self.pkg.lines(self.info.mod)
        ln = getattr(node, "lineno", 0)
        return lines[ln - 1].strip() if 0 < ln <= len(lines) else ""

    # -- the walk -------------------------------------------------------

    def run(self) -> None:
        self._stmts(list(self.info.fn.body), _PathState(),
                    in_handler=False)

    def _stmts(self, stmts: List[ast.stmt], state: Optional[_PathState],
               in_handler: bool
               ) -> Tuple[Optional[_PathState], List[_PathState]]:
        terms: List[_PathState] = []
        for st in stmts:
            if state is None:
                break
            state, t = self._stmt(st, state, in_handler)
            terms.extend(t)
        return state, terms

    def _stmt(self, st: ast.stmt, state: _PathState, in_handler: bool
              ) -> Tuple[Optional[_PathState], List[_PathState]]:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return state, []
        if isinstance(st, ast.Return):
            if st.value is not None:
                self._expr(st.value, state, in_handler)
                if self.is_reply:
                    term = state.fork()
                    term.acks[st.lineno] = _Event(
                        "ack", st.lineno,
                        "dispatch-handler return (the reply frame)")
                    return None, [term]
            return None, []
        if isinstance(st, ast.Raise):
            if st.exc is not None:
                self._expr(st.exc, state, in_handler)
            return None, []
        if isinstance(st, (ast.If, ast.While)):
            self._expr(st.test, state, in_handler)
            o1, t1 = self._stmts(st.body, state.fork(), in_handler)
            o2, t2 = self._stmts(st.orelse, state.fork(), in_handler)
            if isinstance(st, ast.While):
                o1 = _merge(state, o1)
            return _merge(o1, o2), t1 + t2
        if isinstance(st, ast.For):
            self._expr(st.iter, state, in_handler)
            ob, tb = self._stmts(st.body, state.fork(), in_handler)
            oe, te = self._stmts(st.orelse,
                                 (_merge(state, ob) or state).fork(),
                                 in_handler)
            return _merge(state, ob, oe), tb + te
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._expr(item.context_expr, state, in_handler)
            return self._stmts(st.body, state, in_handler)
        if isinstance(st, ast.Try):
            return self._try(st, state, in_handler)
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._expr(child, state, in_handler)
        return state, []

    def _try(self, st: ast.Try, state: _PathState, in_handler: bool
             ) -> Tuple[Optional[_PathState], List[_PathState]]:
        relevant = (not in_handler) and (
            bool(state.durs) or self._body_has_durability(st.body))
        ob, tb = self._stmts(st.body, state.fork(), in_handler)
        # an exception can fire at any point in the body: the handlers
        # see the union of everything the body may have done
        handler_in = _merge(state, ob, *tb) or state
        outs: List[Optional[_PathState]] = []
        terms: List[_PathState] = list(tb)
        for h in st.handlers:
            if relevant:
                self._check_handler(h)
            oh, th = self._stmts(h.body, handler_in.fork(),
                                 in_handler=True)
            outs.append(oh)
            terms.extend(th)
        oe: Optional[_PathState] = ob
        if st.orelse:
            oe, te = self._stmts(st.orelse,
                                 ob.fork() if ob else handler_in.fork(),
                                 in_handler)
            terms.extend(te)
        out = _merge(oe, *outs)
        if st.finalbody:
            fin_in = _merge(out, *terms) or state
            of, tf = self._stmts(st.finalbody, fin_in.fork(), in_handler)
            terms.extend(tf)
            out = of if out is not None else None
        return out, terms

    def _body_has_durability(self, stmts: List[ast.stmt]) -> bool:
        for st in stmts:
            for node in _scope_walk(st):
                if isinstance(node, ast.Call) \
                        and self._kinds(node) & {"journal", "commit",
                                                 "ship"}:
                    return True
        return False

    def _check_handler(self, h: ast.ExceptHandler) -> None:
        """A handler on the durability path must re-raise, fence, or
        unlink; a handler that fences must not retry (CL905)."""
        reraises = fences = False
        retry_line = 0
        for node in _scope_walk(h):
            if isinstance(node, ast.Raise):
                reraises = True
            elif isinstance(node, ast.Call):
                kinds = _direct_kinds(node)
                callee = _resolve_callee(self.pkg, self.info, node)
                if callee is not None:
                    kinds |= self.summaries.get(callee.fn, set())
                if kinds & {"fence", "unlink"}:
                    fences = True
                if _tail(node) == "retry_call":
                    retry_line = node.lineno
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                if any(isinstance(t, ast.Attribute) and t.attr == "_fenced"
                       for t in targets):
                    fences = True
        if not (reraises or fences):
            self.emit(self.info.mod, h.lineno, "CL901",
                      f"exception path between durability and ack in "
                      f"'{self.info.name}' neither re-raises, fences "
                      f"the session, nor unlinks the journal record — "
                      f"swallowing here serves on with memory, local "
                      f"disk, and the standby's disk free to disagree "
                      f"about an acknowledged write")
        if fences and not reraises and retry_line:
            self.emit(self.info.mod, retry_line, "CL905",
                      f"retry_call inside a fencing handler of "
                      f"'{self.info.name}' — the fence declares this "
                      f"session unserveable; retrying across it serves "
                      f"from state the fence just disowned")

    def _expr(self, node: ast.AST, state: _PathState,
              in_handler: bool) -> None:
        if isinstance(node, ast.Call):
            for a in node.args:
                self._expr(a, state, in_handler)
            for kw in node.keywords:
                self._expr(kw.value, state, in_handler)
            self._call(node, state)
            return
        if isinstance(node, ast.Lambda):
            self._expr(node.body, state, in_handler)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, state, in_handler)

    def _call(self, node: ast.Call, state: _PathState) -> None:
        kinds = self._kinds(node)
        line = node.lineno
        label = self._label(node)
        if _tail(node) == "retry_call" \
                and {k for e in state.durs.values()
                     for k in (e.kind,)} & {"journal", "commit"}:
            first = min(state.durs.values(), key=lambda e: e.line)
            self.emit(self.info.mod, line, "CL905",
                      f"retry_call after the durability point "
                      f"('{first.label}' at line {first.line}) in "
                      f"'{self.info.name}' — a retried side effect "
                      f"after the journal write replays a mutation the "
                      f"log already holds")
        for kind in ("journal", "commit", "ship"):
            if kind not in kinds:
                continue
            if state.acks:
                ack = min(state.acks.values(), key=lambda e: e.line)
                self.emit(self.info.mod, line, "CL901",
                          f"ack '{ack.label}' at line {ack.line} "
                          f"precedes the {kind} event '{label}' at "
                          f"line {line} in '{self.info.name}' — a "
                          f"crash between them acknowledges a write "
                          f"that is not durable everywhere a takeover "
                          f"reads")
            if kind in ("journal", "commit") \
                    and any(e.kind == "ship" for e in state.durs.values()):
                ship = min((e for e in state.durs.values()
                            if e.kind == "ship"), key=lambda e: e.line)
                self.emit(self.info.mod, line, "CL901",
                          f"ship '{ship.label}' at line {ship.line} "
                          f"precedes the {kind} event '{label}' at "
                          f"line {line} in '{self.info.name}' — the "
                          f"standby receives a record the local "
                          f"journal does not hold yet")
            state.durs[line] = _Event(kind, line, label)
        if "ack" in kinds:
            state.acks[line] = _Event("ack", line, label)


# -- CL902: surface extraction ----------------------------------------------


def _client_methods(pkg: _Package) -> List[Tuple[_Module, int, str]]:
    out: List[Tuple[_Module, int, str]] = []
    for fn, info in pkg.infos.items():
        for node in _scope_walk(fn):
            if not isinstance(node, ast.Call):
                continue
            tail = _tail(node)
            if tail in _CLIENT_CALL_TAILS and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                out.append((info.mod, node.lineno, node.args[0].value))
            elif tail == "retry_call" and len(node.args) >= 2 \
                    and isinstance(node.args[0], ast.Attribute) \
                    and node.args[0].attr == "call" \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str):
                out.append((info.mod, node.lineno, node.args[1].value))
    return out


def _check_surfaces(pkg: _Package, tables: List[dict], emit,
                    full_scan: bool) -> None:
    served: Set[str] = set()
    for table in tables:
        served |= set(table)
    clients = _client_methods(pkg)
    if tables:
        for mod, line, method in clients:
            if method not in served:
                emit(mod, line, "CL902",
                     f"client invokes rpc method {method!r} but no "
                     f"scanned server dispatch table serves it — the "
                     f"call can only ever raise 'unknown rpc method'")
    if full_scan and tables and clients:
        used = {m for _, _, m in clients}
        for table in tables:
            for method, (mod, line, cls) in sorted(table.items()):
                if method not in used:
                    emit(mod, line, "CL902",
                         f"server dispatch table entry {method!r} "
                         f"({cls or 'table'}) has no client invocation "
                         f"anywhere in the package — dead surface, or "
                         f"a client-side method lost its wiring")
    # -- handle-surface diff: every WorkerBase subclass must expose the
    # same public method set (the Transport contract in base.py)
    if not full_scan:
        return
    base_methods: Set[str] = set()
    subclasses = []
    for qual, cinfo in sorted(pkg.classes.items()):
        if cinfo.name == "WorkerBase":
            base_methods |= set(cinfo.methods)
        elif any(b.split(".")[-1] == "WorkerBase" for b in cinfo.bases):
            subclasses.append(cinfo)
    if len(subclasses) < 2:
        return
    surfaces = {
        c.qual: {m for m in c.methods
                 if not m.startswith("_") and m not in base_methods}
        for c in subclasses}
    for c in subclasses:
        for m in sorted(surfaces[c.qual]):
            missing = [o.name for o in subclasses
                       if o is not c and m not in surfaces[o.qual]]
            if missing:
                emit(c.mod, c.methods[m].lineno, "CL902",
                     f"handle method '{m}' exists on {c.name} but not "
                     f"on {', '.join(missing)} — the Transport handle "
                     f"surfaces must agree or the fleet behaves "
                     f"differently per transport")


# -- CL903: taxonomy extraction ---------------------------------------------


class _Taxonomy(NamedTuple):
    classes: Dict[str, Tuple[str, _Module, int, ast.ClassDef]]
    registered: Set[str]
    registry_site: Optional[Tuple[_Module, int]]
    retryable: Optional[Tuple[List[str], _Module, int]]


def _collect_taxonomy(pkg: _Package) -> _Taxonomy:
    classes: Dict[str, Tuple[str, _Module, int, ast.ClassDef]] = {}
    registered: Set[str] = set()
    registry_site = None
    retryable = None
    for rel, mod in sorted(pkg.mods.items()):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.Assign) \
                            and len(sub.targets) == 1 \
                            and isinstance(sub.targets[0], ast.Name) \
                            and sub.targets[0].id == "error_code" \
                            and isinstance(sub.value, ast.Constant) \
                            and isinstance(sub.value.value, str):
                        classes.setdefault(
                            node.name,
                            (sub.value.value, mod, node.lineno, node))
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if name == "ERROR_CODES" \
                        and isinstance(node.value, ast.DictComp):
                    it = node.value.generators[0].iter
                    if isinstance(it, (ast.Tuple, ast.List)):
                        registered |= {e.id for e in it.elts
                                       if isinstance(e, ast.Name)}
                        registry_site = (mod, node.lineno)
                elif name == "RETRYABLE_CODES" \
                        and isinstance(node.value, (ast.Tuple, ast.List)):
                    codes = [e.value for e in node.value.elts
                             if isinstance(e, ast.Constant)
                             and isinstance(e.value, str)]
                    retryable = (codes, mod, node.lineno)
    return _Taxonomy(classes, registered, registry_site, retryable)


def _check_taxonomy(pkg: _Package, tax: _Taxonomy, emit,
                    full_scan: bool) -> None:
    if tax.registry_site is None:
        return
    reg_mod, reg_line = tax.registry_site
    by_code: Dict[str, str] = {}
    for name, (code, mod, line, node) in sorted(tax.classes.items()):
        if name not in tax.registered:
            emit(mod, line, "CL903",
                 f"taxonomy class {name} defines error_code {code!r} "
                 f"but is not in the ERROR_CODES registry — its errors "
                 f"cross the wire as the generic remote-failure shape, "
                 f"code and context lost")
        prior = by_code.get(code)
        if prior is not None:
            emit(mod, line, "CL903",
                 f"error_code {code!r} is claimed by both {prior} and "
                 f"{name} — the registry maps each code to ONE class; "
                 f"a duplicate silently shadows on unmarshal")
        by_code.setdefault(code, name)
        # marshalability: wire.unmarshal_error reconstructs with
        # cls(message, **context) — extra required params break it
        for sub in node.body:
            if not (isinstance(sub, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))
                    and sub.name == "__init__"):
                continue
            a = sub.args
            required = (a.posonlyargs + a.args)[1:]
            n_defaults = len(a.defaults)
            bad = [p.arg for i, p in enumerate(required)
                   if i < len(required) - n_defaults]
            kwonly_bad = [p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults)
                          if d is None]
            if bad or kwonly_bad or a.kwarg is None:
                emit(mod, sub.lineno, "CL903",
                     f"{name}.__init__ is not marshalable as "
                     f"cls(message, **context): required params "
                     f"{bad + kwonly_bad or '(no **context)'} — "
                     f"unmarshal_error cannot rebuild it client-side "
                     f"with code and context intact")
    for name in sorted(tax.registered - set(tax.classes)):
        emit(reg_mod, reg_line, "CL903",
             f"ERROR_CODES registers {name} but no scanned class of "
             f"that name defines an error_code — dead registry entry")
    # raise sites must use registered classes
    hint_codes: Dict[str, List[Tuple[_Module, int]]] = {}
    for fn, info in pkg.infos.items():
        for node in _scope_walk(fn):
            if not isinstance(node, ast.Call):
                continue
            tail = _tail(node)
            entry = tax.classes.get(tail)
            if entry is None:
                continue
            if tail not in tax.registered:
                emit(info.mod, node.lineno, "CL903",
                     f"raise site constructs unregistered taxonomy "
                     f"class {tail} — its {entry[0]!r} code does not "
                     f"survive the wire")
            if any(kw.arg == "retry_after_s" for kw in node.keywords):
                hint_codes.setdefault(entry[0], []).append(
                    (info.mod, node.lineno))
    if tax.retryable is None:
        return
    codes, rmod, rline = tax.retryable
    known = {code for code, *_ in tax.classes.values()}
    for code in codes:
        if code not in known:
            emit(rmod, rline, "CL903",
                 f"RETRYABLE_CODES lists {code!r} but no scanned "
                 f"taxonomy class carries that code")
        elif full_scan and code not in hint_codes:
            emit(rmod, rline, "CL903",
                 f"RETRYABLE_CODES lists {code!r} but no raise site in "
                 f"the package offers a retry_after_s hint for it — "
                 f"clients are told to retry with no honest window")
    for code, sites in sorted(hint_codes.items()):
        if code not in codes:
            mod, line = sites[0]
            emit(mod, line, "CL903",
                 f"{code} is raised with a retry_after_s hint here but "
                 f"is not in RETRYABLE_CODES — the client-side retry "
                 f"policy will drop a retry the server priced")


# -- CL904: idempotency-token threading -------------------------------------


def _check_idempotency(pkg: _Package, emit, full_scan: bool) -> None:
    journal_with_token = False
    has_guard = has_seed = False
    for fn, info in pkg.infos.items():
        params = fn.args
        names = {a.arg for a in (params.posonlyargs + params.args
                                 + params.kwonlyargs)}
        takes_token = "append_id" in names
        uses_token = False
        for node in _scope_walk(fn):
            if isinstance(node, ast.Call):
                passes = any(
                    kw.arg == "append_id" or (
                        kw.arg is None
                        and isinstance(kw.value, ast.Name)
                        and kw.value.id == "append_id")
                    for kw in node.keywords) or any(
                    isinstance(a, ast.Name) and a.id == "append_id"
                    for a in node.args)
                if passes:
                    uses_token = True
                if _tail(node) in _JOURNAL_TAILS and any(
                        kw.arg == "append_id" for kw in node.keywords):
                    journal_with_token = True
                if _tail(node) == "add" and any(
                        isinstance(a, ast.Name) and a.id == "append_id"
                        for a in node.args):
                    has_seed = True
            elif isinstance(node, ast.Dict):
                # forwarding the token inside a wire params literal
                # ({"append_id": append_id}) threads it too
                if any(isinstance(v, ast.Name) and v.id == "append_id"
                       for v in node.values):
                    uses_token = True
            elif isinstance(node, ast.Compare):
                if isinstance(node.left, ast.Name) \
                        and node.left.id == "append_id" \
                        and any(isinstance(op, ast.In)
                                for op in node.ops):
                    has_guard = True
                    uses_token = True
        if takes_token and not uses_token:
            emit(info.mod, fn.lineno, "CL904",
                 f"'{fn.name}' accepts the append_id idempotency token "
                 f"and drops it — the journal record it leads to can "
                 f"never be deduplicated, so a retried append folds "
                 f"twice")
    if full_scan and journal_with_token:
        if not has_guard:
            emit(None, 0, "CL904",
                 "the journal threads append_id but no scanned code "
                 "membership-tests it against a dedupe set — a retried "
                 "append is journaled (and folded) twice",
                 path="protocol:idempotency")
        if not has_seed:
            emit(None, 0, "CL904",
                 "the journal threads append_id but no scanned code "
                 "seeds a dedupe set from it (.add(append_id)) — "
                 "replay on the standby cannot recognize already-"
                 "applied records", path="protocol:idempotency")


# -- CL905: retry_on inspection (flow-independent half) ---------------------


def _check_retry_scope(pkg: _Package, tax: _Taxonomy, emit) -> None:
    for fn, info in pkg.infos.items():
        for node in _scope_walk(fn):
            if not isinstance(node, ast.Call) \
                    or _tail(node) not in ("retry_call", "retry"):
                continue
            for kw in node.keywords:
                if kw.arg != "retry_on":
                    continue
                elts = kw.value.elts \
                    if isinstance(kw.value, (ast.Tuple, ast.List)) \
                    else [kw.value]
                for e in elts:
                    name = (_dotted(e) or "").split(".")[-1]
                    if name in tax.classes or name in _BLANKET_RETRY:
                        emit(info.mod, node.lineno, "CL905",
                             f"retry_on includes {name} — a structured "
                             f"refusal does not become valid by "
                             f"retrying; only transient OSError "
                             f"surfaces ride the bounded-retry path")


# -- drivers ----------------------------------------------------------------


def _analyze(pkg: _Package, select: Optional[Set[str]],
             full_scan: bool) -> List[Finding]:
    directives = {rel: _line_directives(mod.text)
                  for rel, mod in pkg.mods.items()}
    findings: List[Finding] = []

    def emit(mod: Optional[_Module], line: int, rule: str,
             message: str, path: Optional[str] = None) -> None:
        if select is not None and rule not in select:
            return
        if mod is not None:
            sup = directives.get(mod.path, {}).get(line, set())
            if "*" in sup or rule in sup:
                return
            lines = pkg.lines(mod)
            snippet = lines[line - 1].strip() \
                if 0 < line <= len(lines) else ""
            rel = mod.path
        else:
            snippet, rel = "", path or "protocol:package"
        findings.append(Finding(
            rule=rule, path=rel, line=line, message=message,
            severity=PROTOCOL_RULES[rule][0], snippet=snippet))

    summaries = _grow_protocol_summaries(pkg)
    reply, tables = _reply_methods(pkg)
    tax = _collect_taxonomy(pkg)
    if select is None or select & {"CL901", "CL905"}:
        for fn, info in pkg.infos.items():
            _FlowWalk(pkg, info, summaries, reply, emit).run()
    if select is None or "CL902" in select:
        _check_surfaces(pkg, tables, emit, full_scan)
    if select is None or "CL903" in select:
        _check_taxonomy(pkg, tax, emit, full_scan)
    if select is None or "CL904" in select:
        _check_idempotency(pkg, emit, full_scan)
    if select is None or "CL905" in select:
        _check_retry_scope(pkg, tax, emit)
    return findings


def analyze_protocol(paths=None, root=None,
                     select: Optional[Set[str]] = None) -> List[Finding]:
    """Run Layer 5 over ``paths`` (default: the installed package — a
    full scan, which also enables the whole-surface CL902 direction,
    the RETRYABLE coverage direction of CL903, and the package-level
    CL904 dedupe checks). Findings sorted by (path, line, rule)."""
    files = scan_targets(paths, root)
    pkg = _Package(files)
    findings = _analyze(pkg, select, full_scan=paths is None)
    uniq = {}
    for f in findings:
        uniq.setdefault((f.rule, f.path, f.line, f.message), f)
    return sorted(uniq.values(), key=lambda f: (f.path, f.line, f.rule))


# -- the static happens-before export ---------------------------------------


def _success_events(pkg: _Package, info: _FuncInfo,
                    summaries: Dict[ast.AST, Set[str]],
                    visited: Set[ast.AST], out: List[str]) -> None:
    """Direct journal/commit/ship events on the success path of
    ``info``, in program order, with resolvable calls inlined (handlers
    skipped — the success path is the one that acks)."""
    if info.fn in visited:
        return
    visited.add(info.fn)

    def walk_expr(node: ast.AST) -> None:
        if isinstance(node, ast.Call):
            for a in node.args:
                walk_expr(a)
            for kw in node.keywords:
                walk_expr(kw.value)
            kinds = _direct_kinds(node) & {"journal", "commit", "ship"}
            if kinds:
                out.extend(sorted(kinds))
                return
            callee = _resolve_callee(pkg, info, node)
            if callee is not None and summaries.get(callee.fn, set()) \
                    & {"journal", "commit", "ship"}:
                _success_events(pkg, callee, summaries, visited, out)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                walk_expr(child)

    def walk_stmts(stmts: List[ast.stmt]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, ast.Try):
                walk_stmts(st.body)
                walk_stmts(st.orelse)
                walk_stmts(st.finalbody)
                continue
            if isinstance(st, (ast.If, ast.While, ast.For)):
                for child in ast.iter_child_nodes(st):
                    if isinstance(child, ast.expr):
                        walk_expr(child)
                walk_stmts(st.body)
                walk_stmts(st.orelse)
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    walk_expr(item.context_expr)
                walk_stmts(st.body)
                continue
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    walk_expr(child)

    walk_stmts(list(info.fn.body))


def happens_before(paths=None, root=None) -> dict:
    """The static per-operation happens-before graph, in the JSON shape
    :mod:`.protocol_witness` validates observed event orders against:
    ``{"ops": {kind: {"order": [...], "edges": [[a, b], ...],
    "function": "path:Class.method"}}}``. An edge ``[a, b]`` asserts
    that within one operation every ``a`` completes before any ``b``;
    the terminal ``ack`` is the operation's successful return."""
    files = scan_targets(paths, root)
    pkg = _Package(files)
    summaries = _grow_protocol_summaries(pkg)
    ops: Dict[str, dict] = {}
    by_name = {c.name: c for c in pkg.classes.values()}
    for kind, (cls_name, method) in sorted(PROTOCOL_OPS.items()):
        cinfo = by_name.get(cls_name)
        if cinfo is None or method not in cinfo.methods:
            continue
        info = pkg.infos.get(cinfo.methods[method])
        if info is None:
            continue
        seq: List[str] = []
        _success_events(pkg, info, summaries, set(), seq)
        seq.append("ack")
        order: List[str] = []
        for k in seq:
            if k not in order:
                order.append(k)
        edges = [[a, b] for i, a in enumerate(order)
                 for b in order[i + 1:]]
        ops[kind] = {"order": order, "edges": edges,
                     "function": f"{cinfo.mod.path}:{cls_name}.{method}"}
    return {"ops": ops}
