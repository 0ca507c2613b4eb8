"""Layer 4: host-concurrency analysis (CL801-805).

The port's host code is lock-dense: the fleet's declare locks, session
fences, the ``_migrating`` claim, the batcher, queue, cache and
admission locks, and locks the reference never had: the kernel build
lock (``ops/build.py _LOCK``), the first-``torch.linalg`` lock
(``serve/service.py _LINALG_LOCK``), the kernel store's and the
autotuner's. This layer checks them statically; its runtime mirror is
:mod:`.witness`.

Model
-----

**Lock identities** are attribute-resolved, not value-tracked: every
``self.<attr> = threading.Lock()/RLock()/Condition()/Semaphore()``
assignment defines a lock ``Class.<attr>`` (inheritance-aware — a
``DurableSession`` method taking ``self._lock`` holds
``MarketSession._lock``); module-level ``NAME = threading.Lock()``
defines ``module.NAME``; a local ``lock = threading.Lock()`` is a
function-scoped identity. A non-``self`` receiver resolves through a
small type environment (parameter annotations, ``x = ClassName(...)``
assignments, ``self.<attr>`` types recorded from ``__init__``) and
falls back to attribute-name uniqueness (``w.declare_lock`` is a
``WorkerBase`` lock because no other scanned class defines that
attribute); a genuinely ambiguous receiver gets a site-unique identity
— it still counts as "a lock is held" but can never fabricate a
cross-site cycle.

**Held-lock sets** are lexical (``with`` nesting, plus a linear
``.acquire()``/``.release()`` approximation) and interprocedural: each
function's *entry held set* is the intersection of the held sets at
every resolved call site (call sites inside ``__init__`` bodies are
construction-time and excluded — the object is not shared yet), grown
to a fixpoint over the package call graph, resolved through module
scopes, import aliases, ``self``/``cls`` methods and the receiver-type
environment. Lambda bodies are walked in their enclosing function.

Rules
-----

- **CL801 — lock-order cycles.** Every acquisition of ``B`` while
  ``A`` is held contributes a may-hold-before edge ``A -> B``
  (callee acquisitions propagate through summaries). A cycle in that
  graph is a potential deadlock the moment two threads interleave. A
  ``# consensus-lint: lock-order A < B`` comment documents an intended
  total order; an edge contradicting a declared order is reported even
  without a full cycle.
- **CL802 — blocking under a lock.** ``Future.result``, queue
  get/put/join, ``Event.wait``, ``Condition.wait`` (on a condition
  *other* than one currently held — waiting on the held condition
  releases it, the correct idiom), ``Thread.join``, ``time.sleep``,
  the waits that block on the card (``torch.cuda.synchronize()`` and
  ``.synchronize()`` on a CUDA ``Event`` or ``Stream``, the port's
  counterpart of ``block_until_ready``), the ``nvcc`` subprocess waits
  (``Popen.wait``/``Popen.communicate``), replication-log/ledger I/O
  (``journal_block``/``commit_round``/``replay_session``/
  ``verify_collect``/``atomic_write``), and fault-site hooks that take
  a ``path=`` (the torn-write file forms — a bare ``fire(site)`` is
  raise-only and exempt) reached while any lock is held. Bounded forms
  (an explicit timeout argument) are exempt: they delay, not deadlock.
  ``.item()`` and ``.cpu()`` also wait for the card when their tensor
  lives there, but a receiver's device cannot be typed statically and
  both names are common on host tensors and numpy scalars; counting
  them would bury the real waits under false positives, so they are
  left out.
- **CL803/CL804 — guarded-by inference.** For every mutable instance
  attribute, the write sites' held-lock sets vote: a lock held at a
  strict majority of (non-construction) write sites is the inferred
  guard, and a ``# guarded-by: _lock`` comment on the attribute's
  ``__init__`` assignment pins it explicitly (``# guarded-by: none``
  opts an attribute out). A write with the guard absent is CL803 when
  nothing is held and CL804 when a *different* lock is held; an
  attribute whose write sites split across locks with no majority is
  one CL804 asking for an annotation. Reads are deliberately not
  flagged (racy reads of monotonic floats/bools are this codebase's
  documented idiom); inference needs >= 2 write sites unless annotated.
- **CL805 — fault-site catalog drift.** Every literal site in a
  ``faults.fire``/``faults.corrupt`` hook call must be in
  ``faults.plan.FAULT_SITES``, and (on a whole-package scan) every
  cataloged site must appear at >= 1 hook call.

``# consensus-lint: disable=CL80x — rationale`` suppresses in place;
the rationale rides in the same comment (the directive parser takes the
first token of each comma-separated piece).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Set, Tuple

from .findings import Finding
from .rules import _dotted, _line_directives, _Module, scan_targets
from .dataflow import _module_name

#: rule ID -> (severity, one-line description)
CONCURRENCY_RULES = {
    "CL801": ("error", "lock-order cycle (potential deadlock) or an "
                       "acquisition contradicting a declared "
                       "'# consensus-lint: lock-order A < B' total order"),
    "CL802": ("error", "blocking call (Future.result / queue op / "
                       "Event.wait / sleep / torch.cuda.synchronize / "
                       "Popen.wait / replication-log I/O / torn-write "
                       "fault hook) reached while a lock is held"),
    "CL803": ("error", "guarded instance attribute written with no lock "
                       "held (its other writes hold a guarding lock)"),
    "CL804": ("error", "instance attribute written under inconsistent "
                       "lock sets (a different lock than its guard, or "
                       "no majority guard at all)"),
    "CL805": ("error", "fault-site drift: a hook call names a site "
                       "missing from faults.plan.FAULT_SITES, or a "
                       "cataloged site has no hook call in the package"),
}

#: threading constructors that create mutual-exclusion lock objects
_LOCK_CONSTRUCTORS = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
}

#: dotted calls that block the calling thread outright (CL802); the
#: card's whole-device wait stands where the reference has
#: ``jax.block_until_ready``
_BLOCKING_DOTTED = {
    "time.sleep", "concurrent.futures.wait", "futures.wait",
    "concurrent.futures.as_completed", "futures.as_completed",
    "select.select", "torch.cuda.synchronize",
}

#: method tails that wait for the card on any receiver: a CUDA
#: ``Event``'s or ``Stream``'s ``.synchronize()`` (no other scanned
#: object has a method of that name)
_DEVICE_WAIT_TAILS = {"synchronize"}

#: method tails that are replication-log / ledger / atomic-file I/O —
#: reaching disk while a lock is held stretches the lock over fsync
#: latency (and a shared-filesystem stall becomes a process-wide stall)
_IO_TAILS = {"journal_block", "commit_round", "replay_session",
             "verify_collect", "atomic_write"}

#: handle kind -> method names that block on it (unbounded forms)
_BLOCKING_METHODS = {
    "queue": {"get", "put", "join"},
    "event": {"wait"},
    "future": {"result", "exception"},
    "thread": {"join"},
    "process": {"wait", "communicate"},
}

#: constructor dotted names -> blocking-handle kind (CL701-style handle
#: dataflow, for locals and self attributes alike)
_HANDLE_CONSTRUCTORS = {
    "queue.Queue": "queue", "queue.SimpleQueue": "queue",
    "queue.LifoQueue": "queue", "queue.PriorityQueue": "queue",
    "threading.Event": "event", "threading.Thread": "thread",
    "concurrent.futures.Future": "future", "futures.Future": "future",
    "Future": "future",
    "subprocess.Popen": "process",
}

#: faults-package hook tails whose literal site argument CL805 audits
_HOOK_TAILS = {"fire", "corrupt"}

#: attribute-mutating method names counted as WRITES to ``self.<attr>``
_MUTATOR_METHODS = {
    "append", "extend", "insert", "add", "update", "pop", "popitem",
    "remove", "discard", "clear", "setdefault", "move_to_end",
    "difference_update", "intersection_update", "appendleft",
}

_LOCK_ORDER_RE = re.compile(
    r"consensus-lint:\s*lock-order\s+([\w.]+)\s*<\s*([\w.]+)")
_GUARDED_BY_RE = re.compile(r"#.*guarded-by:\s*([\w]+)")


class LockId(NamedTuple):
    """One lock identity: display name + defining site. Identity is the
    whole tuple — two classes' ``_lock`` attributes never unify, and the
    (path, line) half is what :mod:`.witness` joins its creation-site
    records against."""

    name: str       #: "WorkerBase.declare_lock" / "build._LOCK"
    path: str       #: repo-relative posix path of the defining line
    line: int

    def render(self) -> str:
        return f"{self.name} ({self.path}:{self.line})"


class _ClassInfo:
    """Per-class table: lock attributes, attribute types, methods,
    base-class names, and ``# guarded-by:`` annotations."""

    def __init__(self, qual: str, name: str, mod: _Module,
                 node: ast.ClassDef):
        self.qual = qual
        self.name = name
        self.mod = mod
        self.node = node
        self.bases: List[str] = [d for d in (_dotted(b) for b in node.bases)
                                 if d]
        self.methods: Dict[str, ast.AST] = {}
        self.lock_attrs: Dict[str, int] = {}      # attr -> def line
        self.attr_types: Dict[str, str] = {}      # attr -> dotted class
        self.attr_kinds: Dict[str, str] = {}      # attr -> handle kind
        self.guards: Dict[str, str] = {}          # attr -> lock attr|"none"


class _FuncInfo:
    """Per-function record grown by the fixpoint passes."""

    def __init__(self, mod: _Module, fn: ast.AST,
                 cls: Optional[_ClassInfo]):
        self.mod = mod
        self.fn = fn
        self.cls = cls
        self.name = fn.name
        self.is_init = fn.name == "__init__"
        #: locks this function may acquire, directly or transitively
        self.acquires: Set[LockId] = set()
        #: entry held set: intersection over resolved call sites
        self.entry: Optional[frozenset] = None    # None = no caller seen


class _Package:
    """Whole-scan state: modules, classes, functions, scope maps."""

    def __init__(self, files: List[Tuple]):
        self.mods: Dict[str, _Module] = {}
        self.modname: Dict[str, str] = {}
        self.classes: Dict[str, _ClassInfo] = {}       # qual -> info
        self.class_scope: Dict[str, Dict[str, str]] = {}  # rel -> name->qual
        self.func_scope: Dict[str, Dict[str, ast.AST]] = {}
        self.infos: Dict[ast.AST, _FuncInfo] = {}
        self.module_locks: Dict[str, Dict[str, LockId]] = {}  # rel->name->id
        #: method name -> [(class qual, node)] for unique-name fallback
        self.method_sites: Dict[str, List[Tuple[str, ast.AST]]] = {}
        #: lock attr name -> [class quals defining it]
        self.lock_attr_owners: Dict[str, List[str]] = {}
        self.order_decls: List[Tuple[str, str, str, int]] = []  # a<b @site
        self._lines: Dict[str, List[str]] = {}    # rel -> splitlines
        for f, rel in files:
            try:
                text = f.read_text(encoding="utf-8")
                tree = ast.parse(text, filename=str(f))
            except (OSError, SyntaxError):
                continue
            mod = _Module(rel, text, tree)
            self.mods[rel] = mod
            self.modname[rel] = _module_name(rel)
        for rel, mod in self.mods.items():
            self._index_module(rel, mod)
        self._build_scopes()
        for rel, mod in self.mods.items():
            self._collect_order_decls(rel, mod)

    # -- indexing -------------------------------------------------------

    def _index_module(self, rel: str, mod: _Module) -> None:
        modname = self.modname[rel]
        self.module_locks[rel] = {}
        lines = mod.text.splitlines()
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                dotted = mod.aliases.canon(_dotted(node.value.func)) or ""
                if dotted in _LOCK_CONSTRUCTORS:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            short = modname.split(".")[-1] or modname
                            self.module_locks[rel][t.id] = LockId(
                                f"{short}.{t.id}", rel, node.lineno)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            qual = f"{modname}.{node.name}"
            info = _ClassInfo(qual, node.name, mod, node)
            self.classes.setdefault(qual, info)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info.methods.setdefault(sub.name, sub)
                    self.method_sites.setdefault(sub.name, []).append(
                        (qual, sub))
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    target, value = sub.targets[0], sub.value
                elif isinstance(sub, ast.AnnAssign):
                    target, value = sub.target, sub.value
                else:
                    continue
                if not (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"):
                    continue
                attr = target.attr
                if isinstance(value, ast.Call):
                    dotted = mod.aliases.canon(_dotted(value.func)) or ""
                    if dotted in _LOCK_CONSTRUCTORS:
                        info.lock_attrs[attr] = sub.lineno
                        self.lock_attr_owners.setdefault(
                            attr, []).append(qual)
                    elif dotted in _HANDLE_CONSTRUCTORS:
                        info.attr_kinds[attr] = _HANDLE_CONSTRUCTORS[dotted]
                    elif dotted:
                        info.attr_types.setdefault(attr, dotted)
                # a ``# guarded-by: <lock>`` / ``# guarded-by: none``
                # annotation pins intent on ANY self-attribute
                # assignment line, not just constructor calls
                line = lines[sub.lineno - 1] if sub.lineno <= len(lines) \
                    else ""
                m = _GUARDED_BY_RE.search(line)
                if m:
                    info.guards.setdefault(attr, m.group(1))
        # function table: every def, tagged with its enclosing class
        stack: List[Tuple[ast.AST, Optional[_ClassInfo]]] = [
            (mod.tree, None)]
        while stack:
            node, cls = stack.pop()
            for child in ast.iter_child_nodes(node):
                nxt = cls
                if isinstance(child, ast.ClassDef):
                    nxt = self.classes.get(
                        f"{modname}.{child.name}")
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    self.infos[child] = _FuncInfo(mod, child, cls)
                    nxt = None          # nested defs are their own scope
                stack.append((child, nxt))

    def _build_scopes(self) -> None:
        """Per-module name -> class-qual / function maps, resolving
        relative and absolute imports against the scanned set (the
        :mod:`.dataflow` scope discipline)."""
        by_func_qual: Dict[str, ast.AST] = {}
        for fn, info in self.infos.items():
            if info.cls is None:
                by_func_qual.setdefault(
                    f"{self.modname[info.mod.path]}.{fn.name}", fn)
        for rel, mod in self.mods.items():
            modname = self.modname[rel]
            cscope: Dict[str, str] = {}
            fscope: Dict[str, ast.AST] = {}
            for qual, cinfo in self.classes.items():
                if qual.rsplit(".", 1)[0] == modname:
                    cscope.setdefault(cinfo.name, qual)
            for fn, info in self.infos.items():
                if info.mod is mod and info.cls is None:
                    fscope.setdefault(fn.name, fn)
            pkg_parts = modname.split(".")
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ImportFrom):
                    continue
                if node.level:
                    base = pkg_parts[:-node.level] \
                        if node.level <= len(pkg_parts) else []
                    target = ".".join(base + (node.module.split(".")
                                              if node.module else []))
                else:
                    target = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    local = a.asname or a.name
                    if f"{target}.{a.name}" in self.classes:
                        cscope.setdefault(local, f"{target}.{a.name}")
                    callee = by_func_qual.get(f"{target}.{a.name}")
                    if callee is not None:
                        fscope.setdefault(local, callee)
            self.class_scope[rel] = cscope
            self.func_scope[rel] = fscope

    def _collect_order_decls(self, rel: str, mod: _Module) -> None:
        for i, line in enumerate(mod.text.splitlines(), 1):
            idx = line.find("#")
            if idx < 0:
                continue
            m = _LOCK_ORDER_RE.search(line[idx:])
            if m:
                self.order_decls.append((m.group(1), m.group(2), rel, i))

    def lines(self, mod: _Module) -> List[str]:
        """Cached splitlines — snippet lookups happen per write site
        and per finding, not once per module."""
        cached = self._lines.get(mod.path)
        if cached is None:
            cached = self._lines[mod.path] = mod.text.splitlines()
        return cached

    # -- resolution helpers ---------------------------------------------

    def resolve_class(self, mod: _Module, dotted: Optional[str]
                      ) -> Optional[_ClassInfo]:
        if not dotted:
            return None
        scope = self.class_scope.get(mod.path, {})
        head = dotted.split(".")[0]
        if dotted in scope:
            return self.classes.get(scope[dotted])
        if head in scope and "." not in dotted:
            return self.classes.get(scope[head])
        canon = mod.aliases.canon(dotted)
        if canon in self.classes:
            return self.classes[canon]
        # suffix match: "failover.DurableSession" etc.
        for qual in self.classes:
            if canon and qual.endswith("." + canon):
                return self.classes[qual]
        return None

    def mro(self, cinfo: _ClassInfo) -> List[_ClassInfo]:
        """The class plus its resolvable bases, depth-first (good enough
        for this package's single-inheritance lattices)."""
        out, seen = [], set()
        stack = [cinfo]
        while stack:
            c = stack.pop(0)
            if c.qual in seen:
                continue
            seen.add(c.qual)
            out.append(c)
            for b in c.bases:
                base = self.resolve_class(c.mod, b)
                if base is not None:
                    stack.append(base)
        return out

    def lock_for_attr(self, cinfo: Optional[_ClassInfo], attr: str
                      ) -> Optional[LockId]:
        """``self.<attr>`` in class ``cinfo`` -> the defining class's
        lock identity (inheritance-aware)."""
        if cinfo is None:
            return None
        for c in self.mro(cinfo):
            if attr in c.lock_attrs:
                return LockId(f"{c.name}.{attr}", c.mod.path,
                              c.lock_attrs[attr])
        return None

    def unique_attr_lock(self, attr: str) -> Optional[LockId]:
        owners = self.lock_attr_owners.get(attr, [])
        if len(owners) == 1:
            c = self.classes[owners[0]]
            return LockId(f"{c.name}.{attr}", c.mod.path,
                          c.lock_attrs[attr])
        return None

    def unique_method(self, name: str) -> Optional[ast.AST]:
        sites = self.method_sites.get(name, [])
        if len(sites) == 1:
            return sites[0][1]
        return None

    def all_lock_ids(self) -> Dict[LockId, None]:
        out: Dict[LockId, None] = {}
        for cinfo in self.classes.values():
            for attr, line in cinfo.lock_attrs.items():
                out[LockId(f"{cinfo.name}.{attr}", cinfo.mod.path,
                           line)] = None
        for table in self.module_locks.values():
            for lid in table.values():
                out[lid] = None
        return out


# -- the per-function walker ------------------------------------------------


class _Access(NamedTuple):
    """One attribute write site (CL803/804 evidence)."""

    cls_qual: str
    attr: str
    path: str
    line: int
    held: frozenset
    in_init: bool
    snippet: str


class _Walk:
    """One lexical pass over a function body: tracks the held-lock list,
    records acquisition edges, call sites, blocking calls, and attribute
    writes. Runs once per fixpoint round (summaries) and once in the
    findings pass."""

    def __init__(self, pkg: _Package, info: _FuncInfo,
                 entry: Iterable[LockId] = ()):
        self.pkg = pkg
        self.info = info
        self.mod = info.mod
        self.entry: Tuple[LockId, ...] = tuple(entry)
        self.local_types: Dict[str, str] = {}     # name -> dotted class
        self.local_locks: Dict[str, LockId] = {}  # name -> local lock id
        self.local_kinds: Dict[str, str] = {}     # name -> handle kind
        #: (edge a->b, site node) in acquisition order
        self.edges: List[Tuple[LockId, LockId, ast.AST]] = []
        #: (node, held-at-site, callee _FuncInfo|None, canon dotted)
        self.calls: List[Tuple[ast.AST, Tuple[LockId, ...],
                               Optional[_FuncInfo], str]] = []
        self.accesses: List[_Access] = []
        self.acquired: Set[LockId] = set()
        self._seed_types()

    def _seed_types(self) -> None:
        args = self.info.fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            if a.annotation is not None:
                cinfo = self.pkg.resolve_class(self.mod,
                                               _dotted(a.annotation))
                if cinfo is not None:
                    self.local_types[a.arg] = cinfo.qual
        if self.info.cls is not None and args.args:
            self.local_types[args.args[0].arg] = self.info.cls.qual

    # -- expression typing ---------------------------------------------

    def _type_of(self, node: ast.AST) -> Optional[_ClassInfo]:
        """The scanned class an expression evaluates to, or None."""
        if isinstance(node, ast.Name):
            qual = self.local_types.get(node.id)
            return self.pkg.classes.get(qual) if qual else None
        if isinstance(node, ast.Attribute):
            base = self._type_of(node.value)
            if base is not None:
                for c in self.pkg.mro(base):
                    t = c.attr_types.get(node.attr)
                    if t:
                        return self.pkg.resolve_class(c.mod, t)
            return None
        if isinstance(node, ast.Call):
            return self.pkg.resolve_class(self.mod, _dotted(node.func))
        return None

    def _handle_kind(self, node: ast.AST) -> Optional[str]:
        """Blocking-handle kind of a receiver expression (CL802)."""
        if isinstance(node, ast.Name):
            kind = self.local_kinds.get(node.id)
            if kind:
                return kind
            if node.id in ("future", "fut"):
                return "future"
        if isinstance(node, ast.Attribute):
            if node.attr == "future":
                return "future"
            base = self._type_of(node.value)
            if base is not None:
                for c in self.pkg.mro(base):
                    if node.attr in c.attr_kinds:
                        return c.attr_kinds[node.attr]
        return None

    def _lock_of(self, node: ast.AST) -> Optional[LockId]:
        """Resolve an expression to a lock identity (or None)."""
        if isinstance(node, ast.Name):
            if node.id in self.local_locks:
                return self.local_locks[node.id]
            mod_lock = self.pkg.module_locks.get(self.mod.path, {})
            return mod_lock.get(node.id)
        if isinstance(node, ast.Attribute):
            attr = node.attr
            root = _dotted(node.value)
            if root in ("self", "cls"):
                lid = self.pkg.lock_for_attr(self.info.cls, attr)
                if lid is not None:
                    return lid
                # self receiver but the attr is a lock of some OTHER
                # class only: not this object's lock
                return None
            recv = self._type_of(node.value)
            if recv is not None:
                lid = self.pkg.lock_for_attr(recv, attr)
                if lid is not None:
                    return lid
            if attr in self.pkg.lock_attr_owners:
                lid = self.pkg.unique_attr_lock(attr)
                if lid is not None:
                    return lid
                # ambiguous: a real lock, unknown which — site-unique
                # identity (held-ness without cross-site unification)
                return LockId(f"?.{attr}", self.mod.path, node.lineno)
        return None

    # -- held-set bookkeeping ------------------------------------------

    def _held(self, local: List[LockId]) -> Tuple[LockId, ...]:
        return self.entry + tuple(local)

    def _acquire(self, lid: LockId, node: ast.AST,
                 local: List[LockId]) -> bool:
        held = self._held(local)
        if lid in held:
            return False                 # re-entrant RLock: no edge
        for h in held:
            self.edges.append((h, lid, node))
        self.acquired.add(lid)
        local.append(lid)
        return True

    # -- the walk -------------------------------------------------------

    def run(self) -> None:
        self._block(list(self.info.fn.body), [])

    def _block(self, stmts: List[ast.stmt], local: List[LockId]) -> None:
        # acquire()/release() calls extend/shrink ``local`` linearly
        for st in stmts:
            self._stmt(st, local)

    def _stmt(self, st: ast.stmt, local: List[LockId]) -> None:
        if isinstance(st, ast.With) or isinstance(st, ast.AsyncWith):
            pushed = 0
            for item in st.items:
                lid = self._lock_of(item.context_expr)
                if lid is not None:
                    if self._acquire(lid, item.context_expr, local):
                        pushed += 1
                else:
                    self._expr(item.context_expr, local)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, item.context_expr)
            self._block(st.body, local)
            for _ in range(pushed):
                local.pop()
            return
        if isinstance(st, ast.Assign):
            self._expr(st.value, local)
            for t in st.targets:
                self._bind(t, st.value)
                self._write_target(t, st, local)
            return
        if isinstance(st, ast.AugAssign):
            self._expr(st.value, local)
            self._write_target(st.target, st, local)
            return
        if isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._expr(st.value, local)
                self._bind(st.target, st.value)
                self._write_target(st.target, st, local)
            return
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return                       # their own scopes
        if isinstance(st, (ast.If, ast.While)):
            # branches share ``local``: a branch-local .acquire() is
            # approximated as held afterwards (conservative for CL802,
            # and a release() in the other branch pops it back off)
            self._expr(st.test, local)
            self._block(st.body, local)
            self._block(st.orelse, local)
            return
        if isinstance(st, ast.For):
            self._expr(st.iter, local)
            self._block(st.body, local)
            self._block(st.orelse, local)
            return
        if isinstance(st, ast.Try):
            self._block(st.body, local)
            for h in st.handlers:
                self._block(h.body, local)
            self._block(st.orelse, local)
            self._block(st.finalbody, local)
            return
        if isinstance(st, ast.Return):
            if st.value is not None:
                self._expr(st.value, local)
            return
        if isinstance(st, ast.Expr):
            self._expr(st.value, local, statement=True)
            return
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._expr(child, local)
            elif isinstance(child, ast.stmt):
                self._stmt(child, local)

    def _bind(self, target: ast.AST, value: ast.AST) -> None:
        """Track local types / lock handles / blocking handles."""
        if not isinstance(target, ast.Name):
            return
        if isinstance(value, ast.Call):
            dotted = self.mod.aliases.canon(_dotted(value.func)) or ""
            if dotted in _LOCK_CONSTRUCTORS:
                self.local_locks[target.id] = LockId(
                    f"{self.info.name}.{target.id}", self.mod.path,
                    value.lineno)
                return
            if dotted in _HANDLE_CONSTRUCTORS:
                self.local_kinds[target.id] = _HANDLE_CONSTRUCTORS[dotted]
                return
            cinfo = self.pkg.resolve_class(self.mod, _dotted(value.func))
            if cinfo is not None:
                self.local_types[target.id] = cinfo.qual
                return
            if dotted.split(".")[-1] in ("submit",):
                self.local_kinds[target.id] = "future"
                return
        self.local_types.pop(target.id, None)
        self.local_kinds.pop(target.id, None)

    def _write_target(self, target: ast.AST, st: ast.stmt,
                      local: List[LockId]) -> None:
        """Record ``self.<attr>`` stores (plain, augmented, and
        subscript stores rooted at ``self.<attr>``)."""
        attr = None
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self":
            attr = target.attr
        elif isinstance(target, ast.Subscript):
            root = target.value
            if isinstance(root, ast.Attribute) \
                    and isinstance(root.value, ast.Name) \
                    and root.value.id == "self":
                attr = root.attr
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._write_target(elt, st, local)
            return
        if attr is None or self.info.cls is None:
            return
        self._record_access(attr, st, local)

    def _record_access(self, attr: str, node: ast.AST,
                       local: List[LockId]) -> None:
        cinfo = self.info.cls
        if attr in cinfo.lock_attrs or attr in cinfo.attr_kinds:
            return                       # the locks themselves
        lines = self.pkg.lines(self.mod)
        ln = getattr(node, "lineno", 0)
        snippet = lines[ln - 1].strip() if 0 < ln <= len(lines) else ""
        self.accesses.append(_Access(
            cinfo.qual, attr, self.mod.path, ln,
            frozenset(self._held(local)),
            self.info.is_init, snippet))

    def _expr(self, node: ast.AST, local: List[LockId],
              statement: bool = False) -> None:
        if isinstance(node, ast.Call):
            self._call(node, local, statement)
            return
        if isinstance(node, ast.Lambda):
            # walked in the enclosing scope: a lambda handed to a
            # callback still runs this module's lock acquisitions
            self._expr(node.body, local)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, local)

    def _call(self, node: ast.Call, local: List[LockId],
              statement: bool) -> None:
        for a in node.args:
            self._expr(a, local)
        for kw in node.keywords:
            self._expr(kw.value, local)
        if not isinstance(node.func, (ast.Name, ast.Attribute)):
            self._expr(node.func, local)
            return
        # explicit acquire()/release() on a resolvable lock
        if isinstance(node.func, ast.Attribute):
            lid = self._lock_of(node.func.value)
            if lid is not None:
                if node.func.attr == "acquire" and statement:
                    self._acquire(lid, node, local)
                    return
                if node.func.attr == "release" and statement \
                        and lid in local:
                    local.remove(lid)
                    return
        callee = self._resolve_callee(node)
        dotted = self.mod.aliases.canon(_dotted(node.func)) or ""
        self.calls.append((node, self._held(local), callee, dotted))

    def _resolve_callee(self, node: ast.Call) -> Optional[_FuncInfo]:
        fn = node.func
        if isinstance(fn, ast.Name):
            target = self.pkg.func_scope.get(self.mod.path, {}).get(fn.id)
            return self.pkg.infos.get(target) if target is not None \
                else None
        if isinstance(fn, ast.Attribute):
            root = _dotted(fn.value)
            if root in ("self", "cls") and self.info.cls is not None:
                for c in self.pkg.mro(self.info.cls):
                    if fn.attr in c.methods:
                        return self.pkg.infos.get(c.methods[fn.attr])
                return None
            recv = self._type_of(fn.value)
            if recv is not None:
                for c in self.pkg.mro(recv):
                    if fn.attr in c.methods:
                        return self.pkg.infos.get(c.methods[fn.attr])
                return None
            target = self.pkg.unique_method(fn.attr)
            if target is not None:
                return self.pkg.infos.get(target)
            # module-function via canonical dotted name
            dotted = self.mod.aliases.canon(_dotted(fn)) or ""
            scope = self.pkg.func_scope.get(self.mod.path, {})
            tail = dotted.split(".")[-1] if dotted else ""
            if tail in scope:
                return self.pkg.infos.get(scope[tail])
        return None


# -- fixpoint drivers -------------------------------------------------------


def _grow_summaries(pkg: _Package) -> Dict[ast.AST, _Walk]:
    """Run the walker over every function, then grow transitive acquire
    sets and entry held sets to a fixpoint. Returns the per-function
    walks (re-used by the findings pass — the walk is deterministic)."""
    walks: Dict[ast.AST, _Walk] = {}
    for fn, info in pkg.infos.items():
        w = _Walk(pkg, info)
        w.run()
        walks[fn] = w
        info.acquires = set(w.acquired)
    # transitive acquisitions
    for _ in range(16):
        changed = False
        for fn, info in pkg.infos.items():
            for _node, _held, callee, _d in walks[fn].calls:
                if callee is not None \
                        and not callee.acquires <= info.acquires:
                    info.acquires |= callee.acquires
                    changed = True
        if not changed:
            break
    # entry held sets: intersection over non-construction call sites
    for info in pkg.infos.values():
        info.entry = None
    for _ in range(8):
        changed = False
        for fn, info in pkg.infos.items():
            caller_entry = info.entry or frozenset()
            if pkg.infos[fn].is_init:
                continue                 # construction-time calls excluded
            for node, held, callee, _d in walks[fn].calls:
                if callee is None:
                    continue
                site_held = frozenset(held) | caller_entry
                prev = callee.entry
                nxt = site_held if prev is None else (prev & site_held)
                if nxt != prev:
                    callee.entry = nxt
                    changed = True
        if not changed:
            break
    for info in pkg.infos.values():
        if info.entry is None:
            info.entry = frozenset()
    return walks


class _Results(NamedTuple):
    pkg: _Package
    #: (a, b) -> first (path, line, snippet) acquisition site
    edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]]
    findings: List[Finding]


def _snippet(pkg: _Package, mod: _Module, line: int) -> str:
    lines = pkg.lines(mod)
    return lines[line - 1].strip() if 0 < line <= len(lines) else ""


#: positional slot of the timeout parameter per blocking method —
#: ``q.get(block, timeout)`` and ``q.put(item, block, timeout)`` only
#: bound the wait at their timeout slot, so ``q.put(item)`` and
#: ``q.get(True)`` stay unbounded
_TIMEOUT_ARG_INDEX = {
    "wait": 0, "wait_for": 1, "result": 0, "exception": 0, "join": 0,
    "get": 1, "put": 2, "communicate": 1,
}


def _timeout_bounded(node: ast.Call, meth: str) -> bool:
    """An explicit timeout argument (``timeout=`` or the method's
    positional timeout slot) marks the blocking form bounded — a delay,
    not a deadlock. ``timeout=None`` literals stay unbounded."""
    for kw in node.keywords:
        if kw.arg == "timeout":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is None)
    idx = _TIMEOUT_ARG_INDEX.get(meth)
    if idx is None or len(node.args) <= idx:
        return False
    arg = node.args[idx]
    return not (isinstance(arg, ast.Constant) and arg.value is None)


def _analyze(pkg: _Package, select: Optional[Set[str]],
             full_scan: bool) -> _Results:
    walks = _grow_summaries(pkg)
    directives = {rel: _line_directives(mod.text)
                  for rel, mod in pkg.mods.items()}
    findings: List[Finding] = []

    def emit(mod: _Module, line: int, rule: str, message: str) -> None:
        sup = directives.get(mod.path, {}).get(line, set())
        if "*" in sup or rule in sup:
            return
        if select is not None and rule not in select:
            return
        findings.append(Finding(
            rule=rule, path=mod.path, line=line, message=message,
            severity=CONCURRENCY_RULES[rule][0],
            snippet=_snippet(pkg, mod, line)))

    # ---- edge collection (direct + interprocedural) -------------------
    edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]] = {}

    def add_edge(a: LockId, b: LockId, mod: _Module, line: int) -> None:
        if a == b or a.name.startswith("?.") or b.name.startswith("?."):
            return
        edges.setdefault((a, b), (mod.path, line,
                                  _snippet(pkg, mod, line)))

    accesses: List[_Access] = []
    hook_sites: Dict[str, List[Tuple[str, int]]] = {}
    for fn, info in pkg.infos.items():
        w = walks[fn]
        entry = tuple(info.entry or ())
        for a, b, node in w.edges:
            add_edge(a, b, info.mod, getattr(node, "lineno", 0))
        # entry-held locks order-precede every local acquisition
        for lid in w.acquired:
            for h in entry:
                if h != lid:
                    add_edge(h, lid, info.mod, info.fn.lineno)
        for node, held, callee, dotted in w.calls:
            line = getattr(node, "lineno", 0)
            full_held = tuple(dict.fromkeys(entry + tuple(held)))
            if callee is not None:
                for b in callee.acquires:
                    for h in full_held:
                        if h != b:
                            add_edge(h, b, info.mod, line)
            # ---- CL805: hook-site audit (held or not) ----------------
            tail = dotted.split(".")[-1] if dotted else ""
            parts = dotted.split(".") if dotted else []
            is_hook = tail in _HOOK_TAILS and ("faults" in parts[:3]
                                               or "plan" in parts[:3])
            if is_hook and node.args and isinstance(node.args[0],
                                                    ast.Constant) \
                    and isinstance(node.args[0].value, str):
                site = node.args[0].value
                hook_sites.setdefault(site, []).append(
                    (info.mod.path, line))
                from ..faults.plan import FAULT_SITES
                if site not in FAULT_SITES:
                    emit(info.mod, line, "CL805",
                         f"fault hook names site {site!r} which is not "
                         f"in faults.plan.FAULT_SITES — add it to the "
                         f"catalog or fix the name")
            # ---- CL802: blocking under a lock ------------------------
            if not full_held:
                continue
            held_s = ", ".join(h.render() for h in full_held)
            if dotted in _BLOCKING_DOTTED:
                emit(info.mod, line, "CL802",
                     f"'{dotted}' blocks while holding {held_s} — every "
                     f"other thread needing that lock stalls for the "
                     f"full wait; block outside the critical section")
                continue
            if isinstance(node.func, ast.Attribute):
                meth = node.func.attr
                if meth in _IO_TAILS:
                    emit(info.mod, line, "CL802",
                         f"replication-log/ledger I/O '.{meth}()' runs "
                         f"while holding {held_s} — the lock is held "
                         f"across fsync/shared-filesystem latency")
                    continue
                if meth in _DEVICE_WAIT_TAILS:
                    emit(info.mod, line, "CL802",
                         f"'.{meth}()' waits for the card while holding "
                         f"{held_s}")
                    continue
                recv_lock = w._lock_of(node.func.value)
                if recv_lock is not None and meth in ("wait", "wait_for"):
                    if recv_lock in full_held:
                        continue   # cond.wait releases the held cond
                    if not _timeout_bounded(node, meth):
                        emit(info.mod, line, "CL802",
                             f"'.{meth}()' waits on "
                             f"{recv_lock.render()} while holding "
                             f"{held_s} (the wait only releases its OWN "
                             f"condition)")
                    continue
                kind = w._handle_kind(node.func.value)
                if kind is not None \
                        and meth in _BLOCKING_METHODS.get(kind, ()):
                    if not _timeout_bounded(node, meth):
                        emit(info.mod, line, "CL802",
                             f"blocking '.{meth}()' on a {kind} handle "
                             f"while holding {held_s} — an unbounded "
                             f"wait under a lock is a deadlock waiting "
                             f"for its second thread")
                    continue
            if dotted:
                tail = dotted.split(".")[-1]
                parts = dotted.split(".")
                if tail == "fire" and ("faults" in parts[:3]
                                       or "plan" in parts[:3]):
                    has_path = any(kw.arg == "path"
                                   for kw in node.keywords) \
                        or len(node.args) >= 2
                    if has_path:
                        emit(info.mod, line, "CL802",
                             f"fault hook with a file 'path=' (torn-"
                             f"write form) fires while holding {held_s} "
                             f"— injected file I/O runs under the lock; "
                             f"the raise-only 'fire(site)' form is "
                             f"exempt")
        accesses.extend(
            _Access(a.cls_qual, a.attr, a.path, a.line,
                    a.held | frozenset(entry), a.in_init, a.snippet)
            for a in w.accesses)

    # ---- CL801: cycles + declared-order violations --------------------
    if select is None or "CL801" in select:
        _check_lock_order(pkg, edges, emit)

    # ---- CL803/804: guarded-by inference ------------------------------
    if select is None or select & {"CL803", "CL804"}:
        _check_guarded_by(pkg, accesses, emit)

    # ---- CL805: catalog completeness (whole-package scans only) -------
    if full_scan and (select is None or "CL805" in select):
        from ..faults.plan import FAULT_SITES

        for site in FAULT_SITES:
            if site not in hook_sites:
                findings.append(Finding(
                    rule="CL805", path="faults:catalog", line=0,
                    message=f"cataloged fault site {site!r} has no "
                            f"fire/corrupt hook call anywhere in the "
                            f"scanned package — dead catalog entry or a "
                            f"lost hook",
                    severity="error", snippet=site))

    return _Results(pkg, edges, findings)


def _check_lock_order(pkg: _Package, edges, emit) -> None:
    # declared-order violations: edge (B, A) against a declared A < B
    decl = {}
    for a, b, rel, line in pkg.order_decls:
        decl[(a, b)] = (rel, line)
    by_name = {}
    for (a, b), site in edges.items():
        by_name.setdefault((a.name, b.name), (a, b, site))
    for (a_name, b_name), (rel, dline) in decl.items():
        hit = by_name.get((b_name, a_name))
        if hit is not None:
            a, b, (path, line, _snip) = hit
            emit(pkg.mods[path], line, "CL801",
                 f"acquiring {b.render()} while holding {a.render()} "
                 f"contradicts the declared lock order "
                 f"'{a_name} < {b_name}' ({rel}:{dline})")
    # cycles: Tarjan SCCs over the identity graph
    graph: Dict[LockId, Set[LockId]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    index: Dict[LockId, int] = {}
    low: Dict[LockId, int] = {}
    on_stack: Set[LockId] = set()
    stack: List[LockId] = []
    sccs: List[List[LockId]] = []
    counter = [0]

    def strongconnect(v: LockId) -> None:
        # iterative Tarjan (the graph is tiny; recursion would be fine,
        # but an explicit stack avoids pathological corpus depth)
        work = [(v, iter(sorted(graph[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(graph[nxt]))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(scc)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    for scc in sccs:
        members = sorted(scc)
        cyc_edges = [((a, b), edges[(a, b)]) for (a, b) in edges
                     if a in scc and b in scc]
        cyc_edges.sort(key=lambda e: e[1][:2])
        (a0, b0), (path, line, _snip) = cyc_edges[0]
        detail = "; ".join(
            f"{a.name} -> {b.name} at {p}:{ln}"
            for (a, b), (p, ln, _s) in cyc_edges)
        emit(pkg.mods[path], line, "CL801",
             f"lock-order cycle over {{{', '.join(m.name for m in members)}}}"
             f" — two threads interleaving these acquisitions deadlock: "
             f"{detail}. Impose one total order (document it with "
             f"'# consensus-lint: lock-order A < B')")


def _check_guarded_by(pkg: _Package, accesses: List[_Access],
                      emit) -> None:
    by_attr: Dict[Tuple[str, str], List[_Access]] = {}
    for a in accesses:
        if a.in_init:
            continue                     # pre-publication construction
        by_attr.setdefault((a.cls_qual, a.attr), []).append(a)
    for (cls_qual, attr), sites in sorted(by_attr.items()):
        cinfo = pkg.classes.get(cls_qual)
        if cinfo is None:
            continue
        annotated = None
        for c in pkg.mro(cinfo):
            if attr in c.guards:
                annotated = c.guards[attr]
                break
        if annotated == "none":
            continue
        guard: Optional[LockId] = None
        if annotated is not None:
            guard = pkg.lock_for_attr(cinfo, annotated)
            if guard is None:
                emit(cinfo.mod, cinfo.node.lineno, "CL804",
                     f"'# guarded-by: {annotated}' on "
                     f"{cinfo.name}.{attr} names no lock attribute "
                     f"resolvable on {cinfo.name}")
                continue
        else:
            if len(sites) < 2:
                continue                 # not enough evidence to infer
            votes: Dict[LockId, int] = {}
            for a in sites:
                for lid in a.held:
                    votes[lid] = votes.get(lid, 0) + 1
            majority = [lid for lid, n in votes.items()
                        if n * 2 > len(sites)]
            if majority:
                # several locks can clear the strict-majority bar (one
                # nested under another): the guard is the one held at
                # the MOST writes — alphabetical tie-break only between
                # equals, never over a better-supported lock
                guard = sorted(majority,
                               key=lambda lid: (-votes[lid], lid))[0]
            else:
                distinct = {a.held for a in sites}
                if len(distinct) > 1 and any(a.held for a in sites):
                    first = min(sites, key=lambda a: (a.path, a.line))
                    locksets = sorted(
                        "{" + ", ".join(sorted(l.name for l in h)) + "}"
                        for h in distinct)
                    emit(pkg.mods[first.path], first.line, "CL804",
                         f"attribute {cinfo.name}.{attr} is written "
                         f"under inconsistent lock sets "
                         f"({', '.join(locksets)}) with no majority "
                         f"guard — pick one lock and pin it with "
                         f"'# guarded-by: <lock>'")
                continue
        for a in sorted(sites, key=lambda a: (a.path, a.line)):
            if guard in a.held:
                continue
            if not a.held:
                why = ("annotated" if annotated
                       else "held at the majority of writes")
                emit(pkg.mods[a.path], a.line, "CL803",
                     f"write to {cinfo.name}.{attr} with no lock held — "
                     f"its guard is {guard.render()} ({why})")
            else:
                others = ", ".join(sorted(l.name for l in a.held))
                emit(pkg.mods[a.path], a.line, "CL804",
                     f"write to {cinfo.name}.{attr} holds {others} but "
                     f"not its guard {guard.render()} — inconsistent "
                     f"locking reads as protection and is not")


# -- public drivers ---------------------------------------------------------


def analyze_concurrency(paths=None, root=None,
                        select: Optional[Set[str]] = None
                        ) -> List[Finding]:
    """Run Layer 4 over ``paths`` (default: the installed package — a
    full scan, which also enables the CL805 catalog-completeness
    direction). The lock/call graph covers exactly the scanned files.
    Findings are sorted by (path, line, rule)."""
    files = scan_targets(paths, root)
    pkg = _Package(files)
    res = _analyze(pkg, select, full_scan=paths is None)
    uniq = {}
    for f in res.findings:
        uniq.setdefault((f.rule, f.path, f.line, f.message), f)
    return sorted(uniq.values(), key=lambda f: (f.path, f.line, f.rule))


def lock_order_edges(paths=None, root=None) -> dict:
    """The static lock table + may-hold-before edge set, in the JSON
    shape :mod:`.witness` compares observed acquisition orders against:
    ``{"locks": {"path:line": name}, "edges": [[a_key, b_key], ...]}``
    where a key is the lock's defining ``path:line`` — the same site an
    instrumented lock records at construction time."""
    files = scan_targets(paths, root)
    pkg = _Package(files)
    res = _analyze(pkg, select=set(), full_scan=False)
    locks = {f"{lid.path}:{lid.line}": lid.name
             for lid in pkg.all_lock_ids()}
    edge_keys = sorted({(f"{a.path}:{a.line}", f"{b.path}:{b.line}")
                        for (a, b) in res.edges})
    return {"locks": locks, "edges": [list(e) for e in edge_keys]}
