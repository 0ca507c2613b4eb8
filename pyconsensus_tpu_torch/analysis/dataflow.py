"""The interprocedural dataflow machinery Layer 6 runs on.

A package-wide call graph (module scopes, relative and absolute import
aliases, ``self``/``cls`` methods), a small flow-sensitive abstract
interpreter over every function body (gen/kill def-use taint with joins
at control-flow merges, loop bodies iterated twice) and a summary
fixpoint that propagates taint through calls and returns.

The interpreter here is model-free: it knows how values flow, not which
values are suspect or where they must not arrive. :mod:`.determinism`
subclasses :class:`_Analyzer` with its sources, sanitizers and sinks.
The reference's own model on this machinery, host divergence into
``shard_map`` specs, jit static arguments and mesh construction
(CL401-404), waits for its ``torch.distributed`` sinks.

Known approximations (all conservative or documented): module-level
constants are host context; attribute stores (``self.x = …``) taint only
the root name locally; nested ``def``s see the enclosing function's
final taint state for their free variables.
"""

from __future__ import annotations

import ast
import pathlib
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .findings import Finding
from .rules import _dotted, _Module


def _src_line(mod: _Module, node: ast.AST) -> str:
    lines = mod.text.splitlines()
    i = getattr(node, "lineno", 0)
    return lines[i - 1] if 0 < i <= len(lines) else ""


def _module_name(rel: str) -> str:
    """``pyconsensus_tpu_torch/serve/fleet.py`` -> dotted module name."""
    p = pathlib.PurePosixPath(rel)
    parts = list(p.with_suffix("").parts)
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class _FuncInfo:
    """Per-function interprocedural summary (grown monotonically)."""

    def __init__(self, modname: str, mod: _Module, fn: ast.AST):
        self.modname = modname
        self.mod = mod
        self.fn = fn
        self.qual = f"{modname}.{fn.name}"
        args = fn.args
        self.params: List[str] = (
            [a.arg for a in args.posonlyargs] + [a.arg for a in args.args]
            + [a.arg for a in args.kwonlyargs])
        #: param name -> origin description, tainted by some call site
        self.tainted_params: Dict[str, str] = {}
        #: body derives taint from a SOURCE and can return it
        self.returns_taint: Optional[str] = None
        #: a tainted parameter can flow through to the return value
        self.propagates_params: bool = False


class _Package:
    """Whole-scan state: module table, function table, import resolution,
    and the enclosing-scope taint snapshots for nested defs."""

    def __init__(self, files: List[Tuple[pathlib.Path, str]]):
        self.mods: Dict[str, _Module] = {}          # rel path -> _Module
        self.modname_of: Dict[str, str] = {}
        self.infos: List[_FuncInfo] = []            # every def, in order
        self.by_qual: Dict[str, _FuncInfo] = {}     # first def wins
        self.by_node: Dict[ast.AST, _FuncInfo] = {}
        #: nested def node -> joined taint state of its enclosing scope
        self.enclosing_state: Dict[ast.AST, Dict[str, str]] = {}
        for f, rel in files:
            try:
                text = f.read_text(encoding="utf-8")
                tree = ast.parse(text, filename=str(f))
            except (OSError, SyntaxError):
                continue
            mod = _Module(rel, text, tree)
            self.mods[rel] = mod
            self.modname_of[rel] = _module_name(rel)
        for rel, mod in self.mods.items():
            modname = self.modname_of[rel]
            for fn in mod.funcs:
                info = _FuncInfo(modname, mod, fn)
                self.infos.append(info)
                self.by_qual.setdefault(info.qual, info)
                self.by_node[fn] = info
        self.scopes: Dict[str, Dict[str, _FuncInfo]] = {}
        self._build_scopes()

    def _build_scopes(self) -> None:
        for rel, mod in self.mods.items():
            modname = self.modname_of[rel]
            scope: Dict[str, _FuncInfo] = {}
            for fn in mod.funcs:
                scope.setdefault(fn.name, self.by_node[fn])
            pkg_parts = modname.split(".")
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ImportFrom):
                    continue
                if node.level:                       # relative import
                    base = pkg_parts[:-node.level] if node.level <= len(
                        pkg_parts) else []
                    target = ".".join(base + (node.module.split(".")
                                              if node.module else []))
                else:
                    target = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    callee = self.by_qual.get(f"{target}.{a.name}")
                    if callee is not None:
                        scope[a.asname or a.name] = callee
            self.scopes[rel] = scope

    def resolve(self, mod: _Module, call_func: ast.AST
                ) -> Optional[_FuncInfo]:
        """Map a call's func expression to a known scanned function."""
        scope = self.scopes.get(mod.path, {})
        if isinstance(call_func, ast.Name):
            return scope.get(call_func.id)
        if isinstance(call_func, ast.Attribute):
            root = _dotted(call_func.value)
            if root in ("self", "cls"):              # same-module method
                return scope.get(call_func.attr)
            dotted = mod.aliases.canon(_dotted(call_func))
            if dotted:
                return self.by_qual.get(dotted)
        return None

    def note_enclosing(self, child: ast.AST, state: Dict[str, str]) -> bool:
        prev = self.enclosing_state.get(child, {})
        nxt = dict(prev)
        for k, v in state.items():
            nxt.setdefault(k, v)
        if nxt != prev:
            self.enclosing_state[child] = nxt
            return True
        return False


def _canon(mod: _Module, node: ast.AST) -> str:
    return mod.aliases.canon(_dotted(node)) or ""


# -- the per-function abstract interpreter ---------------------------------


class _Analyzer:
    """Flow-sensitive taint walk of one function body.

    State is ``{name: origin-description}``; statements execute in
    order, branches fork and join, loop bodies run twice (enough for the
    loop-carried flows this package contains). The base class carries no
    source or sink: a layer subclasses it and overrides
    :meth:`_eval_call` (sources, sanitizers), :meth:`_check_call_sinks`
    and :meth:`_branch_sink`."""

    def __init__(self, pkg: _Package, info: _FuncInfo,
                 findings: Optional[List[Finding]] = None,
                 directives: Optional[Dict[int, Set[str]]] = None,
                 synthetic: bool = False):
        self.pkg = pkg
        self.info = info
        self.mod = info.mod
        self.findings = findings            # None = summary-only pass
        self.directives = directives or {}
        #: the propagates-params probe runs with every param tainted by a
        #: FAKE origin — it must not write that taint into real summaries
        self.synthetic = synthetic
        self.returned_taint: Optional[str] = None
        self.changed = False

    # ---- expression taint -------------------------------------------------

    def eval(self, node: Optional[ast.AST], state: Dict[str, str]
             ) -> Optional[str]:
        """Origin description when ``node``'s value may be tainted, else
        None."""
        if node is None:
            return None
        if isinstance(node, ast.Name):
            return state.get(node.id)
        if isinstance(node, ast.Call):
            return self._eval_call(node, state)
        if isinstance(node, ast.Attribute):
            return self.eval(node.value, state)
        if isinstance(node, ast.Subscript):
            return (self.eval(node.value, state)
                    or self.eval(node.slice, state))
        if isinstance(node, ast.NamedExpr):
            org = self.eval(node.value, state)
            self._assign_target(node.target, org, state)
            return org
        if isinstance(node, ast.Lambda):
            # walk the body at the definition site (its sinks fire, its
            # captured taint propagates out); the lambda's own params
            # shadow enclosing names
            inner = dict(state)
            a = node.args
            for p in a.posonlyargs + a.args + a.kwonlyargs:
                inner.pop(p.arg, None)
            return self.eval(node.body, inner)
        if isinstance(node, (ast.Constant, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            return None
        for child in ast.iter_child_nodes(node):
            org = self.eval(child, state)
            if org:
                return org
        return None

    def _eval_call(self, node: ast.Call, state: Dict[str, str]
                   ) -> Optional[str]:
        args = list(node.args) + [kw.value for kw in node.keywords]
        arg_origins = [self.eval(a, state) for a in args]
        tainted_arg = next((o for o in arg_origins if o), None)
        if not isinstance(node.func, (ast.Name, ast.Attribute)):
            tainted_arg = self.eval(node.func, state) or tainted_arg
        elif isinstance(node.func, ast.Attribute):
            # method call: the receiver's taint flows through the result
            tainted_arg = self.eval(node.func.value, state) or tainted_arg
        if self.findings is not None:
            self._check_call_sinks(node, args, arg_origins, state)
        callee = self.pkg.resolve(self.mod, node.func)
        if callee is not None:
            self._bind_params(callee, node, arg_origins)
            if callee.returns_taint:
                return f"{callee.fn.name}() <- {callee.returns_taint}"
            if callee.propagates_params and tainted_arg:
                return tainted_arg
            return None
        return tainted_arg                  # unresolved: pass through

    def _bind_params(self, callee: _FuncInfo, node: ast.Call,
                     arg_origins) -> None:
        if self.synthetic:
            return
        # method call: the receiver occupies the first parameter slot, so
        # positional arguments shift by one (self.helper(tainted) must
        # taint 'idx', not 'self')
        shift = int(isinstance(node.func, ast.Attribute)
                    and bool(callee.params)
                    and callee.params[0] in ("self", "cls"))
        for pos, (a, org) in enumerate(zip(node.args, arg_origins)):
            if isinstance(a, ast.Starred):
                break
            if org and pos + shift < len(callee.params):
                name = callee.params[pos + shift]
                if name not in callee.tainted_params:
                    callee.tainted_params[name] = org
                    self.changed = True
        for kw, org in zip(node.keywords,
                           arg_origins[len(node.args):]):
            if kw.arg and org and kw.arg in callee.params \
                    and kw.arg not in callee.tainted_params:
                callee.tainted_params[kw.arg] = org
                self.changed = True

    # ---- sinks (a layer's model overrides these) --------------------------

    def _check_call_sinks(self, node: ast.Call, args, arg_origins,
                          state: Dict[str, str]) -> None:
        return None

    def _branch_sink(self, node: ast.AST, state: Dict[str, str]) -> None:
        # the test is evaluated in EVERY pass — its side effects (walrus
        # assignments, call-site param binding) belong to the summaries
        self.eval(node.test, state)

    # ---- statement execution ---------------------------------------------

    def _assign_target(self, target: ast.AST, origin: Optional[str],
                       state: Dict[str, str]) -> None:
        if isinstance(target, ast.Name):
            if origin:
                state[target.id] = origin
            else:
                state.pop(target.id, None)       # kill: clean redefinition
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._assign_target(
                    elt.value if isinstance(elt, ast.Starred) else elt,
                    origin, state)
        elif isinstance(target, (ast.Subscript, ast.Attribute)):
            # container/attribute store: taint the ROOT name (a[i] = bad
            # makes a suspect); never kill on clean stores
            root = target
            while isinstance(root, (ast.Subscript, ast.Attribute)):
                root = root.value
            if isinstance(root, ast.Name) and origin:
                state[root.id] = origin

    def exec_block(self, stmts: Iterable[ast.stmt],
                   state: Dict[str, str]) -> Dict[str, str]:
        for st in stmts:
            state = self.exec_stmt(st, state)
        return state

    def exec_stmt(self, st: ast.stmt, state: Dict[str, str]
                  ) -> Dict[str, str]:
        if isinstance(st, ast.Assign):
            org = self.eval(st.value, state)
            for t in st.targets:
                self._assign_target(t, org, state)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._assign_target(st.target, self.eval(st.value, state),
                                    state)
        elif isinstance(st, ast.AugAssign):
            org = self.eval(st.value, state) or self.eval(st.target, state)
            self._assign_target(st.target, org, state)
        elif isinstance(st, ast.If):
            self._branch_sink(st, state)
            s1 = self.exec_block(st.body, dict(state))
            s2 = self.exec_block(st.orelse, dict(state))
            state = _join(s1, s2)
        elif isinstance(st, ast.While):
            self._branch_sink(st, state)
            once = self.exec_block(st.body, dict(state))
            twice = self.exec_block(st.body, dict(once))
            state = self.exec_block(st.orelse, _join(state,
                                                     _join(once, twice)))
        elif isinstance(st, ast.For):
            org = self.eval(st.iter, state)
            body_state = dict(state)
            self._assign_target(st.target, org, body_state)
            once = self.exec_block(st.body, body_state)
            again = dict(once)
            self._assign_target(st.target, org, again)
            twice = self.exec_block(st.body, again)
            state = self.exec_block(st.orelse, _join(state,
                                                     _join(once, twice)))
        elif isinstance(st, ast.Try):
            merged = _join(state, self.exec_block(st.body, dict(state)))
            for h in st.handlers:
                hstate = dict(merged)
                if h.name:
                    hstate.pop(h.name, None)
                merged = _join(merged, self.exec_block(h.body, hstate))
            merged = self.exec_block(st.orelse, merged)
            state = self.exec_block(st.finalbody, merged)
        elif isinstance(st, ast.With):
            for item in st.items:
                org = self.eval(item.context_expr, state)
                if item.optional_vars is not None:
                    self._assign_target(item.optional_vars, org, state)
            state = self.exec_block(st.body, state)
        elif isinstance(st, ast.Return):
            org = self.eval(st.value, state)
            if org and not self.returned_taint:
                self.returned_taint = org
        elif isinstance(st, ast.Expr):
            self.eval(st.value, state)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # snapshot the enclosing taint for the nested def's free vars
            if not self.synthetic:
                self.changed |= self.pkg.note_enclosing(st, state)
        elif isinstance(st, ast.Raise):
            self.eval(st.exc, state)
        elif isinstance(st, ast.Assert):
            self.eval(st.test, state)
        elif isinstance(st, ast.Delete):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    state.pop(t.id, None)
        return state

    # ---- drivers ----------------------------------------------------------

    def initial_state(self) -> Dict[str, str]:
        return _join(dict(self.info.tainted_params),
                     self.pkg.enclosing_state.get(self.info.fn, {}))

    def run(self) -> None:
        state = self.exec_block(self.info.fn.body, self.initial_state())
        del state
        if self.returned_taint and not self.info.returns_taint:
            # param pass-through is the propagates_params bit; only
            # source-derived returns set returns_taint (otherwise every
            # caller of e.g. normalize() would see taint on clean args)
            if self.returned_taint not in set(
                    self.info.tainted_params.values()):
                self.info.returns_taint = self.returned_taint
                self.changed = True


def _join(a: Dict[str, str], b: Dict[str, str]) -> Dict[str, str]:
    out = dict(a)
    for k, v in b.items():
        out.setdefault(k, v)
    return out


def _propagates(pkg: _Package, info: _FuncInfo, analyzer) -> bool:
    """Does a tainted parameter reach this function's return value?
    One synthetic summary run of ``analyzer`` (an :class:`_Analyzer`
    subclass) with every parameter tainted."""
    probe = analyzer(pkg, info, synthetic=True)
    state = {p: "param" for p in info.params}
    try:
        probe.exec_block(info.fn.body, state)
    except RecursionError:                            # pragma: no cover
        return True
    return probe.returned_taint is not None


def grow_summaries(pkg: _Package, analyzer, rounds: int = 8) -> None:
    """Grow the summaries (propagates_params / returns_taint /
    tainted_params / nested-def scopes) to a fixpoint under
    ``analyzer``'s model; findings are discarded in these passes.
    propagates_params is INSIDE the loop: a pass-through chain whose
    caller is defined before its callee only converges on the second
    round (definition order must not decide whether a flow is seen)."""
    for _ in range(rounds):
        changed = False
        for info in pkg.infos:
            if not info.propagates_params \
                    and _propagates(pkg, info, analyzer):
                info.propagates_params = True
                changed = True
            a = analyzer(pkg, info)
            a.run()
            changed |= a.changed
        if not changed:
            break
