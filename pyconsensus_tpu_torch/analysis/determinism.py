"""Layer 6: bit-determinism & numerics-flow analysis (CL1001-CL1005).

Every contract this package ships — replication-log replay, cross-worker
takeover, the economy's ``mechanism_digest``, the card's bitwise checks
against the plain versions — is a *bit-identity* claim: identical inputs
must reproduce identical bytes. An unordered ``os.listdir`` sweep
feeding a size sum, a ``dict.items()`` fold assembling an npz, a
completion-order ``as_completed`` collection folded into reputation —
each replays differently on another host (or the same host under a
different ``PYTHONHASHSEED``), and replay tests only catch the
interleaving that actually fired.

This pass rides :mod:`.dataflow`'s machinery (package table, call-graph
fixpoint, flow-sensitive abstract interpreter) with its own
source/sanitizer/sink model. Taint origins are category-prefixed
strings; the category at the sink selects the rule:

- **order** (CL1001) — unordered iteration: ``dict``/``set``/
  ``frozenset`` iteration (``.items()``/``.keys()``/``.values()``, set
  literals/comprehensions/constructors), ``os.listdir``/``scandir``/
  ``walk``, non-sorted ``glob``/``Path.iterdir``/``rglob``.
- **completion** (CL1002) — completion-order collection:
  ``as_completed``, ``imap_unordered``.
- **hostnd** (CL1003) — host nondeterminism: ``id()``, builtin
  ``hash()`` (str/bytes hashes are salted per process), ``time.*``
  clocks, ``uuid.*``, unseeded host RNG (``random.*``,
  ``numpy.random.*``, ``default_rng()`` with NO seed argument —
  seeded constructions and the economy's ``strategy_rng`` key
  derivation are clean by design).
- **floatacc** (CL1004) — float-accumulation hazard: builtin ``sum()``
  or an ``+=`` fold over an order-/completion-tainted collection.

**Sinks** — digest computation (``hashlib.*`` constructor arguments and
``.update()`` on handles built from them, ``mechanism_digest``),
replication-journal and ledger payloads (``journal_block``/
``record_round`` arguments), npz state assembly (``np.savez``/
``savez_compressed``) and JSON artifacts (``json.dump``/``dumps``
WITHOUT ``sort_keys=True``).

**Sanitizers** — ``sorted()`` (strips order/completion taint; host
nondeterminism passes through), ``min``/``max`` (order-insensitive
reductions), ``strategy_rng``/seeded ``default_rng(seed)``, and
canonical JSON (``sort_keys=True``).

**CL1005** is a source rule here. The reference checks it on compiled
HLO (the scatter-add family); this package has no HLO, and its
counterpart is the ground rule "no float atomics on any path whose
output is compared bitwise or digested". It is enforced at two layers:

- in ``csrc/*.cu`` and ``*.cuh``: no ``atomicAdd`` (nor its ``_block``
  or ``_system`` forms) on a ``float``, ``double``, ``__half`` or
  ``__nv_bfloat16`` operand — the order in which a grid's atomics land
  decides the float sum. Integer atomics and host-side
  ``std::atomic`` counters are exact and stay silent;
- in the Python: ``index_add(_)``, ``scatter_add(_)``,
  ``scatter_reduce(_)``, ``index_put(_)(…, accumulate=True)`` and
  ``torch.bincount(weights=)`` — PyTorch lowers each to float atomics
  on the card.

The runtime mirror is :mod:`.determinism_witness` (DigestWitness).
``# consensus-lint: disable=CL100x`` line directives (``//`` comments
in CUDA sources) suppress in place, with the written rationale on the
same comment.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .dataflow import (_Analyzer, _canon, _Package, _src_line,
                       grow_summaries)
from .findings import Finding
from .rules import _line_directives, scan_targets

#: rule ID -> (severity, one-line description)
DETERMINISM_RULES = {
    "CL1001": ("error", "unordered iteration (dict/set iteration, "
                        "os.listdir, non-sorted glob/iterdir) reaches a "
                        "digest/journal/ledger/serialization sink — "
                        "iteration order feeds bytes that must replay "
                        "bit-identical; sort first"),
    "CL1002": ("error", "completion-order collection (as_completed / "
                        "imap_unordered) reaches a digest/journal/"
                        "serialization sink — scheduler timing decides "
                        "the fold order; key the fold by sequence "
                        "instead"),
    "CL1003": ("error", "host nondeterminism (id(), salted hash(), "
                        "time.*, uuid.*, unseeded host RNG) reaches a "
                        "digest/journal/serialization sink — the value "
                        "differs per process/run; derive from a seeded "
                        "key (strategy_rng) or drop it from the "
                        "payload"),
    "CL1004": ("error", "float accumulation (sum() / '+=' fold) over an "
                        "order-tainted collection reaches reputation/"
                        "ledger/digest state — float addition is not "
                        "associative, so an unordered fold breaks "
                        "bit-replay; sort the iterate or fold by "
                        "sequence key"),
    "CL1005": ("error", "float atomics on a bitwise-compared or digested "
                        "path: atomicAdd on a float/double/half/bfloat16 "
                        "operand in a CUDA source, or an accumulating "
                        "torch scatter (index_add_ / scatter_add_ / "
                        "scatter_reduce_ / index_put_(accumulate=True) / "
                        "bincount(weights=)) — the landing order of the "
                        "atomics decides the float sum"),
}

#: rules the taint pass emits (CL1005 is the source scan beside it)
STATIC_DETERMINISM_RULES = frozenset(
    r for r in DETERMINISM_RULES if r != "CL1005")

_CATEGORY_RULE = {"order": "CL1001", "completion": "CL1002",
                  "hostnd": "CL1003", "floatacc": "CL1004"}

_CATEGORY_NOUN = {
    "order": "an unordered-iteration value",
    "completion": "a completion-order value",
    "hostnd": "a host-nondeterministic value",
    "floatacc": "an order-dependent float accumulation",
}

#: canonical dotted calls yielding ORDER taint (filesystem enumeration
#: without a pinned order)
_ORDER_CALLS = {
    "os.listdir", "os.scandir", "os.walk",
    "glob.glob", "glob.iglob",
}

#: attribute-call tails yielding ORDER taint on any receiver:
#: Path.iterdir/glob/rglob enumerate in readdir order; dict views
#: iterate in insertion order (unpinned across processes)
_ORDER_TAILS = {"iterdir", "glob", "rglob", "items", "keys", "values"}

#: set construction — str-hash iteration order changes per process
#: under PYTHONHASHSEED
_SET_CTOR_TAILS = {"set", "frozenset"}

#: completion-order collection
_COMPLETION_TAILS = {"as_completed", "imap_unordered"}

#: host-nondeterminism call prefixes (canonical dotted)
_HOSTND_PREFIXES = (
    "time.", "uuid.uuid", "random.", "numpy.random.", "secrets.",
    "os.urandom", "os.getpid",
)

#: bare builtins whose results differ per process
_HOSTND_BUILTINS = {"id", "hash"}

#: sanitizer tails: sorted() pins the order; min/max are
#: order-insensitive reductions; strategy_rng is the economy's seeded
#: key-derivation path (blessed randomness)
_ORDER_SANITIZER_TAILS = {"sorted", "min", "max"}
_RNG_SANITIZER_TAILS = {"strategy_rng"}

#: sink tails: replication-journal / ledger payload construction
_JOURNAL_SINK_TAILS = {"journal_block", "record_round"}

#: sink tails: npz state assembly
_SAVEZ_TAILS = {"savez", "savez_compressed"}

#: container mutators that fold a tainted operand into their receiver
_MUTATOR_TAILS = {"append", "add", "extend", "update", "insert",
                  "setdefault", "appendleft"}


def _category(origin: Optional[str]) -> str:
    return origin.split(":", 1)[0] if origin else ""


class _DetAnalyzer(_Analyzer):
    """The Layer 3a abstract interpreter with the determinism
    source/sanitizer/sink model. State values are category-prefixed
    origin strings (``order: d.items() at path:line``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        #: names lexically assigned from a hashlib constructor in this
        #: function — their ``.update(x)`` calls are digest sinks
        self._digest_handles: Set[str] = set()

    # ---- expression taint --------------------------------------------

    def eval(self, node, state):
        # set literals / comprehensions iterate in hash order
        if isinstance(node, (ast.Set, ast.SetComp)):
            for child in ast.iter_child_nodes(node):
                org = self.eval(child, state)
                if org and _category(org) != "order":
                    return org
            return (f"order: set literal at "
                    f"{self.mod.path}:{node.lineno}")
        return super().eval(node, state)

    def _origin(self, kind: str, what: str, node: ast.AST) -> str:
        return f"{kind}: {what} at {self.mod.path}:{node.lineno}"

    def _eval_call(self, node: ast.Call, state):
        args = list(node.args) + [kw.value for kw in node.keywords]
        arg_origins = [self.eval(a, state) for a in args]
        tainted_arg = next((o for o in arg_origins if o), None)
        if not isinstance(node.func, (ast.Name, ast.Attribute)):
            tainted_arg = self.eval(node.func, state) or tainted_arg

        dotted = _canon(self.mod, node.func) or ""
        tail = dotted.split(".")[-1] if dotted else ""

        # -- sanitizers -------------------------------------------------
        if tail in _ORDER_SANITIZER_TAILS:
            # sorted()/min()/max() pin or erase the order; host
            # nondeterminism passes through (sorting a uuid does not
            # make it reproducible)
            if tainted_arg and _category(tainted_arg) in ("order",
                                                          "completion",
                                                          "floatacc"):
                return None
            return tainted_arg
        if tail in _RNG_SANITIZER_TAILS:
            return None
        if dotted in ("json.dump", "json.dumps") and any(
                kw.arg == "sort_keys" and isinstance(kw.value, ast.Constant)
                and kw.value.value for kw in node.keywords):
            # canonical JSON: key order is pinned regardless of the
            # input dict's insertion/hash order — the serialization IS
            # the sort
            return None
        if tail == "default_rng":
            # seeded default_rng(seed) is the blessed reproducible RNG;
            # default_rng() with no arguments draws OS entropy
            if args:
                return tainted_arg
            return self._origin("hostnd", "unseeded default_rng()", node)

        # -- sources ----------------------------------------------------
        if dotted in _ORDER_CALLS:
            return self._origin("order", f"{dotted}()", node)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _ORDER_TAILS:
            return self._origin("order", f".{node.func.attr}()", node)
        if tail in _SET_CTOR_TAILS and "." not in dotted:
            org = tainted_arg
            if org and _category(org) != "order":
                return org
            return self._origin("order", f"{tail}(...)", node)
        if tail in _COMPLETION_TAILS:
            return self._origin("completion", f"{tail}()", node)
        if dotted in _HOSTND_BUILTINS:
            return self._origin("hostnd", f"{dotted}()", node)
        for pref in _HOSTND_PREFIXES:
            if dotted == pref.rstrip(".") or dotted.startswith(pref):
                return self._origin("hostnd", f"{dotted}()", node)

        # -- CL1004: unordered float accumulation via builtin sum() ----
        if dotted == "sum" and tainted_arg and \
                _category(tainted_arg) in ("order", "completion"):
            return (f"floatacc: sum() over {tainted_arg}")

        # receiver taint flows through method-call results
        if isinstance(node.func, ast.Attribute):
            tainted_arg = self.eval(node.func.value, state) or tainted_arg

        if self.findings is not None:
            self._check_call_sinks(node, args, arg_origins, state)

        # container-fold propagation: lst.append(v) / d.update(v) / s.add(v)
        # with a tainted operand taints the RECEIVER name — the dominant
        # payload-assembly idiom (append inside an items() loop)
        if tainted_arg and isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATOR_TAILS and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id not in self._digest_handles:
            state[node.func.value.id] = tainted_arg

        callee = self.pkg.resolve(self.mod, node.func)
        if callee is not None:
            self._bind_params(callee, node, arg_origins)
            if callee.returns_taint:
                # keep the category prefix at the front so the sink can
                # still classify the wrapped origin
                return (f"{_category(callee.returns_taint)}: "
                        f"{callee.fn.name}() <- {callee.returns_taint}")
            if callee.propagates_params and tainted_arg:
                return tainted_arg
            return None
        return tainted_arg                  # unresolved: pass through

    # ---- sinks --------------------------------------------------------

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        sup = self.directives.get(line, set())
        if "*" in sup or rule in sup:
            return
        self.findings.append(Finding(
            rule=rule, path=self.mod.path, line=line, message=message,
            severity=DETERMINISM_RULES[rule][0],
            snippet=_src_line(self.mod, node).strip()))

    def _sink_hit(self, node: ast.Call, origin: str, sink: str) -> None:
        cat = _category(origin)
        rule = _CATEGORY_RULE.get(cat)
        if rule is None:
            return
        noun = _CATEGORY_NOUN[cat]
        fix = {"order": "sort the iterate before it reaches the sink",
               "completion": "fold by sequence key, not completion "
                             "order",
               "hostnd": "derive from a seeded key or drop it from the "
                         "payload",
               "floatacc": "sort the iterate (or fold by sequence key) "
                           "so the accumulation order is pinned",
               }[cat]
        self._emit(node, rule,
                   f"{sink} in '{self.info.fn.name}' consumes {noun} "
                   f"({origin}) — the bytes cannot replay "
                   f"bit-identically; {fix}")

    def _check_call_sinks(self, node: ast.Call, args, arg_origins,
                          state) -> None:
        dotted = _canon(self.mod, node.func) or ""
        tail = dotted.split(".")[-1] if dotted else ""
        org = next((o for o in arg_origins if o), None)

        if org:
            if dotted.startswith("hashlib."):
                self._sink_hit(node, org,
                               f"digest computation '{tail}(...)'")
                return
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "update" and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id in self._digest_handles:
                self._sink_hit(node, org, "digest '.update(...)'")
                return
            if tail == "mechanism_digest":
                self._sink_hit(node, org, "'mechanism_digest(...)'")
                return
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _JOURNAL_SINK_TAILS:
                self._sink_hit(node, org,
                               f"replication payload "
                               f"'.{node.func.attr}(...)'")
                return
            if tail in _SAVEZ_TAILS and dotted.startswith("numpy."):
                self._sink_hit(node, org, f"npz assembly '{tail}(...)'")
                return
            if dotted in ("json.dump", "json.dumps"):
                sort_keys = any(
                    kw.arg == "sort_keys"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value
                    for kw in node.keywords)
                if not sort_keys:
                    self._sink_hit(node, org,
                                   f"JSON artifact '{dotted}(...)' "
                                   f"(no sort_keys=True)")
                return

    def _branch_sink(self, node: ast.AST, state) -> None:
        # no branch sink in this layer — only evaluate the test so its
        # side effects (walrus, call-site param binding) still happen
        self.eval(node.test, state)

    # ---- statement execution -----------------------------------------

    def exec_stmt(self, st: ast.stmt, state):
        if isinstance(st, ast.Assign):
            # track digest handles: h = hashlib.sha256(...) makes
            # h.update(x) a sink in this function
            if isinstance(st.value, ast.Call):
                vdotted = _canon(self.mod, st.value.func) or ""
                if vdotted.startswith("hashlib."):
                    for t in st.targets:
                        if isinstance(t, ast.Name):
                            self._digest_handles.add(t.id)
        elif isinstance(st, ast.AugAssign):
            # '+=' fold whose operand (or accumulator) carries order
            # taint is an order-dependent accumulation (CL1004 origin)
            vorg = self.eval(st.value, state)
            torg = self.eval(st.target, state)
            org = vorg or torg
            if org and _category(org) in ("order", "completion") and \
                    isinstance(st.op, ast.Add):
                self._assign_target(st.target,
                                    f"floatacc: '+=' fold over {org}",
                                    state)
                return state
            self._assign_target(st.target, org, state)
            return state
        return super().exec_stmt(st, state)


def analyze_determinism(paths=None, root=None,
                        select: Optional[Set[str]] = None
                        ) -> List[Finding]:
    """Run Layer 6 over ``paths`` (default: the installed package): the
    taint analysis (CL1001-1004; summaries grown to a fixpoint, then one
    findings pass with line-directive suppression) and the CL1005 source
    scan of the Python and CUDA files. Findings sorted by (path, line,
    rule)."""
    want = set(DETERMINISM_RULES) if select is None \
        else set(select) & set(DETERMINISM_RULES)
    findings: List[Finding] = []
    if not want:
        return findings
    pkg = _Package(scan_targets(paths, root))
    directives = {rel: _line_directives(mod.text)
                  for rel, mod in pkg.mods.items()}
    if want & STATIC_DETERMINISM_RULES:
        grow_summaries(pkg, _DetAnalyzer)
        for info in pkg.infos:
            _DetAnalyzer(pkg, info, findings=findings,
                         directives=directives.get(info.mod.path, {})).run()
    if "CL1005" in want:
        findings.extend(_python_atomics(pkg, directives))
        for f, rel in scan_targets(paths, root, suffixes=_CUDA_SUFFIXES):
            findings.extend(cuda_float_atomics(
                f.read_text(encoding="utf-8"), rel))
    if select is not None:
        findings = [f for f in findings if f.rule in select]
    uniq = {}
    for f in findings:
        uniq.setdefault((f.rule, f.path, f.line, f.message), f)
    return sorted(uniq.values(), key=lambda f: (f.path, f.line, f.rule))


# -- CL1005: the float-atomics source rule ----------------------------------

#: torch calls that accumulate through float atomics on the card,
#: whatever their arguments (in-place and out-of-place forms)
_ATOMIC_SCATTER_TAILS = {"index_add_", "index_add", "scatter_add_",
                         "scatter_add", "scatter_reduce_",
                         "scatter_reduce"}

#: torch calls that accumulate only under a keyword
_ACCUMULATE_TAILS = {"index_put_", "index_put"}

_CUDA_SUFFIXES = (".cu", ".cuh")

#: CUDA atomic adds whose operand type decides the rule
_ATOMIC_ADD_RE = re.compile(r"\batomicAdd(?:_block|_system)?\s*\(")

#: floating element types of an atomicAdd operand
_FLOAT_TYPES = ("float", "double", "__half", "half", "__nv_bfloat16",
                "nv_bfloat16", "__half2", "__nv_bfloat162", "float2",
                "float4", "double2")

_FLOAT_TYPE_RE = "|".join(re.escape(t) for t in
                          sorted(_FLOAT_TYPES, key=len, reverse=True))

#: a floating literal as the added value (``1.0f``, ``0.5``, ``1e-3``)
_FLOAT_LITERAL_RE = re.compile(
    r"^[-+]?(\d+\.\d*|\.\d+|\d+[eE][-+]?\d+|\d+\.?\d*[fF])"
    r"([eE][-+]?\d+)?[fF]?$")


def _python_atomics(pkg: _Package, directives) -> List[Finding]:
    """The Python half of CL1005: accumulating torch scatters."""
    out: List[Finding] = []
    for rel, mod in pkg.mods.items():
        sup_map = directives.get(rel, {})
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            tail = ""
            if isinstance(node.func, ast.Attribute):
                tail = node.func.attr
            elif isinstance(node.func, ast.Name):
                tail = node.func.id
            dotted = _canon(mod, node.func)
            what = None
            if tail in _ATOMIC_SCATTER_TAILS:
                what = f"'{tail}(...)'"
            elif tail in _ACCUMULATE_TAILS and any(
                    kw.arg == "accumulate"
                    and not (isinstance(kw.value, ast.Constant)
                             and not kw.value.value)
                    for kw in node.keywords):
                what = f"'{tail}(..., accumulate=True)'"
            elif (tail == "bincount" and not dotted.startswith("numpy.")
                  and (any(kw.arg == "weights" for kw in node.keywords)
                       or len(node.args) >= 2)):
                what = "'bincount(..., weights=)'"
            if what is None:
                continue
            sup = sup_map.get(node.lineno, set())
            if "*" in sup or "CL1005" in sup:
                continue
            out.append(Finding(
                rule="CL1005", path=rel, line=node.lineno,
                message=(f"{what} accumulates through float atomics on "
                         f"the card — the landing order decides the sum, "
                         f"so the result is not bit-reproducible; fold "
                         f"in a fixed order (sort the indices, segment "
                         f"and reduce, or a hand-written ordered pass)"),
                severity=DETERMINISM_RULES["CL1005"][0],
                snippet=_src_line(mod, node).strip()))
    return out


def _strip_cuda_comments(text: str) -> Tuple[str, Dict[int, Set[str]]]:
    """The source with ``//`` and ``/* */`` comments and string literals
    blanked (line structure kept), and the ``// consensus-lint:
    disable=...`` directives by line."""
    directives: Dict[int, Set[str]] = {}
    out = []
    i, n, line = 0, len(text), 1
    while i < n:
        c = text[i]
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            comment = text[i:j]
            if "consensus-lint:" in comment and "disable=" in comment:
                ids = comment.split("disable=", 1)[1]
                directives[line] = {
                    s.split()[0] for s in ids.replace(";", ",").split(",")
                    if s.strip()}
            out.append(" " * (j - i))
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            chunk = text[i:j]
            out.append("".join(ch if ch == "\n" else " " for ch in chunk))
            line += chunk.count("\n")
            i = j
        elif c == '"':
            j = i + 1
            while j < n and text[j] != '"' and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            out.append(" " * (min(j + 1, n) - i))
            i = min(j + 1, n)
        else:
            if c == "\n":
                line += 1
            out.append(c)
            i += 1
    return "".join(out), directives


def _split_args(text: str, start: int) -> Tuple[List[str], int]:
    """The top-level comma-separated arguments of the call whose
    opening parenthesis is at ``text[start - 1]``."""
    depth, args, cur, i = 0, [], [], start
    while i < len(text):
        c = text[i]
        if c in "([{":
            depth += 1
        elif c in ")]}":
            if depth == 0:
                args.append("".join(cur).strip())
                return args, i
            depth -= 1
        if c == "," and depth == 0:
            args.append("".join(cur).strip())
            cur = []
        else:
            cur.append(c)
        i += 1
    return args, i


def _operand_type(code: str, pos: int, arg: str) -> Optional[str]:
    """The element type an atomicAdd's address operand points at: a
    cast to a floating pointer, else the nearest declaration of the
    operand's base name before ``pos``. None when it cannot be told."""
    cast = re.match(r"^\(\s*(?:const\s+)?(" + _FLOAT_TYPE_RE
                    + r")\s*\*\s*\)", arg)
    if cast:
        return cast.group(1)
    base = re.match(r"^[&\s(]*([A-Za-z_]\w*)", arg)
    if base is None:
        return None
    name = base.group(1)
    decl = re.compile(
        r"\b(" + _FLOAT_TYPE_RE + r"|int|unsigned|long|short|char|bool|"
        r"u?int(?:8|16|32|64)_t|size_t|unsigned\s+(?:int|long(?:\s+long)?)"
        r"|long\s+long)\b(?:\s+const)?[\s*&]*(?:const\s+)?"
        r"(?:__restrict__\s+)?[\s*&]*\b" + re.escape(name)
        + r"\s*(?=[\[;=,)])")
    found = None
    for m in decl.finditer(code, 0, pos):
        found = m.group(1)
    return found


def cuda_float_atomics(text: str, rel: str) -> List[Finding]:
    """The CUDA half of CL1005 over one ``.cu``/``.cuh`` source: every
    ``atomicAdd``/``atomicAdd_block``/``atomicAdd_system`` whose operand
    is floating (by its declaration, a cast, or a floating literal as
    the added value). ``std::atomic`` counters are never matched."""
    code, directives = _strip_cuda_comments(text)
    lines = text.splitlines()
    out: List[Finding] = []
    for m in _ATOMIC_ADD_RE.finditer(code):
        args, _ = _split_args(code, m.end())
        if not args:
            continue
        ty = _operand_type(code, m.start(), args[0])
        floating = ty in _FLOAT_TYPES
        if ty is None and len(args) > 1:
            floating = bool(_FLOAT_LITERAL_RE.match(args[1]))
        if not floating:
            continue
        line = code.count("\n", 0, m.start()) + 1
        sup = directives.get(line, set())
        if "*" in sup or "CL1005" in sup:
            continue
        call = m.group(0).rstrip("( ")
        out.append(Finding(
            rule="CL1005", path=rel, line=line,
            message=(f"'{call}' on a {ty or 'floating'} operand: the "
                     f"order in which the grid's atomics land decides "
                     f"the float sum, so the output is not "
                     f"bit-reproducible; reduce in a fixed order (per-"
                     f"block partials, then one ordered pass)"),
            severity=DETERMINISM_RULES["CL1005"][0],
            snippet=lines[line - 1].strip() if line <= len(lines) else ""))
    return out
