"""The scan machinery every layer shares, and the generic AST rules.

Each layer parses the scanned files once into a :class:`_Module` (alias
map, function table), resolves its targets through :func:`scan_targets`
and honours the same line directives: a ``# consensus-lint:
disable=CL201,CL802 — rationale`` (or bare ``# noqa``) comment on the
finding's line suppresses it in place.

The generic rules are CL201 (mutable default argument), CL202 (bare
except) and CL203 (unused module-level import). The reference's
traced-context rules (CL101-105, CL501, CL502, CL601, CL701) guard code
that ``jax.jit`` traces; this package has no traced context, so they are
not carried.
"""

from __future__ import annotations

import ast
import pathlib
from typing import Dict, List, Optional, Set, Tuple

from .findings import Finding

#: rule ID -> (severity, one-line description)
RULES = {
    "CL201": ("warning", "mutable default argument"),
    "CL202": ("warning", "bare except clause"),
    "CL203": ("warning", "unused module-level import"),
}


def _dotted(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` -> that string; None for non-trivial
    roots."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Aliases:
    """Canonicalize the module's import aliases: np -> numpy, ..."""

    def __init__(self, tree: ast.Module):
        self.map: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.map[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.map[a.asname or a.name] = f"{node.module}.{a.name}"

    def canon(self, dotted: Optional[str]) -> Optional[str]:
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        head = self.map.get(head, head)
        return f"{head}.{rest}" if rest else head


def _line_directives(text: str) -> Dict[int, Set[str]]:
    """{lineno: set of suppressed rule IDs} ('*' = all) from
    ``# consensus-lint: disable=...`` / ``# noqa`` comments. Each
    comma-separated piece contributes its first whitespace token, so a
    suppression can carry its written rationale in the same comment:
    ``# consensus-lint: disable=CL802 — the journal write must commit
    under the session lock``."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if "#" not in line:
            continue
        comment = line[line.index("#"):]
        if "consensus-lint:" in comment and "disable=" in comment:
            ids = comment.split("disable=", 1)[1]
            out[i] = {s.split()[0] for s in ids.replace(";", ",").split(",")
                      if s.strip()}
        elif "# noqa" in comment:
            out[i] = {"*"}
    return out


_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


class _Module:
    """Per-module analysis state: alias map and function table."""

    def __init__(self, path: str, text: str, tree: ast.Module):
        self.path = path
        self.text = text
        self.tree = tree
        self.aliases = _Aliases(tree)
        self.funcs: List[ast.AST] = [n for n in ast.walk(tree)
                                     if isinstance(n, _FuncNode)]


# -- the generic rules ------------------------------------------------------


def _srcline(mod: _Module, node: ast.AST) -> str:
    lines = mod.text.splitlines()
    i = getattr(node, "lineno", 0)
    return lines[i - 1].strip() if 0 < i <= len(lines) else ""


def _mk(mod: _Module, node: ast.AST, rule: str, message: str) -> Finding:
    sev = RULES[rule][0]
    return Finding(rule=rule, path=mod.path,
                   line=getattr(node, "lineno", 0), message=message,
                   severity=sev, snippet=_srcline(mod, node))


def _rule_mutable_default(mod: _Module):
    for fn in mod.funcs:
        for default in list(fn.args.defaults) + [
                d for d in fn.args.kw_defaults if d is not None]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                yield _mk(mod, default, "CL201",
                          f"mutable default argument in '{fn.name}'")


def _rule_bare_except(mod: _Module):
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            yield _mk(mod, node, "CL202",
                      "bare 'except:' swallows KeyboardInterrupt/"
                      "SystemExit — name the exception")


def _rule_unused_import(mod: _Module):
    if pathlib.PurePath(mod.path).name == "__init__.py":
        return                        # re-export surface
    bound: Dict[str, ast.AST] = {}
    for node in mod.tree.body:        # module level only
        if isinstance(node, ast.Import):
            for a in node.names:
                bound[a.asname or a.name.split(".")[0]] = node
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name != "*":
                    bound[a.asname or a.name] = node
        elif isinstance(node, ast.Try):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Import):
                    for a in sub.names:
                        bound[a.asname or a.name.split(".")[0]] = sub
                elif isinstance(sub, ast.ImportFrom) \
                        and sub.module != "__future__":
                    for a in sub.names:
                        if a.name != "*":
                            bound[a.asname or a.name] = sub
    if not bound:
        return
    used: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            used.add(node.value)      # __all__ strings, doctest refs
    for name, node in bound.items():
        if name not in used:
            yield _mk(mod, node, "CL203",
                      f"import '{name}' is never used")


_ALL_RULES = (_rule_mutable_default, _rule_bare_except, _rule_unused_import)


# -- driver ---------------------------------------------------------------


def lint_file(path, rel_path: Optional[str] = None,
              select: Optional[Set[str]] = None) -> List[Finding]:
    """Lint one source file; returns findings sorted by line."""
    p = pathlib.Path(path)
    text = p.read_text(encoding="utf-8")
    rel = rel_path if rel_path is not None else p.name
    try:
        tree = ast.parse(text, filename=str(p))
    except SyntaxError as e:
        return [Finding(rule="CL000", path=rel, line=e.lineno or 0,
                        message=f"syntax error: {e.msg}", severity="error",
                        snippet="")]
    mod = _Module(rel, text, tree)
    directives = _line_directives(text)
    out: List[Finding] = []
    for rule_fn in _ALL_RULES:
        for f in rule_fn(mod):
            if select and f.rule not in select:
                continue
            suppressed = directives.get(f.line, set())
            if "*" in suppressed or f.rule in suppressed:
                continue
            out.append(f)
    return sorted(out, key=lambda f: (f.line, f.rule))


def default_scan_root() -> pathlib.Path:
    """The package's parent directory — paths are reported relative to it
    (``pyconsensus_tpu_torch/...``), stable across checkouts and
    installs."""
    return pathlib.Path(__file__).resolve().parents[2]


def default_paths() -> List[pathlib.Path]:
    """The port package itself."""
    return [pathlib.Path(__file__).resolve().parents[1]]


def scan_targets(paths=None, root: Optional[pathlib.Path] = None,
                 suffixes: Tuple[str, ...] = (".py",)
                 ) -> List[Tuple[pathlib.Path, str]]:
    """Resolve ``paths`` (files or directories, default: the installed
    pyconsensus_tpu_torch package) to ``[(file, repo-relative posix
    path)]`` — the scope a run actually covers, which the baseline
    updater uses to preserve accepted entries OUTSIDE a restricted run's
    scope. ``suffixes`` picks the file kinds (CL1005's source rule also
    reads ``.cu`` and ``.cuh``)."""
    root = root or default_scan_root()
    targets = [pathlib.Path(p) for p in (paths or default_paths())]
    files: List[pathlib.Path] = []
    for t in targets:
        if t.is_dir():
            files.extend(sorted(f for f in t.rglob("*")
                                if f.suffix in suffixes and f.is_file()))
        elif t.suffix in suffixes:
            files.append(t)
    out = []
    for f in files:
        try:
            rel = f.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = f.name
        out.append((f, rel))
    return out


def lint_paths(paths=None, root: Optional[pathlib.Path] = None,
               select: Optional[Set[str]] = None) -> List[Finding]:
    """Lint ``paths`` (files or directories, default: the installed
    pyconsensus_tpu_torch package). Findings are sorted by (path,
    line)."""
    out: List[Finding] = []
    for f, rel in scan_targets(paths, root):
        out.extend(lint_file(f, rel_path=rel, select=select))
    return sorted(out, key=lambda x: (x.path, x.line, x.rule))
