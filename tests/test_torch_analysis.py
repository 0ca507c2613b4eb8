"""The port's consensus-lint (``pyconsensus_tpu_torch.analysis``) on the
CPU: the generic-rule corpus (CL201-203, one parametrised case a rule),
the suppression directive, stable fingerprints, the baseline workflow,
the command line's exit codes, scopes and rule list, the shipped tree
clean under ``--strict`` with an empty baseline, and the port's
independence: neither the package (its analysis included) nor
``chip_smoke.py`` imports JAX or the JAX package, and the lock witness
loads from its file before the package so that the locks the package
builds at import are witnessed too."""

import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from pyconsensus_tpu_torch.analysis import (Finding, fingerprints,
                                            lint_paths, load_baseline,
                                            match_baseline)
from pyconsensus_tpu_torch.analysis.baseline import (default_baseline_path,
                                                     save_baseline)
from pyconsensus_tpu_torch.analysis.cli import run as cli_run
from pyconsensus_tpu_torch.analysis.concurrency import (CONCURRENCY_RULES,
                                                        analyze_concurrency)
from pyconsensus_tpu_torch.analysis.determinism import (DETERMINISM_RULES,
                                                        analyze_determinism)
from pyconsensus_tpu_torch.analysis.protocol import (PROTOCOL_RULES,
                                                     analyze_protocol)
from pyconsensus_tpu_torch.analysis.rules import RULES, lint_file

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "pyconsensus_tpu_torch"

#: per rule: (snippet that MUST trigger it, snippet that must NOT)
CORPUS = {
    "CL201": (
        "def f(a, b=[]):\n    return a\n",
        "def f(a, b=()):\n    return a\n",
    ),
    "CL202": (
        "def f(a):\n    try:\n        return a\n    except:\n        pass\n",
        "def f(a):\n    try:\n        return a\n    except ValueError:\n"
        "        pass\n",
    ),
    "CL203": (
        "import os\nX = 1\n",
        "import os\nX = os.sep\n",
    ),
}


@pytest.mark.parametrize("rule", sorted(CORPUS))
def test_rule_triggers_and_stays_silent(rule, tmp_path):
    pos_src, neg_src = CORPUS[rule]
    pos = tmp_path / "pos.py"
    pos.write_text(textwrap.dedent(pos_src))
    neg = tmp_path / "neg.py"
    neg.write_text(textwrap.dedent(neg_src))
    assert rule in {f.rule for f in lint_file(pos, rel_path="pos.py")}, (
        f"{rule} did not fire on its positive snippet")
    assert rule not in {f.rule for f in lint_file(neg, rel_path="neg.py")}, (
        f"{rule} fired on its negative snippet")


def test_every_rule_has_corpus_coverage():
    assert set(CORPUS) == set(RULES)


def test_suppression_comment(tmp_path):
    p = tmp_path / "s.py"
    p.write_text("def f(a, b=[]):  # consensus-lint: disable=CL201 — "
                 "read-only sentinel\n    return a\n")
    assert lint_file(p, rel_path="s.py") == []


def test_fingerprints_stable_across_line_shifts(tmp_path):
    src = "def f(a, b=[]):\n    return a\n"
    p = tmp_path / "m.py"
    p.write_text(src)
    fp1 = fingerprints(lint_file(p, rel_path="m.py"))
    p.write_text("# a new comment line\n# another\n" + src)
    fp2 = fingerprints(lint_file(p, rel_path="m.py"))
    assert fp1 and fp1 == fp2


# ------------------------------------------------------- baseline workflow


def test_shipped_baseline_is_empty_and_matches_tree():
    """The checked-in baseline accepts nothing, and the tree needs
    nothing accepted: every finding was fixed or carries its rationale
    directive in place."""
    baseline = load_baseline()
    assert baseline == {"version": 1, "findings": []}
    assert json.loads(default_baseline_path().read_text()) == baseline
    findings = (lint_paths() + analyze_concurrency() + analyze_protocol()
                + analyze_determinism())
    new, matched, stale = match_baseline(findings, baseline)
    assert new == [], "\n".join(f.render() for f in new)
    assert matched == [] and stale == []


def test_baseline_roundtrip(tmp_path):
    f = Finding(rule="CL201", path="x.py", line=3, message="m",
                severity="warning", snippet="def f(a, b=[]):")
    bl = tmp_path / "bl.json"
    save_baseline([f], path=bl, reason="test rationale")
    doc = json.loads(bl.read_text())
    assert doc["findings"][0]["reason"] == "test rationale"
    new, matched, stale = match_baseline([f], load_baseline(bl))
    assert (new, len(matched), stale) == ([], 1, [])
    # a DIFFERENT finding is new; the old entry goes stale
    g = Finding(rule="CL202", path="x.py", line=9, message="m2",
                severity="warning", snippet="except:")
    new, matched, stale = match_baseline([g], load_baseline(bl))
    assert len(new) == 1 and matched == [] and len(stale) == 1


# ---------------------------------------------------------------- CLI


def test_cli_exit_codes_and_baseline_update(tmp_path, capsys):
    src = tmp_path / "mod.py"
    src.write_text("def f(a, b=[]):\n    return a\n")
    bl = tmp_path / "bl.json"
    # new finding, empty baseline -> exit 1
    assert cli_run([str(src), "--baseline", str(bl)]) == 1
    # accept it -> exit 0 afterwards
    assert cli_run([str(src), "--baseline", str(bl),
                    "--update-baseline"]) == 0
    assert cli_run([str(src), "--baseline", str(bl)]) == 0
    # fix the code -> the stale entry fails only --strict
    src.write_text("X = 1\n")
    assert cli_run([str(src), "--baseline", str(bl)]) == 0
    assert cli_run([str(src), "--baseline", str(bl), "--strict"]) == 1
    out = capsys.readouterr().out
    assert "stale baseline" in out


def test_update_baseline_preserves_out_of_scope_entries(tmp_path):
    """A path-, rule- or layer-restricted --update-baseline run must not
    delete accepted entries it could not have reproduced."""
    mod = tmp_path / "mod.py"
    mod.write_text("def f(a, b=[]):\n    return a\n")
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"version": 1, "findings": [
        {"fingerprint": "CL802:mod.py:deadbeef", "rule": "CL802",
         "path": "mod.py", "message": "m", "reason": "accepted: layer"},
        {"fingerprint": "CL202:other.py:cafebabe", "rule": "CL202",
         "path": "other.py", "message": "m", "reason": "accepted: legacy"},
    ]}))
    assert cli_run([str(mod), "--baseline", str(bl), "--no-concurrency",
                    "--update-baseline"]) == 0
    kept = {e["fingerprint"]: e
            for e in json.loads(bl.read_text())["findings"]}
    assert "CL802:mod.py:deadbeef" in kept          # layer didn't run
    assert "CL202:other.py:cafebabe" in kept        # file not in scope
    assert kept["CL802:mod.py:deadbeef"]["reason"] == "accepted: layer"
    assert any(e.startswith("CL201:mod.py:") for e in kept)  # new accept


def test_strict_stale_is_scoped_to_the_run(tmp_path):
    """Out-of-scope baseline entries (other files, a skipped layer, a
    rule outside --select) are not stale: only a run that could have
    reproduced an entry may fail on its absence."""
    mod = tmp_path / "mod.py"
    mod.write_text("X = 1\n")
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"version": 1, "findings": [
        {"fingerprint": "CL1001:mod.py:deadbeef", "rule": "CL1001",
         "path": "mod.py", "message": "m", "reason": "accepted"},
        {"fingerprint": "CL202:other.py:cafebabe", "rule": "CL202",
         "path": "other.py", "message": "m", "reason": "accepted"},
    ]}))
    assert cli_run([str(mod), "--baseline", str(bl), "--strict",
                    "--no-determinism"]) == 0
    assert cli_run([str(mod), "--baseline", str(bl), "--strict",
                    "--select", "CL201"]) == 0
    assert cli_run([str(mod), "--baseline", str(bl), "--strict"]) == 1


def test_cli_list_rules_is_exactly_the_ported_layers(capsys):
    assert cli_run(["--list-rules"]) == 0
    out = capsys.readouterr().out
    listed = {line.split()[0] for line in out.splitlines()
              if line.startswith("  CL")}
    want = ({f"CL{n}" for n in range(201, 204)}
            | {f"CL{n}" for n in range(801, 806)}
            | {f"CL{n}" for n in range(901, 906)}
            | {f"CL{n}" for n in range(1001, 1006)})
    assert listed == want
    assert set(RULES) | set(CONCURRENCY_RULES) | set(PROTOCOL_RULES) \
        | set(DETERMINISM_RULES) == want


def test_cli_drops_the_unported_layers_flags(capsys):
    for flag in ("--contracts", "--no-contracts", "--no-dataflow"):
        with pytest.raises(SystemExit) as ei:
            cli_run([flag])
        assert ei.value.code == 2
    capsys.readouterr()


def test_cli_json_format(tmp_path, capsys):
    src = tmp_path / "mod.py"
    src.write_text("def f(a, b=[]):\n    return a\n")
    rc = cli_run([str(src), "--format", "json", "--no-baseline"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["new"][0]["rule"] == "CL201"
    assert "fingerprint" in payload["new"][0]


def test_shipped_tree_is_clean_under_strict():
    """``python -m pyconsensus_tpu_torch.analysis --strict`` over the
    port exits 0 with the shipped (empty) baseline."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    r = subprocess.run([sys.executable, "-m",
                        "pyconsensus_tpu_torch.analysis", "--strict"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 error(s), 0 warning(s) (0 baselined)" in r.stdout


# ------------------------------------------------------ independence


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_the_port_and_chip_smoke_import_no_jax():
    """No module of the port (its analysis included) and not
    chip_smoke.py imports jax or the JAX package."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = []
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "pyconsensus_tpu"):
                bad.append(f"{f.relative_to(REPO)}: {name}")
    assert bad == []


def test_the_lock_witness_loads_before_the_package():
    """witness.py imports only the standard library, so a fresh process
    can install it from its file BEFORE importing the port: the locks
    the package builds at import (ops/build.py _LOCK, serve/service.py
    _LINALG_LOCK) then come out as witnessed proxies."""
    code = textwrap.dedent("""
        import importlib.util, json, sys
        spec = importlib.util.spec_from_file_location(
            "boot_witness", sys.argv[1])
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        before = sorted(m for m in sys.modules
                        if m.startswith(("pyconsensus", "torch", "jax")))
        w = mod.LockWitness().install()
        from pyconsensus_tpu_torch.ops import build
        from pyconsensus_tpu_torch.serve import service
        w.uninstall()
        print(json.dumps({
            "before": before,
            "build": isinstance(build._LOCK, mod._WitnessedLock),
            "linalg": isinstance(service._LINALG_LOCK,
                                 mod._WitnessedLock),
            "locks": sorted(w.locks)}))
        """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    r = subprocess.run(
        [sys.executable, "-c", code,
         str(PORT / "analysis" / "witness.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["before"] == []
    assert out["build"] and out["linalg"]
    from pyconsensus_tpu_torch.analysis.concurrency import lock_order_edges

    key = {name: k for k, name in lock_order_edges()["locks"].items()}
    # the runtime keys join the static table's on the defining line
    assert key["build._LOCK"] in out["locks"]
    assert key["service._LINALG_LOCK"] in out["locks"]
    assert not any(k.startswith("pyconsensus_tpu/") for k in out["locks"])
