"""consensus-lint CLI for the PyTorch/CUDA port.

Usage (also ``python -m pyconsensus_tpu_torch.analysis``):

    consensus-lint-torch                    # every layer over the package
    consensus-lint-torch --strict           # + fail on stale baseline
                                            #   entries (the gate)
    consensus-lint-torch path/to/file.py    # explicit targets
    consensus-lint-torch --update-baseline  # accept the current tree
    consensus-lint-torch --list-rules

Exit codes: 0 = no non-baselined findings (and, under --strict, no stale
baseline entries); 1 = new findings; 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from .baseline import (default_baseline_path, load_baseline, match_baseline,
                       save_baseline)
from .concurrency import CONCURRENCY_RULES
from .determinism import DETERMINISM_RULES
from .findings import Finding, fingerprints
from .protocol import PROTOCOL_RULES
from .rules import RULES, lint_paths, scan_targets

#: (flag attribute, rule table) of each layer a ``--no-*`` flag skips
_LAYERS = (("no_concurrency", CONCURRENCY_RULES),
           ("no_protocol", PROTOCOL_RULES),
           ("no_determinism", DETERMINISM_RULES))


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="consensus-lint-torch",
        description="static analysis for pyconsensus_tpu_torch: generic "
                    "AST rules, host concurrency, distributed protocol "
                    "and bit determinism")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "installed pyconsensus_tpu_torch package)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries (the gate)")
    ap.add_argument("--no-concurrency", action="store_true",
                    help="skip the Layer 4 host-concurrency analysis "
                         "(lock-order cycles, blocking-under-lock, "
                         "guarded-by inference, fault-site drift)")
    ap.add_argument("--no-protocol", action="store_true",
                    help="skip the Layer 5 distributed-protocol "
                         "analysis (durability ordering, RPC surface "
                         "drift, error taxonomy, idempotency, "
                         "retry scope)")
    ap.add_argument("--no-determinism", action="store_true",
                    help="skip the Layer 6 bit-determinism analysis "
                         "(order/completion/host-nondeterminism taint "
                         "into digests/journals/artifacts, float-fold "
                         "hazards, and the CL1005 float-atomics scan)")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help=f"baseline file (default: "
                         f"{default_baseline_path()})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to accept the current tree "
                         "(keeps existing reasons)")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--select", default=None, metavar="CL201,CL802",
                    help="comma-separated rule subset")
    ap.add_argument("--list-rules", action="store_true")
    return ap


def _all_rule_meta() -> dict:
    """Every layer's {rule: (severity, description)} in one table."""
    meta: dict = {}
    for table in (RULES, CONCURRENCY_RULES, PROTOCOL_RULES,
                  DETERMINISM_RULES):
        meta.update(table)
    return meta


def _list_rules() -> str:
    lines = []
    for title, table in (("Generic AST rules:", RULES),
                         ("Layer 4 (host concurrency):", CONCURRENCY_RULES),
                         ("Layer 5 (distributed protocol):", PROTOCOL_RULES),
                         ("Layer 6 (bit determinism):", DETERMINISM_RULES)):
        lines.append(title)
        for rid, (sev, desc) in sorted(table.items(),
                                       key=lambda kv: int(kv[0][2:])):
            lines.append(f"  {rid} [{sev:7s}] {desc}")
    return "\n".join(lines)


_SARIF_LEVEL = {"error": "error", "warning": "warning"}


def _sarif_payload(rows) -> dict:
    """SARIF 2.1.0 view of the finding rows (``--format sarif``): rule
    metadata for every rule a result references, one result per finding
    with its location, the stable fingerprint as a partialFingerprint,
    and the baseline state mapped onto SARIF's ``baselineState``
    vocabulary. Exit codes are the JSON format's, unchanged."""
    meta = _all_rule_meta()
    rule_ids = sorted({r["rule"] for r in rows})
    index = {rid: i for i, rid in enumerate(rule_ids)}
    rules = []
    for rid in rule_ids:
        sev, desc = meta.get(rid, ("warning", rid))
        rules.append({
            "id": rid,
            "shortDescription": {"text": desc},
            "defaultConfiguration": {
                "level": _SARIF_LEVEL.get(sev, "note")},
        })
    results = []
    for r in rows:
        results.append({
            "ruleId": r["rule"],
            "ruleIndex": index[r["rule"]],
            "level": _SARIF_LEVEL.get(r["severity"], "note"),
            "message": {"text": r["message"]},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": r["path"]},
                    "region": {"startLine": max(int(r["line"]), 1)},
                }}],
            "partialFingerprints": {"consensusLint/v1": r["fingerprint"]},
            "baselineState": ("unchanged" if r["state"] == "baselined"
                              else "new"),
        })
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "consensus-lint",
                "informationUri": "pyconsensus_tpu_torch/analysis",
                "rules": rules,
            }},
            "results": results,
        }],
    }


def run(argv: Optional[List[str]] = None, stdout=None) -> int:
    out = stdout or sys.stdout
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        print(_list_rules(), file=out)
        return 0

    t0 = time.monotonic()
    select = (set(s.strip() for s in args.select.split(",") if s.strip())
              if args.select else None)
    paths = args.paths or None
    findings: List[Finding] = lint_paths(paths, select=select)

    # each layer's fixpoint only runs when one of its rules is in scope
    if not args.no_concurrency and (select is None
                                    or select & CONCURRENCY_RULES.keys()):
        from .concurrency import analyze_concurrency

        findings.extend(analyze_concurrency(paths, select=select))
    if not args.no_protocol and (select is None
                                 or select & PROTOCOL_RULES.keys()):
        from .protocol import analyze_protocol

        findings.extend(analyze_protocol(paths, select=select))
    if not args.no_determinism and (select is None
                                    or select & DETERMINISM_RULES.keys()):
        from .determinism import analyze_determinism

        findings.extend(analyze_determinism(paths, select=select))

    # an entry this run could not have reproduced (a skipped layer, a
    # file outside a path-restricted scan, a rule outside --select) is
    # out of scope: the updater keeps it and the stale check ignores it
    scanned = {rel for _, rel in scan_targets(paths, suffixes=(
        ".py", ".cu", ".cuh"))}

    def in_scope(entry) -> bool:
        for flag, table in _LAYERS:
            if getattr(args, flag) and entry["rule"] in table:
                return False
        return entry["path"] in scanned and (
            not select or entry["rule"] in select)

    if args.update_baseline:
        doc = save_baseline(findings, path=args.baseline,
                            preserve=lambda e: not in_scope(e))
        print(f"baseline updated: {len(doc['findings'])} finding(s) "
              f"accepted -> {args.baseline or default_baseline_path()}",
              file=out)
        return 0

    baseline = ({"version": 1, "findings": []} if args.no_baseline
                else load_baseline(args.baseline))
    new, matched, stale = match_baseline(findings, baseline)
    if stale:
        by_fp = {e["fingerprint"]: e for e in baseline.get("findings", [])}
        stale = [fp for fp in stale
                 if fp not in by_fp or in_scope(by_fp[fp])]

    if args.format in ("json", "sarif"):
        # one "findings" list covering new AND baselined entries, each
        # row carrying its baseline state; "new"/"baselined"/
        # "stale_baseline" summarize, "schema" gates evolution
        def _row(f: Finding, fp: str, state: str) -> dict:
            return {"rule": f.rule, "path": f.path, "line": f.line,
                    "severity": f.severity, "message": f.message,
                    "snippet": f.snippet, "fingerprint": fp,
                    "state": state}

        rows = sorted(
            [_row(f, fp, "new")
             for f, fp in zip(new, fingerprints(new))]
            + [_row(f, fp, "baselined")
               for f, fp in zip(matched, fingerprints(matched))],
            key=lambda r: (r["path"], r["line"], r["rule"]))
        if args.format == "sarif":
            # results are explicitly sorted and the SARIF envelope is a
            # fixed literal schema
            print(json.dumps(_sarif_payload(rows), indent=2),  # consensus-lint: disable=CL1001 — rows sorted above, fixed literal keys
                  file=out)
        else:
            payload = {
                "schema": 1,
                "findings": rows,
                "new": [vars(f) | {"fingerprint": fp}
                        for f, fp in zip(new, fingerprints(new))],
                "baselined": len(matched),
                "stale_baseline": stale,
                "elapsed_s": round(time.monotonic() - t0, 2),
            }
            # findings rows are explicitly sorted above and the payload
            # keys are a fixed literal schema — insertion order IS the
            # documented order
            print(json.dumps(payload, indent=2), file=out)  # consensus-lint: disable=CL1001 — rows sorted above, fixed literal keys
    else:
        for f in new:
            print(f.render(), file=out)
        if stale and args.strict:
            for fp in stale:
                print(f"stale baseline entry (fix landed? remove it): {fp}",
                      file=out)
        n_err = sum(1 for f in new if f.severity == "error")
        n_warn = len(new) - n_err
        print(f"consensus-lint: {n_err} error(s), {n_warn} warning(s) "
              f"({len(matched)} baselined"
              + (f", {len(stale)} stale baseline entr"
                 + ("y" if len(stale) == 1 else "ies") if stale else "")
              + f") in {time.monotonic() - t0:.1f}s", file=out)

    if new:
        return 1
    if stale and args.strict:
        return 1
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
