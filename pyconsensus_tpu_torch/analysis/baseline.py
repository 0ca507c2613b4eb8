"""Baseline workflow: land the lint pass green, fail the gate on NEW findings.

The checked-in ``baseline.json`` records the fingerprint of every
accepted finding plus a human rationale (mandatory — a baseline entry is
a documented decision, not a mute button). ``match_baseline`` splits a
run's findings into (new, baselined, stale): *new* findings fail the run;
*stale* entries (baselined fingerprints that no longer occur) fail it too
under ``--strict`` so the file can never rot."""

from __future__ import annotations

import json
import pathlib
from typing import Iterable, List, Tuple

from .findings import Finding, fingerprints

_DEFAULT_BASELINE = pathlib.Path(__file__).with_name("baseline.json")


def default_baseline_path() -> pathlib.Path:
    return _DEFAULT_BASELINE


def load_baseline(path=None) -> dict:
    p = pathlib.Path(path) if path else _DEFAULT_BASELINE
    if not p.exists():
        return {"version": 1, "findings": []}
    return json.loads(p.read_text())


def save_baseline(findings: Iterable[Finding], path=None,
                  reason: str = "baselined by --update-baseline",
                  preserve=None) -> dict:
    """Write the baseline for the given findings, preserving the reasons
    of entries whose fingerprint already exists.

    ``preserve``: optional predicate over EXISTING entries — those for
    which it returns True are kept even when this run did not reproduce
    them. The CLI uses it so a path-, rule- or layer-restricted
    ``--update-baseline`` run cannot silently delete accepted findings
    that were simply outside its scope."""
    p = pathlib.Path(path) if path else _DEFAULT_BASELINE
    old_entries = load_baseline(p).get("findings", [])
    old = {e["fingerprint"]: e for e in old_entries}
    findings = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    entries = []
    seen = set()
    for f, fp in zip(findings, fingerprints(findings)):
        entries.append({
            "fingerprint": fp,
            "rule": f.rule,
            "path": f.path,
            "message": f.message,
            "reason": old.get(fp, {}).get("reason", reason),
        })
        seen.add(fp)
    if preserve is not None:
        for e in old_entries:
            if e["fingerprint"] not in seen and preserve(e):
                entries.append(e)
    entries.sort(key=lambda e: (e["path"], e["fingerprint"]))
    doc = {"version": 1, "findings": entries}
    p.write_text(json.dumps(doc, indent=2, sort_keys=False) + "\n")
    return doc


def match_baseline(findings: List[Finding], baseline: dict
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split ``findings`` into (new, baselined) and return the stale
    baseline fingerprints (entries that matched nothing this run)."""
    findings = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    fps = fingerprints(findings)
    known = {e["fingerprint"] for e in baseline.get("findings", [])}
    new, matched = [], []
    hit = set()
    for f, fp in zip(findings, fps):
        if fp in known:
            matched.append(f)
            hit.add(fp)
        else:
            new.append(f)
    stale = sorted(known - hit)
    return new, matched, stale
