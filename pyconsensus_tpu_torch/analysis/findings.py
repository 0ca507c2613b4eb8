"""Finding record + stable fingerprints for the baseline workflow.

A fingerprint deliberately excludes the line NUMBER: baselined findings
must survive unrelated edits above them. It is ``rule:path:crc32(snippet)``
where the snippet is the stripped source line (or the message),
with a ``#n`` ordinal appended for identical repeats so a baseline entry
suppresses exactly one occurrence."""

from __future__ import annotations

import dataclasses
import zlib
from typing import Iterable, List


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str           #: rule ID, e.g. "CL802"
    path: str           #: repo-relative posix path, or a pseudo-path
                        #: ("faults:catalog") for package-level findings
    line: int           #: 1-based line (0 for whole-artifact findings)
    message: str
    severity: str = "error"      #: "error" | "warning"
    snippet: str = ""            #: stripped source line

    def location(self) -> str:
        return f"{self.path}:{self.line}" if self.line else self.path

    def render(self) -> str:
        return (f"{self.location()}: {self.rule} [{self.severity}] "
                f"{self.message}")


def _base_fingerprint(f: Finding) -> str:
    payload = f.snippet or f.message
    return f"{f.rule}:{f.path}:{zlib.crc32(payload.encode('utf-8')):08x}"


def fingerprints(findings: Iterable[Finding]) -> List[str]:
    """Stable fingerprints, ordinal-suffixed for duplicates in input
    order (callers sort by (path, line) first for determinism)."""
    seen: dict = {}
    out = []
    for f in findings:
        base = _base_fingerprint(f)
        n = seen.get(base, 0)
        seen[base] = n + 1
        out.append(base if n == 0 else f"{base}#{n + 1}")
    return out
