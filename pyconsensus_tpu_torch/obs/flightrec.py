"""Flight recorder: bounded on-disk ring of recent telemetry for
postmortems (``pyconsensus_tpu/obs/flightrec.py``; the artifact format is
the reference's, so ``tools/flightrec_dump.py`` reads a dump of either
package).

A ``kill -9``'d worker cannot flush anything, so the recorder's job is
to make sure *something recent* is already on disk when the chaos stages
tear a fleet apart: each :meth:`FlightRecorder.dump` writes one
self-contained JSON artifact — the last N finished spans, the metric
*deltas* since the previous dump, and the dump reason — into a fixed
ring of ``flight-<slot>.json`` files (``seq % keep``), so disk usage is
bounded no matter how long the process lives. Writes go through
:func:`pyconsensus_tpu_torch.io.atomic_write`: a reader (or a crash) never
sees a torn artifact.

Dump triggers: socket worker process boot + SIGTERM + session
fence, the fleet router's takeover and drain, and every autoscaler
membership change —
so a kill-9 run leaves both the victim's boot-time artifact and the
router's takeover artifact behind. ``tools/flightrec_dump.py`` pretty-
prints a recorder directory.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

__all__ = ["FlightRecorder", "read_flight_dir"]


def _metric_delta(prev: dict, cur: dict) -> dict:
    """Per-series numeric deltas between two registry snapshots (new
    series delta from zero). Histogram series diff their ``count`` and
    ``sum``; counters/gauges diff the value. Sorted iteration: the
    artifact is serialized."""
    out: Dict[str, dict] = {}
    for name in sorted(cur):
        entry = cur[name]
        pseries = (prev.get(name) or {}).get("series") or {}
        series = entry.get("series") or {}
        dseries: Dict[str, object] = {}
        for skey in sorted(series):
            v = series[skey]
            p = pseries.get(skey)
            if isinstance(v, dict):
                dv = {"count": int(v.get("count", 0))
                      - int((p or {}).get("count", 0)),
                      "sum": float(v.get("sum", 0.0))
                      - float((p or {}).get("sum", 0.0))}
                if dv["count"] or dv["sum"]:
                    dseries[skey] = dv
            else:
                d = float(v) - float(p or 0.0)
                if d:
                    dseries[skey] = d
        if dseries:
            out[name] = {"kind": entry.get("kind"), "series": dseries}
    return out


class FlightRecorder:
    """Bounded on-disk telemetry ring for one process.

    ``source`` labels the artifacts (worker name / "router");
    ``max_spans`` bounds spans per dump; ``keep`` is the ring size in
    files. The recorder is pull-based — it reads the process-wide tracer
    and registry at dump time, so nothing is on any hot path between
    dumps."""

    def __init__(self, dir, source: str = "main", max_spans: int = 200,
                 keep: int = 8) -> None:
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir = pathlib.Path(dir)
        self.source = str(source)
        self.max_spans = int(max_spans)
        self.keep = int(keep)
        self._seq = 0
        self._last_snapshot: Optional[dict] = None

    def dump(self, reason: str) -> pathlib.Path:
        """Write one artifact into the ring and return its path. Never
        raises on telemetry-read trouble — a postmortem aid must not
        crash the shutdown path it instruments — but I/O errors do
        propagate (the caller decides whether a dead disk is fatal)."""
        from . import REGISTRY, TRACER          # late: obs exports this
        from ..io import atomic_write

        try:
            spans = [sp.to_dict()
                     for sp in TRACER.spans()[-self.max_spans:]]
        except Exception:                       # noqa: BLE001
            spans = []
        try:
            snap = REGISTRY.snapshot()
        except Exception:                       # noqa: BLE001
            snap = {}
        record = {
            "format": "pyconsensus-flightrec-v1",
            "source": self.source,
            "reason": str(reason),
            "seq": self._seq,
            "spans": spans,
            "metric_deltas": _metric_delta(self._last_snapshot or {},
                                           snap),
        }
        path = self.dir / f"flight-{self._seq % self.keep:03d}.json"
        text = json.dumps(record, sort_keys=True, indent=1)

        def _write(tmp):
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(text + "\n")

        atomic_write(path, _write)
        self._seq += 1
        self._last_snapshot = snap
        return path


def read_flight_dir(dir) -> List[dict]:
    """Parse every artifact in a recorder directory, oldest first (by
    ``seq`` — slot order wraps). Unreadable/torn files are skipped:
    ``atomic_write`` makes torn files impossible from the recorder
    itself, but a postmortem reader must survive anything."""
    out: List[dict] = []
    d = pathlib.Path(dir)
    if not d.is_dir():
        return out
    for path in sorted(d.glob("flight-*.json")):
        try:
            with open(path, encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict):
            rec["_path"] = str(path)
            out.append(rec)
    out.sort(key=lambda r: int(r.get("seq", 0)))
    return out
