"""Telemetry sinks (``pyconsensus_tpu/obs/sinks.py``): JSONL span/event
log, Prometheus text exposition, and the human report tree.

The exposition itself lives with its data structure
(``MetricsRegistry.render_prom`` / ``Tracer.report``); this module owns
the file formats — JSONL writing, reading, and span-tree reconstruction —
so tests and external consumers have one round-trip contract to pin.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Sequence

__all__ = ["write_jsonl", "read_jsonl", "merge_jsonl", "span_tree",
           "write_prom", "trace_forest"]


def write_jsonl(path, events: Sequence[dict], meta: Optional[dict] = None
                ) -> int:
    """Write one JSON object per line: an optional leading ``meta`` record
    (``{"type": "meta", ...}``) followed by the events (normally
    ``Tracer.events()``). Returns the number of records written. Parent
    directories are created."""
    p = pathlib.Path(path)
    if p.parent and not p.parent.exists():
        p.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with open(p, "w", encoding="utf-8") as f:
        if meta is not None:
            f.write(json.dumps({"type": "meta", **meta}, sort_keys=True)
                    + "\n")
            n += 1
        for ev in events:
            f.write(json.dumps(ev, sort_keys=True) + "\n")
            n += 1
    return n


def read_jsonl(path) -> List[dict]:
    """Read a JSONL file back to a list of dicts (blank lines skipped) —
    the round-trip inverse of :func:`write_jsonl`."""
    out: List[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def span_tree(events: Sequence[dict]) -> List[dict]:
    """Reconstruct the nested span forest from flat span events (any
    order): returns the list of root spans, each a copy carrying a
    ``children`` list sorted by start time. Non-span records (meta) are
    ignored; a span whose parent is missing from ``events`` (e.g. a
    truncated log) becomes a root rather than being dropped."""
    spans = [dict(ev) for ev in events if ev.get("type") == "span"]
    # ids are keyed per (process_index, span_id): each host's tracer
    # numbers span_ids from 1, so merged fleet JSONL would otherwise
    # collide ids across hosts and mis-parent children (the per-host
    # trees the tracer promises)
    by_id: Dict[tuple, dict] = {}
    for sp in spans:
        sp["children"] = []
        by_id[(sp.get("process_index", 0), sp["span_id"])] = sp
    roots: List[dict] = []
    for sp in spans:
        # a span whose parent lives in ANOTHER source (the far side of an
        # RPC hop) roots the local tree; trace_forest resolves the
        # cross-source edge over merged logs
        parent = None if sp.get("parent_src") is not None else by_id.get(
            (sp.get("process_index", 0), sp.get("parent_id", 0)))
        if parent is not None and parent is not sp:
            parent["children"].append(sp)
        else:
            roots.append(sp)
    def _sort(nodes: List[dict]) -> None:
        nodes.sort(key=lambda s: s.get("start_s", 0.0))
        for n in nodes:
            _sort(n["children"])
    _sort(roots)
    return roots


def merge_jsonl(paths: Sequence) -> List[dict]:
    """Concatenate the span JSONL files of several processes (the router
    and each fleet worker) into one flat event list. A span that carries
    no ``source`` takes its file's meta ``source`` (else the path). Files
    are read in the order given: sort a globbed directory first."""
    merged: List[dict] = []
    for path in paths:
        events = read_jsonl(path)
        file_src = None
        for ev in events:
            if ev.get("type") == "meta" and ev.get("source"):
                file_src = str(ev["source"])
                break
        for ev in events:
            ev = dict(ev)
            if ev.get("type") == "span" and not ev.get("source"):
                ev["source"] = file_src or str(path)
            merged.append(ev)
    return merged


def trace_forest(events: Sequence[dict]) -> Dict[str, List[dict]]:
    """Reconstruct distributed traces from merged multi-process events:
    ``{trace_id: [root spans]}``, each root carrying nested ``children``
    sorted by start time. Spans are keyed ``(source, span_id)`` — every
    process numbers span_ids from 1, so the source label is what keeps a
    router span and a worker span distinct — and a cross-source parent
    edge (``parent_src``, the RPC hop) resolves against the parent's
    source. Untraced spans (no ``trace_id``) are ignored; a traced span
    whose parent is missing from ``events`` becomes a root."""
    spans = [dict(ev) for ev in events
             if ev.get("type") == "span" and ev.get("trace_id")]
    by_id: Dict[tuple, dict] = {}
    for sp in spans:
        sp["children"] = []
        by_id[(sp.get("source", ""), sp["span_id"])] = sp
    forest: Dict[str, List[dict]] = {}
    for sp in spans:
        src = sp.get("parent_src") or sp.get("source", "")
        parent = by_id.get((src, sp.get("parent_id", 0)))
        if parent is not None and parent is not sp \
                and parent.get("trace_id") == sp.get("trace_id"):
            parent["children"].append(sp)
        else:
            forest.setdefault(str(sp["trace_id"]), []).append(sp)

    def _sort(nodes: List[dict]) -> None:
        nodes.sort(key=lambda s: s.get("start_s", 0.0))
        for n in nodes:
            _sort(n["children"])

    for tid in sorted(forest):
        _sort(forest[tid])
    return {tid: forest[tid] for tid in sorted(forest)}


def write_prom(path, registry) -> str:
    """Render ``registry`` to Prometheus text format and write it to
    ``path`` (parent directories created). Returns the rendered text."""
    text = registry.render_prom()
    p = pathlib.Path(path)
    if p.parent and not p.parent.exists():
        p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text, encoding="utf-8")
    return text
