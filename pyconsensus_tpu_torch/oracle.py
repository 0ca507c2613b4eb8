"""Event bounds parsing and the reference-shaped result dict
(``pyconsensus_tpu/oracle.py:54,80``)."""

from __future__ import annotations

import numpy as np

from .faults.errors import InputError

__all__ = ["parse_event_bounds", "assemble_result"]


def parse_event_bounds(event_bounds, n_events: int):
    """Parse a per-event list of ``{"scaled": bool, "min": float,
    "max": float}`` dicts (``None`` = binary) into ``(scaled, mins,
    maxs)`` numpy arrays."""
    scaled = np.zeros(n_events, dtype=bool)
    mins = np.zeros(n_events, dtype=np.float64)
    maxs = np.ones(n_events, dtype=np.float64)
    if event_bounds is None:
        return scaled, mins, maxs
    if len(event_bounds) != n_events:
        raise InputError(f"event_bounds has {len(event_bounds)} "
                         f"entries for {n_events} events",
                         got=len(event_bounds), expected=n_events)
    for j, b in enumerate(event_bounds):
        if b is None:
            continue
        scaled[j] = bool(b.get("scaled", False))
        mins[j] = float(b.get("min", 0.0))
        maxs[j] = float(b.get("max", 1.0))
        if scaled[j] and maxs[j] <= mins[j]:
            raise InputError(f"event {j}: max must exceed min "
                             f"for a scaled event", event=j)
    return scaled, mins, maxs


def assemble_result(raw: dict) -> dict:
    """The nested result dict (agents / events / scalars) from a flat
    pipeline result; (R, E)-sized keys only when present."""
    result = {
        "agents": {
            "old_rep": raw["old_rep"],
            "this_rep": raw["this_rep"],
            "smooth_rep": raw["smooth_rep"],
            "na_row": raw["na_row"],
            "participation_rows": raw["participation_rows"],
            "relative_part": raw["na_bonus_rows"],
            "reporter_bonus": raw["reporter_bonus"],
        },
        "events": {
            "outcomes_raw": raw["outcomes_raw"],
            "consensus_reward": raw["consensus_reward"],
            "certainty": raw["certainty"],
            "participation_columns": raw["participation_columns"],
            "author_bonus": raw["author_bonus"],
            "outcomes_adjusted": raw["outcomes_adjusted"],
            "outcomes_final": raw["outcomes_final"],
        },
        "participation": float(1.0 - raw["percent_na"]),
        "certainty": float(raw["avg_certainty"]),
        "convergence": bool(raw["convergence"]),
        "iterations": int(raw["iterations"]),
    }
    for key in ("original", "filled"):
        if key in raw:
            result[key] = raw[key]
    if "first_loading" in raw:
        result["events"]["adj_first_loadings"] = raw["first_loading"]
    if "ica_converged" in raw:
        result["ica_converged"] = bool(raw["ica_converged"])
    return result
