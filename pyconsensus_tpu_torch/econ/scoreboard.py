"""The economic scoreboard (``pyconsensus_tpu/econ/scoreboard.py``):
mechanism outcomes and service SLOs in one result dict.

The question the economy answers is "is the oracle ECONOMICALLY sound
under production traffic" — so the scoreboard reports both sides of
that sentence together:

- **cartel ROI** — reputation captured per reputation staked: the
  cartel's final share divided by its stake. ROI < 1 means attacking
  the mechanism destroyed value; ROI >= 1 means the strategy captured
  (or at least kept) influence. Reported per strategy (mean over its
  markets) and as a per-round trajectory.
- **honest-reporter yield** — the honest majority's final share over
  its initial share. Yield >= 1 means honest reporting is the winning
  trade even while cartels attack through the same front door.
- **time-to-catch** — rounds until the cartel's share first decays
  below its stake (the mechanism visibly pricing the attack in).
  Reported as the median over caught markets plus the caught fraction;
  null when no market of the strategy was ever caught.
- **service SLOs** — p50/p99 latency, shed rate, retries, and mean
  batch occupancy of the SAME traffic that carried the attack
  (resolves, drips, storms, stateless mirrors), so the economic claim
  is made under real admission/bucketing behavior, not beside it.

The mechanism half (trajectories, ROI, yield, time-to-catch, the
:func:`mechanism_digest`) is bit-deterministic under the scenario seed;
the service half is measurement and deliberately is not.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np

from ..serve.loadgen import mean_batch_occupancy, quantile
from ..serve.session import share_of

__all__ = ["Scoreboard", "mechanism_digest"]


def mechanism_digest(final_reps: dict) -> str:
    """SHA-256 over every market's final reputation vector (sorted by
    market name) — the one number two economy runs must share to be the
    same economy. A run resumed after a mid-economy SIGKILL must reach
    the uninterrupted run's digest."""
    h = hashlib.sha256()
    for name in sorted(final_reps):
        h.update(name.encode())
        h.update(np.ascontiguousarray(final_reps[name],
                                      dtype=np.float64).tobytes())
    return h.hexdigest()


class Scoreboard:
    """Per-round record sink + end-of-economy aggregation. Thread-safe
    record(); the economy's worker threads report every market round
    here."""

    def __init__(self, scenario) -> None:
        self.scenario = scenario
        self._lock = threading.Lock()
        #: market -> {round_idx: row}
        self._rows: dict = {m.name: {} for m in scenario.markets}

    def record(self, spec, round_idx: int, cartel_share: float,
               lies: int, note: str) -> None:
        with self._lock:
            self._rows[spec.name][int(round_idx)] = {
                "round": int(round_idx),
                "cartel_share": float(cartel_share),
                "lies": int(lies),
                "note": str(note),
            }

    # -- aggregation -----------------------------------------------------

    def _trajectories(self, strategies, by_strategy):
        """(S, rounds) mean trajectories; rounds a resumed economy never
        played in this process are NaN (the aggregates below use final
        state, which resume carries exactly)."""
        R = self.scenario.rounds
        share = np.full((len(strategies), R), np.nan)
        roi = np.full((len(strategies), R), np.nan)
        yld = np.full((len(strategies), R), np.nan)
        for si, s in enumerate(strategies):
            specs = by_strategy[s]
            for k in range(R):
                shares, rois, ylds = [], [], []
                for spec in specs:
                    row = self._rows[spec.name].get(k)
                    if row is None:
                        continue
                    c = row["cartel_share"]
                    shares.append(c)
                    rois.append(c / spec.stake)
                    ylds.append((1.0 - c) / (1.0 - spec.stake))
                if shares:
                    share[si, k] = float(np.mean(shares))
                    roi[si, k] = float(np.mean(rois))
                    yld[si, k] = float(np.mean(ylds))
        return share, roi, yld

    def result(self, final_reps: dict, service: dict, wall_s: float,
               start_rounds: dict) -> dict:
        """Assemble the result dict (the shape ``sim.plots``'s econ
        plots consume)."""
        strategies = []
        by_strategy: dict = {}
        for m in self.scenario.markets:
            if m.strategy not in by_strategy:
                strategies.append(m.strategy)
                by_strategy[m.strategy] = []
            by_strategy[m.strategy].append(m)

        per_strategy = {}
        for s in strategies:
            rois, yields, catches, finals = [], [], [], []
            for spec in by_strategy[s]:
                share = share_of(final_reps[spec.name], spec.cartel)
                finals.append(share)
                rois.append(share / spec.stake)
                yields.append((1.0 - share) / (1.0 - spec.stake))
                rows = self._rows[spec.name]
                caught = [k for k in sorted(rows)
                          if rows[k]["cartel_share"] < spec.stake]
                # rounds are 1-based in the catch clock: caught in the
                # first round -> time_to_catch == 1
                catches.append(caught[0] + 1 if caught else None)
            caught_times = [c for c in catches if c is not None]
            per_strategy[s] = {
                "markets": len(by_strategy[s]),
                "cartel_roi": round(float(np.mean(rois)), 6),
                "honest_yield": round(float(np.mean(yields)), 6),
                "final_cartel_share": round(float(np.mean(finals)), 6),
                "stake": round(float(np.mean(
                    [m.stake for m in by_strategy[s]])), 6),
                "caught_fraction": round(
                    len(caught_times) / len(catches), 4),
                "time_to_catch_rounds": (
                    float(np.median(caught_times))
                    if caught_times else None),
            }

        share, roi, yld = self._trajectories(strategies, by_strategy)
        lat = sorted(service.pop("latencies", []))
        slo = {
            "latency_p50_ms": (None if not lat else
                               round(1e3 * quantile(lat, 0.50), 3)),
            "latency_p99_ms": (None if not lat else
                               round(1e3 * quantile(lat, 0.99), 3)),
            "mean_batch_occupancy": mean_batch_occupancy(),
            **service,
        }
        return {
            "seed": self.scenario.seed,
            "rounds": self.scenario.rounds,
            "n_markets": len(self.scenario.markets),
            "n_sessions": len(self.scenario.markets),
            "resumed_markets": sum(1 for v in start_rounds.values()
                                   if v > 0),
            "wall_s": round(float(wall_s), 4),
            "strategies": strategies,
            "per_strategy": per_strategy,
            "trajectories": {
                "round": list(range(1, self.scenario.rounds + 1)),
                "cartel_share": share.tolist(),
                "cartel_roi": roi.tolist(),
                "honest_yield": yld.tolist(),
            },
            "service": slo,
            "mechanism_digest": mechanism_digest(final_reps),
        }
