"""Adaptive cartel strategies (``pyconsensus_tpu/econ/strategies.py``,
copied: every plan is a host numpy draw).

The Monte-Carlo simulator (`sim/collusion.py`) sweeps STATIC liar grids:
a liar lies the same way every round no matter what the mechanism does
to it. Real cartels adapt. Each strategy here is a deterministic policy
that, every round, observes **its own post-catch reputation** — the
round-start reputation vector the ledger carries, i.e. what the
mechanism actually did to the cartel last round — and decides who lies,
on what fraction of events, who abstains, and how the round's
submissions are shaped on the wire (burst vs drip).

Determinism contract (the ``faults/plan.py`` payload-PRNG discipline):

- every random draw comes from a generator keyed on
  ``(scenario seed, strategy, market, round, tag)`` —
  :func:`strategy_rng` — so a schedule is a pure function of its key,
  independent of how calls for *other* markets interleave, and
  identical across processes, platforms and both packages (the
  generators are host numpy; no device PRNG is involved);
- every ADAPTIVE decision is a pure function of
  ``(params, round index, round-start reputation)`` — no hidden
  per-object state — so replaying a round from the replication log's
  ledger checkpoint reproduces the identical plan: the log alone is
  enough to resume an economy bit-identically (the mid-economy
  SIGKILL resume checks it).

Catalog:

========================  ==============================================
``camouflage``            lie only below an estimated-catch threshold:
                          the lie fraction shrinks as observed erosion
                          grows, and a caught cartel reports honestly
                          until its reputation recovers.
``sybil_split``           reputation fragmented across fresh identities:
                          the cartel's seats are partitioned into waves
                          and only one wave lies per round while the
                          rest abstain — no identity accumulates a
                          catchable history.
``reporter_churn``        exit-after-catch, re-enter: lie with every
                          seat until the observed share drops below the
                          catch threshold, then abstain entirely until
                          the share recovers past the re-entry
                          threshold (hysteresis driven by the observed
                          reputation alone).
``flash_crowd``           coordinated same-deadline submission storms:
                          every seat lies on every event and the
                          round's resolutions are submitted in one
                          synchronized burst under a tight deadline —
                          the service-layer stress; a caught crowd
                          cools down to honest rounds until recovered.
``slow_drip``             streaming reports: the round's events arrive
                          as many small appended blocks and the lie is
                          spread thinly across them, thinning further
                          as erosion is observed.
========================  ==============================================
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = ["STRATEGIES", "StrategyContext", "RoundPlan", "CartelStrategy",
           "Camouflage", "SybilSplit", "ReporterChurn", "FlashCrowd",
           "SlowDrip", "make_strategy", "strategy_rng"]


def strategy_rng(seed: int, strategy: str, market: str, round_idx: int,
                 tag: str):
    """Generator keyed on ``(seed, strategy, market, round, tag)`` —
    independent of call interleaving across markets and stable across
    platforms/backends (crc32 is deterministic; the generator is host
    numpy). The one PRNG entry point of the econ subsystem."""
    return np.random.default_rng(
        [int(seed), zlib.crc32(str(strategy).encode()),
         zlib.crc32(str(market).encode()), int(round_idx),
         zlib.crc32(str(tag).encode())])


@dataclass(frozen=True)
class StrategyContext:
    """What a strategy is allowed to see when planning a round: its
    keying material and the round-start reputation vector (the ledger
    state after the previous round — the mechanism's observable
    response). Nothing else: a policy that peeked at anything
    non-durable could not be replayed from the replication log."""

    seed: int
    market: str
    round_idx: int
    n_reporters: int
    #: cartel seat indices (sorted, fixed for the market's lifetime)
    cartel: Tuple[int, ...]
    #: round-start reputation (what the ledger carries into this round)
    reputation: np.ndarray
    #: the cartel's initial reputation share (its stake)
    stake: float

    @property
    def cartel_share(self) -> float:
        """The cartel's CURRENT share of reputation — the post-catch
        observation every adaptive policy keys on."""
        from ..serve.session import share_of

        return share_of(self.reputation, self.cartel)

    @property
    def erosion(self) -> float:
        """Observed reputation loss relative to stake, in [0, 1]:
        0 = untouched, 1 = fully stripped."""
        if self.stake <= 0.0:
            return 0.0
        return float(np.clip(1.0 - self.cartel_share / self.stake,
                             0.0, 1.0))

    def rng(self, tag: str, strategy: str):
        return strategy_rng(self.seed, strategy, self.market,
                            self.round_idx, tag)


@dataclass(frozen=True)
class RoundPlan:
    """One round's cartel schedule, fully materialized: who lies, on
    what fraction of events, who abstains, and the submission shape.
    A plan is a pure function of ``(strategy params, context)`` —
    :meth:`CartelStrategy.plan_round` is replay-deterministic."""

    #: seats that lie this round (subset of the cartel)
    liars: Tuple[int, ...]
    #: fraction of the round's events the liars lie on (the per-event
    #: mask is drawn by the panel generator from the same key space)
    lie_fraction: float
    #: seats that abstain entirely this round (all-NaN rows)
    abstain: Tuple[int, ...] = ()
    #: how many appended blocks the round's events split into
    n_blocks: int = 1
    #: submit the round's resolutions in a synchronized burst
    burst: bool = False
    #: per-resolve deadline for burst submissions (ms; None = default)
    deadline_ms: Optional[float] = None
    #: why the policy chose this plan (scoreboard annotation)
    note: str = ""


class CartelStrategy:
    """Base: a named, parameterized, stateless policy. Subclasses
    implement :meth:`plan_round` as a pure function of the context."""

    name = "?"

    def __init__(self, **params) -> None:
        unknown = set(params) - set(self.defaults())
        if unknown:
            raise ValueError(
                f"unknown {self.name!r} strategy params "
                f"{sorted(unknown)}; known: {sorted(self.defaults())}")
        self.params = {**self.defaults(), **params}

    @classmethod
    def defaults(cls) -> dict:
        return {}

    def plan_round(self, ctx: StrategyContext) -> RoundPlan:
        raise NotImplementedError


class Camouflage(CartelStrategy):
    """Lie only below the estimated-catch threshold. The policy treats
    observed erosion as its catch estimate: while the share sits near
    the stake it lies on ``base_fraction`` of events; as erosion grows
    the lie thins proportionally (smaller lies are harder to catch);
    once the share has visibly been cut (erosion past ``backoff``) it
    reports honestly until the share recovers."""

    name = "camouflage"

    @classmethod
    def defaults(cls) -> dict:
        return {"base_fraction": 0.6, "backoff": 0.12, "floor": 0.2}

    def plan_round(self, ctx: StrategyContext) -> RoundPlan:
        p = self.params
        if ctx.erosion > p["backoff"]:
            return RoundPlan(liars=(), lie_fraction=0.0,
                             note="backoff: recovering reputation")
        ratio = 1.0 - ctx.erosion
        fraction = p["base_fraction"] * max(p["floor"], ratio)
        return RoundPlan(liars=ctx.cartel, lie_fraction=float(fraction),
                         note=f"lying on {fraction:.2f} of events")


class SybilSplit(CartelStrategy):
    """Reputation fragmented across fresh identities: the cartel's
    seats are split into ``waves`` groups; each round exactly one wave
    lies (on everything) while the remaining cartel seats abstain —
    every lying identity enters its round with no recent lying history
    for the mechanism to have priced in."""

    name = "sybil_split"

    @classmethod
    def defaults(cls) -> dict:
        return {"waves": 3}

    def plan_round(self, ctx: StrategyContext) -> RoundPlan:
        waves = max(1, min(int(self.params["waves"]), len(ctx.cartel)))
        active = ctx.round_idx % waves
        parts = np.array_split(np.asarray(ctx.cartel, dtype=int), waves)
        liars = tuple(int(i) for i in parts[active])
        abstain = tuple(int(i) for i in np.asarray(ctx.cartel, dtype=int)
                        if int(i) not in set(liars))
        return RoundPlan(liars=liars, lie_fraction=1.0, abstain=abstain,
                         note=f"wave {active + 1}/{waves} lying, "
                              f"{len(abstain)} identities parked")


class ReporterChurn(CartelStrategy):
    """Exit-after-catch, re-enter: lie with every seat while the share
    holds above ``reentry_ratio`` of stake; once a catch cuts it below
    ``catch_ratio``, abstain entirely (exit) and let the filled
    non-participation rows drift the reputation back; re-enter as soon
    as the observed share recovers. The hysteresis is memoryless —
    driven entirely by the round-start reputation — so replay from the
    ledger alone reproduces it."""

    name = "reporter_churn"

    @classmethod
    def defaults(cls) -> dict:
        return {"catch_ratio": 0.85, "reentry_ratio": 0.97}

    def plan_round(self, ctx: StrategyContext) -> RoundPlan:
        share, stake = ctx.cartel_share, ctx.stake
        if stake > 0.0 and share >= stake * self.params["reentry_ratio"]:
            return RoundPlan(liars=ctx.cartel, lie_fraction=1.0,
                             note="in-market: lying with every seat")
        return RoundPlan(liars=(), lie_fraction=0.0, abstain=ctx.cartel,
                         note="exited after catch: abstaining until "
                              "reputation recovers")


class FlashCrowd(CartelStrategy):
    """Coordinated same-deadline submission storms: every seat lies on
    every event and the round's resolutions (plus their stateless
    mirrors) are submitted in one synchronized burst under a tight
    deadline — the admission/shed stress test. A crowd whose erosion
    passed ``cooldown`` hides behind honest rounds until recovered
    (storm when fresh, blend in when caught)."""

    name = "flash_crowd"

    @classmethod
    def defaults(cls) -> dict:
        return {"cooldown": 0.1, "deadline_ms": 2000.0}

    def plan_round(self, ctx: StrategyContext) -> RoundPlan:
        if ctx.erosion > self.params["cooldown"]:
            return RoundPlan(liars=(), lie_fraction=0.0, burst=True,
                             deadline_ms=float(self.params["deadline_ms"]),
                             note="cooldown: storming honestly")
        return RoundPlan(liars=ctx.cartel, lie_fraction=1.0, burst=True,
                         deadline_ms=float(self.params["deadline_ms"]),
                         note="storm: full anti-truth burst")


class SlowDrip(CartelStrategy):
    """Streaming reports: the round's events arrive as ``blocks`` small
    appends (the session-ingestion stress) and the lie is spread thinly
    across the stream — ``base_fraction`` of events when untouched,
    thinning with observed erosion like camouflage but never fully
    backing off (a drip is cheap to keep running)."""

    name = "slow_drip"

    @classmethod
    def defaults(cls) -> dict:
        return {"base_fraction": 0.35, "blocks": 4, "floor": 0.1}

    def plan_round(self, ctx: StrategyContext) -> RoundPlan:
        p = self.params
        fraction = p["base_fraction"] * max(p["floor"], 1.0 - ctx.erosion)
        return RoundPlan(liars=ctx.cartel, lie_fraction=float(fraction),
                         n_blocks=max(1, int(p["blocks"])),
                         note=f"dripping {fraction:.2f} lies over "
                              f"{p['blocks']} blocks")


#: the strategy catalog: name -> class (the table above)
STRATEGIES = {cls.name: cls for cls in
              (Camouflage, SybilSplit, ReporterChurn, FlashCrowd,
               SlowDrip)}


def make_strategy(name: str, **params) -> CartelStrategy:
    """Instantiate a cataloged strategy by name."""
    try:
        cls = STRATEGIES[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; choose from "
                         f"{sorted(STRATEGIES)}") from None
    return cls(**params)
