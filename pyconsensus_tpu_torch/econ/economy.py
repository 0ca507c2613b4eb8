"""The multi-round adversarial market economy
(``pyconsensus_tpu/econ/economy.py``: host code over the serve front
door, copied with its panels, plans and retry discipline unchanged).

A :class:`MarketEconomy` drives thousands of concurrent
:class:`~pyconsensus_tpu_torch.serve.session.MarketSession`\\ s — each one a
market with a fixed reporter roster, an embedded cartel running one of
the adaptive :mod:`~pyconsensus_tpu_torch.econ.strategies`, and heterogeneous
shape/panel characteristics — through the REAL serve stack: the
:class:`~pyconsensus_tpu_torch.serve.ConsensusService` front door or a
:class:`~pyconsensus_tpu_torch.serve.fleet.ConsensusFleet`, with admission
control, bounded queues, shape buckets, and (fleet mode) the
replication log underneath. Nothing is simulated at the service layer:
a shed is a real PYC-coded shed, a resolution is a real dispatch.

Each economy round, per market:

1. the cartel's strategy observes the round-start reputation (the
   ledger state — its own post-catch standing) and emits a
   :class:`~pyconsensus_tpu_torch.econ.strategies.RoundPlan`;
2. the round's panel is generated host-side from
   ``(seed, market, round)``-keyed numpy generators
   (:func:`round_panel`) — truth, honest noise, NA non-participation,
   the cartel's anti-truth on the plan's lie mask, abstentions, and an
   optional scaled tail (mixed binary+scaled panels);
3. the panel is appended through the service front door as the plan's
   block schedule (one block, or a slow drip of many);
4. the round is resolved through ``submit(session=...)`` — flash-crowd
   plans submit every storm member's resolution in one synchronized
   same-deadline burst — and optionally mirrored as a stateless
   ``submit(reports=...)`` (``MarketSpec.mirror``), which is what
   exercises the bucket classes under the economy's heterogeneous
   shapes (on an sm_90 card the binary mirrors ride ``bucket_cuda``,
   which launches B.1, B.2 and B.3; scaled mirrors the padded buckets);
5. the resolved ``smooth_rep`` becomes the next round's observation and
   the scoreboard records the round.

Determinism contract (the mid-economy SIGKILL resume checks it): the
MECHANISM state of a finished economy —
every market's reputation trajectory, outcomes, and the scoreboard's
economic metrics — is a pure function of the scenario (seed included).
Panels and plans are keyed host-numpy draws (interleaving-independent,
cross-backend identical); sessions serialize their own mutations; and
overload only ever DELAYS a resolution (sheds are retried with the
deterministic ``faults.retry`` backoff), never changes its bits. The
service-level telemetry (latencies, shed counts) is measurement, not
mechanism state, and is deliberately outside the bit-identity claim.
Replay from any round needs only the replication log: strategies
observe nothing but the ledger-carried reputation, so a resumed economy
(:meth:`MarketEconomy.start` adopts existing logs) continues
bit-identically from the last durable round. The reputations' float64
bits are this package's own: a digest is comparable between runs of
the port, not with the JAX package's (another eigensolver).

The economy runs where its front door runs: a service or fleet built
with ``device=None`` serves on the card (and raises where there is
none), ``device="cpu"`` on the CPU.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from .. import obs
from ..faults import InputError
from ..faults import plan as _faults
from ..serve.loadgen import RETRYABLE_CODES
from ..serve.session import share_of
from .scoreboard import Scoreboard
from .strategies import (STRATEGIES, RoundPlan, StrategyContext,
                         make_strategy, strategy_rng)

__all__ = ["MarketSpec", "Scenario", "MarketEconomy", "build_scenario",
           "round_panel", "split_blocks"]

#: default heterogeneous (reporters, events) shape classes — a small,
#: deliberately repeated set so thousands of sessions stress the bucket
#: POLICY (several distinct buckets, heavy reuse) rather than compiling
#: thousands of single-use executables
DEFAULT_SHAPES = ((8, 16), (12, 24), (16, 32), (24, 48))


@dataclass(frozen=True)
class MarketSpec:
    """One market's static configuration. The cartel occupies the LAST
    ``n_cartel`` seats of the roster (deterministic, so a spec is fully
    described by its scalars)."""

    name: str
    strategy: str
    n_reporters: int = 12
    n_cartel: int = 4
    n_events: int = 24
    #: honest-reporter per-entry flip probability
    variance: float = 0.05
    #: honest-reporter non-participation probability (NaN entries)
    na_frac: float = 0.05
    #: scaled tail: the last n_scaled events carry values on the
    #: [scaled_min, scaled_max] lattice (mixed binary+scaled panels)
    n_scaled: int = 0
    scaled_min: float = -5.0
    scaled_max: float = 15.0
    #: also submit the round's assembled panel as a stateless request —
    #: the traffic that exercises the bucket classes
    mirror: bool = False
    strategy_params: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise InputError(f"unknown strategy {self.strategy!r}; "
                             f"choose from {sorted(STRATEGIES)}")
        if not 0 < self.n_cartel < self.n_reporters:
            raise InputError(
                f"market {self.name!r}: n_cartel must be in "
                f"(0, {self.n_reporters}), got {self.n_cartel}")
        if not 0 <= self.n_scaled <= self.n_events:
            raise InputError(
                f"market {self.name!r}: n_scaled must be in "
                f"[0, {self.n_events}], got {self.n_scaled}")

    @property
    def cartel(self) -> tuple:
        return tuple(range(self.n_reporters - self.n_cartel,
                           self.n_reporters))

    @property
    def stake(self) -> float:
        """The cartel's initial reputation share under the uniform
        prior — what it has staked against being caught."""
        return self.n_cartel / self.n_reporters

    def to_dict(self) -> dict:
        return {"name": self.name, "strategy": self.strategy,
                "n_reporters": self.n_reporters,
                "n_cartel": self.n_cartel, "n_events": self.n_events,
                "variance": self.variance, "na_frac": self.na_frac,
                "n_scaled": self.n_scaled,
                "scaled_min": self.scaled_min,
                "scaled_max": self.scaled_max, "mirror": self.mirror,
                "strategy_params": dict(self.strategy_params)}

    @classmethod
    def from_dict(cls, d: dict) -> "MarketSpec":
        unknown = set(d) - {f for f in cls.__dataclass_fields__}
        if unknown:
            raise InputError(f"unknown market keys {sorted(unknown)}")
        return cls(**d)


@dataclass(frozen=True)
class Scenario:
    """A full economy configuration — JSON round-trippable
    (``--scenario`` on the CLI front door)."""

    seed: int = 0
    rounds: int = 3
    markets: tuple = ()
    #: thread-pool width driving the markets each round
    concurrency: int = 16
    resolve_timeout_s: float = 120.0
    #: bounded retry budget per shed resolution (sheds DELAY, never
    #: change, a resolution — see the module docstring)
    max_attempts: int = 12
    retry_cap_s: float = 1.0

    def __post_init__(self):
        if self.rounds < 1:
            raise InputError("an economy needs at least one round")
        if not self.markets:
            raise InputError("an economy needs at least one market")
        names = [m.name for m in self.markets]
        if len(set(names)) != len(names):
            raise InputError("market names must be unique")

    def to_dict(self) -> dict:
        return {"seed": self.seed, "rounds": self.rounds,
                "concurrency": self.concurrency,
                "resolve_timeout_s": self.resolve_timeout_s,
                "max_attempts": self.max_attempts,
                "retry_cap_s": self.retry_cap_s,
                "markets": [m.to_dict() for m in self.markets]}

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        unknown = set(d) - {f for f in cls.__dataclass_fields__}
        if unknown:
            raise InputError(f"unknown scenario keys {sorted(unknown)}")
        d = dict(d)
        d["markets"] = tuple(
            m if isinstance(m, MarketSpec) else MarketSpec.from_dict(m)
            for m in d.get("markets", ()))
        return cls(**d)


def build_scenario(seed: int = 0, rounds: int = 3,
                   strategies: Sequence[str] = ("camouflage",
                                                "sybil_split",
                                                "flash_crowd"),
                   markets_per_strategy: int = 4,
                   shapes: Sequence = DEFAULT_SHAPES,
                   cartel_fraction: float = 1.0 / 3.0,
                   variance: float = 0.05, na_frac: float = 0.05,
                   scaled_every: int = 4, mirror_every: int = 4,
                   concurrency: int = 16,
                   strategy_params: Optional[dict] = None) -> Scenario:
    """The standard scenario generator: ``markets_per_strategy`` markets
    per named strategy, shapes cycled over the heterogeneous ``shapes``
    classes, every ``scaled_every``-th market carrying a scaled event
    tail (mixed panels), every ``mirror_every``-th mirroring its panel
    as stateless bucket traffic. Pure function of its arguments."""
    if not strategies:
        raise InputError("build_scenario needs at least one strategy")
    params = dict(strategy_params or {})
    markets, i = [], 0
    for s in strategies:
        for j in range(max(1, int(markets_per_strategy))):
            R, E = shapes[i % len(shapes)]
            n_scaled = (max(1, E // 4)
                        if scaled_every and i % scaled_every == scaled_every - 1
                        else 0)
            markets.append(MarketSpec(
                name=f"{s}-{j:04d}", strategy=s, n_reporters=int(R),
                n_cartel=max(1, int(R * cartel_fraction)),
                n_events=int(E), variance=float(variance),
                na_frac=float(na_frac), n_scaled=n_scaled,
                mirror=bool(mirror_every) and i % mirror_every == 0,
                strategy_params=dict(params.get(s, {}))))
            i += 1
    return Scenario(seed=int(seed), rounds=int(rounds),
                    markets=tuple(markets),
                    concurrency=int(concurrency))


# -- panel generation ----------------------------------------------------

def round_panel(seed: int, spec: MarketSpec, round_idx: int,
                plan: RoundPlan):
    """One market round's report panel, host-side and fully keyed:
    every draw comes from ``strategy_rng(seed, "econ.panel", market,
    round, tag)``, so the panel is a pure function of
    ``(seed, market, round, plan)`` — independent of other markets,
    call order, process and package.

    Returns ``(panel, truth, lie_events, event_bounds)``: the (R, E)
    float64 panel (NaN = non-report), the truth vector in event units,
    the boolean lie-event mask the plan's ``lie_fraction`` drew, and
    the event-bounds list (None when the market has no scaled tail).
    """
    R, E = spec.n_reporters, spec.n_events
    lo, hi = float(spec.scaled_min), float(spec.scaled_max)

    def rng(tag):
        return strategy_rng(seed, "econ.panel", spec.name, round_idx, tag)

    truth01 = rng("truth").integers(0, 2, size=E).astype(np.float64)
    flips = rng("noise").random((R, E)) < spec.variance
    panel = np.abs(truth01[None, :] - flips.astype(np.float64))
    na = rng("na").random((R, E)) < spec.na_frac

    truth = truth01.copy()
    anti = 1.0 - truth01
    bounds = None
    if spec.n_scaled:
        sl = slice(E - spec.n_scaled, E)
        panel[:, sl] = lo + panel[:, sl] * (hi - lo)
        truth[sl] = lo + truth01[sl] * (hi - lo)
        anti[sl] = lo + hi - truth[sl]       # the mirrored scaled lie
        bounds = ([None] * (E - spec.n_scaled)
                  + [{"scaled": True, "min": lo, "max": hi}]
                  * spec.n_scaled)

    panel[na] = np.nan
    lie_events = rng("lie_events").random(E) < plan.lie_fraction
    liars = np.asarray(plan.liars, dtype=int)
    if liars.size and lie_events.any():
        cols = np.flatnonzero(lie_events)
        # the shared anti-truth on the lie mask (overriding NA — a NaN
        # lie is no lie); off the mask liars keep their honest-looking
        # noisy rows, which is what camouflage means
        panel[np.ix_(liars, cols)] = np.broadcast_to(
            anti[cols], (liars.size, cols.size))
    abstain = np.asarray(plan.abstain, dtype=int)
    if abstain.size:
        panel[abstain, :] = np.nan
    return panel, truth, lie_events, bounds


def split_blocks(panel: np.ndarray, bounds, n_blocks: int) -> list:
    """Deterministically split a round panel into the plan's append
    schedule: contiguous column chunks (``np.array_split`` order) with
    matching per-block bounds. Returns ``[(block, bounds), ...]``."""
    E = panel.shape[1]
    n = max(1, min(int(n_blocks), E))
    out = []
    for cols in np.array_split(np.arange(E), n):
        if cols.size == 0:
            continue
        b = None if bounds is None else [bounds[c] for c in cols]
        out.append((panel[:, cols], b))
    return out


# -- the harness ---------------------------------------------------------

class MarketEconomy:
    """Drive a :class:`Scenario` through a serve front door — a
    :class:`~pyconsensus_tpu_torch.serve.ConsensusService` or a
    :class:`~pyconsensus_tpu_torch.serve.fleet.ConsensusFleet` (both expose
    ``create_session`` / ``append`` / ``submit(session=...)``). The
    service must be started; the economy never owns its lifecycle.

    Quick use::

        svc = ConsensusService(ServeConfig()).start()
        econ = MarketEconomy(svc, build_scenario(seed=7))
        result = econ.run()       # the scoreboard dict
        svc.close(drain=True)
    """

    def __init__(self, service, scenario: Scenario) -> None:
        self.service = service
        self.scenario = scenario
        self.board = Scoreboard(scenario)
        self._strategies = {m.name: make_strategy(m.strategy,
                                                  **m.strategy_params)
                            for m in scenario.markets}
        self._rep: dict = {}           # market -> round-start reputation
        self._start_round: dict = {}   # market -> first round to play
        self._started = False
        self._lock = threading.Lock()
        self._lat: list = []
        self._errors: dict = {}
        self._sheds = 0
        self._retried = 0
        self._requests = 0
        self._mirrors_abandoned = 0
        self._wall = 0.0
        self._m_rounds = obs.counter(
            "pyconsensus_econ_rounds_total",
            "economy rounds completed by the adversarial harness")
        self._m_lies = obs.counter(
            "pyconsensus_econ_lies_total",
            "lying report entries submitted by cartels",
            labels=("strategy",))
        self._m_catches = obs.counter(
            "pyconsensus_econ_catches_total",
            "rounds in which a cartel's reputation share sat below its "
            "stake (the mechanism holding it down)",
            labels=("strategy",))
        self._m_retries = obs.counter(
            "pyconsensus_econ_resolve_retries_total",
            "economy resolutions retried after a PYC-coded shed")

    # -- session attachment ---------------------------------------------

    def _session_state(self, name: str, round_idx: int = 0) -> dict:
        """The session's state, retried as a resolution is: over an
        autoscaled fleet a rebalance may be moving it (PYC502)."""
        getter = getattr(self.service, "session_state", None)
        if getter is None:
            return self.service.sessions.get(name).state()
        return self._retrying(lambda: getter(name), name, round_idx)

    def start(self) -> "MarketEconomy":
        """Create every market's session — or ADOPT it, when the front
        door is a fleet whose replication-log directory already carries
        the market (the resume path: the log alone determines where the
        economy continues from). Idempotent."""
        if self._started:
            return self
        log_dir = getattr(getattr(self.service, "config", None),
                          "log_dir", None)
        for spec in self.scenario.markets:
            if log_dir is not None:
                from ..serve.failover import ReplicationLog

                if ReplicationLog(log_dir, spec.name).exists():
                    self.service.adopt_session(spec.name)
                else:
                    self.service.create_session(spec.name,
                                                spec.n_reporters)
            else:
                self.service.create_session(spec.name, spec.n_reporters)
            st = self._session_state(spec.name)
            self._rep[spec.name] = np.asarray(st["reputation"],
                                              dtype=np.float64)
            self._start_round[spec.name] = int(st["rounds_resolved"])
        obs.gauge("pyconsensus_econ_markets",
                  "markets in the most recently started economy").set(
            len(self.scenario.markets))
        self._started = True
        return self

    # -- retry discipline -----------------------------------------------

    def _delay(self, exc, market: str, round_idx: int,
               attempt: int) -> float:
        """Deterministic shed backoff: honor the structured
        ``retry_after_s`` hint, floored by the ``faults.retry`` jitter
        keyed on ``(seed, market, round, attempt)`` — reproducible
        runs, decorrelated markets."""
        from ..faults.retry import _sleep_for

        hint = 0.0
        ctx = getattr(exc, "context", None)
        if isinstance(ctx, dict):
            try:
                hint = float(ctx.get("retry_after_s") or 0.0)
            except (TypeError, ValueError):
                hint = 0.0
        jitter = _sleep_for(attempt, 0.01, self.scenario.retry_cap_s,
                            self.scenario.seed,
                            f"econ:{market}:{round_idx}")
        return min(self.scenario.retry_cap_s, max(hint, jitter))

    def _tally(self, code: str, retried: bool = False) -> None:
        with self._lock:
            self._sheds += 1
            self._errors[code] = self._errors.get(code, 0) + 1
            if retried:
                self._retried += 1

    def _retrying(self, fn, market: str, round_idx: int):
        """Run ``fn`` under the bounded shed-retry policy (the loadgen
        RETRYABLE_CODES discipline). Sheds delay, never change, the
        result; a non-retryable error or an exhausted budget raises."""
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as exc:   # noqa: BLE001 — classified below
                code = getattr(exc, "error_code", None)
                retryable = (code in RETRYABLE_CODES
                             and attempt < self.scenario.max_attempts)
                self._tally(code or type(exc).__name__,
                            retried=retryable)
                if not retryable:
                    raise
                self._m_retries.inc()
                time.sleep(self._delay(exc, market, round_idx, attempt))
                attempt += 1

    # -- one round -------------------------------------------------------

    def _plan(self, spec: MarketSpec, round_idx: int) -> RoundPlan:
        ctx = StrategyContext(
            seed=self.scenario.seed, market=spec.name,
            round_idx=round_idx, n_reporters=spec.n_reporters,
            cartel=spec.cartel, reputation=self._rep[spec.name],
            stake=spec.stake)
        return self._strategies[spec.name].plan_round(ctx)

    def _append_phase(self, spec: MarketSpec, round_idx: int):
        """Plan the round, generate the panel, and append the plan's
        block schedule — skipping blocks the session already journaled
        (the mid-round resume path: a killed economy's partially staged
        round continues exactly where the log left it)."""
        plan = self._plan(spec, round_idx)
        panel, _, lie_events, bounds = round_panel(
            self.scenario.seed, spec, round_idx, plan)
        panel = _faults.corrupt("econ.panel", panel)
        blocks = split_blocks(panel, bounds, plan.n_blocks)
        staged = int(self._session_state(spec.name, round_idx).get(
            "staged_blocks", 0))
        for i, (block, b) in enumerate(blocks):
            if i < staged:
                continue
            self._retrying(
                lambda block=block, b=b: self.service.append(
                    spec.name, block, b),
                spec.name, round_idx)
        lies = (len(plan.liars) * int(lie_events.sum())
                if plan.liars else 0)
        return plan, lies, (panel, bounds)

    def _submit_resolve(self, spec: MarketSpec, plan: RoundPlan):
        _faults.fire("econ.submit")
        with self._lock:
            self._requests += 1
        return self.service.submit(session=spec.name,
                                   deadline_ms=plan.deadline_ms)

    def _await_resolve(self, spec: MarketSpec, plan: RoundPlan,
                       round_idx: int, fut, t0: float):
        """Wait out one resolution, retrying sheds from scratch (a shed
        future never dispatched, so a re-submit cannot double-resolve
        the round)."""
        first = [fut]

        def once():
            f = first[0]
            if f is None:
                f = self._submit_resolve(spec, plan)
            first[0] = None
            return f.result(timeout=self.scenario.resolve_timeout_s)

        result = self._retrying(once, spec.name, round_idx)
        lat = time.monotonic() - t0
        with self._lock:
            self._lat.append(lat)
        return result

    def _mirror_submit(self, spec: MarketSpec, payload):
        """The stateless mirror of a round panel — pure bucket-class
        traffic. Sheds here are RECORDED, not retried: shed rate under
        storm load is exactly what the mirror measures."""
        panel, bounds = payload
        with self._lock:
            self._requests += 1
        try:
            return time.monotonic(), self.service.submit(
                reports=panel, event_bounds=bounds)
        except Exception as exc:   # noqa: BLE001 — tallied, mirror only
            self._tally(getattr(exc, "error_code", None)
                        or type(exc).__name__)
            with self._lock:
                self._mirrors_abandoned += 1
            return None

    def _await_mirror(self, handle) -> None:
        if handle is None:
            return
        t0, fut = handle
        try:
            fut.result(timeout=self.scenario.resolve_timeout_s)
        except Exception as exc:   # noqa: BLE001 — tallied, mirror only
            self._tally(getattr(exc, "error_code", None)
                        or type(exc).__name__)
            with self._lock:
                self._mirrors_abandoned += 1
            return
        with self._lock:
            self._lat.append(time.monotonic() - t0)

    def _finish_market(self, spec: MarketSpec, plan: RoundPlan,
                       round_idx: int, result, lies: int) -> None:
        rep = np.asarray(result["agents"]["smooth_rep"],
                         dtype=np.float64)
        self._rep[spec.name] = rep
        share = share_of(rep, spec.cartel)
        if lies:
            self._m_lies.inc(lies, strategy=spec.strategy)
        if share < spec.stake:
            self._m_catches.inc(strategy=spec.strategy)
        self.board.record(spec, round_idx, share, lies, plan.note)

    def run_round(self, round_idx: int) -> None:
        """Play one economy round across every due market (markets a
        resumed log already carries past this round are skipped)."""
        _faults.fire("econ.round")
        due = [m for m in self.scenario.markets
               if self._start_round[m.name] <= round_idx]
        if not due:
            return
        with obs.span("econ.round", round=round_idx, markets=len(due)):
            width = max(1, self.scenario.concurrency)
            with ThreadPoolExecutor(
                    max_workers=width,
                    thread_name_prefix="econ-append") as pool:
                planned = dict(zip(
                    [m.name for m in due],
                    pool.map(lambda s: self._append_phase(s, round_idx),
                             due)))
            burst = [m for m in due if planned[m.name][0].burst]
            normal = [m for m in due if not planned[m.name][0].burst]

            # the storm: every burst member's resolution (and mirror)
            # submitted back-to-back under the plan's shared deadline —
            # offered load as the independent variable, loadgen's
            # open-loop logic applied to the mechanism's own traffic
            inflight = []
            for spec in burst:
                plan, lies, payload = planned[spec.name]
                t0 = time.monotonic()
                try:
                    fut = self._submit_resolve(spec, plan)
                except Exception as exc:   # noqa: BLE001 — classified
                    code = getattr(exc, "error_code", None)
                    self._tally(code or type(exc).__name__,
                                retried=code in RETRYABLE_CODES)
                    if code not in RETRYABLE_CODES:
                        raise
                    fut = None      # _await_resolve resubmits (the
                                    # storm's immediate first retry)
                mirror = (self._mirror_submit(spec, payload)
                          if spec.mirror else None)
                inflight.append((spec, plan, lies, fut, t0, mirror))

            def play_normal(spec):
                plan, lies, payload = planned[spec.name]
                t0 = time.monotonic()
                fut = None
                mirror = (self._mirror_submit(spec, payload)
                          if spec.mirror else None)
                result = self._await_resolve(spec, plan, round_idx,
                                             fut, t0)
                self._finish_market(spec, plan, round_idx, result, lies)
                self._await_mirror(mirror)

            def play_burst(entry):
                spec, plan, lies, fut, t0, mirror = entry
                result = self._await_resolve(spec, plan, round_idx,
                                             fut, t0)
                self._finish_market(spec, plan, round_idx, result, lies)
                self._await_mirror(mirror)

            # one pool drains both phases: the storm's submits were
            # back-to-back above (that IS the burst); its awaits and
            # shed-retries run width-parallel like everything else —
            # serial retries here would grow a big storm's wall time
            # O(markets x attempts x backoff)
            with ThreadPoolExecutor(
                    max_workers=width,
                    thread_name_prefix="econ-resolve") as pool:
                normal_done = pool.map(play_normal, normal)
                burst_done = pool.map(play_burst, inflight)
                for _ in normal_done:
                    pass
                for _ in burst_done:
                    pass
        self._m_rounds.inc()

    # -- the front door --------------------------------------------------

    def run(self) -> dict:
        """Play every scenario round and return the scoreboard result
        dict (see :mod:`~pyconsensus_tpu_torch.econ.scoreboard`)."""
        self.start()
        t0 = time.monotonic()
        for k in range(self.scenario.rounds):
            self.run_round(k)
        self._wall = time.monotonic() - t0
        return self.result()

    def result(self) -> dict:
        """Assemble the scoreboard over whatever rounds have run."""
        with self._lock:
            service = {
                "requests": self._requests,
                "sheds_observed": self._sheds,
                "shed_rate": (round(self._sheds / self._requests, 4)
                              if self._requests else 0.0),
                "retried": self._retried,
                "mirrors_abandoned": self._mirrors_abandoned,
                "errors": dict(self._errors),
                "latencies": list(self._lat),
            }
        return self.board.result(self._rep, service, self._wall,
                                 self._start_round)
