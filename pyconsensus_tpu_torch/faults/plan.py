"""Deterministic, seeded fault injection (``pyconsensus_tpu/faults/
plan.py``: the same plan format, and the same poisoned cells).

A :class:`FaultPlan` is a set of :class:`FaultRule`\\ s keyed by **named
injection sites** — host-side hook points threaded through the front
doors (``FAULT_SITES``). A rule activates by ``(site, occurrence
index)``: the Nth time a site is reached under an armed plan,
deterministically — either at explicit occurrence indices or with a
seeded per-occurrence probability. The PRNG stream is a pure function of
``(plan seed, site name, occurrence index)`` (zlib's crc32 and numpy's
``default_rng``, as in the JAX package), so replaying the same plan file
over the same workload reproduces the same faults in the same places
regardless of how calls to *other* sites interleave, and one plan
poisons the same cells in both packages.

Zero overhead disarmed: :func:`fire` / :func:`corrupt` test one module
global against ``None`` and return. No plan state, no counters, no PRNG
is touched. Every site is in host code on host values, never between
kernel launches on device tensors.

Two hook shapes:

- :func:`fire(site, path=...)` — control-flow faults: raise a
  configured exception (``raise`` kind), simulate a hard kill
  (``crash`` — :class:`SimulatedCrash` derives from ``BaseException``
  so ordinary ``except Exception`` recovery code cannot swallow it,
  matching what a SIGKILL leaves behind), or damage a file in place
  (``torn_write`` / ``truncate`` — the file at ``path`` is cut short,
  silently, exactly like a power loss between write and fsync).
- :func:`corrupt(site, value)` — data faults on host arrays (or dicts
  of arrays): ``nan_storm`` / ``inf_storm`` poison a seeded fraction of
  entries, ``drop_rows`` NaNs whole rows, ``drop_shard`` NaNs one
  contiguous column block (a lost event shard). Returns the value
  unchanged when disarmed or no rule matches.
"""

from __future__ import annotations

import fnmatch
import json
import pathlib
import zlib
from typing import Optional, Sequence

import numpy as np

__all__ = ["FAULT_SITES", "FaultRule", "FaultPlan", "SimulatedCrash",
           "arm", "disarm", "armed", "active_plan", "fire", "corrupt"]

#: The 39 named injection sites of the port — every :func:`fire` /
#: :func:`corrupt` hook call in the package names exactly one of these,
#: and every entry here is reached by at least one hook call (the tests
#: check both directions against the source). They are the JAX package's
#: catalog, site for site, so a plan written for it arms the same sites here:
#: persistence (``io.*``, ``ledger.*``, ``sweep.chunk.*``), the front
#: doors (``sharded.reports``, ``oracle.*``), the out-of-core driver
#: (``streaming.panel``: each host panel before its upload), the serve
#: tier (``serve.*``: submit, dispatch, the executable cache's store and
#: a session's append), the kernel-build store (``aot.cache_write``
#: after an entry's atomic write, ``aot.cache_load`` before its read),
#: the launch-shape autotuner (``tune.cache_write`` before a winner's
#: atomic write),
#: the fleet (``fleet.*``: routing, a worker's heartbeat, a takeover and
#: the replay of a replication log), the autoscaler (``autoscale.*``: a
#: control decision, a scale-up's spawn, a scale-down's drain), the
#: economy (``econ.round`` at each round, ``econ.panel`` on each round
#: panel, ``econ.submit`` before each session resolve), the state
#: plane (``state.snapshot`` inside a compaction snapshot's write,
#: ``state.compact`` before each truncation unlink, ``state.hydrate``
#: at a cold session's hydration, ``state.migrate`` at every session
#: relocation) and the socket
#: transport (``transport.*``: a frame's send and receive and a
#: connection's dial; ``shipping.append``: each replication record
#: shipped to the standby).
FAULT_SITES = (
    "io.read", "io.decode", "io.write", "io.stage",
    "ledger.save", "ledger.load",
    "sweep.chunk.data", "sweep.chunk.write",
    "sweep.chunk.pre_commit", "sweep.chunk.post_commit",
    "sharded.reports", "oracle.reports", "oracle.raw_result",
    "streaming.panel",
    "serve.enqueue", "serve.dispatch", "serve.cache_store",
    "serve.session_append",
    "aot.cache_write", "aot.cache_load",
    "tune.cache_write",
    "fleet.route", "fleet.heartbeat", "fleet.takeover",
    "fleet.ledger_replay",
    "autoscale.decide", "autoscale.spawn", "autoscale.drain",
    "econ.round", "econ.panel", "econ.submit",
    "state.snapshot", "state.compact", "state.hydrate", "state.migrate",
    "transport.send", "transport.recv", "transport.connect",
    "shipping.append",
)


class SimulatedCrash(BaseException):
    """An injected hard kill (``crash`` kind). Derives from
    ``BaseException`` so graceful-recovery code written for *errors*
    (``except Exception``) cannot intercept it — the process state left
    behind is what a real ``kill -9`` at that site would leave, which is
    exactly what crash/resume tests need to exercise."""


#: ``raise`` kind ``error=`` spellings -> exception class. The structured
#: classes come from .errors; ``os_error`` simulates transient
#: infrastructure failures (the retry decorator's domain).
def _error_classes():
    from .errors import (CheckpointCorruptionError, ConsensusError,
                         InputError, NumericsError)

    return {
        "os_error": OSError,
        "input_error": InputError,
        "numerics_error": NumericsError,
        "checkpoint_corruption": CheckpointCorruptionError,
        "consensus_error": ConsensusError,
    }


_FIRE_KINDS = ("raise", "crash", "torn_write", "truncate")
_CORRUPT_KINDS = ("nan_storm", "inf_storm", "drop_rows", "drop_shard",
                  "zero_out")
_KINDS = _FIRE_KINDS + _CORRUPT_KINDS


class FaultRule:
    """One injection rule. ``site`` is an exact site name or an
    ``fnmatch`` pattern (``"sweep.chunk.*"``). Activation: explicit
    ``occurrences`` (0-based indices), or seeded per-occurrence
    ``probability``, or both (union); ``max_fires`` caps total
    activations (default: unlimited for occurrence lists, 1 for pure
    probability rules — a probabilistic rule that can fire forever makes
    replay analysis needlessly noisy). ``args`` parameterizes the kind
    (``fraction``, ``value``, ``rows``, ``shard``, ``n_shards``,
    ``error``, ``message``, ``keep_bytes``)."""

    def __init__(self, site: str, kind: str,
                 occurrences: Optional[Sequence[int]] = None,
                 probability: Optional[float] = None,
                 max_fires: Optional[int] = None,
                 args: Optional[dict] = None) -> None:
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; choose from "
                             f"{_KINDS}")
        if occurrences is None and probability is None:
            occurrences = [0]          # the common "first time" default
        if probability is not None and not 0.0 <= probability <= 1.0:
            raise ValueError("probability must lie in [0, 1]")
        self.site = str(site)
        self.kind = str(kind)
        self.occurrences = (None if occurrences is None
                            else tuple(int(i) for i in occurrences))
        self.probability = None if probability is None else float(probability)
        if max_fires is None:
            max_fires = 1 if self.occurrences is None else 0  # 0 = no cap
        self.max_fires = int(max_fires)
        self.args = dict(args or {})
        self.fires = 0

    def matches(self, site: str) -> bool:
        return site == self.site or fnmatch.fnmatchcase(site, self.site)

    def active(self, occurrence: int, rng_for) -> bool:
        """Whether this rule fires at ``occurrence`` of a matched site.
        ``rng_for(tag)`` supplies the deterministic per-occurrence
        generator (the plan owns the seeding discipline)."""
        if self.max_fires and self.fires >= self.max_fires:
            return False
        if self.occurrences is not None and occurrence in self.occurrences:
            return True
        if self.probability is not None:
            return bool(rng_for("activate").random() < self.probability)
        return False

    def to_dict(self) -> dict:
        out = {"site": self.site, "kind": self.kind}
        if self.occurrences is not None:
            out["occurrences"] = list(self.occurrences)
        if self.probability is not None:
            out["probability"] = self.probability
        if self.max_fires:
            out["max_fires"] = self.max_fires
        if self.args:
            out["args"] = self.args
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        unknown = set(d) - {"site", "kind", "occurrences", "probability",
                            "max_fires", "args"}
        if unknown:
            raise ValueError(f"unknown fault-rule keys {sorted(unknown)}")
        return cls(d["site"], d["kind"],
                   occurrences=d.get("occurrences"),
                   probability=d.get("probability"),
                   max_fires=d.get("max_fires"),
                   args=d.get("args"))


class FaultPlan:
    """A seeded set of rules plus the per-site occurrence bookkeeping.
    One plan instance tracks one chaos run: ``fired`` logs every
    activation ``(site, occurrence, kind)`` in order, so a run can be
    summarized (the CLI prints it) and a replay asserted identical."""

    def __init__(self, seed: int = 0, rules: Sequence = ()) -> None:
        self.seed = int(seed)
        self.rules = [r if isinstance(r, FaultRule) else
                      FaultRule.from_dict(r) for r in rules]
        self._counts: dict = {}
        #: activation log: (site, occurrence, kind) tuples, in fire order
        self.fired: list = []

    # -- deterministic PRNG discipline ----------------------------------

    def _rng(self, site: str, occurrence: int, tag: str):
        """Generator keyed on (seed, site, occurrence, tag): independent
        of call interleaving across sites, stable across platforms
        (crc32 is deterministic), distinct per use within one
        activation (``tag``)."""
        return np.random.default_rng(
            [self.seed, zlib.crc32(site.encode()), occurrence,
             zlib.crc32(tag.encode())])

    def _next(self, site: str):
        """Advance ``site``'s occurrence counter and return the first
        activating rule (or None) with the occurrence index."""
        occ = self._counts.get(site, 0)
        self._counts[site] = occ + 1
        for rule in self.rules:
            if rule.matches(site) and rule.active(
                    occ, lambda tag: self._rng(site, occ, tag)):
                rule.fires += 1
                self.fired.append((site, occ, rule.kind))
                self._record(site, rule.kind)
                return rule, occ
        return None, occ

    @staticmethod
    def _record(site: str, kind: str) -> None:
        from .. import obs

        obs.counter(
            "pyconsensus_faults_injected_total",
            "fault-plan activations by injection site and kind",
            labels=("site", "kind")).inc(site=site, kind=kind)

    # -- the two hook bodies --------------------------------------------

    def fire(self, site: str, path=None) -> None:
        rule, occ = self._next(site)
        if rule is None:
            return
        if rule.kind in ("raise", "crash"):
            self._control(rule, site, occ)
        if rule.kind in ("torn_write", "truncate"):
            if path is None:
                raise ValueError(
                    f"fault rule {rule.kind!r} at {site} needs a file "
                    f"path — this site does not expose one")
            self._tear(pathlib.Path(path), rule, site, occ)
            return
        raise ValueError(f"fault kind {rule.kind!r} is a data fault — "
                         f"site {site} is a fire() (control-flow) site")

    @staticmethod
    def _control(rule: FaultRule, site: str, occ: int) -> None:
        """Shared raise/crash arm of both hooks."""
        if rule.kind == "raise":
            exc = _error_classes()[rule.args.get("error", "os_error")]
            raise exc(rule.args.get(
                "message", f"injected fault at {site} (occurrence {occ})"))
        raise SimulatedCrash(f"injected crash at {site} (occurrence {occ})")

    def _tear(self, path: pathlib.Path, rule: FaultRule, site: str,
              occ: int) -> None:
        """Cut ``path`` short — the torn write a power loss between
        write and fsync leaves. ``keep_bytes`` pins the cut; default:
        a seeded point in the middle half of the file."""
        size = path.stat().st_size
        keep = rule.args.get("keep_bytes")
        if keep is None:
            keep = int(size * (0.25 + 0.5 * self._rng(site, occ,
                                                      "tear").random()))
        with open(path, "r+b") as f:
            f.truncate(max(0, min(int(keep), size)))

    def corrupt(self, site: str, value):
        rule, occ = self._next(site)
        if rule is None:
            return value
        if rule.kind in ("raise", "crash"):
            # control-flow kinds are legal at data sites too
            self._control(rule, site, occ)
        if rule.kind in ("torn_write", "truncate"):
            # loud in BOTH directions: fire() rejects data kinds, and a
            # file kind at a data site must not log a vacuous activation
            raise ValueError(
                f"fault kind {rule.kind!r} is a file fault — site {site} "
                f"is a corrupt() (data) site with no file to tear")
        if isinstance(value, dict):
            # dict payloads (a sweep chunk, a fetched result): poison the
            # FLOAT arrays only — counters/flags ("iterations",
            # "convergence") are bookkeeping, and NaN-ing them would test
            # Python's int() rather than the pipeline's numerics
            return {k: (self._apply(rule, site, occ, v, subkey=k)
                        if np.asarray(v).dtype.kind in "fc" else v)
                    for k, v in value.items()}
        return self._apply(rule, site, occ, value)

    def _apply(self, rule: FaultRule, site: str, occ: int, arr,
               subkey: str = ""):
        arr = np.array(arr, copy=True)     # never mutate the caller's data
        if arr.dtype.kind not in "fc":     # int/bool payloads: poison as f64
            arr = arr.astype(np.float64)
        rng = self._rng(site, occ, f"data:{subkey}")
        if rule.kind in ("nan_storm", "inf_storm", "zero_out"):
            fraction = float(rule.args.get("fraction", 0.05))
            mask = rng.random(arr.shape) < fraction
            if rule.kind == "nan_storm":
                fill = np.nan
            elif rule.kind == "zero_out":
                fill = 0.0
            else:
                fill = float(rule.args.get("value", np.inf))
            arr[mask] = fill
        elif rule.kind == "drop_rows":
            if arr.ndim < 1 or arr.shape[0] == 0:
                return arr
            rows = rule.args.get("rows")
            if rows is None:
                fraction = float(rule.args.get("fraction", 0.1))
                n = max(1, int(round(arr.shape[0] * fraction)))
                rows = rng.choice(arr.shape[0], size=min(n, arr.shape[0]),
                                  replace=False)
            arr[np.asarray(rows, dtype=int)] = np.nan
        elif rule.kind == "drop_shard":
            if arr.ndim < 2 or arr.shape[1] == 0:
                return arr
            n_shards = int(rule.args.get("n_shards", 8))
            shard = rule.args.get("shard")
            if shard is None:
                shard = int(rng.integers(n_shards))
            width = -(-arr.shape[1] // n_shards)
            lo = int(shard) * width
            arr[:, lo:lo + width] = np.nan
        return arr

    # -- serialization ---------------------------------------------------

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "rules": [r.to_dict() for r in self.rules]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        unknown = set(d) - {"seed", "rules"}
        if unknown:
            raise ValueError(f"unknown fault-plan keys {sorted(unknown)}")
        return cls(seed=d.get("seed", 0), rules=d.get("rules", ()))

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(json.dumps(self.to_dict(), indent=2) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "FaultPlan":
        return cls.from_dict(json.loads(pathlib.Path(path).read_text()))

    def replay(self) -> "FaultPlan":
        """A fresh plan with the same seed/rules and zeroed bookkeeping —
        arm it over the same workload to reproduce the run."""
        return FaultPlan.from_dict(self.to_dict())


#: the armed plan (module global — the only state the disarmed fast path
#: reads). One plan at a time, process-wide, like obs.REGISTRY.
_ACTIVE: Optional[FaultPlan] = None


def arm(plan: FaultPlan) -> FaultPlan:
    """Arm ``plan`` process-wide. Returns it (for chaining)."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def disarm() -> None:
    global _ACTIVE
    _ACTIVE = None


class armed:
    """``with faults.armed(plan): ...`` — scoped arming for tests."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        return arm(self.plan)

    def __exit__(self, *exc) -> None:
        disarm()


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def fire(site: str, path=None) -> None:
    """Control-flow injection hook (see module docstring). No-op (one
    global ``is None`` test) when no plan is armed."""
    if _ACTIVE is None:
        return
    _ACTIVE.fire(site, path=path)


def corrupt(site: str, value):
    """Data injection hook: returns ``value`` (host array or dict of
    arrays) possibly poisoned per the armed plan; the input itself is
    never mutated. No-op passthrough when disarmed."""
    if _ACTIVE is None:
        return value
    return _ACTIVE.corrupt(site, value)
