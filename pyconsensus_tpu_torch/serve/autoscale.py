"""SLO-driven elastic fleet: the autoscaler control loop
(``pyconsensus_tpu/serve/autoscale.py``; host code over the fleet's
membership primitives, copied with its control law unchanged).

:class:`AutoScaler` watches an :class:`~pyconsensus_tpu_torch.obs.slo.
SloMonitor`'s windowed view (p99, queue depth, shed ratio against the
declared SLO targets) and turns sustained overload into
``ConsensusFleet.add_worker`` (scale-up / dead-worker replacement) and
sustained idleness into ``ConsensusFleet.drain_worker`` (graceful drain
+ live session migration). Over the socket transport a scale-up spawns a
worker process (``SocketTransport.spawn_worker``) that adopts its kernel
libraries from the kernel-build store of ``aot_cache_dir`` when the
store holds them, so it boots with no ``nvcc``.

Control law:

- **scale-up** after ``up_signals`` CONSECUTIVE evaluations in which
  any declared SLO target is violated by the windowed view, bounded by
  ``max_workers`` and the ``cooldown_s`` quiet period; the sessions
  whose ring home the new worker now is live-migrate onto it
  (``ConsensusFleet.rebalance_to``);
- **scale-down** after ``down_signals`` consecutive evaluations in
  which EVERY observed signal sits below ``down_headroom`` of its
  target, bounded by ``min_workers`` and the same cool-down; the victim
  is the ring worker with the fewest sessions (newest worker on ties),
  drained gracefully — zero lost acknowledged rounds;
- **replacement**: a worker the heartbeat monitor declared dead leaves
  the ring below the loop's target size; the loop spawns a NEW worker
  (a fresh name — never the corpse's) to restore it. The DECLARATION
  (fence, shed, takeover) is the fleet monitor's job and has finished by
  the time the ring shrank; the autoscaler only ever adds capacity, so
  the two paths cannot race over the same sessions.

Hysteresis against heartbeat flap and noisy windows: sustained-signal
streaks (one bad sample never scales), cool-down after every membership
change, hard min/max fleet bounds, and AT MOST ONE membership change in
flight (``evaluate`` is serialized by the autoscaler's lock, the
outermost of the fleet's lock order: ``AutoScaler._lock <
WorkerBase.declare_lock < ConsensusFleet._lock``, see ``serve.fleet``).

Every decision is deterministic given the windowed view, counted in
``pyconsensus_autoscale_decisions_total{action}`` (with the target in
``pyconsensus_autoscale_target_workers``), and logged through the
flight recorder (a span per non-hold decision; a ring dump per
membership change under ``<flightrec_dir>/autoscaler``). The
``autoscale.decide`` / ``autoscale.spawn`` / ``autoscale.drain`` fault
sites let a seeded ``FaultPlan`` break the loop's decision, spawn and
drain steps deterministically — an injected fault costs one control
period, never the fleet.
"""

from __future__ import annotations

import pathlib
import re
import threading
import time
from dataclasses import dataclass
from typing import Optional

from .. import obs
from ..faults import InputError
from ..faults import plan as _faults

__all__ = ["AutoscaleConfig", "AutoScaler"]

#: worker names minted by the fleet (``w<i>``) — scale-down prefers the
#: newest (highest id) among least-loaded victims, deterministically
_WORKER_ID_RE = re.compile(r"^w(\d+)$")


def _worker_id(name: str) -> int:
    m = _WORKER_ID_RE.match(name)
    return int(m.group(1)) if m else -1


@dataclass(frozen=True)
class AutoscaleConfig:
    """The control loop's policy knobs (see module docstring for the
    control law each one parameterizes)."""

    #: hard fleet-size bounds — the loop never drains below ``min`` or
    #: spawns above ``max``, whatever the signals say
    min_workers: int = 1
    max_workers: int = 4
    #: control period of the background loop (``run_in_thread``)
    interval_s: float = 0.5
    #: consecutive violated evaluations before a scale-up fires
    up_signals: int = 2
    #: consecutive idle evaluations before a scale-down fires —
    #: deliberately slower than scale-up (draining is cheap to delay,
    #: overload is not)
    down_signals: int = 6
    #: quiet period after ANY membership change before the next
    #: signal-driven change (replacement of a declared-dead worker is
    #: exempt: a death is monotonic — it cannot flap — and running
    #: below target is itself the incident)
    cooldown_s: float = 3.0
    #: "idle" means every OBSERVED signal <= this fraction of its
    #: target (scale-down headroom: shrinking must not immediately
    #: re-violate)
    down_headroom: float = 0.5
    #: spawn replacements for workers the monitor declared dead
    replace_dead: bool = True
    #: warm-up policy handed to ``ConsensusFleet.add_worker`` (the
    #: kernel-build store makes it build-free when primed)
    warmup: bool = True
    #: after a scale-up, live-rebalance onto the new worker the
    #: sessions whose ring home it now is
    #: (``ConsensusFleet.rebalance_to``, fail-soft — a refused migration
    #: leaves the session serving where it was). Without this a grown
    #: fleet only spreads NEW sessions; the hot ones that triggered the
    #: scale-up stay crowded on the old workers.
    rebalance_on_scale_up: bool = True
    #: bound on sessions moved per scale-up rebalance (None = all of
    #: the new worker's keys) — caps the one-time migration burst
    rebalance_max_sessions: Optional[int] = None


class AutoScaler:
    """The control loop around one :class:`ConsensusFleet` and one
    :class:`SloMonitor` (which must be sampling the fleet's MERGED
    snapshot — the loop consumes ``monitor.window()``, it never samples
    itself). Thread-safe; :meth:`run_in_thread` starts the production
    loop, tests drive :meth:`evaluate` with explicit clocks."""

    def __init__(self, fleet, monitor,
                 config: Optional[AutoscaleConfig] = None,
                 recorder=None) -> None:
        self.fleet = fleet
        self.monitor = monitor
        self.config = config or AutoscaleConfig()
        if self.config.min_workers < 1:
            raise InputError(
                f"min_workers must be >= 1, got "
                f"{self.config.min_workers}")
        if self.config.max_workers < self.config.min_workers:
            raise InputError(
                f"max_workers ({self.config.max_workers}) must be >= "
                f"min_workers ({self.config.min_workers})")
        # one membership change in flight: every evaluate() — the
        # background loop's and any manual caller's — serializes here.
        # Outermost of the fleet's lock order (serve.fleet): held across
        # add_worker/drain_worker, which take declare_lock then the
        # fleet lock.
        self._lock = threading.Lock()
        #: desired fleet size — None until the first evaluation reads
        #: the ring (so a fleet resized before the loop starts is not
        #: fought back to its boot size)
        self._target: Optional[int] = None  # guarded-by: _lock
        self._up_streak = 0                 # guarded-by: _lock
        self._down_streak = 0               # guarded-by: _lock
        self._last_change_t: Optional[float] = None     # guarded-by: _lock
        self._last_decision: dict = {}      # guarded-by: _lock
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._decisions = obs.counter(
            "pyconsensus_autoscale_decisions_total",
            "autoscaler control-loop decisions by action (hold / "
            "scale_up / scale_down / replace / error)",
            labels=("action",))
        self._target_gauge = obs.gauge(
            "pyconsensus_autoscale_target_workers",
            "the autoscaler's current desired fleet size")
        # decision forensics: a ring dump per membership change, next
        # to the router's takeover and drain dumps
        self._recorder = recorder
        if (recorder is None
                and getattr(fleet.config.worker, "flightrec_dir", None)):
            self._recorder = obs.FlightRecorder(
                pathlib.Path(fleet.config.worker.flightrec_dir)
                / "autoscaler", source="autoscaler")

    # -- the control step ----------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One control decision: read the windowed view, update the
        hysteresis streaks, and perform at most one membership change.
        Returns the decision record (``action`` is ``hold`` /
        ``scale_up`` / ``scale_down`` / ``replace`` / ``error``).
        Never raises — an injected or organic failure is an ``error``
        decision that costs one control period."""
        with self._lock:
            t = time.monotonic() if now is None else float(now)
            try:
                decision = self._decide_locked(t)
            except Exception as exc:    # noqa: BLE001 — the loop must
                # outlive an injected decide/spawn/drain fault; the
                # failed step is re-attempted from fresh signals next
                # period
                decision = {"t": t, "action": "error",
                            "error": f"{type(exc).__name__}: {exc}"}
            self._last_decision = decision
            self._decisions.inc(action=decision["action"])
            if self._target is not None:
                self._target_gauge.set(self._target)
        if decision["action"] not in ("hold", "error"):
            self._dump(f"autoscale.{decision['action']}")
        return decision

    def _decide_locked(self, t: float) -> dict:
        _faults.fire("autoscale.decide")
        win = self.monitor.window()
        targets = self.monitor.targets
        ring = tuple(self.fleet.ring.workers())
        alive = len(ring)
        if self._target is None:
            self._target = min(max(alive, self.config.min_workers),
                               self.config.max_workers)
        breached = sorted(
            key for key, target in targets.items()
            if self._exceeds(win.get(key), target, 1.0))
        observed = sorted(
            key for key in targets if win.get(key) is not None)
        idle = bool(observed) and not any(
            self._exceeds(win.get(key), targets[key],
                          self.config.down_headroom)
            for key in observed)
        decision = {"t": t, "action": "hold", "alive": alive,
                    "target": self._target, "breached": breached,
                    "idle": idle,
                    "up_streak": self._up_streak,
                    "down_streak": self._down_streak}

        # 1. replacement — capacity lost to a DECLARED death (the ring
        # only shrinks under a declaration or a drain; drains lower the
        # target first, so ring < target means a death). Exempt from
        # streaks and cool-down: a declaration is monotonic, and
        # serving below target IS the incident.
        if self.config.replace_dead and alive < self._target:
            return self._scale_up(decision, t, action="replace")

        in_cooldown = (self._last_change_t is not None
                       and t - self._last_change_t
                       < self.config.cooldown_s)
        if breached:
            self._up_streak += 1
            self._down_streak = 0
            decision["up_streak"] = self._up_streak
            if (self._up_streak >= self.config.up_signals
                    and not in_cooldown
                    and alive < self.config.max_workers):
                return self._scale_up(decision, t, action="scale_up")
        elif idle:
            self._down_streak += 1
            self._up_streak = 0
            decision["down_streak"] = self._down_streak
            if (self._down_streak >= self.config.down_signals
                    and not in_cooldown
                    and alive > self.config.min_workers):
                return self._scale_down(decision, ring, t)
        else:
            # neither breached nor idle (mid-band, or no samples yet):
            # streaks are CONSECUTIVE by definition — reset both
            self._up_streak = 0
            self._down_streak = 0
        return decision

    @staticmethod
    def _exceeds(observed, target, headroom: float) -> bool:
        if observed is None:
            return False
        return float(observed) > float(target) * float(headroom)

    # -- the actuators --------------------------------------------------

    def _scale_up(self, decision: dict, t: float, action: str) -> dict:
        _faults.fire("autoscale.spawn")
        with obs.span("autoscale.spawn", action=action,
                      breached=",".join(decision["breached"])):
            name = self.fleet.add_worker(warmup=self.config.warmup)
        if self.config.rebalance_on_scale_up and action == "scale_up":
            # placement pressure: move the new worker's ring
            # keys onto it. Fail-soft — rebalancing is advisory, and a
            # failed migration leaves the session serving where it was;
            # the scale-up itself already succeeded. A REPLACEMENT is
            # exempt: the takeover just placed the dead worker's
            # sessions on survivors deliberately, and migrating them
            # again right after the incident would double the
            # disruption for zero durability gain.
            try:
                with obs.span("autoscale.rebalance", worker=name):
                    moved = self.fleet.rebalance_to(
                        name,
                        max_sessions=self.config.rebalance_max_sessions)
                decision["sessions_rebalanced"] = len(moved)
            except Exception:   # noqa: BLE001 — the grown fleet still
                decision["sessions_rebalanced"] = 0     # serves
        self._target = max(self._target, len(self.fleet.ring.workers()))
        self._target = min(self._target, self.config.max_workers)
        self._last_change_t = t
        self._up_streak = 0
        self._down_streak = 0
        decision.update(action=action, worker=name,
                        target=self._target)
        return decision

    def _scale_down(self, decision: dict, ring: tuple,
                    t: float) -> dict:
        _faults.fire("autoscale.drain")
        victim = self._victim(ring)
        # lower the target BEFORE the drain: the replacement rule reads
        # ring < target as "a death happened", and mid-drain the ring
        # has already shrunk
        self._target = max(self.config.min_workers, len(ring) - 1)
        try:
            with obs.span("autoscale.drain", worker=victim):
                result = self.fleet.drain_worker(victim)
        except BaseException:
            # a REFUSED drain (no live peer, injected fault) left the
            # ring as it was: restore the target, or the lowered value
            # would silently suppress the next death's replacement
            self._target = min(len(self.fleet.ring.workers()) or 1,
                               self.config.max_workers)
            raise
        self._last_change_t = t
        self._up_streak = 0
        self._down_streak = 0
        decision.update(action="scale_down", worker=victim,
                        target=self._target,
                        sessions_migrated=len(
                            result.get("sessions_migrated") or ()),
                        drained=bool(result.get("drained")))
        if not result.get("drained"):
            # the drain refused or stranded sessions: restore the
            # target so the worker is not treated as a death
            self._target = min(len(self.fleet.ring.workers()) or 1,
                               self.config.max_workers)
            decision["target"] = self._target
        return decision

    def _victim(self, ring: tuple) -> str:
        """Deterministic drain victim: fewest owned sessions first
        (cheapest migration), newest worker (highest ``w<i>``) on
        ties — the boot workers are the last to go."""
        counts = {name: 0 for name in ring}
        for _session, owner in self.fleet.sessions().items():
            if owner in counts:
                counts[owner] += 1
        return min(ring,
                   key=lambda n: (counts[n], -_worker_id(n), n))

    def _dump(self, reason: str) -> None:
        if self._recorder is None:
            return
        try:
            self._recorder.dump(reason)
        except Exception:   # noqa: BLE001 — forensics never block
            pass            # the control loop

    # -- introspection --------------------------------------------------

    def status(self) -> dict:
        """Operator snapshot (the serve CLI embeds this)."""
        with self._lock:
            return {"target": self._target,
                    "up_streak": self._up_streak,
                    "down_streak": self._down_streak,
                    "last_decision": dict(self._last_decision)}

    # -- the production loop --------------------------------------------

    def run_in_thread(self) -> "AutoScaler":
        """Start the daemon control loop (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_ev.clear()
            self._thread = threading.Thread(
                target=self._loop, name="pyconsensus-autoscaler",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_ev.wait(self.config.interval_s):
            try:
                self.evaluate()
            except Exception:   # noqa: BLE001 — evaluate already
                pass            # shields; belt and suspenders

    def stop(self) -> None:
        """Stop the control loop (the fleet is left at its current
        size — stopping the loop is not a scale-to-zero)."""
        with self._lock:
            th, self._thread = self._thread, None
        if th is None:
            return
        self._stop_ev.set()
        th.join(timeout=10.0)
