"""The port's autoscaler (``pyconsensus_tpu_torch.serve.autoscale``)
against the JAX package's, on the CPU.

- the control law: one scripted sequence of windowed views (a stub
  monitor) drives the port's and the reference's ``AutoScaler`` over two
  stub fleets, and every decision record is the same (breach streaks,
  idle streaks, mid-band resets, cool-down, the min/max bounds, a
  declared death's replacement, a refused or stranded drain, the victim
  rule, a failed rebalance);
- the port's in-process fleet on ``device="cpu"``: a sustained breach
  scales up and live-rebalances, sustained idleness drains the victim
  with every session resolving bit for bit as on one service, a killed
  worker is replaced under a fresh name, every membership change leaves
  an autoscaler flight-recorder dump, and each of ``autoscale.decide``,
  ``autoscale.spawn`` and ``autoscale.drain`` costs one control period
  (an ``error`` decision) and never half-changes the membership;
- the fault catalog is the reference's, ``tune.cache_write`` included
  since the tuner.
"""

import numpy as np
import pytest
import torch

from pyconsensus_tpu import faults as ref_faults
from pyconsensus_tpu.faults import InputError as RefInputError
from pyconsensus_tpu.serve.autoscale import AutoScaler as RefAutoScaler
from pyconsensus_tpu.serve.autoscale import \
    AutoscaleConfig as RefAutoscaleConfig
from pyconsensus_tpu_torch import faults, obs
from pyconsensus_tpu_torch.faults import InputError
from pyconsensus_tpu_torch.obs import read_flight_dir
from pyconsensus_tpu_torch.serve import (ConsensusFleet, ConsensusService,
                                         FleetConfig, ServeConfig)
from pyconsensus_tpu_torch.serve.autoscale import (AutoScaler,
                                                   AutoscaleConfig)
from torch_witness import (  # noqa: F401
    torch_lock_witness, torch_protocol_witness, torch_digest_witness)


@pytest.fixture(autouse=True)
def _witnessed(torch_lock_witness,
               torch_protocol_witness,
               torch_digest_witness):
    """Every test here runs under the port's lock, protocol and digest
    witnesses (the counterpart of the reference's test_autoscale opt-
    in)."""
    yield


#: the six sites of the autoscaler and the economy
NEW_SITES = ("autoscale.decide", "autoscale.spawn", "autoscale.drain",
             "econ.round", "econ.panel", "econ.submit")


@pytest.fixture(autouse=True)
def _clean_registry():
    """Leave the process registry as found: a fleet's heartbeats add
    worker-labelled series that later tests of the same process do not
    expect."""
    yield
    obs.reset()


@pytest.fixture(autouse=True)
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


class StubMonitor:
    """What the autoscaler reads of a monitor: ``targets`` and
    ``window()``."""

    def __init__(self, targets):
        self.targets = dict(targets)
        self.win = {}

    def window(self):
        return dict(self.win)


class _Ring:
    def __init__(self, names):
        self.names = list(names)

    def workers(self):
        return tuple(self.names)


class _Worker:
    flightrec_dir = None


class _Config:
    worker = _Worker()


class StubFleet:
    """The membership surface the autoscaler drives: ``ring``,
    ``add_worker``, ``drain_worker``, ``rebalance_to``, ``sessions``,
    with scriptable deaths, refusals and stranded drains."""

    def __init__(self, n, sessions):
        self.config = _Config()
        self.ring = _Ring(f"w{i}" for i in range(n))
        self.next_id = n
        self._sessions = dict(sessions)
        self.refuse_drain = False
        self.strand_drain = False
        self.fail_rebalance = False
        self.log = []

    def add_worker(self, warmup=True):
        name = f"w{self.next_id}"
        self.next_id += 1
        self.ring.names.append(name)
        self.log.append(("add", name, warmup))
        return name

    def rebalance_to(self, name, max_sessions=None):
        if self.fail_rebalance:
            raise RuntimeError("migration refused")
        moved = sorted(s for s, o in self._sessions.items()
                       if o != name)[:1]
        for s in moved:
            self._sessions[s] = name
        self.log.append(("rebalance", name, max_sessions, moved))
        return [(s, "old") for s in moved]

    def drain_worker(self, name):
        self.log.append(("drain", name))
        if self.refuse_drain:
            raise RuntimeError(f"cannot drain {name!r}")
        if self.strand_drain:
            return {"worker": name, "drained": False,
                    "sessions_migrated": [], "stranded": ["s0"]}
        self.ring.names.remove(name)
        moved = [s for s, o in self._sessions.items() if o == name]
        for s in moved:
            self._sessions[s] = self.ring.names[0]
        return {"worker": name, "drained": True,
                "sessions_migrated": [(s, self.ring.names[0])
                                      for s in moved]}

    def sessions(self):
        return dict(self._sessions)

    def kill(self, name):
        self.ring.names.remove(name)


BREACHED = {"p99_ms": 120.0, "queue_depth": 3.0}
IDLE = {"p99_ms": 10.0, "queue_depth": 1.0}
MID = {"p99_ms": 40.0}
QUEUED = {"queue_depth": 20.0}
EMPTY = {}

#: scripts of (now, window, fleet event) — events: "kill wN", "refuse",
#: "strand", "fail_rebalance", "ok"
SCRIPTS = {
    "up_then_down": [(t, BREACHED, None) for t in (0, 1, 2, 3)]
    + [(4 + t, IDLE, None) for t in range(12)],
    "cooldown_blocks": [(0, BREACHED, None), (0.5, BREACHED, None),
                        (1, BREACHED, None), (1.5, BREACHED, None),
                        (6, BREACHED, None), (6.5, BREACHED, None)],
    "mid_band_resets": [(0, BREACHED, None), (1, MID, None),
                        (2, BREACHED, None), (3, EMPTY, None),
                        (4, IDLE, None), (5, IDLE, None), (6, MID, None),
                        (7, IDLE, None), (8, IDLE, None), (9, IDLE, None)],
    "max_bound": [(t, QUEUED, None) for t in range(0, 40, 6)],
    "min_bound": [(t, IDLE, None) for t in range(20)],
    "replace_death": [(0, MID, None), (1, MID, "kill w1"), (2, MID, None),
                      (3, IDLE, "kill w0"), (4, IDLE, None),
                      (5, IDLE, None)],
    "refused_drain": [(0, IDLE, None), (1, IDLE, None), (2, IDLE, None),
                      (3, IDLE, "refuse"), (4, IDLE, "ok"),
                      (10, IDLE, None), (11, IDLE, None),
                      (12, IDLE, None)],
    "stranded_drain": [(t, IDLE, "strand" if t == 0 else None)
                       for t in range(4)] + [(4, IDLE, "kill w1"),
                                             (5, IDLE, None)],
    "failed_rebalance": [(0, BREACHED, "fail_rebalance"),
                         (1, BREACHED, None), (2, BREACHED, None)],
}


def _drive(scaler_cls, config_cls, script, n, cfg):
    fleet = StubFleet(n, {"s0": "w0", "s1": "w1", "s2": "w0",
                          "s3": f"w{n - 1}"})
    mon = StubMonitor({"p99_ms": 50.0, "queue_depth": 8.0})
    scaler = scaler_cls(fleet, mon, config_cls(**cfg))
    out = []
    for now, win, event in script:
        if event and event.startswith("kill "):
            if event.split()[1] in fleet.ring.names:
                fleet.kill(event.split()[1])
        elif event == "refuse":
            fleet.refuse_drain = True
        elif event == "strand":
            fleet.strand_drain = True
        elif event == "fail_rebalance":
            fleet.fail_rebalance = True
        elif event == "ok":
            fleet.refuse_drain = fleet.strand_drain = False
        mon.win = win
        d = scaler.evaluate(now=float(now))
        out.append(d)
    return out, fleet.log, scaler.status()


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_decision_sequences_equal_the_references(name, n):
    cfg = dict(min_workers=1, max_workers=4, up_signals=2,
               down_signals=3, cooldown_s=5.0, warmup=False,
               rebalance_max_sessions=2)
    got = _drive(AutoScaler, AutoscaleConfig, SCRIPTS[name], n, cfg)
    want = _drive(RefAutoScaler, RefAutoscaleConfig, SCRIPTS[name], n,
                  cfg)
    assert got == want


def test_config_refusals_are_the_references():
    fleet = StubFleet(2, {})
    for scaler_cls, config_cls, err in (
            (AutoScaler, AutoscaleConfig, InputError),
            (RefAutoScaler, RefAutoscaleConfig, RefInputError)):
        with pytest.raises(err, match="min_workers"):
            scaler_cls(fleet, StubMonitor({}), config_cls(min_workers=0))
        with pytest.raises(err, match="max_workers"):
            scaler_cls(fleet, StubMonitor({}),
                       config_cls(min_workers=3, max_workers=2))
    assert AutoscaleConfig() == AutoscaleConfig(
        **RefAutoscaleConfig().__dict__)


def test_fault_catalog_is_the_references_less_the_tuner():
    # the tuner's site came with tune/ (tests/test_torch_tune.py fires
    # it): the catalog is now the reference's whole
    assert len(faults.FAULT_SITES) == 39
    assert set(faults.FAULT_SITES) == set(ref_faults.FAULT_SITES)
    assert set(NEW_SITES) <= set(faults.FAULT_SITES)


# -- the port's in-process fleet -------------------------------------------


R = 8


def _block(seed, e=6):
    rng = np.random.default_rng(seed)
    b = rng.choice([0.0, 1.0], size=(R, e))
    b[rng.random((R, e)) < 0.1] = np.nan
    return b


def _fleet(tmp_path, n, **worker):
    return ConsensusFleet(FleetConfig(
        n_workers=n, log_dir=str(tmp_path / "log"),
        worker=ServeConfig(warmup=(), batch_window_ms=1.0, **worker)),
        device="cpu").start(warmup=False)


def _scaler(fleet, **cfg):
    mon = StubMonitor({"p99_ms": 50.0, "queue_depth": 8.0})
    kw = dict(min_workers=1, max_workers=3, up_signals=2, down_signals=2,
              cooldown_s=1.0, warmup=False)
    kw.update(cfg)
    return AutoScaler(fleet, mon, AutoscaleConfig(**kw)), mon


def _round(front, name, k):
    front.append(name, _block(100 * k + hash(name) % 97))
    return front.submit(session=name).result(60)


def _same(a, b):
    for path, key in (("agents", "smooth_rep"), ("agents", "old_rep"),
                      ("events", "outcomes_final"),
                      ("events", "outcomes_adjusted")):
        np.testing.assert_array_equal(np.asarray(a[path][key]),
                                      np.asarray(b[path][key]))


def test_fleet_scales_up_drains_and_replaces(tmp_path):
    obs.reset()
    frd = tmp_path / "fr"
    fleet = _fleet(tmp_path, 1, flightrec_dir=str(frd))
    one = ConsensusService(ServeConfig(warmup=(), batch_window_ms=1.0),
                           device="cpu").start(warmup=False)
    names = [f"m{i}" for i in range(6)]
    try:
        scaler, mon = _scaler(fleet)
        for nm in names:
            fleet.create_session(nm, n_reporters=R)
            one.create_session(nm, R)
        for nm in names:
            _same(_round(fleet, nm, 0), _round(one, nm, 0))
        # a sustained breach: hold, then scale up with a rebalance
        mon.win = BREACHED
        assert scaler.evaluate(now=0.0)["action"] == "hold"
        up = scaler.evaluate(now=1.0)
        assert up["action"] == "scale_up" and up["worker"] == "w1"
        assert fleet.ring.workers() == ("w0", "w1")
        moved = up["sessions_rebalanced"]
        assert moved == sum(o == "w1" for o in fleet.sessions().values())
        assert moved > 0
        for nm in names:
            _same(_round(fleet, nm, 1), _round(one, nm, 1))
        # sustained idleness: the victim is the one with fewer sessions
        mon.win = IDLE
        counts = {w: sum(o == w for o in fleet.sessions().values())
                  for w in ("w0", "w1")}
        victim = min(("w0", "w1"), key=lambda w: (counts[w], -int(w[1:])))
        assert scaler.evaluate(now=2.5)["action"] == "hold"
        down = scaler.evaluate(now=3.0)
        assert down["action"] == "scale_down" and down["drained"]
        assert down["worker"] == victim
        assert down["sessions_migrated"] == counts[victim]
        assert victim not in fleet.ring.workers()
        for nm in names:
            _same(_round(fleet, nm, 2), _round(one, nm, 2))
        # grow again, then a death below target is replaced at once
        mon.win = BREACHED
        scaler.evaluate(now=5.0)
        assert scaler.evaluate(now=6.0)["action"] == "scale_up"
        assert scaler.status()["target"] == 2
        dead = fleet.ring.workers()[-1]
        fleet.kill_worker(dead)
        mon.win = MID
        rep = scaler.evaluate(now=6.1)      # inside the cool-down
        assert rep["action"] == "replace" and rep["worker"] == "w3"
        assert rep["worker"] != dead and "sessions_rebalanced" not in rep
        assert len(fleet.ring.workers()) == 2
        for nm in names:
            _same(_round(fleet, nm, 3), _round(one, nm, 3))
    finally:
        fleet.close(drain=True)
        one.close(drain=True)
    for action, n in (("scale_up", 2), ("scale_down", 1), ("replace", 1)):
        assert obs.value("pyconsensus_autoscale_decisions_total",
                         action=action) == n
    assert obs.value("pyconsensus_autoscale_target_workers") == 2
    dumps = [r["reason"] for r in read_flight_dir(frd / "autoscaler")]
    assert dumps == ["autoscale.scale_up", "autoscale.scale_down",
                     "autoscale.scale_up", "autoscale.replace"]
    router = [r["reason"] for r in read_flight_dir(frd / "router")]
    assert router == ["drain", "takeover"]


@pytest.mark.parametrize("site,window,n", [
    ("autoscale.decide", MID, 2),
    ("autoscale.spawn", BREACHED, 1),
    ("autoscale.drain", IDLE, 2)])
def test_each_site_costs_one_period(tmp_path, site, window, n):
    obs.reset()
    fleet = _fleet(tmp_path, n)
    try:
        fleet.create_session("m", n_reporters=R)
        _round(fleet, "m", 0)
        scaler, mon = _scaler(fleet, up_signals=1, down_signals=1,
                              cooldown_s=0.0)
        mon.win = window
        before = fleet.ring.workers()
        plan = faults.FaultPlan(seed=0, rules=[
            {"site": site, "kind": "raise", "occurrences": [0],
             "args": {"error": "os_error"}}])
        with faults.armed(plan):
            d = scaler.evaluate(now=0.0)
            assert plan.fired == [(site, 0, "raise")]
            assert d["action"] == "error" and "OSError" in d["error"]
            assert fleet.ring.workers() == before   # nothing half-done
            # the decide site fires before the first read of the ring
            assert scaler.status()["target"] == (
                None if site == "autoscale.decide" else n)
            nxt = scaler.evaluate(now=1.0)
        want = {"autoscale.decide": "hold", "autoscale.spawn": "scale_up",
                "autoscale.drain": "scale_down"}[site]
        assert nxt["action"] == want
        assert obs.value("pyconsensus_autoscale_decisions_total",
                         action="error") == 1
        _round(fleet, "m", 1)
    finally:
        fleet.close(drain=True)


def test_background_loop_scales_on_a_live_monitor(tmp_path):
    """``run_in_thread`` over a real ``SloMonitor`` sampling the
    process registry: an impossible p50 target breaches as soon as
    requests complete, and the loop grows the fleet by itself."""
    import time

    obs.reset()
    fleet = _fleet(tmp_path, 1)
    slo = obs.SloMonitor(targets={"p50_ms": 1e-6}, window_s=5.0)
    scaler = AutoScaler(fleet, slo, AutoscaleConfig(
        min_workers=1, max_workers=2, interval_s=0.05, up_signals=2,
        cooldown_s=0.1, warmup=False))
    try:
        slo.run_in_thread(interval_s=0.05)
        scaler.run_in_thread()
        assert scaler.run_in_thread() is scaler      # idempotent
        deadline = time.monotonic() + 60
        while (len(fleet.ring.workers()) < 2
               and time.monotonic() < deadline):
            fleet.submit(reports=_block(1)).result(60)
        assert fleet.ring.workers() == ("w0", "w1")
    finally:
        scaler.stop()
        slo.stop()
        fleet.close(drain=True)
    assert scaler.status()["last_decision"]["action"] in ("hold",
                                                          "scale_up")


def test_a_moved_session_answers_its_fence_on_the_old_worker(tmp_path):
    """A resolve that reaches a session's old worker after a rebalance or
    drain moved it (queued there under traffic) answers the retryable
    fence error, not "unknown session" (PYC101), so a client retries it
    onto the new owner; the name served again where it returns."""
    from pyconsensus_tpu_torch.faults import ConsensusError
    from pyconsensus_tpu_torch.serve.loadgen import RETRYABLE_CODES

    fleet = _fleet(tmp_path, 2)
    try:
        fleet.create_session("m", n_reporters=R)
        _round(fleet, "m", 0)
        src = fleet.owner_of("m")
        dst = next(w for w in fleet.workers if w != src)
        assert fleet.migrate_session("m", dst) == dst
        with pytest.raises(ConsensusError) as ei:   # at submit or result
            fleet.workers[src].service.submit(session="m").result(60)
        assert ei.value.error_code in RETRYABLE_CODES
        assert fleet.migrate_session("m", src) == src
        _round(fleet, "m", 1)
    finally:
        fleet.close(drain=True)
