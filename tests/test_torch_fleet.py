"""The port's replicated serve fleet (``pyconsensus_tpu_torch.serve``:
``placement``, ``failover``, ``fleet``, ``transport``) against the JAX
package's, on the CPU in float64.

- placement: every key of a 10,000-key corpus lands on the reference's
  worker for 1 to 8 workers; a removal moves only the dead worker's keys
  and adding it back restores the placement;
- logs across packages: a durable session the reference's fleet drove
  verifies and replays in the port mid-round, its resumed resolves equal
  the reference's never-killed run (outcomes and iterations exact,
  ``smooth_rep`` within ``REF_ATOL``), the port's journal names the
  reference's SHA-256 digests, and a torn or corrupt log is refused with
  PYC301 naming the field the reference names;
- any kill point within the port: killing the owner at each point of a
  session's traffic resumes bit for bit the never-killed run; a real
  ``kill -9`` of ``tests/torch_fleet_worker.py`` replays bit for bit;
- stateless parity: the fleet against the reference's direct ``Oracle``
  on the canonical and collusion corpora, binary and scaled (the serve
  tier's bands of ``tests/test_torch_serve.py``);
- shedding and failover: a kill mid-traffic loses nothing, a result that
  lands after the fence is never delivered, an empty fleet sheds PYC503;
- the five fleet fault sites fire at the same occurrences in both
  packages, and ``merge_snapshot`` / ``absorb`` give the reference's
  merged snapshot.

Every wait takes a timeout; the heartbeat monitor runs only in the test
about it.
"""

import json
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from conftest import collusion_reports
from pyconsensus_tpu import Oracle as RefOracle
from pyconsensus_tpu import faults as ref_faults
from pyconsensus_tpu.obs.metrics import MetricsRegistry as RefRegistry
from pyconsensus_tpu.serve import ConsensusFleet as RefFleet
from pyconsensus_tpu.serve import DurableSession as RefDurable
from pyconsensus_tpu.serve import FleetConfig as RefFleetConfig
from pyconsensus_tpu.serve import HashRing as RefRing
from pyconsensus_tpu.serve import MarketSession as RefSession
from pyconsensus_tpu.serve import ReplicationLog as RefLog
from pyconsensus_tpu.serve import ServeConfig as RefServeConfig
from pyconsensus_tpu_torch import Oracle, faults, obs
from pyconsensus_tpu_torch.faults import (CheckpointCorruptionError,
                                          FailoverInProgressError,
                                          InputError, PlacementError,
                                          ServiceOverloadError,
                                          WorkerLostError)
from pyconsensus_tpu_torch.obs.metrics import MetricsRegistry
from pyconsensus_tpu_torch.serve import (ConsensusFleet, ConsensusService,
                                         DurableSession, FleetConfig,
                                         HashRing, LoadGenerator,
                                         MarketSession, ReplicationLog,
                                         ServeConfig, replay_session)
from pyconsensus_tpu_torch.serve.queue import ResolveRequest
from pyconsensus_tpu_torch.serve.transport import (SocketTransport,
                                                   resolve_transport)
from test_oracle import CANONICAL, MISSING, SCALED_BOUNDS, SCALED_REPORTS
from torch_fleet_worker import BLOCKS_PER_ROUND, N_REPORTERS, make_block
from torch_witness import (  # noqa: F401
    torch_lock_witness, torch_protocol_witness, torch_digest_witness)


@pytest.fixture(autouse=True)
def _witnessed(torch_lock_witness,
               torch_protocol_witness,
               torch_digest_witness):
    """Every test here runs under the port's lock, protocol and digest
    witnesses (the counterpart of the reference's test_fleet opt-in)."""
    yield


HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
#: continuous keys against the reference (float64; two eigensolvers)
REF_ATOL = 1e-9
#: the first loading (the padded power loops may exit a sweep apart:
#: ``tests/test_torch_serve.py`` LOADING_ATOL)
LOADING_ATOL = 1e-8
#: an unscaled outcome may be one fused multiply-add apart: an ulp of
#: values up to 20,000 (``SCALED_BOUNDS``)
UNSCALE_ATOL = 2e4 * 2.0 ** -52
NEW_SITES = ("fleet.route", "fleet.heartbeat", "fleet.takeover",
             "fleet.ledger_replay", "state.migrate")
N_ROUNDS = 3
#: wait bound of every future in this file
WAIT_S = 60


@pytest.fixture(autouse=True)
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def port_fleet(tmp_path, n=3, **kw):
    return ConsensusFleet(FleetConfig(
        n_workers=n, log_dir=str(tmp_path / "log"),
        worker=ServeConfig(warmup=(), batch_window_ms=1.0), **kw),
        device="cpu")


def ref_fleet(tmp_path, n=3, **kw):
    return RefFleet(RefFleetConfig(
        n_workers=n, log_dir=str(tmp_path / "log"),
        worker=RefServeConfig(warmup=(), batch_window_ms=1.0), **kw))


def all_ops():
    ops = []
    for k in range(N_ROUNDS):
        for j in range(BLOCKS_PER_ROUND):
            ops.append(("append", k, j))
        ops.append(("resolve", k))
    return ops


def never_killed(n_rounds=N_ROUNDS):
    """The port's single-worker run of the same traffic."""
    session = MarketSession("ref", N_REPORTERS, device="cpu")
    out = []
    for k in range(n_rounds):
        for j in range(BLOCKS_PER_ROUND):
            session.append(make_block(k, j))
        out.append(session.resolve())
    return out, session


def nested_bits(result):
    """The bit-identity tuple of a served (nested) result."""
    return (np.asarray(result["agents"]["smooth_rep"]),
            np.asarray(result["events"]["outcomes_final"]),
            np.asarray(result["events"]["outcomes_adjusted"]),
            int(result["iterations"]),
            np.asarray(result["agents"]["old_rep"]),
            np.asarray(result["certainty"]))


def flat_bits(result):
    """The same tuple of a flat light result dict."""
    return (np.asarray(result["smooth_rep"]),
            np.asarray(result["outcomes_final"]),
            np.asarray(result["outcomes_adjusted"]),
            int(np.asarray(result["iterations"])),
            np.asarray(result["old_rep"]),
            np.asarray(result["avg_certainty"]))


def assert_same_bits(got, want, msg=""):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=msg)


def retrying(fn, attempts=40):
    """Call ``fn`` through the retryable fleet sheds (PYC501/502)."""
    for _ in range(attempts):
        try:
            return fn()
        except (WorkerLostError, FailoverInProgressError) as exc:
            time.sleep(min(0.5, exc.context.get("retry_after_s", 0.05)))
    raise AssertionError("the fleet never served the request")


# -- placement -------------------------------------------------------------

KEYS = [f"session-{i}" for i in range(10_000)]


@pytest.mark.parametrize("n", range(1, 9))
def test_every_key_lands_on_the_references_worker(n):
    names = [f"w{i}" for i in range(n)]
    ours, ref = HashRing(names), RefRing(list(reversed(names)))
    assert [ours.owner(k) for k in KEYS] == [ref.owner(k) for k in KEYS]
    assert [ours.preference(k) for k in KEYS[:500]] == \
        [ref.preference(k) for k in KEYS[:500]]


@pytest.mark.parametrize("n", [2, 3, 8])
def test_removal_moves_only_the_dead_workers_keys(n):
    names = [f"w{i}" for i in range(n)]
    ring = HashRing(names)
    before = {k: ring.owner(k) for k in KEYS}
    victim = "w1"
    moved = ring.moved_keys(KEYS, victim)
    assert set(moved) == {k for k, o in before.items() if o == victim}
    ring.remove(victim)
    ref = RefRing([w for w in names if w != victim])
    for k in KEYS:
        after = ring.owner(k)
        assert after == ref.owner(k)
        if before[k] != victim:
            assert after == before[k], k
        else:
            assert after != victim
    ring.add(victim)
    assert {k: ring.owner(k) for k in KEYS} == before


def test_ring_refusals():
    ring = HashRing()
    with pytest.raises(PlacementError) as ei:
        ring.owner("k")
    assert ei.value.error_code == "PYC503"
    with pytest.raises(PlacementError):
        HashRing(vnodes=0)
    ring.remove("nobody")                  # a no-op, as the reference's
    assert len(ring) == 0


# -- metrics merge ----------------------------------------------------------


def _emit(registry):
    c = registry.counter("req_total", "requests", labels=("path",))
    c.inc(3, path="a")
    c.inc(path="b")
    registry.gauge("depth", "queue depth").set(7)
    h = registry.histogram("lat_seconds", "latency", labels=("path",))
    for v in (0.0004, 0.02, 3.0, 100.0):
        h.observe(v, path="a")
    hb = registry.histogram("beat_seconds", "beat", labels=("worker",),
                            buckets=(0.1, 1.0))
    hb.observe(0.5, worker="w9")
    registry.histogram("empty_seconds", "never observed")


def test_merge_snapshot_and_absorb_match_the_reference():
    ours_src, ref_src = MetricsRegistry(), RefRegistry()
    _emit(ours_src)
    _emit(ref_src)
    assert ours_src.snapshot() == ref_src.snapshot()
    ours, ref = MetricsRegistry(), RefRegistry()
    for reg, src in ((ours, ours_src), (ref, ref_src)):
        reg.merge_snapshot(src.snapshot(), worker="router")
        reg.merge_snapshot(src.snapshot(), worker="w0")
        reg.merge_snapshot(src.snapshot(), worker="w0")   # counters add
        reg.merge_snapshot({"legacy": {"kind": "histogram", "labels": [],
                                       "series": {"": {"sum": 1.0,
                                                       "count": 1}}}},
                           worker="w1")                   # skipped
    assert ours.snapshot() == ref.snapshot()
    assert ours.render_prom() == ref.render_prom()
    assert ours.value("req_total", path="a", worker="w0") == 6.0
    # the metric that already carries ``worker`` keeps its own label
    assert ours.value("beat_seconds", worker="w9")["count"] == 3
    for reg in (ours, ref):
        with pytest.raises(ValueError, match="cannot absorb"):
            reg.get("lat_seconds").absorb([1, 2], 1.0, 3, path="a",
                                          worker="w0")


class _OwnRegistryWorker:
    """A worker handle with a registry of its own (as a worker process
    would have): the merged view labels its series with its name."""

    shares_process_registry = False

    def __init__(self, name, snapshot):
        self.name, self._snapshot = name, snapshot

    def metrics_snapshot(self):
        return {"worker": self.name, "metrics": self._snapshot}


def test_fleet_merged_view_labels_every_worker(tmp_path):
    remote = MetricsRegistry()
    remote.counter("pyconsensus_serve_requests_total", "requests",
                   labels=("path", "outcome")).inc(path="bucket",
                                                   outcome="ok")
    with port_fleet(tmp_path, n=2) as fleet:
        for _ in range(3):
            fleet.submit(reports=np.ones((4, 4)),
                         backend="numpy").result(WAIT_S)
    # read after the drain: every batcher has counted its requests
    process = obs.REGISTRY.snapshot()
    snap = fleet.merged_snapshot()
    text = fleet.render_metrics()
    fleet.workers["remote"] = _OwnRegistryWorker("remote",
                                                 remote.snapshot())
    with_remote = fleet.merged_snapshot()

    def by_worker(view):
        totals = {}
        for k, v in view["pyconsensus_serve_requests_total"][
                "series"].items():
            w = json.loads(k)["worker"]
            totals[w] = totals.get(w, 0.0) + v
        return totals

    # in-process workers share the process registry: it enters once, so
    # the merged view counts every request once
    want = sum(process["pyconsensus_serve_requests_total"][
        "series"].values())
    assert want >= 3
    assert by_worker(snap) == {"router": want}
    assert 'worker="router"' in text and 'worker="w0"' not in text
    # a worker with a registry of its own is merged under its name
    assert by_worker(with_remote) == {"router": want, "remote": 1.0}


# -- the fault sites ----------------------------------------------------------


def _site_scenario(make, fault_mod, root, site, **extra):
    """The same fleet traffic under a seeded rule on ``site``: sessions,
    stateless requests, liveness scans, two kills and live migrations.
    Returns the activations and every operation's outcome."""
    plan = fault_mod.FaultPlan(seed=5, rules=[
        {"site": site, "kind": "raise", "probability": 0.5,
         "max_fires": 0, "args": {"error": "os_error"}}])
    m = np.random.default_rng(3).choice([0.0, 1.0], size=(8, 6))
    fleet = make(n_workers=4, log_dir=str(root),
                 heartbeat_timeout_s=600.0, **extra).start(warmup=False)
    log = []

    def op(name, fn):
        try:
            log.append((name, "ok", fn()))
        except Exception as exc:  # noqa: BLE001 — the outcome is compared
            log.append((name, type(exc).__name__,
                        getattr(exc, "error_code", None)))
    try:
        with fault_mod.armed(plan):
            for i in range(6):
                op(f"create s{i}", lambda i=i: fleet.create_session(
                    f"s{i}", n_reporters=8))
            for i in range(8):
                op("submit", lambda: int(fleet.submit(
                    reports=m, backend="numpy").result(WAIT_S)[
                        "iterations"]))
            for _ in range(3):
                op("scan", fleet.check_workers)
            for w in ("w0", "w1"):
                op(f"kill {w}", lambda w=w: sorted(
                    fleet.kill_worker(w)["sessions_migrated"]))
            for i in range(6):
                op(f"migrate s{i}",
                   lambda i=i: fleet.migrate_session(f"s{i}", "w3"))
        log.append(("sessions", fleet.sessions()))
    finally:
        fleet.close(drain=True)
    return plan.fired, log


@pytest.mark.parametrize("site", NEW_SITES)
def test_fleet_sites_fire_as_the_references(tmp_path, site):
    def ours(**kw):
        return ConsensusFleet(FleetConfig(
            worker=ServeConfig(warmup=(), batch_window_ms=1.0), **kw),
            device="cpu")

    def ref(**kw):
        return RefFleet(RefFleetConfig(
            worker=RefServeConfig(warmup=(), batch_window_ms=1.0), **kw))

    got = _site_scenario(ours, faults, tmp_path / "ours", site)
    want = _site_scenario(ref, ref_faults, tmp_path / "ref", site)
    assert got[0], f"{site} never fired"
    assert got == want


def test_catalog_has_the_fleet_sites():
    # the fleet's five, since the socket transport its four
    # (tests/test_torch_transport.py fires them), since the state plane
    # its five (tests/test_torch_stateplane.py,
    # tests/test_torch_aotcache.py), since the autoscaler and the
    # economy their six (tests/test_torch_autoscale.py,
    # tests/test_torch_econ.py), and since the tuner its one
    # (tests/test_torch_tune.py): the reference's 39
    assert len(faults.FAULT_SITES) == 39
    assert set(faults.FAULT_SITES) == set(ref_faults.FAULT_SITES)
    assert set(NEW_SITES) <= set(faults.FAULT_SITES)
    assert set(faults.FAULT_SITES) <= set(ref_faults.FAULT_SITES)


# -- replication logs across packages --------------------------------------


def _ref_fleet_log(tmp_path):
    """A durable session the reference's fleet drove: round 0 (two
    appends and a resolve) and round 1's first append; the fleet is then
    abandoned. Returns the log root."""
    fleet = ref_fleet(tmp_path, n=2).start(warmup=False)
    try:
        fleet.create_session("mkt", n_reporters=N_REPORTERS)
        for j in range(BLOCKS_PER_ROUND):
            fleet.append("mkt", make_block(0, j))
        fleet.submit(session="mkt").result(WAIT_S)
        fleet.append("mkt", make_block(1, 0))
    finally:
        fleet.close(drain=True)
    return tmp_path / "log"


def test_reference_log_verifies_and_replays_in_the_port(tmp_path):
    root = _ref_fleet_log(tmp_path)
    summary = ReplicationLog(root, "mkt").verify()
    assert summary == RefLog(root, "mkt").verify()
    assert summary["round"] == 1 and summary["staged_blocks"] == 1
    standby = replay_session(root, "mkt", device="cpu")
    assert standby.ledger.round == 1 and len(standby._blocks) == 1
    got = []
    for k in range(1, N_ROUNDS):
        for j in range(len(standby._blocks), BLOCKS_PER_ROUND):
            standby.append(make_block(k, j))
        got.append(standby.resolve())
    ref_session = RefSession("ref", N_REPORTERS)
    want = []
    for k in range(N_ROUNDS):
        for j in range(BLOCKS_PER_ROUND):
            ref_session.append(make_block(k, j))
        want.append(ref_session.resolve())
    for g, w in zip(got, want[1:]):
        for key in ("outcomes_final", "outcomes_adjusted", "na_row"):
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]), err_msg=key)
        assert int(np.asarray(g["iterations"])) == \
            int(np.asarray(w["iterations"]))
        np.testing.assert_allclose(np.asarray(g["smooth_rep"]),
                                   np.asarray(w["smooth_rep"]),
                                   atol=REF_ATOL, rtol=0)


def test_journal_names_the_references_digests(tmp_path):
    scaled = make_block(5, 0)
    scaled[:, 4] = np.where(np.isnan(scaled[:, 4]), np.nan,
                            scaled[:, 4] * 17.5 + 1.25)
    bounds = [None] * 4 + [{"scaled": True, "min": 0.0, "max": 20.0}]
    appends = [(make_block(0, 0), None, None),
               (scaled, bounds, "client-7:1"),
               (make_block(0, 1)[:, :3], None, "client-7:2")]
    ref = RefDurable.create(tmp_path / "ref", "s", N_REPORTERS)
    ours = DurableSession.create(tmp_path / "ours", "s", N_REPORTERS,
                                 device="cpu")
    for block, bnd, aid in appends:
        ref.append(block, bnd, append_id=aid)
        ours.append(block, bnd, append_id=aid)
    assert ours.append(scaled, bounds, append_id="client-7:1") == \
        ref.append(scaled, bounds, append_id="client-7:1")   # deduped
    for i in range(len(appends)):
        with np.load(ref.log._block_path(0, i)) as a, \
                np.load(ours.log._block_path(0, i)) as b:
            assert sorted(a.files) == sorted(b.files)
            for f in a.files:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    with np.load(ref.log.ledger_path) as a, \
            np.load(ours.log.ledger_path) as b:
        assert sorted(a.files) == sorted(b.files)
        np.testing.assert_array_equal(a["reputation"], b["reputation"])
    assert json.loads(ref.log.meta_path.read_text()) == \
        json.loads(ours.log.meta_path.read_text())


def _corrupt(log, how):
    block0 = log._block_path(1, 0)
    if how == "torn_block":
        raw = block0.read_bytes()
        block0.write_bytes(raw[: len(raw) // 2])
    elif how == "tampered_block":
        with np.load(block0) as data:
            state = {k: np.array(data[k]) for k in data.files}
        state["block"][0, 0] = 0.5
        np.savez(block0, **state)
    elif how == "missing_field":
        with np.load(block0) as data:
            state = {k: np.array(data[k]) for k in data.files
                     if k != "digest"}
        np.savez(block0, **state)
    elif how == "index_gap":
        block0.unlink()
    elif how == "torn_ledger":
        raw = log.ledger_path.read_bytes()
        log.ledger_path.write_bytes(raw[:40])
    elif how == "ledger_field":
        with np.load(log.ledger_path) as data:
            state = {k: np.array(data[k]) for k in data.files
                     if k != "round"}
        np.savez(log.ledger_path, **state)
    elif how == "nonfinite_reputation":
        with np.load(log.ledger_path) as data:
            state = {k: np.array(data[k]) for k in data.files}
        state["reputation"][2] = np.nan
        np.savez(log.ledger_path, **state)
    elif how == "roster_mismatch":
        meta = json.loads(log.meta_path.read_text())
        meta["n_reporters"] += 1
        log.meta_path.write_text(json.dumps(meta))
    elif how == "meta_field":
        meta = json.loads(log.meta_path.read_text())
        del meta["alpha"]
        log.meta_path.write_text(json.dumps(meta))
    elif how == "meta_json":
        log.meta_path.write_text("{not json")


@pytest.mark.parametrize("how", [
    "torn_block", "tampered_block", "missing_field", "index_gap",
    "torn_ledger", "ledger_field", "nonfinite_reputation",
    "roster_mismatch", "meta_field", "meta_json"])
def test_corrupt_log_refused_as_the_reference_refuses(tmp_path, how):
    session = RefDurable.create(tmp_path, "s", N_REPORTERS)
    for k in range(2):
        for j in range(BLOCKS_PER_ROUND):
            session.append(make_block(k, j))
        if k == 0:
            session.resolve()
    _corrupt(RefLog(tmp_path, "s"), how)
    with pytest.raises(ref_faults.CheckpointCorruptionError) as want:
        RefLog(tmp_path, "s").verify()
    with pytest.raises(CheckpointCorruptionError) as got:
        ReplicationLog(tmp_path, "s").verify()
    assert got.value.error_code == want.value.error_code == "PYC301"
    assert got.value.context.get("field") == \
        want.value.context.get("field")
    assert str(got.value) == str(want.value)
    with pytest.raises(CheckpointCorruptionError):
        replay_session(tmp_path, "s", device="cpu")


def test_compacted_log_refused_naming_the_roadmap(tmp_path):
    """Compaction is ported (``serve/stateplane.py``): a compacted log
    replays bit for bit the full journal, and an empty snapshot file over
    an intact journal is refused and ignored, not a refusal of the log
    (``tests/test_torch_stateplane.py`` holds the crash matrix)."""
    session = DurableSession.create(tmp_path, "s", N_REPORTERS,
                                    device="cpu")
    for j in range(BLOCKS_PER_ROUND):
        session.append(make_block(0, j))
    for copy in ("full", "torn"):
        shutil.copytree(tmp_path / "s", tmp_path / copy / "s")
    assert session.compact()["records_removed"] == BLOCKS_PER_ROUND
    want = replay_session(tmp_path / "full", "s", device="cpu").resolve()
    assert_same_bits(flat_bits(replay_session(tmp_path, "s",
                                              device="cpu").resolve()),
                     flat_bits(want))
    torn = ReplicationLog(tmp_path / "torn", "s")
    torn.snapshot_path.write_bytes(b"")
    assert "refused" in torn.verify()["snapshot"]
    assert_same_bits(flat_bits(replay_session(tmp_path / "torn", "s",
                                              device="cpu").resolve()),
                     flat_bits(want))


# -- durability within the port -----------------------------------------------


@pytest.mark.parametrize("kill_at", range(len(all_ops()) + 1))
def test_any_kill_point_resumes_bit_identical(tmp_path, kill_at):
    """Kill the owning worker before op ``kill_at`` (after the last op
    for the largest): the takeover-resumed resolves and the carried
    reputation equal the never-killed single-worker run bit for bit."""
    want, ref_session = never_killed()
    fleet = port_fleet(tmp_path).start(warmup=False)
    try:
        fleet.create_session("s", n_reporters=N_REPORTERS)
        got = []
        for i, op in enumerate(all_ops()):
            if i == kill_at:
                victim = fleet.owner_of("s")
                info = fleet.kill_worker(victim)
                assert info["sessions_migrated"] == [
                    ("s", fleet.owner_of("s"))]
            if op[0] == "append":
                fleet.append("s", make_block(op[1], op[2]))
            else:
                got.append(fleet.submit(session="s").result(WAIT_S))
        if kill_at == len(all_ops()):
            fleet.kill_worker(fleet.owner_of("s"))
        state = fleet.session_state("s")
    finally:
        fleet.close(drain=True)
    assert len(got) == N_ROUNDS
    for g, w in zip(got, want):
        assert_same_bits(nested_bits(g), flat_bits(w), f"kill_at={kill_at}")
    np.testing.assert_array_equal(state["reputation"],
                                  ref_session.reputation)
    assert state["rounds_resolved"] == N_ROUNDS


def test_crash_before_commit_re_resolves_identically(tmp_path):
    session = DurableSession.create(tmp_path / "a", "s", N_REPORTERS,
                                    device="cpu")
    for j in range(BLOCKS_PER_ROUND):
        session.append(make_block(0, j))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    want = session.resolve()
    standby = replay_session(tmp_path / "b", "s", device="cpu")
    assert standby.ledger.round == 0
    assert_same_bits(flat_bits(standby.resolve()), flat_bits(want))


def test_failed_commit_fences_and_refused_append_leaves_no_record(
        tmp_path, monkeypatch):
    session = DurableSession.create(tmp_path, "s", N_REPORTERS,
                                    device="cpu")
    session.append(make_block(0, 0))
    with pytest.raises(InputError):
        session.append(make_block(0, 1), event_bounds=[None] * 99)
    assert len(session.log.staged(0)) == 1

    def boom(ledger):
        raise OSError("disk full")
    monkeypatch.setattr(session.log, "commit_round", boom)
    with pytest.raises(OSError):
        session.resolve()
    with pytest.raises(CheckpointCorruptionError, match="fenced"):
        session.append(make_block(0, 1))
    # the durable log replays the round the commit lost
    standby = replay_session(tmp_path, "s", device="cpu")
    assert standby.ledger.round == 0 and len(standby._blocks) == 1


def test_real_kill_minus_nine_replays_bit_identical(tmp_path):
    """``tests/torch_fleet_worker.py`` drives a durable session as a real
    process; SIGKILLed inside round 1, a standby (this process) verifies
    and replays the log and finishes the rounds bit for bit the
    never-killed run."""
    log_root = tmp_path / "log"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_fleet_worker.py"),
         str(log_root), "mkt", "4", "0.1"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    seen = []
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                line = lines.get(timeout=max(0.0, deadline
                                             - time.monotonic()))
            except queue.Empty:
                pytest.fail("worker never reached round 1:\n"
                            + "".join(seen))
            seen.append(line)
            if line.startswith("APPEND 1"):
                break
            if line.startswith("DONE") or "Error" in line:
                pytest.fail("worker did not stop in round 1:\n"
                            + "".join(seen))
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    reader.join(timeout=10)

    standby = replay_session(log_root, "mkt", device="cpu")
    assert standby.ledger.round >= 1
    got = []
    for k in range(standby.ledger.round, 4):
        for j in range(len(standby._blocks), BLOCKS_PER_ROUND):
            standby.append(make_block(k, j))
        got.append(standby.resolve())
    want, ref_session = never_killed(4)
    for g, w in zip(got, want[-len(got):]):
        assert_same_bits(flat_bits(g), flat_bits(w))
    np.testing.assert_array_equal(standby.reputation,
                                  ref_session.reputation)
    assert standby.ledger.round == 4


# -- stateless parity ------------------------------------------------------


def _corpus(name):
    rng = np.random.default_rng(31)
    if name == "canonical":
        return CANONICAL, None
    if name == "missing":
        return MISSING, None
    if name == "scaled":
        return SCALED_REPORTS, SCALED_BOUNDS
    if name == "collusion":
        return collusion_reports(rng, 23, 70, liars=5, na_frac=0.12)[0], None
    reports, _ = collusion_reports(rng, 19, 60, liars=4, na_frac=0.1)
    bounds = [None] * 60
    for c in (3, 17, 41, 58):
        bounds[c] = {"scaled": True, "min": -5.0, "max": 15.0}
        with np.errstate(invalid="ignore"):
            reports[:, c] = reports[:, c] * 20.0 - 5.0
    return reports, bounds


def _assert_parity(got, ref, bounds, what):
    E = len(ref["events"]["outcomes_final"])
    scaled = np.array([bool(b and b.get("scaled"))
                       for b in (bounds or [None] * E)])
    for key in ("outcomes_final", "outcomes_adjusted"):
        a = np.asarray(got["events"][key])
        b = np.asarray(ref["events"][key])
        np.testing.assert_allclose(a[scaled], b[scaled], rtol=0,
                                   atol=UNSCALE_ATOL, err_msg=key)
        np.testing.assert_array_equal(a[~scaled], b[~scaled], err_msg=key)
    assert got["iterations"] == ref["iterations"], what
    assert got["convergence"] == ref["convergence"], what
    for group in ("agents", "events"):
        for key, v in ref[group].items():
            if key in ("outcomes_final", "outcomes_adjusted", "na_row"):
                continue
            a = np.asarray(got[group][key], dtype=np.float64)
            b = np.asarray(v, dtype=np.float64)
            atol = REF_ATOL
            if key == "adj_first_loadings":
                a, b, atol = np.abs(a), np.abs(b), LOADING_ATOL
            np.testing.assert_allclose(a, b, atol=atol, rtol=0,
                                       err_msg=f"{what} {key}")


@pytest.mark.parametrize("name", ["canonical", "missing", "scaled",
                                  "collusion", "collusion_scaled"])
def test_fleet_results_equal_the_references_direct_oracle(tmp_path, name):
    reports, bounds = _corpus(name)
    ref = RefOracle(reports=reports, event_bounds=bounds, backend="jax",
                    pca_method="power").consensus()
    port = Oracle(reports=reports, event_bounds=bounds, device="cpu",
                  pca_method="power").consensus()
    with port_fleet(tmp_path) as fleet:
        futs = [fleet.submit(reports=reports, event_bounds=bounds)
                for _ in range(6)]
        results = [f.result(WAIT_S) for f in futs]
    for got in results:
        _assert_parity(got, ref, bounds, name)
        _assert_parity(got, port, bounds, name)


def test_numpy_backend_through_the_fleet_is_the_references(tmp_path):
    reports, _ = _corpus("collusion")
    ref = RefOracle(reports=reports, backend="numpy").consensus()
    with port_fleet(tmp_path) as fleet:
        got = fleet.resolve(reports=reports, backend="numpy",
                            timeout=WAIT_S)
    for group in ("agents", "events"):
        for key, v in ref[group].items():
            np.testing.assert_array_equal(np.asarray(got[group][key]),
                                          np.asarray(v), err_msg=key)


# -- routing, shedding and failover ----------------------------------------


class _KillAt:
    """A fleet front door that kills ``victim`` just before its
    ``at``-th submit (a kill mid-traffic at a fixed point)."""

    def __init__(self, fleet, at, victim):
        self.fleet, self.at, self.victim = fleet, at, victim
        self.n = 0
        self.lock = threading.Lock()
        self.killed = None

    def submit(self, **kw):
        with self.lock:
            self.n += 1
            if self.n == self.at:
                self.killed = self.fleet.kill_worker(self.victim)
        return self.fleet.submit(**kw)


def test_kill_mid_traffic_loses_nothing(tmp_path):
    fleet = port_fleet(tmp_path).start(warmup=False)
    front = _KillAt(fleet, 16, "w1")
    try:
        gen = LoadGenerator(front, shapes=((12, 48), (24, 96)),
                            na_frac=0.1, seed=3, max_retries=6,
                            retry_cap_s=0.5)
        stats = gen.run_closed(48, concurrency=6, timeout_s=WAIT_S)
        status = fleet.status()
    finally:
        fleet.close(drain=True)
    assert front.killed is not None
    assert stats["succeeded"] == 48, stats
    assert stats["failed"] == 0 and stats["abandoned"] == 0, stats
    assert not status["workers"]["w1"]["alive"]
    assert status["alive"] == 2


def test_kill_mid_traffic_results_are_single_box_bits(tmp_path):
    """Concurrent stateless and session traffic through a kill: every
    request resolves to the single-worker bits or sheds retryably."""
    rng = np.random.default_rng(9)
    mats = [collusion_reports(rng, 14, 40, liars=3, na_frac=0.1)[0]
            for _ in range(4)]
    with ConsensusService(ServeConfig(), device="cpu") as svc:
        want = [svc.resolve(reports=m, timeout=WAIT_S) for m in mats]
    fleet = port_fleet(tmp_path).start(warmup=False)
    fleet.create_session("chaos", n_reporters=N_REPORTERS)
    results, errors = [], []
    lock = threading.Lock()
    started = threading.Event()

    def client(c):
        for i in range(8):
            if i == 3:
                started.set()
            m = (c + i) % len(mats)
            for _ in range(8):
                try:
                    r = fleet.submit(reports=mats[m]).result(WAIT_S)
                    with lock:
                        results.append((m, r))
                    break
                except (WorkerLostError, FailoverInProgressError,
                        ServiceOverloadError) as exc:
                    with lock:
                        errors.append(exc)
                    time.sleep(min(0.5, exc.context.get("retry_after_s",
                                                        0.05)))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(4)]
    try:
        for t in threads:
            t.start()
        assert started.wait(timeout=WAIT_S)
        victim = fleet.owner_of("chaos")
        fleet.kill_worker(victim)
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert fleet.owner_of("chaos") != victim
        for k in range(2):
            for j in range(BLOCKS_PER_ROUND):
                retrying(lambda: fleet.append("chaos", make_block(k, j)))
            retrying(lambda: fleet.submit(session="chaos").result(WAIT_S))
    finally:
        fleet.close(drain=True)
    assert len(results) == 32
    for m, r in results:
        assert_same_bits(nested_bits(r), nested_bits(want[m]))
    for exc in errors:
        assert exc.error_code in ("PYC401", "PYC501", "PYC502"), exc


def test_result_after_the_fence_is_never_delivered(tmp_path, monkeypatch):
    """A dispatch in flight when its worker is killed finishes, but its
    caller gets the retryable PYC501, not the late result."""
    fleet = port_fleet(tmp_path, n=1).start(warmup=False)
    w = fleet.workers["w0"]
    entered, release = threading.Event(), threading.Event()
    real = w.service.batcher._dispatch_direct

    def held(req):
        entered.set()
        assert release.wait(timeout=WAIT_S)
        real(req)
    monkeypatch.setattr(w.service.batcher, "_dispatch_direct", held)
    try:
        fut = fleet.submit(reports=np.ones((4, 4)), backend="numpy")
        assert entered.wait(timeout=WAIT_S)
        fleet.kill_worker("w0")
        release.set()
        with pytest.raises(WorkerLostError) as ei:
            fut.result(timeout=WAIT_S)
        assert ei.value.context["retry_after_s"] > 0
        assert ei.value.context["worker"] == "w0"
    finally:
        release.set()
        fleet.close(drain=True)


def test_queued_requests_shed_as_worker_lost(tmp_path):
    fleet = port_fleet(tmp_path)           # not started: no batcher
    req = ResolveRequest(reports=np.ones((3, 3)))
    fleet.workers["w0"].service.queue.put(req)
    info = fleet.kill_worker("w0")
    assert info["shed_queued"] == 1
    with pytest.raises(WorkerLostError) as ei:
        req.future.result(timeout=0)
    assert ei.value.error_code == "PYC501"
    assert ei.value.context["retry_after_s"] > 0


def test_every_worker_dead_sheds_placement(tmp_path):
    fleet = port_fleet(tmp_path, n=2).start(warmup=False)
    fleet.create_session("s", n_reporters=6)
    fleet.append("s", make_block(0, 0)[:6])
    fleet.submit(session="s").result(WAIT_S)
    fleet.kill_worker("w0")
    fleet.kill_worker("w1")
    failovers = obs.value("pyconsensus_failovers_total")
    for _ in range(2):
        with pytest.raises(PlacementError) as ei:
            fleet.submit(reports=np.ones((3, 3)), backend="numpy")
        assert ei.value.error_code == "PYC503"
        with pytest.raises(PlacementError):
            fleet.submit(session="s")
    assert obs.value("pyconsensus_failovers_total") == failovers
    assert replay_session(fleet.config.log_dir, "s",
                          device="cpu").ledger.round == 1
    gen = LoadGenerator(fleet, shapes=((4, 4),), max_retries=3)
    stats = gen.run_closed(2, concurrency=1, timeout_s=WAIT_S)
    assert stats["errors"] == {"PYC503": 2} and stats["retried"] == 0
    fleet.close(drain=True)


def test_routing_taxonomy(tmp_path):
    fleet = port_fleet(tmp_path, base_retry_s=0.2)
    with pytest.raises(InputError, match="unknown fleet session"):
        fleet.submit(session="nope")
    with pytest.raises(InputError, match="exactly one"):
        fleet.submit(reports=np.ones((3, 3)), session="nope")
    with pytest.raises(PlacementError):
        fleet.kill_worker("w99")
    with pytest.raises(InputError, match="log_dir"):
        ConsensusFleet(FleetConfig(n_workers=1), device="cpu") \
            .create_session("s", n_reporters=4)
    with pytest.raises(InputError):
        ConsensusFleet(FleetConfig(n_workers=0), device="cpu")

    def full(**kw):
        raise ServiceOverloadError("full", reason="queue_full")
    for w in fleet.workers.values():
        w.service.submit = full
    fleet.kill_worker("w2")
    with pytest.raises(ServiceOverloadError) as ei:
        fleet.submit(reports=np.ones((3, 3)))
    ctx = ei.value.context
    assert ctx["reason"] == "cluster_full" and ctx["alive_workers"] == 2
    assert ctx["retry_after_s"] == pytest.approx(0.3, abs=1e-6)

    calls = []

    def limited(**kw):
        calls.append(1)
        raise ServiceOverloadError("over rate", reason="rate_limited",
                                   retry_after_s=0.1)
    for w in fleet.workers.values():
        w.service.submit = limited
    with pytest.raises(ServiceOverloadError) as ei:
        fleet.submit(reports=np.ones((3, 3)))
    assert ei.value.context["reason"] == "rate_limited" and len(calls) == 1


def test_transport_and_device_choices():
    # the socket transport resolves without spawning anything: its
    # processes start at the fleet's make_workers
    socket_transport = resolve_transport("socket")
    assert isinstance(socket_transport, SocketTransport)
    assert socket_transport.supervisor is None
    socket_transport.close()
    with pytest.raises(InputError):
        resolve_transport("carrier-pigeon")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ConsensusFleet(FleetConfig(n_workers=1))


def test_takeover_window_and_stale_object_fence(tmp_path):
    fleet = port_fleet(tmp_path).start(warmup=False)
    try:
        owner = fleet.create_session("mkt", n_reporters=N_REPORTERS)
        fleet.append("mkt", make_block(0, 0))
        fleet._migrating.add("mkt")
        fleet.capacity.begin_takeover(0.5)
        with pytest.raises(FailoverInProgressError) as ei:
            fleet.submit(session="mkt")
        assert ei.value.error_code == "PYC502"
        assert 0 < ei.value.context["retry_after_s"] <= 0.51
        fleet._migrating.discard("mkt")
        fleet.capacity.end_takeover()
        stale = fleet.workers[owner].service.sessions.get("mkt")
        fleet.kill_worker(owner)
        with pytest.raises(WorkerLostError):
            stale.append(make_block(0, 1))
        with pytest.raises(WorkerLostError):
            stale.resolve()
        fleet.append("mkt", make_block(0, 1))
        got = fleet.submit(session="mkt").result(WAIT_S)
        assert "mkt" not in fleet.workers[owner].service.sessions.names()
    finally:
        fleet.close(drain=True)
    want, _ = never_killed(1)
    assert_same_bits(nested_bits(got), flat_bits(want[0]))


def test_standby_never_adopts_a_corrupt_log(tmp_path):
    fleet = port_fleet(tmp_path).start(warmup=False)
    try:
        names = [f"m{i}" for i in range(6)]
        for n in names:
            fleet.create_session(n, n_reporters=6)
            fleet.append(n, make_block(0, 0)[:6])
            fleet.submit(session=n).result(WAIT_S)
        victim = fleet.owner_of(names[0])
        victims = [n for n in names if fleet.owner_of(n) == victim]
        torn = victims[0]
        path = ReplicationLog(fleet.config.log_dir, torn).ledger_path
        raw = path.read_bytes()
        path.write_bytes(raw[: len(raw) // 2])
        info = fleet.kill_worker(victim)
        assert {s for s, _ in info["sessions_migrated"]} == \
            set(victims) - {torn}
        with pytest.raises(CheckpointCorruptionError):
            fleet.submit(session=torn)
        assert torn in fleet.status()["failed_sessions"]
    finally:
        fleet.close(drain=True)


def test_injected_faults_on_the_takeover_path(tmp_path):
    """A ``torn_write`` at ``fleet.ledger_replay`` refuses the session
    with PYC301; a ``fleet.takeover`` fault during a routing-time
    discovery reaches the client as PYC501 and the retried route lands
    the session on the survivor."""
    fleet = port_fleet(tmp_path, n=3).start(warmup=False)
    try:
        for name in ("a", "b"):
            fleet.create_session(name, n_reporters=6)
            fleet.append(name, make_block(0, 0)[:6])
        owner = fleet.owner_of("a")
        plan = faults.FaultPlan(seed=1, rules=[
            {"site": "fleet.ledger_replay", "kind": "torn_write",
             "occurrences": [0], "args": {"keep_bytes": 40}}])
        with faults.armed(plan):
            fleet.kill_worker(owner)
        assert plan.fired == [("fleet.ledger_replay", 0, "torn_write")]
        with pytest.raises(CheckpointCorruptionError):
            fleet.submit(session="a")
        owner = fleet.owner_of("b")
        fleet.workers[owner].hard_kill(0.1)
        plan = faults.FaultPlan(seed=0, rules=[
            {"site": "fleet.takeover", "kind": "raise",
             "occurrences": [0], "args": {"error": "os_error"}}])
        with faults.armed(plan):
            with pytest.raises(WorkerLostError) as ei:
                fleet.submit(session="b")
        assert ei.value.error_code == "PYC501"
        fleet.submit(session="b").result(WAIT_S)
        assert fleet.owner_of("b") != owner
    finally:
        fleet.close(drain=True)


def test_heartbeat_flap_and_the_monitor(tmp_path):
    fleet = port_fleet(tmp_path, n=2, heartbeat_timeout_s=0.08)
    fleet.create_session("s", n_reporters=6)
    fleet.check_workers()
    plan = faults.FaultPlan(seed=0, rules=[
        {"site": "fleet.heartbeat", "kind": "raise",
         "occurrences": [0], "args": {"error": "os_error"}}])
    with faults.armed(plan):
        assert fleet.check_workers() == []      # one lost beat: tolerated
    assert fleet.workers["w0"].alive
    # the monitor declares a fenced worker dead within a few scans
    mon = port_fleet(tmp_path / "m", n=2, monitor=True,
                     heartbeat_interval_s=0.02, heartbeat_timeout_s=5.0)
    mon.start(warmup=False)
    try:
        mon.create_session("s", n_reporters=6)
        owner = mon.owner_of("s")
        mon.workers[owner].hard_kill(0.1)
        deadline = time.monotonic() + 10
        while mon.owner_of("s") == owner and time.monotonic() < deadline:
            time.sleep(0.02)
        assert mon.owner_of("s") != owner
    finally:
        mon.close(drain=True)
    assert mon._monitor is None


def test_elastic_membership_keeps_the_bits(tmp_path):
    """``add_worker``, ``rebalance_to``, ``migrate_session`` and
    ``drain_worker`` move sessions between live workers with every round
    still the never-killed run's bits."""
    want, _ = never_killed(2)
    fleet = port_fleet(tmp_path, n=2).start(warmup=False)
    try:
        names = [f"s{i}" for i in range(8)]
        for n in names:
            fleet.create_session(n, n_reporters=N_REPORTERS)
            for j in range(BLOCKS_PER_ROUND):
                fleet.append(n, make_block(0, j))
        new = fleet.add_worker()
        assert new == "w2" and "w2" in fleet.ring
        moved = fleet.rebalance_to(new)
        assert {n for n, _ in moved} == {
            n for n in names if fleet.ring.owner(n) == new}
        other = next(n for n in names if fleet.owner_of(n) != "w0")
        assert fleet.migrate_session(other, "w0") == "w0"
        info = fleet.drain_worker("w0")
        assert info["drained"] and not fleet.workers["w0"].alive
        assert all(o != "w0" for o in fleet.sessions().values())
        assert fleet.drain_worker("w1")["drained"]
        with pytest.raises(PlacementError, match="last worker"):
            fleet.drain_worker("w2")
        results = {n: fleet.submit(session=n).result(WAIT_S)
                   for n in names}
        for n in names:
            for j in range(BLOCKS_PER_ROUND):
                fleet.append(n, make_block(1, j))
        second = {n: fleet.submit(session=n).result(WAIT_S)
                  for n in names}
    finally:
        fleet.close(drain=True)
    for n in names:
        assert_same_bits(nested_bits(results[n]), flat_bits(want[0]), n)
        assert_same_bits(nested_bits(second[n]), flat_bits(want[1]), n)


def test_adopt_a_dead_fleets_log(tmp_path):
    """A new fleet adopts the log a dead one left and resumes it."""
    want, _ = never_killed(2)
    first = port_fleet(tmp_path).start(warmup=False)
    first.create_session("s", n_reporters=N_REPORTERS)
    for j in range(BLOCKS_PER_ROUND):
        first.append("s", make_block(0, j))
    got = [first.submit(session="s").result(WAIT_S)]
    first.append("s", make_block(1, 0))
    first.close(drain=True)
    second = port_fleet(tmp_path).start(warmup=False)
    try:
        second.adopt_session("s")
        with pytest.raises(InputError, match="already placed"):
            second.adopt_session("s")
        second.append("s", make_block(1, 1), append_id="c:1")
        second.append("s", make_block(1, 1), append_id="c:1")  # a retry
        assert second.session_state("s")["staged_blocks"] == 2
        got.append(second.submit(session="s").result(WAIT_S))
    finally:
        second.close(drain=True)
    for g, w in zip(got, want):
        assert_same_bits(nested_bits(g), flat_bits(w))


def test_launch_counts_survive_concurrent_batchers():
    """The fleet's batcher threads all bump the kernels' launch counts:
    with more threads than cores and a short switch interval no
    increment is lost."""
    from pyconsensus_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launch_counts()
    threads, per = 4 * (os.cpu_count() or 2), 2000
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [ck._count("storage_matvec")
                            for _ in range(per)]) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=WAIT_S)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(prev)
    assert ck.launch_counts()["storage_matvec"] == threads * per
    ck.reset_launch_counts()
