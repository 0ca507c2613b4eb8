"""The port's state plane (``pyconsensus_tpu_torch.serve.stateplane``:
compaction snapshots, tiered residency, hydration; the snapshot-aware
``serve.failover``) against the JAX package's, on the CPU in float64,
mirroring ``tests/test_stateplane.py``:

- the snapshot record: the reference's members, int8 lattice encoding and
  digest byte for byte, so a snapshot either package writes loads in the
  other with an equal digest, the incremental tier's warm eigenstate
  riding its ``ledger__aux__*`` members;
- a log compacted by either package verifies and replays in the other:
  the replayed blocks, dedupe set and ledger are the other's bit for bit,
  the port's resolves equal its replay of the same log never compacted
  bit for bit and the reference's within ``REF_ATOL``;
- the crash matrix, driven by the port's ``FaultPlan`` on the reference's
  sites: a crash between write and truncate, mid-truncation at each
  occurrence, a torn snapshot write that never truncates, a crash inside
  the write, both PYC303 cases and the stale prefix after a commit; every
  case leaves the reference's files and replays bit for bit;
- the tiered store (LRU, the cold resolve bit for bit, the fenced evicted
  object, the busy session kept hot, exactly one hydration under
  contention, a hydration fault that retries clean), the policy and the
  compactor, the config and the service's lifecycle, a tiered fleet's
  cold sessions and a migration that keeps compacted state;
- shipping: a socket worker ships a compacted log's snapshot by content,
  and a standby adopts the shipped compacted copy.
"""

import shutil
import threading

import numpy as np
import pytest
import torch

from pyconsensus_tpu import faults as ref_faults
from pyconsensus_tpu.serve import DurableSession as RefDurable
from pyconsensus_tpu.serve import replay_session as ref_replay
from pyconsensus_tpu.serve.stateplane import load_snapshot as ref_load
from pyconsensus_tpu.serve.stateplane import write_snapshot as ref_write
from pyconsensus_tpu_torch import faults, obs
from pyconsensus_tpu_torch.faults import (CheckpointCorruptionError,
                                          FailoverInProgressError, FaultPlan,
                                          InputError, SimulatedCrash,
                                          SnapshotCorruptionError)
from pyconsensus_tpu_torch.serve import (ConsensusFleet, ConsensusService,
                                         DurableSession, FleetConfig,
                                         MarketSession, ReplicationLog,
                                         ServeConfig, replay_session)
from pyconsensus_tpu_torch.serve.stateplane import (CompactionPolicy,
                                                    Compactor,
                                                    TieredSessionStore,
                                                    hydrate_session,
                                                    load_snapshot,
                                                    snapshot_hint,
                                                    write_snapshot)
from torch_fleet_worker import N_REPORTERS, make_block
from torch_witness import (  # noqa: F401
    torch_lock_witness, torch_protocol_witness)


@pytest.fixture(autouse=True)
def _witnessed(torch_lock_witness, torch_protocol_witness):
    """Every test here runs under the port's lock and protocol witnesses
    (the counterpart of the reference's test_stateplane opt-in)."""
    yield


BITS_KEYS = ("smooth_rep", "outcomes_final", "outcomes_adjusted",
             "old_rep", "avg_certainty")
#: continuous keys against the reference (float64; two eigensolvers:
#: ``tests/test_torch_fleet.py``)
REF_ATOL = 1e-9


@pytest.fixture(autouse=True)
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def assert_same_bits(got, want, msg=""):
    for key in BITS_KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]),
                                      err_msg=f"{msg} [{key}]")


def drive(session, rounds=2, blocks=3, ids=False):
    """``blocks`` appends then a resolve a round; the last round's
    journal is left open, compaction's target state."""
    for k in range(rounds):
        for j in range(blocks):
            kw = {"append_id": f"tok-{k}-{j}"} if ids else {}
            session.append(make_block(k, j), **kw)
        if k < rounds - 1:
            session.resolve()
    return session


def port_session(root, name="s", **kw):
    return DurableSession.create(str(root), name, N_REPORTERS,
                                 device="cpu", **kw)


def count(name, **labels):
    return obs.value(name, **labels) or 0


def staged_equal(a, b):
    """Two staged lists ``[(block, bounds, append_id), ...]`` bit for
    bit."""
    assert len(a) == len(b)
    for (ba, bna, ida), (bb, bnb, idb) in zip(a, b):
        assert np.asarray(ba).tobytes() == np.asarray(bb).tobytes()
        assert np.asarray(ba).shape == np.asarray(bb).shape
        assert bna == bnb and ida == idb


def reference_twin(tmp_path, rounds=2, blocks=3):
    """The never-compacted run of :func:`drive` in the port."""
    return drive(port_session(tmp_path / "twin", "ref"), rounds, blocks)


def assert_replay_matches_twin(tmp_path, name="s"):
    replayed = replay_session(tmp_path, name, device="cpu")
    twin = reference_twin(tmp_path)
    np.testing.assert_array_equal(replayed.ledger.reputation,
                                  twin.ledger.reputation)
    assert len(replayed._blocks) == len(twin._blocks)
    replayed.append(make_block(1, 3))
    twin.append(make_block(1, 3))
    assert_same_bits(replayed.resolve(), twin.resolve(), "replay")


# -- the snapshot record ------------------------------------------------------


class TestSnapshotRecord:
    def test_round_trip_bit_identical(self, tmp_path):
        session = drive(port_session(tmp_path))
        staged = session.log.staged(session.ledger.round)
        path = write_snapshot(session.log, session.ledger.round, staged,
                              {"a1", "a2"}, session.ledger._state_tree())
        snap = load_snapshot(path)
        assert snap["round"] == session.ledger.round
        assert snap["dedupe"] == {"a1", "a2"}
        staged_equal(snap["blocks"], staged)
        np.testing.assert_array_equal(
            snap["ledger"]["reputation"],
            session.ledger._state_tree()["reputation"])

    def test_torn_file_refused_with_hint(self, tmp_path):
        session = drive(port_session(tmp_path))
        staged = session.log.staged(session.ledger.round)
        path = write_snapshot(session.log, session.ledger.round, staged,
                              set(), session.ledger._state_tree())
        raw = bytearray(path.read_bytes())
        mid = len(raw) // 2
        raw[mid:mid + 8] = b"\xff" * 8
        path.write_bytes(bytes(raw))
        with pytest.raises(CheckpointCorruptionError):
            load_snapshot(path)
        assert snapshot_hint(path) == (session.ledger.round, len(staged))

    def test_unreadable_file_refused_without_hint(self, tmp_path):
        path = tmp_path / "snapshot.npz"
        path.write_bytes(b"not a zip archive at all")
        with pytest.raises(CheckpointCorruptionError, match="unreadable"):
            load_snapshot(path)
        assert snapshot_hint(path) is None

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_either_packages_snapshot_loads_in_the_other(self, tmp_path,
                                                         writer):
        """The members, the lattice encoding and the digest order are the
        reference's: the same inputs written by either package give the
        same members and digest, and each loads the other's file."""
        session = drive(port_session(tmp_path), ids=True)
        staged = session.log.staged(session.ledger.round)
        # a continuous block rides the journal as float64
        cont = (np.linspace(0.1, 0.9, N_REPORTERS * 2)
                .reshape(N_REPORTERS, 2), [0.0, 1.0], "cont")
        staged = staged + [cont]
        tree = session.ledger._state_tree()
        write = write_snapshot if writer == "port" else ref_write
        path = write(session.log, session.ledger.round, staged,
                     {"x", "y"}, tree)
        ours, theirs = load_snapshot(path), ref_load(path)
        for snap in (ours, theirs):
            assert snap["round"] == session.ledger.round
            assert snap["dedupe"] == {"x", "y"}
            staged_equal(snap["blocks"], staged)
        with np.load(path) as data:
            members = {k: np.asarray(data[k]) for k in data.files}
        other = (ref_write if writer == "port" else write_snapshot)(
            ReplicationLog(tmp_path / "other", "s"), session.ledger.round,
            staged, {"x", "y"}, tree)
        with np.load(other) as data:
            assert sorted(data.files) == sorted(members)
            for k in data.files:
                assert np.asarray(data[k]).tobytes() == members[k].tobytes()
                assert np.asarray(data[k]).dtype == members[k].dtype
        assert members["block__000000"].dtype == np.int8
        assert members[f"block__{len(staged) - 1:06d}"].dtype == np.float64

    def test_incremental_warm_state_rides_the_snapshot(self, tmp_path):
        """The incremental tier's warm eigenstate is in the ledger's aux
        tree: a snapshot carries it as the reference's
        ``ledger__aux__*`` members."""
        session = port_session(tmp_path, incremental=True,
                               refresh_every=3)
        drive(session, rounds=3, blocks=2)
        session.compact()
        with np.load(session.log.snapshot_path) as data:
            aux = {k: np.asarray(data[k]) for k in data.files
                   if k.startswith("ledger__aux__")}
        assert "ledger__aux__incremental_warm_u" in aux
        np.testing.assert_array_equal(
            aux["ledger__aux__incremental_warm_u"],
            session.ledger.aux["incremental_warm_u"])
        snap = ref_load(session.log.snapshot_path)
        np.testing.assert_array_equal(snap["ledger"]["aux__incremental_"
                                                     "warm_u"],
                                      session.ledger.aux[
                                          "incremental_warm_u"])


# -- compaction and its crash matrix ------------------------------------------


class TestCompaction:
    def test_compact_replay_bit_identical(self, tmp_path):
        session = drive(port_session(tmp_path))
        report = session.compact()
        assert report["records_removed"] == 3
        assert report["bytes_after"] < report["bytes_before"]
        assert_replay_matches_twin(tmp_path)

    def test_journal_bytes_shrink(self, tmp_path):
        session = drive(port_session(tmp_path))
        before = session.journal_bytes()
        assert before == session.log.journal_bytes() > 0
        session.compact()
        assert session.journal_bytes() < before

    def test_dedupe_survives_compaction(self, tmp_path):
        """A committed round's idempotency tokens survive in the
        snapshot's dedupe set: a replayed session acknowledges a retried
        append without folding it twice."""
        session = port_session(tmp_path)
        session.append(make_block(0, 0), append_id="tok-0")
        session.resolve()
        session.append(make_block(1, 0), append_id="tok-1")
        session.compact()
        replayed = replay_session(tmp_path, "s", device="cpu")
        n_before = len(replayed._blocks)
        replayed.append(make_block(1, 0), append_id="tok-1")
        replayed.append(make_block(0, 0), append_id="tok-0")
        assert len(replayed._blocks) == n_before

    def test_crash_between_write_and_truncate(self, tmp_path):
        session = drive(port_session(tmp_path))
        plan = FaultPlan(seed=0, rules=[
            {"site": "state.compact", "kind": "crash",
             "occurrences": [0]}])
        with faults.armed(plan):
            with pytest.raises(SimulatedCrash):
                session.compact()
        assert plan.fired == [("state.compact", 0, "crash")]
        assert len(session.log._staged_entries(1)) == 3
        assert_replay_matches_twin(tmp_path)

    @pytest.mark.parametrize("occurrence", [1, 2])
    def test_crash_mid_truncation(self, tmp_path, occurrence):
        session = drive(port_session(tmp_path))
        plan = FaultPlan(seed=0, rules=[
            {"site": "state.compact", "kind": "crash",
             "occurrences": [occurrence]}])
        with faults.armed(plan):
            with pytest.raises(SimulatedCrash):
                session.compact()
        assert len(session.log._staged_entries(1)) == 3 - occurrence
        assert_replay_matches_twin(tmp_path)

    def test_torn_snapshot_write_never_truncates(self, tmp_path):
        session = drive(port_session(tmp_path))
        before = len(session.log.staged(session.ledger.round))
        refused0 = count("pyconsensus_compactions_total",
                         outcome="refused")
        plan = FaultPlan(seed=0, rules=[
            {"site": "state.snapshot", "kind": "torn_write",
             "occurrences": [0]}])
        with faults.armed(plan):
            with pytest.raises(CheckpointCorruptionError):
                session.compact()
        assert len(session.log.staged(session.ledger.round)) == before
        assert count("pyconsensus_compactions_total",
                     outcome="refused") > refused0
        report = replay_session(tmp_path, "s", device="cpu").compact()
        assert report["records_removed"] == before
        assert_replay_matches_twin(tmp_path)

    def test_crash_inside_snapshot_write(self, tmp_path):
        session = drive(port_session(tmp_path))
        plan = FaultPlan(seed=0, rules=[
            {"site": "state.snapshot", "kind": "crash",
             "occurrences": [0]}])
        with faults.armed(plan):
            with pytest.raises(SimulatedCrash):
                session.compact()
        assert not session.log.snapshot_path.exists()
        assert_replay_matches_twin(tmp_path)

    def test_truncated_journal_with_corrupt_snapshot_is_pyc303(
            self, tmp_path):
        session = drive(port_session(tmp_path))
        session.compact()
        path = session.log.snapshot_path
        raw = bytearray(path.read_bytes())
        raw[len(raw) // 2:len(raw) // 2 + 8] = b"\xff" * 8
        path.write_bytes(bytes(raw))
        with pytest.raises(SnapshotCorruptionError) as got:
            replay_session(tmp_path, "s", device="cpu")
        assert got.value.error_code == "PYC303"
        assert got.value.context["missing_prefix"] == 3
        with pytest.raises(ref_faults.SnapshotCorruptionError) as want:
            ref_replay(tmp_path, "s")
        assert want.value.context["missing_prefix"] == \
            got.value.context["missing_prefix"]

    def test_gap_behind_snapshot_is_pyc303(self, tmp_path):
        session = drive(port_session(tmp_path))
        session.compact()
        session = replay_session(tmp_path, "s", device="cpu")
        session.append(make_block(1, 3))
        session.append(make_block(1, 4))
        path = session.log.snapshot_path
        raw = bytearray(path.read_bytes())
        raw[len(raw) // 2:len(raw) // 2 + 8] = b"\xff" * 8
        path.write_bytes(bytes(raw))
        session.log._staged_entries(session.ledger.round)[0][1].unlink()
        with pytest.raises(SnapshotCorruptionError) as got:
            replay_session(tmp_path, "s", device="cpu")
        assert got.value.context["reason"] == "truncated-journal"
        with pytest.raises(ref_faults.SnapshotCorruptionError):
            ref_replay(tmp_path, "s")

    def test_stale_snapshot_prefix_ignored_after_commit(self, tmp_path):
        session = drive(port_session(tmp_path))
        session.compact()
        session = replay_session(tmp_path, "s", device="cpu")
        session.resolve()                       # commits round 1
        session.append(make_block(2, 0), append_id="tok-2")
        replayed = replay_session(tmp_path, "s", device="cpu")
        assert replayed.log.verify()["snapshot"]["stale"] is True
        twin = reference_twin(tmp_path)
        twin.resolve()
        twin.append(make_block(2, 0))
        assert_same_bits(replayed.resolve(), twin.resolve(), "stale")

    @pytest.mark.parametrize("site,kind,occurrence", [
        ("state.compact", "crash", 0), ("state.compact", "crash", 1),
        ("state.compact", "crash", 2), ("state.snapshot", "crash", 0),
        ("state.snapshot", "torn_write", 0)])
    def test_crash_leaves_the_references_files(self, tmp_path, site, kind,
                                               occurrence):
        """The same plan on the same sites leaves the same files in both
        packages, and each package replays the other's leftovers to the
        same blocks and ledger."""
        rule = {"site": site, "kind": kind, "occurrences": [occurrence]}
        ours = drive(port_session(tmp_path / "port"))
        ref = drive(RefDurable.create(str(tmp_path / "ref"), "s",
                                      N_REPORTERS))
        fired = []
        for session, pkg, root in ((ours, faults, tmp_path / "port"),
                                   (ref, ref_faults, tmp_path / "ref")):
            plan = pkg.FaultPlan(seed=0, rules=[rule])
            with pkg.armed(plan):
                with pytest.raises((SimulatedCrash, ref_faults.SimulatedCrash,
                                    CheckpointCorruptionError,
                                    ref_faults.CheckpointCorruptionError)):
                    session.compact()
            fired.append(plan.fired)
            names = sorted(p.relative_to(root / "s").as_posix()
                           for p in (root / "s").rglob("*") if p.is_file())
            fired.append(names)
        assert fired[0] == fired[2] and fired[1] == fired[3]
        for root in (tmp_path / "port", tmp_path / "ref"):
            p = replay_session(root, "s", device="cpu")
            r = ref_replay(root, "s")
            staged_equal(p._log.verify_collect()[1],
                         r._log.verify_collect()[1])
            np.testing.assert_array_equal(p.ledger.reputation,
                                          r.ledger.reputation)


# -- logs across packages -----------------------------------------------------


class TestAcrossPackages:
    @pytest.mark.parametrize("compactor", ["port", "reference"])
    def test_compacted_log_replays_in_the_other(self, tmp_path, compactor):
        """A log compacted by either package verifies and replays in the
        other: the same blocks, tokens and ledger bit for bit; the port's
        resolve equals its replay of the never-compacted twin bit for bit
        and the reference's within ``REF_ATOL``."""
        root = tmp_path / "log"
        if compactor == "port":
            session = drive(port_session(root), ids=True)
        else:
            session = drive(RefDurable.create(str(root), "s", N_REPORTERS),
                            ids=True)
        shutil.copytree(root, tmp_path / "twin")     # never compacted
        session.compact()
        ours = replay_session(root, "s", device="cpu")
        theirs = ref_replay(root, "s")
        assert ours.log.verify() == theirs.log.verify()
        staged_equal(ours._log.verify_collect()[1],
                     theirs._log.verify_collect()[1])
        assert ours._applied_append_ids == theirs._applied_append_ids
        assert ours._snap_round == theirs._snap_round == 1
        np.testing.assert_array_equal(ours.ledger.reputation,
                                      theirs.ledger.reputation)
        twin = replay_session(tmp_path / "twin", "s", device="cpu")
        got, want, ref = ours.resolve(), twin.resolve(), theirs.resolve()
        assert_same_bits(got, want, "compacted vs twin")
        np.testing.assert_array_equal(np.asarray(got["outcomes_final"]),
                                      np.asarray(ref["outcomes_final"]))
        np.testing.assert_allclose(np.asarray(got["smooth_rep"]),
                                   np.asarray(ref["smooth_rep"]),
                                   rtol=0, atol=REF_ATOL)

    def test_refused_snapshot_rebuilt_as_the_reference(self, tmp_path):
        """A torn snapshot over an intact journal (the crash landed
        before any truncation): both packages refuse it, count it and
        replay the whole journal."""
        session = drive(port_session(tmp_path))
        staged = session.log.staged(1)
        path = write_snapshot(session.log, 1, staged, set(),
                              session.ledger._state_tree())
        raw = bytearray(path.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        path.write_bytes(bytes(raw))
        refused0 = count("pyconsensus_compactions_total", outcome="refused")
        summary = ReplicationLog(tmp_path, "s").verify()
        assert "refused" in summary["snapshot"]
        assert count("pyconsensus_compactions_total",
                     outcome="refused") == refused0 + 1
        assert ref_replay(tmp_path, "s")._log.verify()["staged_blocks"] == 3
        assert_replay_matches_twin(tmp_path)


# -- the policy and the compactor ---------------------------------------------


class TestCompactionPolicy:
    def test_thresholds(self, tmp_path):
        session = drive(port_session(tmp_path))
        assert not CompactionPolicy().enabled()
        assert not CompactionPolicy().due(session)
        assert CompactionPolicy(rounds=1).due(session)
        assert not CompactionPolicy(rounds=10).due(session)
        assert CompactionPolicy(journal_bytes=1).due(session)
        assert not CompactionPolicy(journal_bytes=10 ** 9).due(session)
        assert not CompactionPolicy(rounds=1).due(
            MarketSession("m", N_REPORTERS, device="cpu"))
        session.compact()
        # the snapshot is the new base: no round resolved since
        assert not CompactionPolicy(rounds=1).due(session)

    def test_negative_thresholds_refused(self):
        with pytest.raises(InputError):
            CompactionPolicy(rounds=-1)
        with pytest.raises(InputError):
            CompactionPolicy(journal_bytes=-1)

    def test_sweep_compacts_and_counts(self, tmp_path):
        store = TieredSessionStore(hot_capacity=8)
        for i in range(3):
            store.add(drive(port_session(tmp_path, f"s{i}")))
        compactor = Compactor(store, CompactionPolicy(rounds=1))
        assert compactor.sweep() == {"compacted": 3, "skipped": 0,
                                     "failed": 0}
        assert obs.value("pyconsensus_session_journal_bytes") == 0.0
        assert compactor.sweep() == {"compacted": 0, "skipped": 0,
                                     "failed": 0}

    def test_sweep_skips_fenced_session(self, tmp_path):
        store = TieredSessionStore(hot_capacity=8)
        s = drive(port_session(tmp_path))
        s.fence(FailoverInProgressError("migrating", session="s"))
        store.add(s)
        counts = Compactor(store, CompactionPolicy(rounds=1)).sweep()
        assert counts["skipped"] == 1 and counts["compacted"] == 0

    def test_sweep_survives_a_failed_compaction(self, tmp_path):
        store = TieredSessionStore(hot_capacity=8)
        store.add(drive(port_session(tmp_path)))
        plan = FaultPlan(seed=0, rules=[
            {"site": "state.snapshot", "kind": "raise",
             "occurrences": [0], "args": {"error": "os_error"}}])
        compactor = Compactor(store, CompactionPolicy(journal_bytes=1))
        with faults.armed(plan):
            assert compactor.sweep()["failed"] == 1
        assert compactor.sweep()["compacted"] == 1

    def test_compactor_thread_runs_and_stops(self, tmp_path):
        store = TieredSessionStore(hot_capacity=8)
        s = drive(port_session(tmp_path))
        store.add(s)
        compactor = Compactor(store, CompactionPolicy(rounds=1),
                              interval_s=0.05).run_in_thread()
        try:
            for _ in range(200):
                if s._snap_round is not None:
                    break
                threading.Event().wait(0.02)
        finally:
            compactor.stop()
        assert s._snap_round == 1 and compactor._thread is None

    def test_service_lifecycle(self):
        cfg = ServeConfig(warmup=(), hot_sessions=4, compact_rounds=1,
                          compact_interval_s=3600.0)
        service = ConsensusService(cfg, device="cpu")
        service.start(warmup=False)
        try:
            assert isinstance(service.sessions, TieredSessionStore)
            assert service.compactor is not None
        finally:
            service.close(drain=False)
        assert service.compactor is None

    @pytest.mark.parametrize("kw", [{"hot_sessions": -1},
                                    {"compact_rounds": -1},
                                    {"compact_journal_bytes": -1},
                                    {"compact_interval_s": 0.0}])
    def test_config_validation(self, kw):
        with pytest.raises(InputError):
            ConsensusService(ServeConfig(**kw), device="cpu")


# -- tiered residency ---------------------------------------------------------


class TestTieredStore:
    def _store(self, tmp_path, capacity=2, n=4):
        store = TieredSessionStore(hot_capacity=capacity)
        store.hydrator = lambda name: hydrate_session(tmp_path, name,
                                                      device="cpu")
        for i in range(n):
            s = port_session(tmp_path, f"s{i}")
            s.append(make_block(0, 0))
            store.add(s)
        return store

    def test_lru_eviction_and_owned_accounting(self, tmp_path):
        sessions0 = count("pyconsensus_serve_sessions")
        hot0 = count("pyconsensus_sessions_hot")
        store = self._store(tmp_path)
        assert len(store.hot_names()) == 2
        assert set(store.names()) == {"s0", "s1", "s2", "s3"}
        assert store.cold_names() == ["s0", "s1"]
        assert count("pyconsensus_serve_sessions") - sessions0 == 4
        assert count("pyconsensus_sessions_hot") - hot0 == 2

    def test_cold_resolve_bit_identical(self, tmp_path):
        store = self._store(tmp_path)
        hydrated0 = count("pyconsensus_sessions_hydrated_total")
        cold = store.get("s0")
        assert count("pyconsensus_sessions_hydrated_total") - hydrated0 == 1
        twin = port_session(tmp_path / "twin", "r")
        twin.append(make_block(0, 0))
        assert_same_bits(cold.resolve(), twin.resolve(), "cold resolve")
        store.get("s0")
        assert count("pyconsensus_sessions_hydrated_total") - hydrated0 == 1

    def test_evicted_object_is_fenced(self, tmp_path):
        store = TieredSessionStore(hot_capacity=1)
        store.hydrator = lambda name: replay_session(tmp_path, name,
                                                     device="cpu")
        a = port_session(tmp_path, "a")
        store.add(a)
        store.add(port_session(tmp_path, "b"))
        assert store.cold_names() == ["a"]
        with pytest.raises(FailoverInProgressError, match="evicted") as ei:
            a.append(make_block(0, 0))
        assert ei.value.error_code == "PYC502"
        fresh = store.get("a")
        assert fresh is not a
        fresh.append(make_block(0, 0))

    def test_busy_session_not_evicted(self, tmp_path):
        store = TieredSessionStore(hot_capacity=1)
        a = port_session(tmp_path, "a")
        store.add(a)
        acquired, release = threading.Event(), threading.Event()

        def hold():
            with a._lock:
                acquired.set()
                release.wait(timeout=30.0)

        holder = threading.Thread(target=hold)
        holder.start()
        try:
            assert acquired.wait(timeout=10.0)
            store.add(port_session(tmp_path, "b"))
            assert store.hot_names() == ["a"]
            assert store.cold_names() == ["b"]
        finally:
            release.set()
            holder.join()

    def test_plain_sessions_pinned_hot(self):
        store = TieredSessionStore(hot_capacity=1)
        store.add(MarketSession("m0", N_REPORTERS, device="cpu"))
        store.add(MarketSession("m1", N_REPORTERS, device="cpu"))
        assert store.hot_names() == ["m0", "m1"]
        assert store.cold_names() == []

    def test_cold_get_without_hydrator_refused(self, tmp_path):
        store = self._store(tmp_path)
        store.hydrator = None
        with pytest.raises(InputError, match="no hydrator"):
            store.get("s0")

    def test_duplicate_names_refused_across_tiers(self, tmp_path):
        store = self._store(tmp_path)
        assert "s0" in store.cold_names()
        with pytest.raises(InputError, match="already exists"):
            store.create("s0", N_REPORTERS, device="cpu")
        with pytest.raises(InputError, match="already exists"):
            store.add(MarketSession("s0", N_REPORTERS, device="cpu"))

    def test_remove_cold_session(self, tmp_path):
        store = self._store(tmp_path)
        store.remove("s0")
        assert "s0" not in store.names()
        with pytest.raises(InputError):
            store.get("s0")

    def test_exactly_one_hydration_under_contention(self, tmp_path):
        store = self._store(tmp_path, capacity=2, n=3)
        assert store.cold_names() == ["s0"]
        hydrated0 = count("pyconsensus_sessions_hydrated_total")
        got, errors = [], []

        def touch():
            try:
                got.append(store.get("s0"))
            except Exception as exc:    # noqa: BLE001 — asserted below
                errors.append(exc)

        threads = [threading.Thread(target=touch) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not errors
        assert len({id(s) for s in got}) == 1
        assert count("pyconsensus_sessions_hydrated_total") - hydrated0 == 1

    def test_hydration_fault_retries_clean(self, tmp_path):
        store = self._store(tmp_path)
        plan = FaultPlan(seed=0, rules=[
            {"site": "state.hydrate", "kind": "raise",
             "occurrences": [0], "args": {"error": "os_error"}}])
        with faults.armed(plan):
            with pytest.raises(OSError):
                store.get("s0")
            session = store.get("s0")
        assert plan.fired == [("state.hydrate", 0, "raise")]
        session.append(make_block(1, 0))

    def test_hydrated_compacted_session_equals_its_twin(self, tmp_path):
        """Hydration is the snapshot-aware replay: a cold session whose
        log was compacted resolves bit for bit its never-compacted
        twin."""
        store = TieredSessionStore(hot_capacity=1)
        store.hydrator = lambda name: hydrate_session(tmp_path, name,
                                                      device="cpu")
        s = drive(port_session(tmp_path))
        s.compact()
        store.add(s)
        store.add(port_session(tmp_path, "other"))
        assert store.cold_names() == ["s"]
        assert_same_bits(store.get("s").resolve(),
                         reference_twin(tmp_path).resolve(), "hydrated")


# -- the fleet and shipping ---------------------------------------------------


def tiered_fleet(tmp_path, n=2, **worker_kwargs):
    return ConsensusFleet(FleetConfig(
        n_workers=n, log_dir=str(tmp_path / "log"),
        worker=ServeConfig(warmup=(), batch_window_ms=1.0,
                           **worker_kwargs)), device="cpu")


def seed_fleet(fleet, root, names, rounds=1, blocks=2):
    twins = {}
    for n in names:
        fleet.create_session(n, n_reporters=N_REPORTERS)
        twins[n] = port_session(root, n)
        for k in range(rounds):
            for j in range(blocks):
                fleet.append(n, make_block(k, j))
                twins[n].append(make_block(k, j))
    return twins


def assert_fleet_serves_twins(fleet, twins, seed=0):
    for n, twin in sorted(twins.items()):
        block = make_block(90 + seed, 0)
        fleet.append(n, block)
        twin.append(block)
        got = fleet.submit(session=n).result(60)
        want = twin.resolve()
        np.testing.assert_array_equal(
            np.asarray(got["agents"]["smooth_rep"]),
            np.asarray(want["smooth_rep"]), err_msg=n)
        np.testing.assert_array_equal(
            np.asarray(got["events"]["outcomes_final"]),
            np.asarray(want["outcomes_final"]), err_msg=n)


class TestFleet:
    def test_tiered_fleet_cold_sessions_serve_identical(self, tmp_path):
        fleet = tiered_fleet(tmp_path, hot_sessions=2, compact_rounds=1,
                             compact_interval_s=3600.0).start(warmup=False)
        try:
            twins = seed_fleet(fleet, tmp_path / "twins",
                               [f"mkt-{i}" for i in range(6)])
            assert_fleet_serves_twins(fleet, twins)
            for w in fleet.workers.values():
                assert w.service.compactor is not None
                w.service.compactor.sweep()
            hydrated0 = count("pyconsensus_sessions_hydrated_total")
            assert_fleet_serves_twins(fleet, twins, seed=1)
            assert count("pyconsensus_sessions_hydrated_total") > hydrated0
            for w in fleet.workers.values():
                assert len(w.service.sessions.hot_names()) <= 2
        finally:
            fleet.close(drain=False)

    def test_migration_preserves_compacted_state(self, tmp_path):
        fleet = tiered_fleet(tmp_path).start(warmup=False)
        try:
            twins = seed_fleet(fleet, tmp_path / "twins", ["mkt"],
                               rounds=2)
            src = fleet.owner_of("mkt")
            fleet.workers[src].service.sessions.get("mkt").compact()
            target = next(n for n in fleet.workers if n != src)
            assert fleet.migrate_session("mkt", target) == target
            adopted = fleet.workers[target].service.sessions.get("mkt")
            assert adopted._snap_round == 0
            assert_fleet_serves_twins(fleet, twins)
        finally:
            fleet.close(drain=False)

    def test_socket_worker_ships_the_snapshot_by_content(self, tmp_path):
        """A compaction rewrites ``snapshot.npz`` in place: the worker
        ships it whenever its content changed, skips a journal record a
        compaction removed before it shipped, and the standby adopts the
        shipped compacted copy bit for bit."""
        from pyconsensus_tpu_torch.serve.transport import worker
        from pyconsensus_tpu_torch.serve.transport.shipping import (
            LogShipper, ShippingReceiver, adopt_shipped)
        from pyconsensus_tpu_torch.tune.fingerprint import \
            runtime_fingerprint

        fp = runtime_fingerprint("cpu")
        rcv = ShippingReceiver(tmp_path / "shipped", fingerprint=fp).start()
        svc = ConsensusService(ServeConfig(warmup=(), batch_window_ms=1.0),
                               device="cpu")
        shipper = LogShipper(rcv.host, rcv.port, expect_fingerprint=fp)
        proc = worker.FleetWorkerProcess("w0", svc, tmp_path / "local",
                                         shipped_root=tmp_path / "shipped",
                                         shipper=shipper)
        twin = port_session(tmp_path / "twin", "m")
        try:
            proc.create_session({"name": "m", "n_reporters": N_REPORTERS})
            for j in range(3):
                proc.append({"session": "m", "block": make_block(0, j)})
                twin.append(make_block(0, j))
            session = svc.sessions.get("m")
            session.compact()
            # a record journaled and compacted away before its ship
            session.append(make_block(0, 3))
            twin.append(make_block(0, 3))
            session.compact()
            records0 = count("pyconsensus_shipping_records_total",
                             kind="snapshot")
            proc.append({"session": "m", "block": make_block(0, 4)})
            twin.append(make_block(0, 4))
            assert count("pyconsensus_shipping_records_total",
                         kind="snapshot") == records0 + 1
            shipped = tmp_path / "shipped" / "m" / "snapshot.npz"
            local = tmp_path / "local" / "m" / "snapshot.npz"
            assert shipped.read_bytes() == local.read_bytes()
            # unchanged content is not shipped again
            proc.append({"session": "m", "block": make_block(0, 5)})
            twin.append(make_block(0, 5))
            assert count("pyconsensus_shipping_records_total",
                         kind="snapshot") == records0 + 1
            adopted = adopt_shipped(tmp_path / "shipped",
                                    tmp_path / "standby", "m",
                                    device="cpu")
            assert adopted.log.verify()["snapshot"]["blocks"] == 4
            assert_same_bits(adopted.resolve(), twin.resolve(), "shipped")
        finally:
            shipper.close()
            svc.close(drain=False)
            rcv.close()


def test_the_catalog_has_the_state_plane_sites():
    assert len(faults.FAULT_SITES) == 39
    assert {"aot.cache_write", "aot.cache_load", "state.snapshot",
            "state.compact", "state.hydrate"} <= set(faults.FAULT_SITES)
    assert set(faults.FAULT_SITES) <= set(ref_faults.FAULT_SITES)
