"""The state plane (``pyconsensus_tpu/serve/stateplane.py``): log
compaction, tiered session residency, and the hydration behind them.

- **Log compaction.** A :class:`~.failover.ReplicationLog` journals one
  record a block and removes them only when the round commits, so many
  appends between rare resolves grow the journal without bound. A
  **snapshot record** (``snapshot.npz``: the open round's journaled
  prefix, the cumulative append-dedupe set, and the ledger checkpoint
  tree with the incremental tier's warm eigenstate in its aux members,
  under one SHA-256 digest, written through ``io.atomic_write``)
  truncates the journal behind it. Verify, replay and the shipping plane
  read it: a takeover replays snapshot plus suffix bit for bit the full
  journal's replay, because the snapshot is built from the verified
  journal bytes, never from memory. The member names, the int8 lattice
  encoding and the digest order are the reference's byte for byte, so a
  log compacted by either package verifies and replays in the other.

- **Tiered residency.** :class:`TieredSessionStore` keeps at most
  ``hot_capacity`` sessions in memory (LRU) and hydrates the rest from
  their compacted local logs on first touch: a worker owns many more
  sessions than it holds. A session goes cold only under its own lock
  (every acknowledged mutation is already journaled), and the evicted
  object is fenced with a retryable PYC502, so a caller holding it can
  never append beside the hydrated replacement.

- **Crash discipline.** A crash mid-compaction leaves the old snapshot
  and the full journal, the new snapshot and an untruncated journal
  (the replay skips the covered prefix), or the new snapshot and the
  suffix: never a state that loses an acknowledged round. A torn
  snapshot over an intact journal is refused and rebuilt
  (``pyconsensus_compactions_total{outcome="refused"}``); over a
  truncated journal it raises ``SnapshotCorruptionError`` (PYC303), and
  the shipped copy is the recovery.

Lock order: the :class:`Compactor` takes the store lock only to copy
the hot list, then each session's own lock (``DurableSession._lock``);
no fleet, ring or capacity lock is held here.

Fault sites: ``state.snapshot`` fires inside the snapshot's write (a
``torn_write`` tears it), ``state.compact`` before each truncation
unlink, ``state.hydrate`` at a cold session's hydration.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

from .. import obs
from ..faults import (CheckpointCorruptionError, FailoverInProgressError,
                      InputError)
from ..faults import plan as _faults
from ..io import atomic_write
from .failover import DurableSession, replay_session
from .session import MarketSession, SessionStore

__all__ = ["SNAPSHOT_VERSION", "write_snapshot", "load_snapshot",
           "snapshot_hint", "hydrate_session", "TieredSessionStore",
           "CompactionPolicy", "Compactor"]

SNAPSHOT_VERSION = 1

#: snapshot members that must always be present (per-block members are
#: counted by ``blocks``; ``ledger__*`` members mirror the checkpoint)
_SNAP_FIELDS = ("format_version", "round", "blocks", "dedupe", "digest")


def _hot_gauge():
    return obs.gauge("pyconsensus_sessions_hot",
                     "sessions resident in memory (hot tier)")


def count_compaction(outcome: str) -> None:
    """One compaction attempt outcome (``compacted`` / ``skipped`` /
    ``failed`` / ``refused`` — the last counted at snapshot-load time
    when a torn snapshot is ignored in favor of the intact journal)."""
    obs.counter("pyconsensus_compactions_total",
                "journal compaction attempts by outcome",
                labels=("outcome",)).inc(outcome=outcome)


# -- snapshot record ------------------------------------------------------

def _encode_lattice(block: np.ndarray) -> np.ndarray:
    """int8 sentinel encoding for lattice-exact panels (the journal's
    8x shrink): ``round(2 * value)`` with ``-1`` marking NaN — the
    ``models.pipeline.encode_reports`` convention, host-side, without
    the ingest accounting (this is storage, not ingestion)."""
    return np.where(np.isnan(block), -1,
                    np.round(np.clip(block, 0.0, 1.0) * 2.0)
                    ).astype(np.int8)


def _decode_lattice(enc: np.ndarray) -> np.ndarray:
    # MarketSession._staged_host's exact decode: bit-identical panels
    return np.where(enc < 0, np.nan, enc.astype(np.float64) * 0.5)


def _snapshot_digest(members: dict) -> str:
    """SHA-256 over every member except ``digest``, sorted by name:
    name, dtype, shape, and the contiguous bytes — torn files, renamed
    members, and silent dtype drift all refuse."""
    h = hashlib.sha256()
    for name in sorted(members):
        if name == "digest":
            continue
        arr = np.ascontiguousarray(members[name])
        h.update(name.encode())
        h.update(arr.dtype.str.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def write_snapshot(log, round_idx: int, staged: list, dedupe: set,
                   ledger_tree: dict):
    """Write ``log.snapshot_path`` covering the open round's journaled
    prefix (``staged``: the VERIFIED ``[(block, bounds, append_id),
    ...]`` list the replay path itself produced — the snapshot carries
    exactly the bytes a full-log replay would fold), the cumulative
    append-dedupe set, and the ledger checkpoint tree (reputation,
    round, history, aux — including the warm incremental eigenstate).
    Atomic: a SIGKILL mid-write leaves the previous snapshot (or none).
    The ``state.snapshot`` fault site fires inside the write window
    with the temp path, so a ``torn_write`` rule produces exactly the
    power-loss artifact the loader must refuse. Returns the path."""
    members = {
        "format_version": np.int64(SNAPSHOT_VERSION),
        "round": np.int64(round_idx),
        "blocks": np.int64(len(staged)),
        "dedupe": np.frombuffer(
            json.dumps(sorted(str(d) for d in dedupe)).encode(),
            dtype=np.uint8),
    }
    for j, (block, bounds, append_id) in enumerate(staged):
        block = np.asarray(block, dtype=np.float64)
        lattice = bool((np.isnan(block) | (block == 0.5) | (block == 1.0)
                        | ((block == 0.0) & ~np.signbit(block))).all())
        members[f"block__{j:06d}"] = (_encode_lattice(block) if lattice
                                      else block)
        members[f"bounds__{j:06d}"] = np.frombuffer(
            json.dumps(None if bounds is None else list(bounds)).encode(),
            dtype=np.uint8)
        if append_id is not None:
            members[f"aid__{j:06d}"] = np.frombuffer(
                str(append_id).encode(), dtype=np.uint8)
    for name in sorted(ledger_tree):
        members[f"ledger__{name}"] = np.asarray(ledger_tree[name])
    members["digest"] = np.frombuffer(
        _snapshot_digest(members).encode(), dtype=np.uint8)
    path = log.snapshot_path

    def write(tmp):
        np.savez(tmp, **members)
        _faults.fire("state.snapshot", path=tmp)
    return atomic_write(path, write, suffix=".tmp.npz")


def load_snapshot(path) -> dict:
    """Load + integrity-check one snapshot record. Returns ``{"round",
    "blocks": [(block, bounds, append_id), ...], "dedupe": set,
    "ledger": {member: array}}``; raises CheckpointCorruptionError
    (PYC301) naming the refusing check on any structural, digest, or
    cross-field failure — the CALLER decides whether that refusal is
    recoverable (journal intact: rebuild) or fatal (journal truncated:
    PYC303)."""
    def bad(why, **ctx):
        return CheckpointCorruptionError(
            f"{path}: compaction snapshot {why}", source=str(path), **ctx)

    try:
        with np.load(path) as data:
            members = {name: np.asarray(data[name]) for name in data.files}
    except Exception as exc:
        # the torn-final-write artifact: the npz zip structure is cut
        # short — refuse before trusting any member
        raise bad(f"is unreadable ({type(exc).__name__}: {exc})") from exc
    for field in _SNAP_FIELDS:
        if field not in members:
            raise bad(f"field {field!r} is missing", field=field)
    digest = bytes(members["digest"].astype(np.uint8)).decode()
    if _snapshot_digest(members) != digest:
        raise bad("content digest mismatch (torn or tampered snapshot)")
    version = int(members["format_version"])
    if version != SNAPSHOT_VERSION:
        raise bad(f"format version {version} is not {SNAPSHOT_VERSION}",
                  found=version, expected=SNAPSHOT_VERSION)
    round_idx = int(members["round"])
    n_blocks = int(members["blocks"])
    ledger = {name[len("ledger__"):]: arr
              for name, arr in members.items()
              if name.startswith("ledger__")}
    if "round" in ledger and int(ledger["round"]) != round_idx:
        raise bad(f"embedded ledger is at round {int(ledger['round'])}, "
                  f"snapshot declares {round_idx}", field="round")
    blocks = []
    for j in range(n_blocks):
        key = f"block__{j:06d}"
        if key not in members or f"bounds__{j:06d}" not in members:
            raise bad(f"journaled prefix block {j} is missing",
                      field=key)
        raw = members[key]
        block = (_decode_lattice(raw) if raw.dtype == np.int8
                 else np.asarray(raw, dtype=np.float64))
        bounds = json.loads(
            bytes(members[f"bounds__{j:06d}"].astype(np.uint8)).decode())
        aid_key = f"aid__{j:06d}"
        append_id = (bytes(members[aid_key].astype(np.uint8)).decode()
                     if aid_key in members else None)
        blocks.append((block, bounds, append_id))
    dedupe = set(json.loads(
        bytes(members["dedupe"].astype(np.uint8)).decode()))
    return {"round": round_idx, "blocks": blocks, "dedupe": dedupe,
            "ledger": ledger}


def snapshot_hint(path) -> Optional[tuple]:
    """Best-effort ``(round, blocks)`` off a snapshot that FAILED
    :func:`load_snapshot` — a torn npz often still decodes its small
    leading members. The failover layer uses this to fail safe: if a
    refused snapshot still declares coverage the journal cannot
    account for, the truncation already happened and replay must raise
    PYC303 instead of silently dropping the covered prefix. Returns
    None when nothing trustworthy decodes."""
    try:
        with np.load(path) as data:
            if "round" in data.files and "blocks" in data.files:
                return int(np.asarray(data["round"]).item()), \
                    int(np.asarray(data["blocks"]).item())
    except Exception:   # noqa: BLE001 — a fully unreadable file simply
        pass            # yields no hint; the gap check still applies
    return None


# -- hydration ------------------------------------------------------------

def hydrate_session(log_root, name: str, executable_provider=None,
                    device=None, dtype=None) -> DurableSession:
    """Bring one cold session hot from its compacted local log: the
    snapshot-aware :func:`~.failover.replay_session` (snapshot prefix +
    journal suffix, bit for bit the always-hot session) on ``device``
    (None: the card) in ``dtype``, timed and counted. ``state.hydrate``
    fires first, so a plan can kill or refuse the hydration a cold
    request is paying for."""
    _faults.fire("state.hydrate")
    t0 = time.perf_counter()
    session = replay_session(log_root, name,
                             executable_provider=executable_provider,
                             device=device, dtype=dtype)
    obs.counter("pyconsensus_sessions_hydrated_total",
                "cold sessions hydrated from the compacted local "
                "log").inc()
    obs.histogram("pyconsensus_session_hydrate_seconds",
                  "cold-session hydration latency (snapshot + journal "
                  "suffix replay)").observe(time.perf_counter() - t0)
    return session


# -- tiered residency -----------------------------------------------------

class TieredSessionStore(SessionStore):
    """A :class:`~.session.SessionStore` that keeps at most
    ``hot_capacity`` sessions resident (LRU) and hydrates the rest from
    their replication logs on first touch.

    - ``pyconsensus_serve_sessions`` keeps counting OWNED sessions
      (hot + cold) — the fleet-facing total; the new
      ``pyconsensus_sessions_hot`` gauge counts residency.
    - Eviction is ack-iff-durable: only :class:`DurableSession` objects
      (their log already carries every acknowledged mutation) whose
      lock is free and that carry no fence are evicted; the evicted
      OBJECT is fenced with a retryable PYC502, so a caller holding a
      stale reference retries onto the hydrated replacement instead of
      racing it for journal indices. Plain in-memory sessions are
      pinned hot (nothing durable to hydrate from).
    - Exactly one hydration per cold touch: the first getter hydrates
      outside the store lock; concurrent getters wait on its event.

    ``hydrator`` is injected by the owning worker (it knows the log
    root and the executable provider); a cold ``get`` without one is a
    structured refusal, not a KeyError.
    """

    def __init__(self, hot_capacity: int) -> None:
        super().__init__()
        if int(hot_capacity) < 1:
            raise InputError(
                f"hot_capacity must be >= 1, got {hot_capacity}",
                field="hot_capacity")
        self.hot_capacity = int(hot_capacity)
        #: hot tier, LRU order (front = coldest)  guarded-by: _lock
        self._sessions: OrderedDict = OrderedDict()
        #: owned-but-evicted session names          guarded-by: _lock
        self._cold: set = set()
        #: in-flight hydrations, name -> Event      guarded-by: _lock
        self._hydrating: dict = {}
        #: injected by the owning worker: name -> DurableSession
        self.hydrator: Optional[Callable[[str], DurableSession]] = None

    # -- registry surface (SessionStore contract) ----------------------

    def create(self, name: str, n_reporters: int, **kwargs
               ) -> MarketSession:
        with self._lock:
            if name in self._sessions or name in self._cold:
                raise InputError(f"session {name!r} already exists")
            session = MarketSession(name, n_reporters, **kwargs)
            self._sessions[name] = session
            self._moved.pop(name, None)
            obs.gauge("pyconsensus_serve_sessions",
                      "live market sessions").inc(1)
            _hot_gauge().inc(1)
            self._evict_overflow_locked()
            return session

    def add(self, session: MarketSession) -> MarketSession:
        with self._lock:
            if session.name in self._sessions or session.name in self._cold:
                raise InputError(
                    f"session {session.name!r} already exists")
            self._sessions[session.name] = session
            self._moved.pop(session.name, None)
            obs.gauge("pyconsensus_serve_sessions",
                      "live market sessions").inc(1)
            _hot_gauge().inc(1)
            self._evict_overflow_locked()
            return session

    def get(self, name: str) -> MarketSession:
        while True:
            with self._lock:
                session = self._sessions.get(name)
                if session is not None:
                    self._sessions.move_to_end(name)
                    return session
                if name not in self._cold:
                    if name in self._moved:
                        raise self._moved[name]
                    raise InputError(f"unknown session {name!r}")
                event = self._hydrating.get(name)
                if event is None:
                    if self.hydrator is None:
                        raise InputError(
                            f"session {name!r} is cold and this store "
                            f"has no hydrator to bring it back",
                            session=name)
                    event = threading.Event()
                    self._hydrating[name] = event
                    leader = True
                else:
                    leader = False
            if not leader:
                # exactly-one-hydration: wait for the leader, then loop
                # (on leader failure the next getter becomes leader)
                event.wait()
                continue
            try:
                # the hydration runs OUTSIDE the store lock: a slow
                # replay must not block unrelated hot traffic
                session = self.hydrator(name)
            except BaseException:
                with self._lock:
                    self._hydrating.pop(name, None)
                event.set()
                raise
            with self._lock:
                self._cold.discard(name)
                self._sessions[name] = session
                self._sessions.move_to_end(name)
                _hot_gauge().inc(1)
                self._hydrating.pop(name, None)
                self._evict_overflow_locked()
            event.set()
            return session

    def remove(self, name: str, moved: Optional[BaseException] = None
               ) -> None:
        with self._lock:
            if self._sessions.pop(name, None) is not None:
                obs.gauge("pyconsensus_serve_sessions",
                          "live market sessions").inc(-1)
                _hot_gauge().inc(-1)
            elif name in self._cold:
                self._cold.discard(name)
                obs.gauge("pyconsensus_serve_sessions",
                          "live market sessions").inc(-1)
            if moved is not None:
                self._moved[name] = moved

    def names(self) -> list:
        with self._lock:
            return sorted(set(self._sessions) | self._cold)

    # -- tier surface ---------------------------------------------------

    def hot_names(self) -> list:
        with self._lock:
            return list(self._sessions)

    def hot_items(self) -> list:
        """A point-in-time ``[(name, session), ...]`` snapshot of the
        hot tier (LRU order) — what the compactor sweeps; taken under
        the store lock, used outside it."""
        with self._lock:
            return list(self._sessions.items())

    def cold_names(self) -> list:
        with self._lock:
            return sorted(self._cold)

    def is_hot(self, name: str) -> bool:
        with self._lock:
            return name in self._sessions

    def _evict_overflow_locked(self) -> list:
        """LRU eviction down to ``hot_capacity``. Caller holds the
        store lock. Eviction order is LRU-first; a session is skipped
        (stays hot) when it is not durable, carries a fence (a
        migration fence must survive — rehydrating would un-fence it),
        or its lock is busy (an in-flight mutation has not reached its
        durable ack yet). If nothing qualifies the tier soft-overflows
        rather than evicting unsafely."""
        evicted = []
        if len(self._sessions) <= self.hot_capacity:
            return evicted
        for name in list(self._sessions):
            if len(self._sessions) <= self.hot_capacity:
                break
            session = self._sessions[name]
            if not isinstance(session, DurableSession):
                continue                    # nothing durable to reload
            # non-blocking: an in-flight append/resolve holds this and
            # its ack is not durable yet — evicting now would break
            # ack-iff-durable, so skip and try the next-coldest
            if not session._lock.acquire(blocking=False):
                continue
            try:
                if session._fenced is not None:
                    continue            # a fence must outlive residency
                # under the session lock every acknowledged mutation is
                # journaled (ack-iff-durable) — the log IS the session.
                # Fence the evicted OBJECT: a caller still holding this
                # reference retries (PYC502) onto the hydrated
                # replacement instead of journaling beside it.
                session._fenced = FailoverInProgressError(
                    f"session {name!r} was evicted to the cold tier — "
                    f"retry to touch the hydrated copy",
                    session=name, reason="evicted", retry_after_s=0.05)
            finally:
                session._lock.release()
            del self._sessions[name]
            self._cold.add(name)
            _hot_gauge().inc(-1)
            evicted.append(name)
        return evicted


# -- compaction policy + background sweeper -------------------------------

class CompactionPolicy:
    """When to snapshot-truncate a session's journal: after ``rounds``
    resolved rounds since the last snapshot, or once the staged journal
    reaches ``journal_bytes`` bytes — whichever fires first; either
    threshold 0 disables it. Both thresholds are per-session."""

    def __init__(self, rounds: int = 0, journal_bytes: int = 0) -> None:
        self.rounds = int(rounds)
        self.journal_bytes = int(journal_bytes)
        if self.rounds < 0 or self.journal_bytes < 0:
            raise InputError(
                f"compaction thresholds must be >= 0, got rounds="
                f"{rounds} journal_bytes={journal_bytes}")

    def enabled(self) -> bool:
        return bool(self.rounds or self.journal_bytes)

    def due(self, session) -> bool:
        if not isinstance(session, DurableSession):
            return False
        if self.journal_bytes:
            try:
                if session.log.journal_bytes() >= self.journal_bytes:
                    return True
            except OSError:
                return False
        if self.rounds:
            base = (-1 if session._snap_round is None
                    else int(session._snap_round))
            if int(session.ledger.round) - base >= self.rounds:
                return True
        return False


class Compactor:
    """Background compaction sweeper: walks the hot tier on an
    interval and calls :meth:`~.failover.DurableSession.compact` on
    every session the policy says is due. Per-session work holds ONLY
    that session's lock (the store lock is held just long enough to
    snapshot the hot list) — see the module docstring's lock-order
    argument. Never raises out of the sweep: a failed compaction is
    counted (``outcome="failed"``) and retried next interval."""

    def __init__(self, store: SessionStore, policy: CompactionPolicy,
                 interval_s: float = 5.0) -> None:
        self.store = store
        self.policy = policy
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _hot_items(self) -> list:
        items = getattr(self.store, "hot_items", None)
        if items is not None:
            return items()
        out = []
        for name in self.store.names():
            try:
                out.append((name, self.store.get(name)))
            except InputError:
                pass                    # removed between list and get
        return out

    def sweep(self) -> dict:
        """One pass over the hot tier. Returns counts for tests and the
        CLI; updates ``pyconsensus_session_journal_bytes`` to the
        staged-journal total across the sessions it examined."""
        counts = {"compacted": 0, "skipped": 0, "failed": 0}
        journal_total = 0
        for name, session in self._hot_items():
            if not isinstance(session, DurableSession):
                continue
            if not self.policy.due(session):
                try:
                    journal_total += session.log.journal_bytes()
                except OSError:
                    pass
                continue
            try:
                session.compact()
                counts["compacted"] += 1
                count_compaction("compacted")
            except FailoverInProgressError:
                counts["skipped"] += 1      # evicted/migrating under us
                count_compaction("skipped")
            except Exception:   # noqa: BLE001 — a failed compaction
                # must never take the sweeper down; the journal is
                # intact (truncation only follows a landed snapshot)
                # and the next interval retries
                counts["failed"] += 1
                count_compaction("failed")
            try:
                journal_total += session.log.journal_bytes()
            except OSError:
                pass
        obs.gauge("pyconsensus_session_journal_bytes",
                  "staged-journal bytes across sessions examined by "
                  "the last compaction sweep").set(float(journal_total))
        return counts

    def run_in_thread(self) -> "Compactor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="pyconsensus-compactor", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sweep()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)
