"""Ledger-backed session durability and hot-standby takeover
(``pyconsensus_tpu/serve/failover.py``).

The replication log of a fleet session is the
:class:`~pyconsensus_tpu_torch.ledger.ReputationLedger` checkpoint plus a
journal of the current round's staged event blocks, on a directory every
worker can reach. Layout per session (the reference's, so a log written
by either package verifies and replays in the other)::

    <log_root>/<session>/
        meta.json                       # roster size + session knobs
        ledger.npz                      # state AFTER the last resolved
                                        # round (atomic, fsynced)
        staged/round_<k>_block_<i>.npz  # round k's journaled appends,
                                        # SHA-256 content-digested
        snapshot.npz                    # optional compaction record
                                        # (serve.stateplane): the open
                                        # round's journaled prefix, the
                                        # dedupe set and the ledger tree,
                                        # truncating the journal

Write ordering is what makes "zero lost resolutions" true:

- ``append`` journals the block (atomic write + digest) BEFORE folding
  it into the in-memory statistics: an append that returned to the
  caller is durable; an append that raised never happened anywhere.
- ``resolve`` records the round into the ledger and saves the
  checkpoint BEFORE clearing the round's journal: a crash between the
  two leaves stale staged files for an already-committed round, which
  replay recognizes by round index and discards.
- a crash BEFORE the ledger save leaves the previous checkpoint plus
  the full journal: replay re-resolves the round from identical inputs
  and, because every resolution path is deterministic on one device,
  produces the same bits the dead worker would have returned.

:func:`replay_session` is the hot-standby takeover path: VERIFY the
whole log first (:meth:`ReplicationLog.verify`, a dry run built on
``ReputationLedger._read_state``; a standby never adopts a corrupt log),
then rebuild a :class:`DurableSession` whose reputation, round count and
staged blocks are the dead worker's durable state, on the standby's
device and dtype. The ledger's float64 reputation enters the session
verbatim, so the resumed resolves equal the never-killed run's bit for
bit on the same device.

A compacted log replays its snapshot's prefix plus the journal suffix
behind it, bit for bit the full journal's replay (the snapshot is built
from the verified journal bytes, never from memory): a torn snapshot
over an intact journal is refused and ignored, and one over a truncated
journal raises ``SnapshotCorruptionError`` (PYC303).
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import re
from typing import Optional

import numpy as np

from ..faults import (CheckpointCorruptionError, InputError,
                      SnapshotCorruptionError)
from ..faults import plan as _faults
from ..io import atomic_write
from ..ledger import ReputationLedger
from ..oracle import parse_event_bounds
from .incremental import INCREMENTAL_REFRESH_DEFAULT
from .session import MarketSession

__all__ = ["ReplicationLog", "DurableSession", "replay_session"]

_META_FIELDS = ("session", "n_reporters", "alpha", "catch_tolerance",
                "convergence_tolerance")
_BLOCK_RE = re.compile(r"^round_(\d+)_block_(\d+)\.npz$")


def _digest(block: np.ndarray, bounds_json: bytes) -> str:
    h = hashlib.sha256()
    h.update(str(block.shape).encode())
    h.update(np.ascontiguousarray(block, dtype=np.float64).tobytes())
    h.update(bounds_json)
    return h.hexdigest()


class ReplicationLog:
    """One session's durable directory (see module docstring). Every
    mutation goes through ``io.atomic_write``, so a SIGKILL at any
    instruction leaves either the old record or the new; a torn FILE
    from a lost fsync is still detected (npz structure + content
    digest)."""

    def __init__(self, root, name: str) -> None:
        self.name = str(name)
        self.dir = pathlib.Path(root) / self.name
        self.staged_dir = self.dir / "staged"
        self.ledger_path = self.dir / "ledger.npz"
        self.meta_path = self.dir / "meta.json"
        self.snapshot_path = self.dir / "snapshot.npz"

    # -- creation / opening ---------------------------------------------

    @classmethod
    def create(cls, root, name: str, n_reporters: int,
               alpha: float = 0.1, catch_tolerance: float = 0.1,
               convergence_tolerance: float = 1e-6,
               incremental: bool = False,
               refresh_every: Optional[int] = None) -> "ReplicationLog":
        log = cls(root, name)
        if log.meta_path.exists():
            raise InputError(
                f"replication log for session {name!r} already exists "
                f"at {log.dir}", session=name)
        log.staged_dir.mkdir(parents=True, exist_ok=True)
        meta = {"session": log.name, "n_reporters": int(n_reporters),
                "alpha": float(alpha),
                "catch_tolerance": float(catch_tolerance),
                "convergence_tolerance": float(convergence_tolerance),
                # the incremental policy, so a standby resumes the same
                # refresh cadence (optional fields: a log without them
                # replays as a plain exact session)
                "incremental": bool(incremental),
                "refresh_every": int(
                    INCREMENTAL_REFRESH_DEFAULT if refresh_every is None
                    else refresh_every)}

        def write(tmp):
            pathlib.Path(tmp).write_text(json.dumps(meta, indent=2))
        atomic_write(log.meta_path, write)
        return log

    def exists(self) -> bool:
        return self.meta_path.exists()

    def meta(self) -> dict:
        try:
            meta = json.loads(self.meta_path.read_text())
        except FileNotFoundError:
            raise
        except Exception as exc:
            raise CheckpointCorruptionError(
                f"{self.meta_path}: session meta does not decode as JSON "
                f"({type(exc).__name__}: {exc})",
                source=str(self.meta_path)) from exc
        for field in _META_FIELDS:
            if field not in meta:
                raise CheckpointCorruptionError(
                    f"{self.meta_path}: session meta field {field!r} is "
                    f"missing", field=field, source=str(self.meta_path))
        return meta

    # -- the journal ----------------------------------------------------

    def _block_path(self, round_idx: int, block_idx: int) -> pathlib.Path:
        return self.staged_dir / (f"round_{int(round_idx):06d}"
                                  f"_block_{int(block_idx):06d}.npz")

    def journal_block(self, round_idx: int, block_idx: int, block,
                      event_bounds=None,
                      append_id: Optional[str] = None) -> pathlib.Path:
        """Durably journal one appended event block (atomic + digested)
        and return its path. Runs BEFORE the in-memory fold.
        ``append_id`` is the caller's idempotency token, kept with the
        record so a standby knows which logical appends the journal
        already carries: a client whose append landed but whose
        acknowledgment died with the worker can retry it without the
        block folding twice."""
        block = np.ascontiguousarray(block, dtype=np.float64)
        bounds_json = json.dumps(
            None if event_bounds is None else list(event_bounds)).encode()
        state = {
            "round": np.int64(round_idx),
            "index": np.int64(block_idx),
            "block": block,
            "bounds": np.frombuffer(bounds_json, dtype=np.uint8),
            "digest": np.frombuffer(
                _digest(block, bounds_json).encode(), dtype=np.uint8),
        }
        if append_id is not None:
            # optional field: id-less records lack it (the digest covers
            # content, the id covers retry identity)
            state["append_id"] = np.frombuffer(
                str(append_id).encode(), dtype=np.uint8)
        path = self._block_path(round_idx, block_idx)

        def write(tmp):
            np.savez(tmp, **state)
        return atomic_write(path, write, suffix=".tmp.npz")

    def _read_block(self, path: pathlib.Path) -> tuple:
        """Load + integrity-check one journaled block: ``(index, block,
        bounds, append_id)`` (``append_id`` None on id-less records);
        raises CheckpointCorruptionError naming the file on any
        structural or digest failure."""
        def bad(why, **ctx):
            return CheckpointCorruptionError(
                f"{path}: staged block {why}", source=str(path), **ctx)

        try:
            with np.load(path) as data:
                fields = set(data.files)
                for field in ("round", "index", "block", "bounds",
                              "digest"):
                    if field not in fields:
                        raise bad(f"field {field!r} is missing",
                                  field=field)
                block = np.asarray(data["block"], dtype=np.float64)
                bounds_json = bytes(np.asarray(data["bounds"],
                                               dtype=np.uint8))
                digest = bytes(np.asarray(data["digest"],
                                          dtype=np.uint8)).decode()
                index = int(np.asarray(data["index"]).item())
                append_id = (bytes(np.asarray(data["append_id"],
                                              dtype=np.uint8)).decode()
                             if "append_id" in fields else None)
        except CheckpointCorruptionError:
            raise
        except Exception as exc:
            # a torn final record: the npz zip structure itself is cut
            # short (BadZipFile / short read), the power-loss artifact
            raise bad(f"is unreadable ({type(exc).__name__}: {exc})") \
                from exc
        if _digest(block, bounds_json) != digest:
            raise bad("content digest mismatch (torn or tampered "
                      "replication record)")
        bounds = json.loads(bounds_json.decode())
        return index, block, bounds, append_id

    def _staged_entries(self, round_idx: int) -> list:
        """Sorted ``[(index, path), ...]`` of round ``round_idx``'s
        journal records on disk (the index read from the file name; no
        content is read)."""
        entries = []
        if self.staged_dir.exists():
            for p in sorted(self.staged_dir.iterdir()):
                m = _BLOCK_RE.match(p.name)
                if m and int(m.group(1)) == int(round_idx):
                    entries.append((int(m.group(2)), p))
        entries.sort()
        return entries

    def staged(self, round_idx: int, start: int = 0) -> list:
        """The journaled blocks of round ``round_idx`` in append order:
        ``[(block, bounds, append_id), ...]``. Validates digests and index
        contiguity (a gap means a lost record: replication is torn,
        refuse). ``start`` is the compaction suffix: records below it are
        the snapshot's, and any still on disk (a crash between the
        snapshot's write and the truncation) are skipped; contiguity is
        then required from ``start``."""
        out, indices = [], []
        for name_idx, p in self._staged_entries(round_idx):
            if name_idx < int(start):
                continue            # covered by the snapshot
            index, block, bounds, append_id = self._read_block(p)
            indices.append(index)
            out.append((block, bounds, append_id))
        if indices != list(range(int(start), int(start) + len(indices))):
            raise CheckpointCorruptionError(
                f"{self.staged_dir}: staged blocks of round {round_idx} "
                f"are not contiguous from {int(start)} (got indices "
                f"{indices}) — a journal record is missing",
                source=str(self.staged_dir), round=int(round_idx),
                indices=indices)
        return out

    def truncate_staged(self, round_idx: int, upto: int) -> int:
        """Unlink round ``round_idx``'s records with index below
        ``upto``, which the snapshot now carries. Called only after the
        snapshot's write landed and read back whole; ``state.compact``
        fires before each unlink, so a crash can stop the truncation at
        any record and the replay still folds the snapshot's prefix plus
        the surviving records. Returns the number of records removed."""
        removed = 0
        for name_idx, p in self._staged_entries(round_idx):
            if name_idx < int(upto):
                _faults.fire("state.compact")
                p.unlink(missing_ok=True)
                removed += 1
        return removed

    def journal_bytes(self) -> int:
        """Bytes of the staged journal on disk: what compaction shrinks
        and ``pyconsensus_session_journal_bytes`` reports."""
        total = 0
        if self.staged_dir.exists():
            for p in self.staged_dir.iterdir():
                try:
                    total += p.stat().st_size
                except OSError:
                    pass            # unlinked by a racing truncation
        return total

    def commit_round(self, ledger: ReputationLedger) -> None:
        """Persist the post-round ledger state, then clear every staged
        record of now-closed rounds (anything below ``ledger.round``).
        The ledger save is the commit point; the cleanup is garbage
        collection a crash may skip and replay tolerates."""
        ledger.save(self.ledger_path)
        if self.staged_dir.exists():
            for p in sorted(self.staged_dir.iterdir()):
                m = _BLOCK_RE.match(p.name)
                if m and int(m.group(1)) < ledger.round:
                    p.unlink(missing_ok=True)

    # -- verification + replay ------------------------------------------

    def verify(self) -> dict:
        """The takeover preflight: a DRY RUN over the whole log (meta,
        the ledger checkpoint's full validation, the snapshot, every
        staged block of the current round: digest + contiguity) with zero
        state mutation. Returns a summary dict; raises
        :class:`CheckpointCorruptionError` naming the offending field or
        file."""
        return self.verify_collect()[0]

    def verify_collect(self) -> tuple:
        """:meth:`verify` plus what the takeover replay needs:
        ``(summary, [(block, bounds, append_id), ...],
        ledger_state_or_None, dedupe_ids)``, so the journal, the snapshot
        and the checkpoint are each read and validated once inside the
        takeover window.

        A valid ``snapshot.npz`` at the ledger's open round contributes
        its journaled prefix (the staged list is the snapshot's prefix
        plus the suffix on disk); a snapshot of an older round is stale:
        its prefix is ignored, its dedupe set (the only durable record
        of committed rounds' idempotency tokens) is kept. A torn snapshot
        over an intact journal is refused and ignored
        (``pyconsensus_compactions_total{outcome="refused"}``); over a
        truncated journal it raises ``SnapshotCorruptionError``
        (PYC303)."""
        meta = self.meta()
        summary = {"session": meta["session"],
                   "n_reporters": int(meta["n_reporters"]),
                   "round": 0, "staged_blocks": 0, "ledger": None,
                   "snapshot": None}
        state = None
        if self.ledger_path.exists():
            state = ReputationLedger._read_state(self.ledger_path)
            n_reporters = int(state["reputation"].shape[0])
            if n_reporters != int(meta["n_reporters"]):
                raise CheckpointCorruptionError(
                    f"{self.ledger_path}: ledger carries "
                    f"{n_reporters} reporters, session "
                    f"meta declares {meta['n_reporters']}",
                    field="reputation", source=str(self.ledger_path))
            summary["ledger"] = {"n_reporters": n_reporters,
                                 "round": int(state["round"]),
                                 "rounds_recorded": len(state["history"])}
            summary["round"] = int(state["round"])
        open_round = summary["round"]
        prefix, dedupe, start, hint = [], set(), 0, None
        if self.snapshot_path.exists():
            from .stateplane import (count_compaction, load_snapshot,
                                     snapshot_hint)
            try:
                snap = load_snapshot(self.snapshot_path)
            except CheckpointCorruptionError as exc:
                snap = None
                summary["snapshot"] = {"refused": str(exc)}
                count_compaction("refused")
                # what the refused bytes still declare they covered: the
                # journal below must account for it (checked after the
                # suffix is read)
                hint = snapshot_hint(self.snapshot_path)
            if snap is not None:
                dedupe = set(snap["dedupe"])
                stale = int(snap["round"]) != open_round
                summary["snapshot"] = {"round": int(snap["round"]),
                                       "blocks": len(snap["blocks"]),
                                       "stale": stale}
                if not stale:
                    prefix = snap["blocks"]
                    start = len(prefix)
        try:
            suffix = self.staged(open_round, start=start)
        except CheckpointCorruptionError:
            if start == 0:
                # no usable snapshot covers the gap: with a snapshot file
                # present the missing prefix was truncated behind it
                entries = self._staged_entries(open_round)
                if entries and entries[0][0] > 0 \
                        and self.snapshot_path.exists():
                    raise SnapshotCorruptionError(
                        f"{self.snapshot_path}: the journal of round "
                        f"{open_round} was truncated behind a snapshot "
                        f"that cannot be used "
                        f"({summary.get('snapshot')}) — "
                        f"{entries[0][0]} prefix record(s) are gone; "
                        f"recover from the shipped copy",
                        path=str(self.snapshot_path),
                        reason="truncated-journal",
                        missing_prefix=int(entries[0][0]),
                        round=int(open_round))
            raise
        if start == 0 and hint is not None:
            hint_round, hint_blocks = hint
            if hint_round == open_round and len(suffix) < hint_blocks:
                # the journal reads clean but holds fewer records than
                # the refused snapshot covered: the truncation landed
                raise SnapshotCorruptionError(
                    f"{self.snapshot_path}: the refused snapshot "
                    f"declares {hint_blocks} covered block(s) of round "
                    f"{open_round} but only {len(suffix)} journal "
                    f"record(s) survive — the truncated prefix exists "
                    f"nowhere readable; recover from the shipped copy",
                    path=str(self.snapshot_path),
                    reason="truncated-journal",
                    missing_prefix=int(hint_blocks - len(suffix)),
                    round=int(open_round))
        staged = list(prefix) + suffix
        summary["staged_blocks"] = len(staged)
        return summary, staged, state, dedupe


class DurableSession(MarketSession):
    """A :class:`MarketSession` whose every accepted mutation is durable
    in a :class:`ReplicationLog` before it is acknowledged: the unit of
    state the fleet fails over with zero lost resolutions. Use
    :meth:`create` for a fresh session (it commits the starting
    reputation, so a non-uniform prior survives a round-0 crash) and
    :func:`replay_session` to resume a dead worker's. ``device`` and
    ``dtype`` are the session's (see :class:`MarketSession`)."""

    def __init__(self, log: ReplicationLog, n_reporters: int,
                 ledger: ReputationLedger, **kwargs) -> None:
        super().__init__(log.name, n_reporters, ledger=ledger, **kwargs)
        self._log = log
        self._fenced = None
        self.rounds_resolved = ledger.round
        #: idempotency tokens of the appends this session applied: a
        #: retried append whose original landed folds nothing the second
        #: time. Seeded from the journal (and the snapshot) at replay.
        self._applied_append_ids: set = set()   # guarded-by: _lock
        #: the last compaction snapshot's round (None: never) and the
        #: blocks it covered: what the compaction policy counts from
        self._snap_round: Optional[int] = None  # guarded-by: _lock
        self._snap_blocks: int = 0              # guarded-by: _lock

    @classmethod
    def create(cls, log_root, name: str, n_reporters: int,
               reputation=None, alpha: float = 0.1,
               catch_tolerance: float = 0.1,
               convergence_tolerance: float = 1e-6,
               incremental: bool = False,
               refresh_every: int = INCREMENTAL_REFRESH_DEFAULT,
               executable_provider=None, device=None,
               dtype=None) -> "DurableSession":
        log = ReplicationLog.create(
            log_root, name, n_reporters, alpha=alpha,
            catch_tolerance=catch_tolerance,
            convergence_tolerance=convergence_tolerance,
            incremental=incremental, refresh_every=refresh_every)
        ledger = ReputationLedger(n_reporters, reputation=reputation)
        session = cls(log, n_reporters, ledger, alpha=alpha,
                      catch_tolerance=catch_tolerance,
                      convergence_tolerance=convergence_tolerance,
                      incremental=incremental,
                      refresh_every=refresh_every,
                      executable_provider=executable_provider,
                      device=device, dtype=dtype)
        # commit round 0: the starting reputation is durable before the
        # first append, so a standby replaying an empty journal starts
        # from the prior the caller configured
        log.commit_round(ledger)
        return session

    @property
    def log(self) -> ReplicationLog:
        return self._log

    def _admit(self, block):
        return block   # applied pre-journal in append()

    def fence(self, exc: BaseException) -> None:
        """Fence this object at takeover: every later ``append`` /
        ``resolve`` raises ``exc``. Taking the session lock means an
        in-flight mutation finishes its journal write FIRST (the replay
        that follows reads it), and anything after the fence was never
        acknowledged."""
        with self._lock:
            self._fenced = exc

    @property
    def fenced(self) -> Optional[BaseException]:
        """The error :meth:`fence` set (None while unfenced)."""
        return self._fenced

    def journal_bytes(self) -> int:
        """Bytes of this session's staged journal on disk: the
        compaction policy's size signal."""
        return self._log.journal_bytes()

    def compact(self) -> dict:
        """Snapshot-truncate this session's journal: write
        ``snapshot.npz`` (the open round's journaled prefix, the
        cumulative dedupe set and the ledger tree), read it back whole,
        then unlink the records it covers. The snapshot is built from the
        verified journal on disk (the takeover's read path), never from
        memory, so snapshot plus suffix replays bit for bit the full
        journal. Under the session lock: no append journals between the
        read and the truncation. A crash anywhere loses nothing: before
        the snapshot's rename the old state is whole, after it the
        truncation is garbage collection the replay tolerates. Returns a
        report dict."""
        from .stateplane import (count_compaction, load_snapshot,
                                 write_snapshot)

        with self._lock:
            if self._fenced is not None:
                raise self._fenced
            bytes_before = self._log.journal_bytes()
            summary, staged, _, dedupe = self._log.verify_collect()  # consensus-lint: disable=CL802 — the snapshot's covered prefix must be exact against racing appends
            open_round = int(summary["round"])
            # the cumulative dedupe set: the old snapshot's, every
            # journaled token, and the tokens of committed rounds whose
            # records the commit removed (this snapshot keeps them)
            dedupe = set(dedupe)
            dedupe.update(aid for _, _, aid in staged if aid is not None)
            dedupe.update(self._applied_append_ids)
            write_snapshot(self._log, open_round, staged, dedupe,
                           self.ledger._state_tree())
            # verify before truncating: a torn write is caught while the
            # journal is still whole (PYC301; the next sweep retries)
            try:
                load_snapshot(self._log.snapshot_path)
            except CheckpointCorruptionError:
                count_compaction("refused")
                raise
            removed = self._log.truncate_staged(open_round, len(staged))
            self._snap_round = open_round
            self._snap_blocks = len(staged)
            bytes_after = self._log.journal_bytes()
        return {"session": self.name, "round": open_round,
                "blocks": len(staged), "records_removed": removed,
                "bytes_before": int(bytes_before),
                "bytes_after": int(bytes_after)}

    def append(self, reports_block, event_bounds=None,
               append_id: Optional[str] = None) -> int:
        # journal-then-fold under the session lock: the journal index is
        # the in-memory block count, and no interleaved append may slip
        # between the durable write and the fold (replay order must be
        # the fold order)
        with self._lock:
            if self._fenced is not None:
                raise self._fenced
            if append_id is not None \
                    and append_id in self._applied_append_ids:
                # the retry of an append that already landed: acknowledge
                # without journaling or folding a second copy
                return self.n_events
            block = np.asarray(reports_block, dtype=np.float64)
            if block.ndim == 1:
                block = block[:, None]
            if block.ndim != 2 or block.shape[0] != self.n_reporters:
                raise InputError(
                    f"appended block must be ({self.n_reporters}, e), "
                    f"got {block.shape}", shape=tuple(block.shape))
            # validate BEFORE journaling: a refused append must leave no
            # record for replay to fold
            parse_event_bounds(event_bounds, block.shape[1])
            # the injection seam fires before the journal write, so the
            # log and the fold see the same (possibly corrupted) bytes
            block = MarketSession._admit(self, block)
            path = self._log.journal_block(self.ledger.round,  # consensus-lint: disable=CL802 — ack-iff-durable needs the journal write inside the critical section
                                           len(self._blocks), block,
                                           event_bounds,
                                           append_id=append_id)
            try:
                total = super().append(block, event_bounds)
                if append_id is not None:
                    self._applied_append_ids.add(append_id)
                return total
            except BaseException:
                # the fold failed AFTER the journal write: the caller is
                # told this append never happened, so the record must
                # not survive for replay to fold. If even the unlink
                # fails, fence: journal and memory disagree.
                try:
                    path.unlink(missing_ok=True)
                except OSError as cleanup:
                    self._fenced = CheckpointCorruptionError(
                        f"session {self.name!r} is fenced: a failed "
                        f"append left an orphan journal record that "
                        f"could not be removed ({cleanup})",
                        session=self.name, source=str(path))
                raise

    def resolve(self, algorithm: str = "sztorc", max_iterations: int = 1,
                **oracle_kwargs) -> dict:
        with self._lock:
            if self._fenced is not None:
                raise self._fenced
            result = super().resolve(algorithm=algorithm,
                                     max_iterations=max_iterations,
                                     **oracle_kwargs)
            # commit point, under the lock: an append released between
            # resolve and commit would journal under a round index the
            # commit then garbage-collects
            try:
                self._log.commit_round(self.ledger)  # consensus-lint: disable=CL802 — round close must be atomic with the in-memory resolve
            except BaseException as exc:
                # resolved in memory, not on disk: this object is one
                # round ahead of its log. Fence instead of serving on;
                # the durable log (previous checkpoint + the round's
                # journal) replays this round bit for bit on a standby.
                self._fenced = CheckpointCorruptionError(
                    f"session {self.name!r} is fenced: round "
                    f"{self.ledger.round} resolved but its ledger "
                    f"commit failed ({type(exc).__name__}: {exc}) — "
                    f"replay the replication log to resume",
                    session=self.name,
                    source=str(self._log.ledger_path))
                raise
        return result


def replay_session(log_root, name: str, executable_provider=None,
                   device=None, dtype=None) -> DurableSession:
    """Hot-standby takeover of one session: verify the dead worker's log
    (no corrupt log is ever adopted), rebuild the ledger from its
    validated state verbatim, and re-fold the journaled blocks in append
    order on ``device`` (None: the card) in ``dtype`` (None: the default
    dtype). The returned session is the dead worker's in-memory session
    at its last acknowledged operation.

    The ``fleet.ledger_replay`` fault site exposes the ledger file, so a
    ``torn_write`` rule can tear the log between death and adoption; the
    verify preflight then refuses with PYC301."""
    log = ReplicationLog(log_root, name)
    _faults.fire("fleet.ledger_replay",
                 path=log.ledger_path if log.ledger_path.exists()
                 else None)
    summary, staged, state, dedupe = log.verify_collect()
    if state is not None:
        ledger = ReputationLedger._from_state(state,
                                              source=log.ledger_path)
    else:                       # pre-commit round-0 crash: fresh uniform
        ledger = ReputationLedger(summary["n_reporters"])
    meta = log.meta()
    session = DurableSession(
        log, int(meta["n_reporters"]), ledger,
        alpha=float(meta["alpha"]),
        catch_tolerance=float(meta["catch_tolerance"]),
        convergence_tolerance=float(meta["convergence_tolerance"]),
        incremental=bool(meta.get("incremental", False)),
        refresh_every=int(meta.get("refresh_every",
                                   INCREMENTAL_REFRESH_DEFAULT)),
        executable_provider=executable_provider, device=device,
        dtype=dtype)
    # the snapshot's dedupe set first: the only durable record of the
    # committed rounds' idempotency tokens
    session._applied_append_ids.update(dedupe)
    for block, bounds, append_id in staged:
        # fold WITHOUT re-journaling (the records exist): the same
        # arithmetic the dead worker ran against the same reputation;
        # the journal's tokens seed the standby's dedupe set
        MarketSession.append(session, block, bounds)
        if append_id is not None:
            session._applied_append_ids.add(append_id)
    snap = summary.get("snapshot") or {}
    if snap.get("round") == summary["round"] and not snap.get("stale"):
        # the compaction policy counts from the adopted snapshot
        session._snap_round = int(snap["round"])
        session._snap_blocks = int(snap["blocks"])
    return session
