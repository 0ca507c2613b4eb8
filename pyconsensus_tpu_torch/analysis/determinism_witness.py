"""Runtime digest witness — the dynamic mirror of Layer 6 (CL1001-04).

:mod:`.determinism` proves statically that no unordered iteration,
completion-order fold, or host-nondeterministic value reaches a
digest/journal/ledger sink; this module checks the property the proof
is *about*: the digests the running code actually produces must be
**re-derivable from the durable artifacts alone**. A
:class:`DigestWitness` monkeypatches four digest-bearing surfaces
while installed:

- ``ReplicationLog.journal_block`` — records the (session, round,
  block) key and the content digest the journal writer computed, after
  the write returns;
- ``ReputationLedger.record_round`` — records the round number and a
  canonical-JSON digest of the history record the call appended (the
  record is pure derived scalars, so the SAME digest must fall out of
  the on-disk checkpoint on replay);
- ``ReplicationLog.commit_round`` — records the committing ledger's
  full history as a canonical digest list, keyed by log. The commit is
  what links an in-memory ledger to a durable checkpoint, so the
  replay comparison is per-log and exact — no cross-session round
  ambiguity;
- ``econ.scoreboard.mechanism_digest`` — records the digest AND
  recomputes it immediately over the reversed-insertion-order view of
  the same input dict. The function's sorted() fold makes it
  order-invariant by construction; a divergence here means someone
  edited the fold without keeping the invariant, and the witness
  raises at the call site, not at teardown.

:meth:`DigestWitness.check` then replays the durable side: every
journaled block file still on disk is re-read through the log's own
validating reader and its digest compared against the recorded one;
every committed log's ledger checkpoint is re-loaded through
``ReputationLedger._from_state`` and its replayed history digests
compared against the last recorded commit; and every witnessed
``record_round`` whose ledger was committed to a tracked log must
reappear digest-identical in that log's replayed history. The first
diverging op raises :class:`DeterminismWitnessViolation` naming the op
and BOTH digests — the exact two bits a failover postmortem needs.
Files the round commit's garbage collection already unlinked, log dirs
a test removed, and ledgers that never committed to any tracked log
are skipped: the witness constrains agreement, not retention.

The port's fleet, economy and autoscale suites run under the witness
through module-level autouse fixtures, and ``chip_smoke.py --only
witness`` installs one around its fleet and economy blocks on the
card.

Overhead: one digest + list append per journaled block / recorded
round / commit; nothing in the serving path imports this module.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import importlib
import json
import pathlib
import threading
from typing import List, Optional, Tuple

__all__ = ["DigestWitness", "DeterminismWitnessViolation",
           "digest_witnessed"]

#: real constructor bound at import time so the witness's own state
#: lock is never itself a (lock-)witnessed proxy when both witnesses
#: are installed in the same test
_REAL_LOCK = threading.Lock


def _canonical_record_digest(record: dict) -> str:
    """Digest of one ledger history record in canonical JSON — the
    round's derived scalars, independent of dict insertion order."""
    return hashlib.sha256(
        json.dumps(record, sort_keys=True).encode()).hexdigest()


class DeterminismWitnessViolation(AssertionError):
    """A recorded digest does not match its replay from the durable
    artifact (or an order-invariance recompute). ``op`` names the
    diverging operation, ``recorded``/``replayed`` carry both digests,
    ``dump_path`` where the full witness JSON landed."""

    def __init__(self, message: str, op: str = "",
                 recorded: str = "", replayed: str = "",
                 dump_path: Optional[str] = None):
        super().__init__(message)
        self.op = op
        self.recorded = recorded
        self.replayed = replayed
        self.dump_path = dump_path


class DigestWitness:
    """Records the (op, digest) stream of every journaled block,
    recorded round, ledger commit, and mechanism digest while
    installed; :meth:`check` replays each through the durable artifact
    and raises on the first divergence. Use :func:`digest_witnessed`
    for the context-manager form."""

    def __init__(self):
        self._mu = _REAL_LOCK()
        #: [{"op", "key", "digest", ...}, ...] in call order
        self.records: List[dict] = []
        self._installed = False
        self._saved: List[Tuple[object, str, object]] = []

    # -- recording ------------------------------------------------------

    def _record(self, op: str, key: str, digest: str, **extra) -> None:
        with self._mu:
            self.records.append(
                {"op": op, "key": key, "digest": digest, **extra})

    # -- shims ----------------------------------------------------------

    def _wrap_journal_block(self, real):
        w = self

        @functools.wraps(real)
        def wrapper(log, round_idx, block_idx, block, event_bounds=None,
                    append_id=None):
            result = real(log, round_idx, block_idx, block,
                          event_bounds=event_bounds, append_id=append_id)
            from ..serve.failover import _digest
            import numpy as np

            blk = np.ascontiguousarray(block, dtype=np.float64)
            bounds_json = json.dumps(
                None if event_bounds is None
                else list(event_bounds)).encode()
            w._record(
                "journal_block",
                f"{log.name}:round{int(round_idx)}:block{int(block_idx)}",
                _digest(blk, bounds_json),
                root=str(log.dir.parent), name=log.name,
                round=int(round_idx), block=int(block_idx))
            return result

        return wrapper

    def _wrap_record_round(self, real):
        w = self

        @functools.wraps(real)
        def wrapper(ledger, result):
            out = real(ledger, result)
            w._record("record_round", f"round{int(ledger.round)}",
                      _canonical_record_digest(ledger.history[-1]),
                      round=int(ledger.round), ledger_id=id(ledger),
                      hist_index=len(ledger.history) - 1)
            return out

        return wrapper

    def _wrap_commit_round(self, real):
        w = self

        @functools.wraps(real)
        def wrapper(log, ledger):
            result = real(log, ledger)
            digests = [_canonical_record_digest(rec)
                       for rec in ledger.history]
            w._record(
                "commit_round", f"{log.name}:round{int(ledger.round)}",
                hashlib.sha256("".join(digests).encode()).hexdigest(),
                root=str(log.dir.parent), name=log.name,
                digests=digests, ledger_id=id(ledger))
            return result

        return wrapper

    def _wrap_mechanism_digest(self, real):
        w = self

        @functools.wraps(real)
        def wrapper(final_reps):
            digest = real(final_reps)
            # order-invariance recompute AT the call site: the reversed
            # insertion order must produce the identical digest (the
            # sorted() fold inside is the invariant Layer 6 trusts)
            reordered = real(dict(reversed(list(final_reps.items()))))
            if reordered != digest:
                raise DeterminismWitnessViolation(
                    f"mechanism_digest is insertion-order-dependent: "
                    f"{digest} (given order) vs {reordered} (reversed) "
                    f"over the same {len(final_reps)} market(s)",
                    op="mechanism_digest", recorded=digest,
                    replayed=reordered)
            w._record("mechanism_digest",
                      f"{len(final_reps)}markets", digest)
            return digest

        return wrapper

    def install(self) -> "DigestWitness":
        if self._installed:
            return self
        failover = importlib.import_module(
            "pyconsensus_tpu_torch.serve.failover")
        ledger_mod = importlib.import_module(
            "pyconsensus_tpu_torch.ledger")
        scoreboard = importlib.import_module(
            "pyconsensus_tpu_torch.econ.scoreboard")
        targets = (
            (failover.ReplicationLog, "journal_block",
             self._wrap_journal_block),
            (failover.ReplicationLog, "commit_round",
             self._wrap_commit_round),
            (ledger_mod.ReputationLedger, "record_round",
             self._wrap_record_round),
            (scoreboard, "mechanism_digest",
             self._wrap_mechanism_digest),
        )
        for holder, name, wrap in targets:
            real = (holder.__dict__[name] if isinstance(holder, type)
                    else getattr(holder, name))
            self._saved.append((holder, name, real))
            setattr(holder, name, wrap(real))
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for holder, name, real in self._saved:
            setattr(holder, name, real)
        self._saved = []
        self._installed = False

    # -- validation -----------------------------------------------------

    def report(self) -> dict:
        with self._mu:
            return {"records": [dict(r) for r in self.records]}

    def dump(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.report(), indent=2) + "\n",
                        encoding="utf-8")
        return path

    def _raise(self, op: str, recorded: str, replayed: str,
               dump_path) -> None:
        dumped = str(self.dump(dump_path)) if dump_path is not None \
            else None
        raise DeterminismWitnessViolation(
            f"digest divergence at {op}: recorded {recorded} at call "
            f"time, replayed {replayed} from the durable artifact"
            + (f" (witness dumped to {dumped})" if dumped else ""),
            op=op, recorded=recorded, replayed=replayed,
            dump_path=dumped)

    def check(self, dump_path=None) -> dict:
        """Replay every recorded digest through the durable side and
        assert agreement (see the module docstring for exactly what is
        replayed and what is skipped). Returns the report — augmented
        with ``recorded``/``checked``/``skipped`` counts — on success;
        dumps it and raises :class:`DeterminismWitnessViolation` on the
        first divergence."""
        from ..serve.failover import ReplicationLog, _digest
        from ..faults import CheckpointCorruptionError
        from ..ledger import ReputationLedger
        import numpy as np

        with self._mu:
            records = [dict(r) for r in self.records]
        # mechanism_digest entries were verified at the call site; they
        # count as checked without a teardown replay
        checked = sum(1 for r in records if r["op"] == "mechanism_digest")
        skipped = 0

        # the LAST commit per (root, name) is the checkpoint the file
        # currently holds (each save overwrites); its ledger_id links
        # the in-memory record_round stream to that log
        last_commit: dict = {}
        for rec in records:
            if rec["op"] == "commit_round":
                last_commit[(rec["root"], rec["name"])] = rec

        # replayed per-log history digests (None = artifact gone: skip)
        disk_history: dict = {}
        for (root, name), commit in last_commit.items():
            log = ReplicationLog(root, name)
            if not (log.dir.exists() and log.ledger_path.exists()):
                disk_history[(root, name)] = None
                continue
            try:
                # the history is host data: the replay needs no card
                led = ReputationLedger._from_state(
                    ReputationLedger._read_state(log.ledger_path),
                    source=str(log.ledger_path), device="cpu")
            except CheckpointCorruptionError:
                # a corruption test tore the checkpoint on purpose; the
                # runtime reader refuses it loudly — that refusal is the
                # tested behavior, not a digest disagreement
                disk_history[(root, name)] = None
                continue
            disk_history[(root, name)] = [
                _canonical_record_digest(rec) for rec in led.history]

        # commit replay: the checkpoint on disk must carry exactly the
        # history the last witnessed commit serialized
        for (root, name), commit in last_commit.items():
            replayed = disk_history[(root, name)]
            if replayed is None:
                skipped += 1
                continue
            checked += 1
            if replayed != commit["digests"]:
                diverge = next(
                    (i for i, (a, b) in enumerate(
                        zip(commit["digests"], replayed)) if a != b),
                    min(len(commit["digests"]), len(replayed)))
                rec_d = (commit["digests"][diverge]
                         if diverge < len(commit["digests"]) else "<absent>")
                rep_d = (replayed[diverge]
                         if diverge < len(replayed) else "<absent>")
                self._raise(
                    f"commit_round[{commit['key']}] history record "
                    f"{diverge}", rec_d, rep_d, dump_path)

        # record_round replay: a witnessed round whose ledger committed
        # to a tracked log must reappear digest-identical in that log's
        # replayed history (ledgers that never committed are skipped)
        log_of_ledger = {c["ledger_id"]: key
                         for key, c in last_commit.items()}
        for rec in records:
            if rec["op"] != "record_round":
                continue
            key = log_of_ledger.get(rec.get("ledger_id"))
            if key is None or disk_history.get(key) is None:
                skipped += 1
                continue
            replayed = disk_history[key]
            idx = int(rec["hist_index"])
            if idx >= len(replayed):
                skipped += 1
                continue    # recorded after the last commit: not durable
            checked += 1
            if rec["digest"] != replayed[idx]:
                self._raise(f"record_round[{rec['key']}]",
                            rec["digest"], replayed[idx], dump_path)

        # journal replay: every journaled block still on disk re-reads
        # to the digest the writer computed
        for rec in records:
            if rec["op"] != "journal_block":
                continue
            log = ReplicationLog(rec["root"], rec["name"])
            if not log.dir.exists():
                skipped += 1
                continue            # test tore the dir down: skip
            path = log._block_path(rec["round"], rec["block"])
            if not path.exists():
                skipped += 1
                continue            # GC'd by a later commit_round
            try:
                _, blk, bounds, _ = log._read_block(path)
            except CheckpointCorruptionError:
                skipped += 1
                continue    # deliberately torn record: the reader's
            # refusal IS the behavior corruption tests pin
            checked += 1
            replayed = _digest(
                np.ascontiguousarray(blk, dtype=np.float64),
                json.dumps(None if bounds is None
                           else list(bounds)).encode())
            if replayed != rec["digest"]:
                self._raise(f"journal_block[{rec['key']}]",
                            rec["digest"], replayed, dump_path)
        report = self.report()
        report.update(recorded=len(records), checked=checked,
                      skipped=skipped)
        return report


@contextlib.contextmanager
def digest_witnessed(check: bool = True, dump_path=None):
    """Install a fresh :class:`DigestWitness` for the block; on clean
    exit, :meth:`~DigestWitness.check` it. The witness is always
    uninstalled, even on error."""
    w = DigestWitness()
    w.install()
    try:
        yield w
    finally:
        w.uninstall()
    if check:
        w.check(dump_path=dump_path)
