"""Structured consensus error taxonomy (``pyconsensus_tpu/faults/errors.py``:
the same classes and the same codes).

Every failure the pipeline can *diagnose* carries a stable ``error_code``
so operators (and the chaos suite) can alert on classes of failure
instead of grepping message strings. The classes double-inherit from the
builtin exception the pre-taxonomy code raised (``ValueError`` for input
and checkpoint problems, ``ArithmeticError`` for numeric ones), so every
existing ``except ValueError`` / ``pytest.raises(ValueError)`` caller
keeps working — the taxonomy *narrows* what is raised, it never widens
what must be caught.

Code space:

- ``PYC1xx`` — input: malformed files, ragged CSV rows, bad shapes,
  non-finite reputation, empty matrices. The caller's data is wrong.
- ``PYC2xx`` — numerics: non-finite values escaping into (or out of) the
  resolution after quarantine/fallback exhausted the degradation chain.
  ``PYC201`` is the generic case; ``PYC202`` marks a detected
  power-family PCA non-convergence (residual plateau / collapsed
  loading) that survived every fallback rung.
- ``PYC3xx`` — checkpoint: torn/corrupted/incomplete persisted state
  (ledger checkpoints, sweep chunks). Always names the offending field
  or file so a resume failure is actionable without a debugger.
- ``PYC4xx`` — service: the consensus serving layer
  (``pyconsensus_tpu.serve``) refused or shed a request by POLICY —
  bounded queue full, per-tenant rate limit exceeded, deadline passed
  before dispatch, or shutdown drain in progress. The request itself is
  well-formed; retrying later (the ``context`` carries ``retry``
  guidance) is the expected recovery.
- ``PYC5xx`` — fleet: the replicated serve fleet
  (``pyconsensus_tpu.serve.fleet``) could not place or complete a
  request because of a WORKER fault rather than load policy — the
  owning worker died with the request in flight (``PYC501``), its
  sessions are mid-takeover on the standby (``PYC502``), or no worker
  can own the key at all (``PYC503``). ``PYC501``/``PYC502`` carry an
  honest ``retry_after_s`` (the expected takeover window) — the client
  retries and lands on the survivor; ``PYC503`` is a deployment error
  (empty fleet / unknown worker), not retryable.
- ``PYC6xx`` — transport: the out-of-process socket/RPC layer
  (``pyconsensus_tpu.serve.transport``) refused a frame or a peer.
  ``PYC601`` is a damaged or ill-formed WIRE artifact (torn/truncated
  frame, payload digest mismatch, oversized frame, foreign magic) —
  the bytes are refused, never half-decoded; whether to reconnect is
  the caller's call (the fleet translates a dead peer into PYC501).
  ``PYC602`` is a HANDSHAKE refusal: the peer speaks a different
  protocol version or carries a different runtime fingerprint
  (framework version, platform, device generation) — a
  wrong-toolchain worker must be refused at connect, before any
  request could be served with bits compiled by a different world.
  Neither is retryable through ``faults.retry`` (retrying identical
  bytes or an identical fingerprint cannot succeed); transient SOCKET
  errors stay ``OSError`` and ride the bounded-reconnect path.

``context`` keyword arguments are stored on the exception (``.context``)
for structured logging; the message stays human-first.
"""

from __future__ import annotations

__all__ = ["ConsensusError", "InputError", "NumericsError",
           "ConvergenceError", "CheckpointCorruptionError",
           "AotCacheCorruptionError", "SnapshotCorruptionError",
           "ServiceOverloadError",
           "WorkerLostError", "FailoverInProgressError",
           "PlacementError", "TransportError", "HandshakeError",
           "ERROR_CODES"]


class ConsensusError(Exception):
    """Base of the structured taxonomy. ``error_code`` is stable across
    releases; ``context`` carries machine-readable details (row/column
    indices, field names, file paths)."""

    error_code = "PYC000"

    def __init__(self, message: str = "", **context) -> None:
        super().__init__(message)
        self.context = dict(context)

    def __str__(self) -> str:  # "[PYC101] path: bad field ..." in logs
        return f"[{self.error_code}] {super().__str__()}"


class InputError(ConsensusError, ValueError):
    """The caller's data is malformed: ragged/truncated CSV rows, a
    non-2-D or empty reports matrix, non-finite reputation, unknown
    formats. Subclasses ``ValueError`` — the exception this replaced."""

    error_code = "PYC101"


class NumericsError(ConsensusError, ArithmeticError):
    """Non-finite values survived quarantine and the whole documented
    fallback chain (``faults.degrade``) — the resolution cannot produce
    a trustworthy answer and refuses to return a poisoned one."""

    error_code = "PYC201"


class ConvergenceError(NumericsError):
    """A power-family PCA scorer failed to converge (residual plateau /
    collapsed loading detected on the host result) and every fallback
    rung — exact Gram eigh, then the numpy reference path — failed too."""

    error_code = "PYC202"


class CheckpointCorruptionError(ConsensusError, ValueError):
    """Persisted state failed validation on restore: a missing or
    malformed field in a ledger checkpoint, a sweep chunk whose content
    checksum does not match, a torn npz. The message names the offending
    field/file; recovery (re-dispatch, re-compute) is the caller's call —
    ``CheckpointedSweep`` recomputes, ``ReputationLedger.load`` raises."""

    error_code = "PYC301"


class AotCacheCorruptionError(CheckpointCorruptionError):
    """A persisted AOT bucket executable failed verify-before-adopt
    (``serve.aotcache``): torn/truncated file, payload digest
    mismatch, or a compatibility-fingerprint miss (different compiler
    version, device generation, topology, or BucketKey). The entry is
    REFUSED and deleted — deserializing it could install an executable
    compiled for different hardware or a different toolchain — and the
    bucket transparently recompiles. ``context`` carries the machine
    fields (``reason``, ``path``, expected vs found); the message names
    the refusing check. A corruption subclass of PYC301 rather than a
    new family: the recovery semantics (never adopt, rebuild from
    source of truth) are the checkpoint discipline's."""

    error_code = "PYC302"


class SnapshotCorruptionError(CheckpointCorruptionError):
    """A compaction snapshot (``serve.stateplane``) failed
    verify-before-adopt AND the journal suffix behind it was already
    truncated — the one state-plane failure that cannot self-heal from
    local disk alone. A torn/corrupt snapshot whose journal is still
    intact (the crash landed between snapshot write and truncation) is
    NOT this error: replay simply ignores the bad snapshot, rebuilds
    from the untruncated journal, and the next compaction sweep
    replaces it (``pyconsensus_compactions_total{outcome="refused"}``).
    This class fires only when records the snapshot was supposed to
    cover are gone, so adopting the session locally would lose
    acknowledged rounds; recovery is a shipped copy or an operator
    restoring the snapshot file. ``context`` carries the refusing
    check (``reason``), the snapshot ``path``, and the missing prefix
    length. A corruption subclass of PYC301 like PYC302: same
    never-adopt discipline, narrower blast radius."""

    error_code = "PYC303"


class ServiceOverloadError(ConsensusError, RuntimeError):
    """The serving layer (``pyconsensus_tpu.serve``) shed this request by
    POLICY: the bounded request queue was full, the tenant's token bucket
    was empty, the request's deadline expired before dispatch, or the
    service is draining for shutdown. Deterministic by design — over-rate
    traffic is refused with this stable code at admission, never absorbed
    into unbounded queue growth or a deadline-less hang. ``context``
    carries the shed ``reason`` (``queue_full`` / ``rate_limited`` /
    ``deadline`` / ``draining``) plus tenant/queue detail for structured
    logging and retry policy."""

    error_code = "PYC401"


class WorkerLostError(ConsensusError, RuntimeError):
    """A fleet worker died (SIGKILL, crash, heartbeat loss) while this
    request was queued or in flight on it. The request was ACCEPTED and
    is now provably not running anywhere — it is safe to retry; the
    consistent-hash ring routes the retry to a surviving worker (or, for
    a session, to the standby once takeover completes). ``context``
    carries the dead ``worker`` name and an honest ``retry_after_s``
    (the fleet's expected takeover window)."""

    error_code = "PYC501"


class FailoverInProgressError(ConsensusError, RuntimeError):
    """The request targets a session whose owning worker just died and
    whose durable state (ledger checkpoint + staged-block journal) is
    being replayed onto the standby RIGHT NOW. The session is fenced
    during replay — serving from half-replayed state could return bits
    that differ from the single-box run, the one thing the fleet
    guarantees never happens. ``context.retry_after_s`` is the honest
    remaining takeover-window estimate."""

    error_code = "PYC502"


class PlacementError(ConsensusError, RuntimeError):
    """Consistent-hash placement has no worker for the key: the ring is
    empty (every worker dead or the fleet never started), or a caller
    named a worker the fleet does not know. Unlike PYC501/PYC502 this is
    not transient — retrying without operator action (restart workers)
    cannot succeed, so no ``retry_after_s`` is offered."""

    error_code = "PYC503"


class TransportError(ConsensusError, RuntimeError):
    """A wire-level artifact of the out-of-process transport
    (``serve.transport.wire``) failed validation: truncated/torn frame,
    payload SHA-256 mismatch (a bit flip in transit or on a proxy),
    frame length beyond the bounded-read limit, or foreign magic bytes.
    The frame is REFUSED before any payload byte is decoded — a damaged
    RPC must surface loudly, never as a half-parsed request.

    Deliberately a ``RuntimeError``, NOT an ``OSError``: the transport's
    bounded reconnect retries ``retry_on=(OSError,)``, and a structured
    refusal must never ride that path (identical bytes re-read from a
    broken stream stay broken; an identical fingerprint re-offered
    stays refused — the PYC4xx/5xx double-inheritance precedent).
    Transient SOCKET failures keep their builtin ``OSError`` types and
    DO reconnect, counted under
    ``pyconsensus_transport_reconnects_total``."""

    error_code = "PYC601"


class HandshakeError(TransportError):
    """The versioned connect handshake refused the peer: protocol
    version mismatch, or a runtime-fingerprint field
    (``tune.fingerprint.runtime_fingerprint``: framework version,
    platform, device generation) differs between router and
    worker. A wrong-toolchain worker could serve bits compiled by a
    different world — the refusal happens at connect, before any
    request is routed. ``context`` carries the offending field with
    expected vs found values."""

    error_code = "PYC602"


#: stable code -> class registry (the same codes as the JAX package's;
#: tests pin them)
ERROR_CODES = {
    cls.error_code: cls
    for cls in (ConsensusError, InputError, NumericsError,
                ConvergenceError, CheckpointCorruptionError,
                AotCacheCorruptionError, SnapshotCorruptionError,
                ServiceOverloadError,
                WorkerLostError, FailoverInProgressError, PlacementError,
                TransportError, HandshakeError)
}
