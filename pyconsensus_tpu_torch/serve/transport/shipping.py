"""Replication-log shipping: a dead process's journal on the standby's
disk (``pyconsensus_tpu/serve/transport/shipping.py``).

The in-process fleet reads one shared replication-log directory. Across
processes the socket fleet ships the log instead: every record a
worker's :class:`~pyconsensus_tpu_torch.serve.failover.ReplicationLog`
writes (session meta, each round's ledger checkpoint, each journaled
block) is streamed over the wire protocol to a :class:`ShippingReceiver`
that writes the standby's copy, **before the mutation is acknowledged**.

Verify before adopt, at both ends:

- the receiver recomputes the SHA-256 of every record against the digest
  in the frame and refuses a mismatch with PYC301, writes through
  ``io.atomic_write``, and confines paths to the session's directory (a
  hostile relative path cannot escape the root);
- a takeover runs the whole :meth:`ReplicationLog.verify` over the
  shipped copy: :func:`adopt_shipped` seeds the standby's own log root
  only from a log that verified whole, then ``replay_session`` rebuilds
  the session bit for bit, as an in-process takeover does from the
  shared directory.

A compacted log ships its ``snapshot.npz`` too. Compaction rewrites it
in place, so the worker decides to ship it by its content's digest, not
its name, and reads it once per ship: the rename that installs a snapshot
is atomic, so the bytes shipped are one whole snapshot, whose digest the
receiver checks (a mismatch is refused and shipped again later). The
standby's copy keeps the journal records the compaction removed; the
snapshot-aware replay skips them as the covered prefix.

The ``shipping.append`` fault site fires at every ship; a transient
``OSError`` is retried, bounded; a taxonomy refusal is not.
"""

from __future__ import annotations

import hashlib
import pathlib
import re
from typing import Optional

from ... import obs
from ...faults import CheckpointCorruptionError
from ...faults import plan as _faults
from ...faults.retry import retry_call
from ...io import atomic_write
from .rpc import RpcClient, RpcServer

__all__ = ["ShippingReceiver", "LogShipper", "adopt_shipped"]

#: the only file names a shipped record may claim (the ReplicationLog
#: layout); anything else is refused before any byte lands on disk
_RELPATH_RE = re.compile(
    r"^(meta\.json|ledger\.npz|snapshot\.npz"
    r"|staged/round_\d{6}_block_\d{6}\.npz)$")
#: session directory names: never a pure-dot path component
_SESSION_RE = re.compile(r"^(?!\.+$)[A-Za-z0-9._~-]+$")


def _records(kind: str) -> None:
    obs.counter("pyconsensus_shipping_records_total",
                "replication-log records shipped to a standby's disk",
                labels=("kind",)).inc(kind=kind)


class ShippingReceiver:
    """The standby's disk: an RPC server whose one method, ``ship``,
    writes digest-checked replication records under ``root``. The fleet's
    :class:`~.supervisor.SocketTransport` hosts it. ``fingerprint`` is
    what it answers the shippers' handshakes with (None: this process's
    on the card)."""

    def __init__(self, root, host: str = "127.0.0.1", port: int = 0,
                 fingerprint: Optional[dict] = None) -> None:
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._server = RpcServer({"ship": self._ship},
                                 name="shipping-receiver",
                                 host=host, port=port,
                                 fingerprint=fingerprint)
        self.host, self.port = self._server.host, self._server.port

    def start(self) -> "ShippingReceiver":
        self._server.start()
        return self

    def close(self) -> None:
        self._server.close()

    def _ship(self, params: dict) -> dict:
        session = str(params.get("session", ""))
        relpath = str(params.get("relpath", ""))
        data = params.get("data")
        if not _SESSION_RE.match(session) or not _RELPATH_RE.match(relpath):
            raise CheckpointCorruptionError(
                f"shipped record names a path outside the replication "
                f"layout: session={session!r} relpath={relpath!r}",
                session=session, relpath=relpath)
        if not isinstance(data, (bytes, bytearray)):
            raise CheckpointCorruptionError(
                "shipped record carries no byte payload",
                session=session, relpath=relpath)
        digest = hashlib.sha256(bytes(data)).hexdigest()
        if digest != str(params.get("digest", "")):
            # damaged in transit or read torn at the sender: adopting it
            # would hand the standby a record its verify refuses later
            raise CheckpointCorruptionError(
                f"shipped record {session}/{relpath} digest mismatch",
                session=session, relpath=relpath, expected=digest,
                found=params.get("digest"))
        path = self.root / session / relpath
        path.parent.mkdir(parents=True, exist_ok=True)

        def write(tmp):
            pathlib.Path(tmp).write_bytes(bytes(data))
        atomic_write(path, write)
        kind = ("staged" if relpath.startswith("staged/")
                else relpath.split(".", 1)[0])
        _records(kind)
        obs.counter("pyconsensus_shipping_bytes_total",
                    "replication-record bytes landed on the standby's "
                    "disk").inc(len(data))
        return {"ok": True, "bytes": len(data)}


class LogShipper:
    """The sender, owned by a worker process: reads a just-committed
    record back off local disk (the durable bytes, what a local recovery
    would also read) and streams it to the receiver. ``shipping.append``
    is the injection seam; a transient socket error is retried,
    bounded. ``expect_fingerprint`` is what the receiver must answer
    with (None: this process's on the card)."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0,
                 retries: int = 3, label: str = "shipper",
                 expect_fingerprint: Optional[dict] = None) -> None:
        self._client = RpcClient(host, port, pool=1,
                                 timeout_s=timeout_s, label=label,
                                 expect_fingerprint=expect_fingerprint)
        self.retries = int(retries)

    def ship_file(self, session: str, relpath: str, path) -> str:
        """Ship the record ``relpath`` of ``session``, read once from
        ``path``, with its SHA-256; returns that digest."""
        _faults.fire("shipping.append", path=path)  # consensus-lint: disable=CL802 — the injected tear must land inside the ship-before-ack critical section it tests (the caller's shipped-set bookkeeping and the ship are one atomic step)
        data = pathlib.Path(path).read_bytes()
        digest = hashlib.sha256(data).hexdigest()
        retry_call(self._client.call, "ship",
                   {"session": str(session), "relpath": str(relpath),
                    "data": data, "digest": digest},
                   retries=self.retries, base_delay=0.05, max_delay=1.0,
                   retry_on=(OSError,),
                   label=f"shipping.append:{session}")
        return digest

    def close(self) -> None:
        self._client.close()


def adopt_shipped(shipped_root, local_root, name: str,
                  executable_provider=None, device=None, dtype=None):
    """Cross-process takeover: verify the shipped copy of session
    ``name`` whole, snapshot included (a standby never adopts a corrupt
    log: PYC301 names the record, PYC303 a truncated journal behind an
    unusable snapshot), seed the standby's own log root with the
    verified files (atomic writes; the standby journals its next rounds
    there and keeps shipping), and replay the session bit for bit on
    ``device`` (None: the card) in ``dtype``. Returns the adopted
    :class:`~pyconsensus_tpu_torch.serve.failover.DurableSession`."""
    from ..failover import ReplicationLog, replay_session

    shipped = ReplicationLog(shipped_root, name)
    shipped.verify()
    src_dir = shipped.dir
    dst_dir = pathlib.Path(local_root) / str(name)
    for src in sorted(src_dir.rglob("*")):
        if not src.is_file():
            continue
        dst = dst_dir / src.relative_to(src_dir)
        dst.parent.mkdir(parents=True, exist_ok=True)
        payload = src.read_bytes()

        def write(tmp, payload=payload):
            pathlib.Path(tmp).write_bytes(payload)
        atomic_write(dst, write)
    return replay_session(local_root, name,
                          executable_provider=executable_provider,
                          device=device, dtype=dtype)
