"""``pyconsensus-fleet-worker-torch`` — one fleet worker as an OS process
(``pyconsensus_tpu/serve/transport/worker.py``; also ``python -m
pyconsensus_tpu_torch.serve.transport.worker``).

The process behind :class:`~.supervisor.WorkerSupervisor`: a whole
``ConsensusService`` (micro-batcher, executable cache, admission) and
durable sessions, served over the socket RPC protocol on ``--device``
(the card by default: its ``cuda:0``, which the supervisor pins with
``CUDA_VISIBLE_DEVICES``; ``cpu`` on request only). Every mutation keeps
the fleet's write order, one hop further:

- ``append``: journal locally (``DurableSession``, durable before the
  ack), SHIP the new journal record to the standby's disk, then ack. An
  acknowledged append is durable in both places a takeover can read.
- ``submit_session`` (a resolve): the round commits locally (ledger
  checkpoint), the checkpoint ships, then the result returns. A kill
  between commit and ship loses only the shipped checkpoint: the shipped
  journal still holds the round's inputs, and the replay resolves it
  again bit for bit.
- a ship failure after local durability FENCES the session (PYC301):
  memory, the local disk and the standby's disk never disagree about an
  acknowledged write.

Every result crosses as host arrays: :func:`host_arrays` fetches each
tensor of a reply, bit for bit, before the wire sees it.

A compacted session ships its ``snapshot.npz`` whenever its content
changed (``shipping.py``), and a journal record that a compaction removed
before it shipped is covered by that snapshot. With ``hot_sessions > 0``
the worker's tiered store hydrates cold sessions from this worker's own
log root (``serve/stateplane.py``).

The worker prints ``READY <port>`` once its card answers, its kernel
libraries are loaded and its service is warm, and exits on SIGTERM (or
when the process that started it is gone) through a graceful drain,
writing its spans to ``<log-root>/trace-<name>.jsonl``. With an
``aot_cache_dir`` it loads the libraries from the kernel-build store
(``serve/aotcache.py``: no ``nvcc`` when the store holds them) and warms
the configured keys from it before ``READY``; its compile monitor counts
each ``nvcc`` run, store adoption and library load. A card worker
without a card, or whose kernel libraries neither load, adopt from the
store nor build, raises before ``READY``: no worker carries on on the CPU
unless asked. SIGKILL needs no cooperation: the shipped log is what
survives it. With ``flightrec_dir`` the worker keeps a flight recorder
under ``<flightrec_dir>/<name>/`` and dumps it at boot (what a later
SIGKILL leaves behind), on SIGTERM before the drain, at shutdown and
when a shipping failure fences a session.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import signal
import sys
import threading
from typing import Optional, Sequence

__all__ = ["FleetWorkerProcess", "host_arrays", "main"]


def host_arrays(obj):
    """``obj`` with every ``torch.Tensor`` (in dicts, lists and tuples)
    replaced by its host numpy array, bit for bit: the one place a reply
    leaves the device."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: host_arrays(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [host_arrays(v) for v in obj]
    return obj


class FleetWorkerProcess:
    """The RPC handlers around one ``ConsensusService`` (see the module
    docstring); apart from :func:`main` so tests can run a worker in
    process against real sockets."""

    def __init__(self, name: str, service, log_root,
                 shipped_root=None, shipper=None,
                 result_wait_s: float = 300.0, recorder=None) -> None:
        self.name = str(name)
        self.service = service
        self.log_root = pathlib.Path(log_root)
        self.shipped_root = (None if shipped_root is None
                             else pathlib.Path(shipped_root))
        self.shipper = shipper
        self.result_wait_s = float(result_wait_s)
        #: optional ``obs.FlightRecorder``, dumped when a shipping failure
        #: fences a session (and by :func:`main` on boot and SIGTERM)
        self.recorder = recorder
        #: (session, relpath) records already shipped: a journal record
        #: never changes once written, so its name identifies it;
        #: ledger.npz changes every round and is shipped again each time;
        #: the snapshot is rewritten in place, so its key carries the
        #: digest of the content shipped
        self._shipped: set = set()          # guarded-by: _ship_lock
        self._ship_lock = threading.Lock()
        if hasattr(self.service.sessions, "hydrator"):
            # a tiered store hydrates cold sessions from this worker's
            # own log root
            from ..stateplane import hydrate_session

            self.service.sessions.hydrator = lambda name: hydrate_session(
                self.log_root, name,
                executable_provider=self.service.incremental_executable_for,
                device=self.service.device, dtype=self.service.dtype)

    # -- shipping -------------------------------------------------------

    def _ship_session(self, name: str, ledger: bool) -> None:
        """Ship every record of ``name``'s local log not shipped yet (and
        the ledger checkpoint when ``ledger``), before the RPC's ack. A
        failure fences the session: an acknowledged write is on the
        standby's disk, or it is not acknowledged."""
        if self.shipper is None:
            return
        from ...faults import CheckpointCorruptionError
        from ..failover import ReplicationLog

        log = ReplicationLog(self.log_root, name)
        with self._ship_lock:
            todo = []
            for rel in ("meta.json", "ledger.npz"):
                path = log.dir / rel
                if not path.exists():
                    continue
                if (rel == "ledger.npz" and ledger) \
                        or (name, rel) not in self._shipped:
                    todo.append((rel, path))
            if log.staged_dir.exists():
                for path in sorted(log.staged_dir.iterdir()):
                    rel = f"staged/{path.name}"
                    if (name, rel) not in self._shipped:
                        todo.append((rel, path))
            try:
                for rel, path in todo:
                    # the ship completes inside the section: the shipped
                    # set records only what landed
                    try:
                        self.shipper.ship_file(name, rel, path)
                    except FileNotFoundError:
                        if rel.startswith("staged/"):
                            # a compaction removed it after writing the
                            # snapshot that covers it: the snapshot,
                            # read below, ships instead
                            continue
                        raise
                    self._shipped.add((name, rel))
                # the snapshot last: a record a compaction removed above
                # is in the snapshot read now
                self._ship_snapshot(name, log)
            except Exception as exc:    # noqa: BLE001 — any ship failure
                # fences: serving on with the standby's disk behind an
                # acknowledged write is what this class prevents
                fence = CheckpointCorruptionError(
                    f"session {name!r} is fenced: replication-log "
                    f"shipping failed ({type(exc).__name__}: {exc}); "
                    f"the local log is durable: ship it again and "
                    f"replay to resume", session=name, worker=self.name)
                try:
                    self.service.sessions.get(name).fence(fence)
                except Exception:   # noqa: BLE001 — the fence is best
                    pass            # effort; the raise below is not
                if self.recorder is not None:
                    try:
                        self.recorder.dump("fence")
                    except Exception:   # noqa: BLE001 — the fence's
                        pass            # raise below is what matters
                raise fence from exc

    def _ship_snapshot(self, name: str, log) -> None:
        """Ship ``name``'s snapshot when its content is not the one
        shipped last. The caller holds ``_ship_lock``."""
        try:
            digest = hashlib.sha256(
                log.snapshot_path.read_bytes()).hexdigest()
        except FileNotFoundError:
            return
        if (name, "snapshot.npz", digest) in self._shipped:
            return
        shipped = self.shipper.ship_file(name, "snapshot.npz",
                                         log.snapshot_path)
        self._shipped.add((name, "snapshot.npz", shipped))

    def _seed_shipped(self, name: str) -> None:
        """After adopting a shipped log, every record of the local copy
        is on the standby's disk by construction."""
        from ..failover import ReplicationLog

        log = ReplicationLog(self.log_root, name)
        with self._ship_lock:
            self._shipped.add((name, "meta.json"))
            if log.snapshot_path.exists():
                self._shipped.add((name, "snapshot.npz", hashlib.sha256(
                    log.snapshot_path.read_bytes()).hexdigest()))
            if log.staged_dir.exists():
                for path in sorted(log.staged_dir.iterdir()):
                    self._shipped.add((name, f"staged/{path.name}"))

    # -- handlers -------------------------------------------------------

    def _wait(self, params: dict) -> float:
        return float(params.get("wait_s") or self.result_wait_s)

    def ping(self, params: dict) -> dict:
        return {"ok": True, "worker": self.name, "pid": os.getpid(),
                "queue_depth": len(self.service.queue)}

    def submit(self, params: dict) -> dict:
        fut = self.service.submit(
            reports=params.get("reports"),
            event_bounds=params.get("event_bounds"),
            reputation=params.get("reputation"),
            tenant=str(params.get("tenant", "default")),
            deadline_ms=params.get("deadline_ms"),
            backend=params.get("backend"),
            **dict(params.get("oracle_kwargs") or {}))
        return host_arrays(fut.result(timeout=self._wait(params)))

    def submit_session(self, params: dict) -> dict:
        name = str(params["session"])
        fut = self.service.submit(
            session=name, tenant=str(params.get("tenant", "default")),
            deadline_ms=params.get("deadline_ms"),
            **dict(params.get("oracle_kwargs") or {}))
        result = host_arrays(fut.result(timeout=self._wait(params)))
        # the resolve committed the round locally; its checkpoint ships
        # before the result is acknowledged
        self._ship_session(name, ledger=True)
        return result

    def create_session(self, params: dict) -> dict:
        from ..failover import DurableSession

        kwargs = self.service.session_defaults(
            dict(params.get("kwargs") or {}))
        session = DurableSession.create(
            self.log_root, str(params["name"]),
            int(params["n_reporters"]), **kwargs)
        self.service.sessions.add(session)
        self._ship_session(session.name, ledger=True)
        return {"ok": True, "worker": self.name}

    def append(self, params: dict) -> dict:
        name = str(params["session"])
        session = self.service.sessions.get(name)
        # the idempotency token makes a retried append safe across this
        # process's death: the standby's dedupe set, seeded from the
        # shipped journal, acknowledges without folding twice
        total = session.append(params["block"],
                               params.get("event_bounds"),
                               append_id=params.get("append_id"))
        self._ship_session(name, ledger=False)
        return {"total_events": int(total)}

    def session_state(self, params: dict) -> dict:
        return host_arrays(
            self.service.sessions.get(str(params["name"])).state())

    def adopt_session(self, params: dict) -> dict:
        from ...faults import InputError
        from .shipping import adopt_shipped

        if self.shipped_root is None:
            raise InputError(
                f"worker {self.name!r} has no shipped-log root to "
                f"adopt from", worker=self.name)
        name = str(params["name"])
        session = adopt_shipped(
            self.shipped_root, self.log_root, name,
            executable_provider=self.service.incremental_executable_for,
            device=self.service.device, dtype=self.service.dtype)
        self.service.sessions.add(session)
        self._seed_shipped(name)
        return {"ok": True, "rounds_resolved": int(session.ledger.round),
                "staged_blocks": len(session._blocks)}

    def fence_session(self, params: dict) -> dict:
        """Fence the session object under its lock (an in-flight
        mutation finishes its journal write first; anything later raises
        the retryable worker loss and was never acknowledged), then ship
        the whole fenced log, so the adopting worker reads every
        journaled record although this process did not die."""
        from ...faults import InputError, WorkerLostError

        name = str(params["name"])
        try:
            session = self.service.sessions.get(name)
        except InputError:
            return {"ok": True, "fenced": False}    # not in this store
        fence = getattr(session, "fence", None)
        if fence is not None:
            fence(WorkerLostError(
                f"session {name!r} migrated off draining worker "
                f"{self.name!r}", worker=self.name, session=name,
                retry_after_s=float(params.get("retry_after_s") or 1.0)))
        self._ship_session(name, ledger=True)
        return {"ok": True, "fenced": fence is not None}

    def release_session(self, params: dict) -> dict:
        name = str(params["name"])
        try:
            stale = self.service.sessions.get(name)
        except Exception:   # noqa: BLE001 — gone already, or its fence
            stale = None
        # a request for it still queued here answers its fence
        # (retryable), not "unknown session"
        self.service.sessions.remove(
            name, moved=getattr(stale, "fenced", None))
        # a later session of the same name writes new bytes under the
        # same file names: its records must ship again
        with self._ship_lock:
            self._shipped = {key for key in self._shipped
                             if key[0] != name}
        return {"ok": True}

    def warm_from_disk(self, params: dict) -> dict:
        """Adopt the configured keys whose entries are in the kernel
        store (``ConsensusService.warm_from_disk``)."""
        return {"adopted": int(self.service.warm_from_disk())}

    def warm(self, params: dict) -> dict:
        """Warm what requests of ``shapes`` ride, as the serve command
        line warms one service (``serve.cli``)."""
        from ..cli import warm_for_shapes

        shapes = [(int(r), int(e)) for r, e in params.get("shapes") or ()]
        return {"warmed": warm_for_shapes(
            self.service, shapes, bool(params.get("has_na", True)))}

    def metric(self, params: dict) -> dict:
        from ... import obs

        return {"value": obs.value(str(params["name"]),
                                   **dict(params.get("labels") or {}))}

    def metrics_snapshot(self, params: dict) -> dict:
        """The whole registry snapshot, which the fleet merges into the
        cluster view under a ``worker`` label."""
        from ... import obs

        return {"worker": self.name, "metrics": obs.REGISTRY.snapshot()}

    def metrics_render(self, params: dict) -> dict:
        """This worker's registry as Prometheus text."""
        from ... import obs

        return {"worker": self.name, "text": obs.render_prom()}

    def stats(self, params: dict) -> dict:
        """The reference's operator view, plus this process's kernel
        launches (``ops.cuda_kernels.launch_counts``), its device, its
        ``CUDA_VISIBLE_DEVICES``, its compile monitor's events and the
        seconds of each ``nvcc`` it ran (``ops.build.build_seconds``)."""
        from ... import obs
        from ...obs.compilemon import COMPILE_EVENTS
        from ...ops import build
        from ...ops.cuda_kernels import launch_counts

        return {"worker": self.name, "pid": os.getpid(),
                "queue_depth": len(self.service.queue),
                "cache_size": len(self.service.cache),
                "sessions": self.service.sessions.names(),
                "launches": launch_counts(),
                "device": str(self.service.device),
                "visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "compile_events": {
                    e: int(obs.value("pyconsensus_jax_compile_events_total",
                                     event=e) or 0)
                    for e in COMPILE_EVENTS},
                "build_seconds": build.build_seconds(),
                "builds": self.service.cache.builds,
                "adopted": self.service.cache.adopted}

    def drain(self, params: dict) -> dict:
        self.service.close(drain=True,
                           timeout=params.get("timeout_s", 60.0))
        return {"ok": True}

    def handlers(self) -> dict:
        return {"ping": self.ping, "submit": self.submit,
                "submit_session": self.submit_session,
                "create_session": self.create_session,
                "append": self.append,
                "session_state": self.session_state,
                "adopt_session": self.adopt_session,
                "fence_session": self.fence_session,
                "release_session": self.release_session,
                "warm_from_disk": self.warm_from_disk,
                "warm": self.warm,
                "metric": self.metric, "stats": self.stats,  # consensus-lint: disable=CL902 — operator surface: read through the raw call() hatch (chip_smoke.py, the tests), not by the fleet client
                "metrics.snapshot": self.metrics_snapshot,
                "metrics.render": self.metrics_render,
                "drain": self.drain}


def _load_kernels(device, aot_cache_dir=None) -> None:
    """A card worker loads every kernel library before it announces
    ``READY``: found in its build directory, adopted from the kernel
    store of ``aot_cache_dir`` or built by ``nvcc``. One that fails raises
    here, and the worker never serves."""
    if device.type != "cuda":
        return
    from ...ops import build

    if aot_cache_dir:
        from ..aotcache import AotCache

        build.attach_store(AotCache(aot_cache_dir, device=device))
    for src in build.SOURCES:
        build.load(src)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="pyconsensus-fleet-worker-torch",
        description="one out-of-process consensus fleet worker: a "
                    "ConsensusService and replication log behind the "
                    "socket RPC protocol")
    ap.add_argument("--name", required=True)
    ap.add_argument("--port", type=int, default=0,
                    help="RPC listen port (0: the OS picks; the port is "
                         "announced as 'READY <port>')")
    ap.add_argument("--log-root", required=True,
                    help="this worker's local replication-log root")
    ap.add_argument("--shipped-root", default=None,
                    help="the standby's shipped-log root this worker "
                         "adopts sessions from at a takeover")
    ap.add_argument("--ship-host", default="127.0.0.1")
    ap.add_argument("--ship-port", type=int, default=0,
                    help="shipping receiver port (0 disables shipping)")
    ap.add_argument("--config-json", default=None,
                    help="inline ServeConfig JSON")
    ap.add_argument("--result-wait-s", type=float, default=300.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the service's device: the card (default; its "
                         "cuda:0, so pin it with CUDA_VISIBLE_DEVICES) or, "
                         "on request, the CPU")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"),
                    help="the default float dtype the service computes in")
    args = ap.parse_args(argv)

    import torch

    from ... import obs
    from ...parallel.sharded import resolve_device
    from ...tune.fingerprint import runtime_fingerprint
    from ..service import ConsensusService, ServeConfig
    from .rpc import RpcServer
    from .shipping import LogShipper

    torch.set_default_dtype(getattr(torch, args.dtype))
    obs.install_compile_monitor()
    device = resolve_device(args.device)    # raises without a card
    cfg = (ServeConfig.from_dict(json.loads(args.config_json))
           if args.config_json else ServeConfig())
    _load_kernels(device, cfg.aot_cache_dir)
    # spans written here carry source=<worker name>, so the merged fleet
    # JSONL rebuilds the cross-process forest
    obs.TRACER.source = args.name
    fingerprint = runtime_fingerprint(device)

    service = ConsensusService(cfg, device=device)
    if cfg.aot_cache_dir:
        # the keys warmed by an earlier process, adopted before the
        # warm-up builds anything
        service.warm_from_disk()
    service.start(warmup=True)
    shipper = (LogShipper(args.ship_host, args.ship_port,
                          label=f"{args.name}-shipper",
                          expect_fingerprint=fingerprint)
               if args.ship_port else None)
    recorder = None
    if cfg.flightrec_dir:
        recorder = obs.FlightRecorder(
            pathlib.Path(cfg.flightrec_dir) / args.name, source=args.name)
    worker = FleetWorkerProcess(args.name, service, args.log_root,
                                shipped_root=args.shipped_root,
                                shipper=shipper,
                                result_wait_s=args.result_wait_s,
                                recorder=recorder)
    server = RpcServer(worker.handlers(), name=args.name, port=args.port,
                       fingerprint=fingerprint).start()
    stop = threading.Event()

    def _sigterm(*_):
        if recorder is not None:
            try:    # the last-gasp artifact BEFORE the drain, which may
                recorder.dump("sigterm")    # never return
            except Exception:   # noqa: BLE001
                pass
        stop.set()

    signal.signal(signal.SIGTERM, _sigterm)
    if recorder is not None:
        # a later kill -9 flushes nothing: something recent must be on
        # disk the moment traffic starts
        recorder.dump("boot")
    parent = os.getppid()
    print(f"READY {server.port}", flush=True)
    # a worker whose router is gone (its parent changed) drains and exits
    # rather than serving nobody
    while not stop.wait(1.0) and os.getppid() == parent:
        pass
    try:
        service.close(drain=True, timeout=30.0)
    finally:
        server.close()
        if shipper is not None:
            shipper.close()
        if recorder is not None:
            try:
                recorder.dump("shutdown")
            except Exception:   # noqa: BLE001 — a clean drain stays one
                pass
        try:
            obs.write_jsonl(
                pathlib.Path(args.log_root) / f"trace-{args.name}.jsonl",
                obs.events(), meta={"source": args.name})
        except OSError as exc:
            # telemetry must not turn a clean drain into a crash
            print(f"WARNING: worker {args.name!r} could not write its "
                  f"trace ({exc})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
