"""The process supervisor and the socket worker handles
(``pyconsensus_tpu/serve/transport/supervisor.py``).

:class:`WorkerSupervisor` owns the OS processes of a socket fleet: it
builds the kernels once (unless the kernel-build store of
``aot_cache_dir`` holds them: each worker then adopts them from it, with
no ``nvcc``), spawns every worker (``worker.py``: a whole
``ConsensusService`` and replication log behind the RPC protocol), waits
for each ``READY <port>``, drains them at shutdown and SIGKILLs one for
the chaos tests. **One worker process a card**: worker ``i`` runs on
``devices[i % len(devices)]`` (by default every card this process sees),
pinned with ``CUDA_VISIBLE_DEVICES``, so inside the worker its card is
``cuda:0`` and a stray current-device call cannot open a second context
on another card. A fleet on the CPU puts every worker on the CPU.

The spawned environment carries the package root on ``PYTHONPATH`` and
no ``JAX_*`` or ``XLA_*`` variable (a worker imports no JAX), and every
worker computes in the router's default float dtype: the connect
handshake refuses any fingerprint that differs from the one the router
expects for that worker's device.

:class:`SocketWorkerHandle` is the router-side face of one process, with
the ``transport.base`` worker surface:

- ``submit_*`` run the RPC on a small thread pool a worker and return
  ``Future``\\ s (the service's front-door contract); a transport failure
  on a dead worker surfaces as the retryable ``WorkerLostError``
  (PYC501), as in the in-process fleet;
- ``heartbeat`` pings with a short deadline and caches the worker's queue
  depth, on a control connection of its own; the metric scrapes
  (``metrics_snapshot``, the SLO monitor's and ``/metrics``' source) have
  a telemetry connection of their own, so neither waits behind queued
  submits;
- ``hard_kill`` IS ``SIGKILL``: the dead process's memory is gone, and
  the shipped replication log is what the standby adopts.

:class:`SocketTransport` wires it together for ``ConsensusFleet``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

from ... import obs
from ...faults import (InputError, ServiceOverloadError, TransportError,
                       WorkerLostError)
from ...faults import plan as _faults
from .base import Transport, WorkerBase
from .rpc import RpcClient
from .shipping import ShippingReceiver

__all__ = ["WorkerProcess", "WorkerSupervisor", "SocketWorkerHandle",
           "SocketTransport", "worker_subprocess_env"]


def worker_subprocess_env(card=None) -> dict:
    """A worker's environment: this process's without ``JAX_*`` and
    ``XLA_*``, the package root first on ``PYTHONPATH``, and, for a card
    worker, ``CUDA_VISIBLE_DEVICES`` naming card ``card`` of this
    process's view (mapped through this process's own
    ``CUDA_VISIBLE_DEVICES`` when it has one)."""
    import pyconsensus_tpu_torch

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    pkg_root = pathlib.Path(pyconsensus_tpu_torch.__file__).resolve() \
        .parents[1]
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(pkg_root), env.get("PYTHONPATH", "")) if p)
    if card is not None:
        seen = [c.strip() for c in
                os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
                if c.strip()]
        env["CUDA_VISIBLE_DEVICES"] = (seen[card] if seen
                                       else str(int(card)))
    return env


def _placement(device, devices) -> list:
    """The worker placements of a fleet on ``device``: ``["cpu"]`` on the
    CPU, else card indices of this process's view (``devices``: ints,
    ``"cuda:i"`` or ``torch.device``; None: every card)."""
    import torch

    if device.type == "cpu":
        return ["cpu"]
    if devices is None:
        return list(range(torch.cuda.device_count()))
    cards = []
    for d in devices:
        d = torch.device("cuda", d) if isinstance(d, int) \
            else torch.device(d)
        if d.type != "cuda":
            raise InputError(f"a socket fleet on the card places workers "
                             f"on cards, not on {d}", device=str(d))
        cards.append(d.index if d.index is not None else 0)
    if not cards:
        raise InputError("SocketTransport(devices=) names no card")
    return cards


class WorkerProcess:
    """One supervised worker subprocess. Construction starts it; call
    :meth:`wait_ready` for its port (several start together and are
    waited on in turn)."""

    def __init__(self, name: str, cmd: list, env: dict) -> None:
        self.name = str(name)
        self.port: Optional[int] = None
        #: seconds from the spawn to ``READY`` (None until then): the
        #: boot, kernel load or adoption and warm-up included
        self.ready_s: Optional[float] = None
        self._t0 = time.monotonic()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     text=True, env=env)
        self._port: list = []
        self._done = threading.Event()
        # the reader drains stdout for the process's lifetime: a full
        # pipe would block the worker's prints
        threading.Thread(target=self._read, daemon=True,
                         name=f"pyconsensus-worker-{self.name}-out"
                         ).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.startswith("READY ") and not self._port:
                self.ready_s = time.monotonic() - self._t0
                self._port.append(int(line.split()[1]))
                self._done.set()
        self._done.set()        # EOF: the worker died before READY

    def wait_ready(self, timeout_s: float) -> int:
        """Block until the worker announces ``READY <port>``. A worker
        that dies or stays silent past the deadline is killed and
        refused with ``TransportError(reason="spawn")``."""
        if not self._done.wait(timeout_s) or not self._port:
            self.sigkill()
            raise TransportError(
                f"worker process {self.name!r} did not announce READY "
                f"within {timeout_s:.0f}s "
                f"(exit code {self.proc.poll()})", reason="spawn",
                worker=self.name)
        self.port = self._port[0]
        return self.port

    @property
    def running(self) -> bool:
        return self.proc.poll() is None

    def sigkill(self) -> None:
        """The chaos primitive: SIGKILL, no cooperation, no cleanup."""
        if self.running:
            self.proc.kill()
        self.proc.wait(timeout=30.0)

    def terminate(self, timeout_s: float = 30.0) -> None:
        if self.running:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.sigkill()


class SocketWorkerHandle(WorkerBase):
    """Router-side handle of one worker process (see the module
    docstring): a one-connection control plane (heartbeats, drain) that a
    long resolve never blocks, and a pooled data plane whose calls run on
    the handle's thread pool. ``expect_fingerprint`` is the fingerprint
    the worker must answer with."""

    #: the worker is its own process with its own registry: the fleet's
    #: merged view adds its snapshot under ``worker=<name>``
    shares_process_registry = False

    def __init__(self, name: str, process: WorkerProcess,
                 expect_fingerprint: dict, rpc_timeout_s: float = 120.0,
                 pool: int = 4, takeover_window_s: float = 1.0) -> None:
        super().__init__(name)
        self.process = process
        self.takeover_window_s = float(takeover_window_s)
        self._ctl = RpcClient("127.0.0.1", process.port, pool=1,
                              timeout_s=rpc_timeout_s,
                              label=f"{name}-ctl",
                              expect_fingerprint=expect_fingerprint)
        self._data = RpcClient("127.0.0.1", process.port, pool=pool,
                               timeout_s=rpc_timeout_s,
                               label=f"{name}-data",
                               expect_fingerprint=expect_fingerprint)
        # the telemetry plane: a scrape or an SLO sample neither waits
        # behind the data plane's queued submits (under load it would
        # see the fleet only after the load) nor delays a heartbeat
        self._obs = RpcClient("127.0.0.1", process.port, pool=1,
                              timeout_s=rpc_timeout_s,
                              label=f"{name}-obs",
                              expect_fingerprint=expect_fingerprint)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=pool,
            thread_name_prefix=f"pyconsensus-rpc-{name}")
        #: racy-monotonic cache refreshed by the heartbeat scan; a stale
        #: read ages the capacity gauge by one scan at most
        self._depth = 0     # guarded-by: none

    # -- liveness -------------------------------------------------------

    @property
    def alive(self) -> bool:  # consensus-lint: disable=CL902 — the same surface as FleetWorker's plain alive attribute (WorkerBase): a property here only so a process that exited reads as dead
        """False once the router fenced this worker or its process
        exited: a death the router did not cause is seen at the next
        routing or scan, not only after the heartbeat timeout."""
        return self._alive and self.process.running

    @alive.setter
    def alive(self, value: bool) -> None:
        self._alive = bool(value)

    def start(self, warmup: bool = True) -> None:
        """The process warmed before it announced READY; one heartbeat
        makes a worker that died since fail loudly."""
        if not self.heartbeat():
            raise TransportError(
                f"worker process {self.name!r} announced READY but "
                f"does not answer its boot heartbeat "
                f"(exit code {self.process.proc.poll()})",
                reason="spawn", worker=self.name)

    def heartbeat(self) -> bool:
        if not self.alive or not self.process.running:
            return False    # an exited process never beats again
        start = time.monotonic()
        try:
            _faults.fire("fleet.heartbeat")
            reply = self._ctl.ping(timeout_s=1.0)
        except Exception:   # noqa: BLE001 — a lost probe, not a fault:
            return False    # timeout, refusal or injected flap alike
        latency = time.monotonic() - start
        self.last_heartbeat_latency_s = latency
        obs.histogram(
            "pyconsensus_fleet_heartbeat_seconds",
            "router-observed heartbeat round-trip latency by worker",
            labels=("worker",)).observe(latency, worker=self.name)
        self._depth = int(reply.get("queue_depth", 0))
        self.last_heartbeat = time.monotonic()
        return True

    def queue_depth(self) -> int:
        return self._depth

    def hard_kill(self, retry_after_s: float) -> int:
        """SIGKILL the process. Its queued requests die with it; their
        in-flight RPCs surface as PYC501 through the futures (a count the
        router cannot see: returns 0)."""
        if not self.alive:
            return 0
        self.alive = False
        self.takeover_window_s = float(retry_after_s)
        self.process.sigkill()
        return 0

    def close(self, drain: bool = True,
              timeout: Optional[float] = 60.0) -> None:
        if self.alive and self.process.running:
            if drain:
                try:
                    self._ctl.call("drain", {"timeout_s": timeout},
                                   timeout_s=timeout)
                except Exception:   # noqa: BLE001 — shutdown wins
                    pass
            self.process.terminate(timeout_s=timeout or 30.0)
        self.alive = False
        self._pool.shutdown(wait=False)
        self._ctl.close()
        self._data.close()
        self._obs.close()

    # -- the request plane ----------------------------------------------

    def _translate(self, exc: BaseException) -> BaseException:
        """A transport failure against a dead or dying worker becomes the
        fleet's retryable worker loss; anything else crosses unchanged
        (it is already the worker's structured error)."""
        if isinstance(exc, (OSError, TransportError)):
            return WorkerLostError(
                f"worker {self.name!r} lost mid-call "
                f"({type(exc).__name__})", worker=self.name,
                retry_after_s=self.takeover_window_s)
        if (isinstance(exc, ServiceOverloadError)
                and exc.context.get("reason") == "draining"
                and not self.alive):
            # the drain the worker reported was its own teardown
            return WorkerLostError(
                f"worker {self.name!r} died while serving",
                worker=self.name, retry_after_s=self.takeover_window_s)
        return exc

    def _rpc_future(self, method: str, params: dict):
        # the trace context is taken on the submitting thread (the span
        # stack is thread-local) and rides the envelope
        tctx = obs.trace_context()

        def run():
            try:
                return self._data.call(method, params, trace=tctx)
            except Exception as exc:    # noqa: BLE001 — translated and
                raise self._translate(exc) from exc     # re-raised into
        return self._pool.submit(run)                   # the Future

    @staticmethod
    def _split_kwargs(kwargs: dict) -> dict:
        """``service.submit`` kwargs -> RPC params: the request fields by
        name, everything else as oracle kwargs."""
        kwargs = dict(kwargs)
        params = {key: kwargs.pop(key)
                  for key in ("event_bounds", "reputation",
                              "deadline_ms", "backend", "wait_s")
                  if key in kwargs}
        params["oracle_kwargs"] = kwargs
        return params

    def submit_stateless(self, reports, tenant: str, **kwargs):
        params = self._split_kwargs(kwargs)
        params.update(reports=reports, tenant=tenant)
        return self._rpc_future("submit", params)

    def submit_session(self, session: str, tenant: str, **kwargs):
        params = self._split_kwargs(kwargs)
        params.update(session=session, tenant=tenant)
        return self._rpc_future("submit_session", params)

    # -- the session plane ----------------------------------------------

    def _call_data(self, method: str, params: dict):
        """A synchronous data-plane RPC with the futures' translation: a
        dead socket surfaces as the retryable PYC501, a structured worker
        error crosses unchanged."""
        try:
            return self._data.call(method, params)
        except Exception as exc:    # noqa: BLE001 — translated+re-raised
            raise self._translate(exc) from exc

    def create_session(self, name: str, n_reporters: int,
                       kwargs: dict) -> None:
        self._call_data("create_session",
                        {"name": name, "n_reporters": int(n_reporters),
                         "kwargs": dict(kwargs)})

    def append(self, session: str, block, event_bounds=None,
               append_id: Optional[str] = None) -> int:
        reply = self._call_data("append",
                                {"session": session, "block": block,
                                 "event_bounds": event_bounds,
                                 "append_id": append_id})
        return int(reply["total_events"])

    def session_state(self, name: str) -> dict:
        return self._call_data("session_state", {"name": name})

    def adopt_session(self, name: str) -> None:
        self._call_data("adopt_session", {"name": name})

    def evict_session(self, name: str) -> None:
        """After a takeover: a dead process's object died with it; a live
        worker is asked to release the session."""
        if self.alive:
            try:
                self._data.call("release_session", {"name": name})
            except Exception:   # noqa: BLE001 — eviction is advisory
                pass

    def fence_session(self, name: str, exc: BaseException) -> None:
        """A dead worker's fence is structural (nothing survives a
        SIGKILL, and everything it acknowledged is in the shipped log). A
        live worker being drained is fenced for real: the fence RPC fences
        the session object and ships the whole fenced log before the
        adoption reads it. A worker that died mid-drain already shipped
        every acknowledged write."""
        if not self.alive:
            return
        try:
            self._data.call("fence_session", {
                "name": name,
                "retry_after_s": float(
                    getattr(exc, "context", {}).get("retry_after_s")
                    or self.takeover_window_s)})
        except Exception:   # noqa: BLE001 — died mid-drain: the shipped
            pass            # log already holds every acknowledged write

    def warm_from_disk(self) -> int:
        try:
            reply = self._data.call("warm_from_disk", {})
        except Exception:   # noqa: BLE001 — warming never aborts a
            return 0        # takeover
        return int(reply.get("adopted", 0))

    def warm(self, shapes, has_na: bool) -> int:
        return int(self._data.call("warm", {
            "shapes": [list(s) for s in shapes],
            "has_na": bool(has_na)})["warmed"])

    def launch_counts(self) -> dict:
        return self._data.call("stats", {})["launches"]

    # -- telemetry ------------------------------------------------------

    def metrics_snapshot(self) -> dict:
        """The worker process's registry snapshot (``{"worker",
        "metrics"}``), over the telemetry connection: a scrape never
        delays a heartbeat nor waits behind queued submits."""
        return self._obs.call("metrics.snapshot", {})

    def metrics_render(self) -> dict:
        """The worker process's own Prometheus text."""
        return self._obs.call("metrics.render", {})

    # -- introspection ---------------------------------------------------

    def call(self, method: str, params: Optional[dict] = None,  # consensus-lint: disable=CL902 — deliberate escape hatch: raw RPC for tests/bench/operator tooling, not part of the Transport contract FleetWorker must mirror
             timeout_s: Optional[float] = None):
        """Raw RPC (tests, operator tooling, the command line's warm-up
        and ``stats``)."""
        return self._data.call(method, params, timeout_s=timeout_s)


class WorkerSupervisor:
    """Spawn and own the worker processes of one socket fleet. Worker
    ``i`` runs on ``placement[i % len(placement)]`` (``"cpu"`` or a card
    index of this process's view)."""

    def __init__(self, n_workers: int, worker_config, base_dir,
                 placement, rpc_timeout_s: float = 120.0,
                 ready_timeout_s: float = 180.0,
                 aot_cache_dir=None) -> None:
        import torch

        from ...tune.fingerprint import runtime_fingerprint

        if int(n_workers) < 1:
            raise InputError("a fleet needs at least one worker")
        self.base = pathlib.Path(base_dir)
        self.base.mkdir(parents=True, exist_ok=True)
        self.placement = list(placement)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.ready_timeout_s = float(ready_timeout_s)
        #: every worker computes in this process's default dtype
        self.dtype = str(torch.get_default_dtype()).replace("torch.", "")
        #: the fingerprint each placement must answer with (its device
        #: queried once; a query opens no context)
        self.fingerprints = {
            p: runtime_fingerprint("cpu" if p == "cpu"
                                   else torch.device("cuda", p))
            for p in set(self.placement)}
        self._worker_cfg = dict(worker_config.__dict__)
        if aot_cache_dir is not None:
            self._worker_cfg["aot_cache_dir"] = str(aot_cache_dir)
        if any(p != "cpu" for p in self.placement):
            self._prebuild(self._worker_cfg.get("aot_cache_dir"))
        self.receiver = ShippingReceiver(
            self.base / "_shipped",
            fingerprint=self.fingerprints[self.placement[0]]).start()
        self._spawns = 0
        #: worker name -> its placement
        self._where: dict = {}
        self.processes: dict = {}
        self._spawned = obs.counter(
            "pyconsensus_transport_workers_spawned_total",
            "fleet worker processes spawned by the supervisor")
        try:
            # every worker starts at once, then each READY is awaited
            for i in range(int(n_workers)):
                self.processes[f"w{i}"] = self._start(f"w{i}")
            for proc in self.processes.values():
                proc.wait_ready(self.ready_timeout_s)
        except BaseException:
            self.close()
            raise
        self._spawned.inc(len(self.processes))

    @staticmethod
    def _prebuild(aot_cache_dir) -> None:
        """Build the kernels once, here, before the first spawn: N
        workers starting cold would each run ``nvcc`` on every source.
        With a store that holds the libraries every worker adopts them
        itself; with one that does not, the fresh build is persisted
        into it."""
        from ...ops import build

        store = None
        if aot_cache_dir:
            from ..aotcache import AotCache

            store = AotCache(aot_cache_dir, device="cpu")
            if store.has_libraries():
                return
        previous = build.attach_store(store) if store is not None \
            else None
        try:
            build.build_all()
        except RuntimeError as exc:
            raise TransportError(
                f"the kernels did not build, so no card worker can "
                f"load them: {exc}", reason="spawn") from exc
        finally:
            if store is not None:
                build.attach_store(previous)

    def fingerprint_of(self, name: str) -> dict:
        """The fingerprint worker ``name`` must answer with (its
        placement's)."""
        return self.fingerprints[self._where[name]]

    def spawn_worker(self, name: str) -> WorkerProcess:
        """Spawn ONE more worker process after construction (the next
        placement in turn), with the same config, environment rules,
        shipping receiver and readiness contract."""
        name = str(name)
        if name in self.processes and self.processes[name].running:
            raise InputError(
                f"worker process {name!r} already exists", worker=name)
        proc = self._start(name)
        self.processes[name] = proc
        proc.wait_ready(self.ready_timeout_s)
        self._spawned.inc()
        return proc

    def _start(self, name: str) -> WorkerProcess:
        where = self.placement[self._spawns % len(self.placement)]
        self._spawns += 1
        self._where[name] = where
        log_root = self.base / name
        log_root.mkdir(parents=True, exist_ok=True)
        cmd = [sys.executable, "-m",
               "pyconsensus_tpu_torch.serve.transport.worker",
               "--name", name, "--port", "0",
               "--log-root", str(log_root),
               "--shipped-root", str(self.base / "_shipped"),
               "--ship-host", self.receiver.host,
               "--ship-port", str(self.receiver.port),
               "--config-json", json.dumps(self._worker_cfg),
               "--device", "cpu" if where == "cpu" else "cuda",
               "--dtype", self.dtype]
        env = worker_subprocess_env(None if where == "cpu" else where)
        return WorkerProcess(name, cmd, env)

    def close(self) -> None:
        for proc in self.processes.values():
            try:
                proc.terminate(timeout_s=10.0)
            except Exception:   # noqa: BLE001 — teardown is best-effort
                pass
        self.receiver.close()


class SocketTransport(Transport):
    """The out-of-process fleet transport: real worker processes, one a
    card of ``devices`` (None: every card this process sees; on a fleet
    whose device is the CPU, every worker on the CPU), socket RPC and
    shipped replication logs. ``FleetConfig.log_dir`` is the transport's
    base directory (each worker's local log root and the ``_shipped``
    standby root live under it); without one a temporary base is made
    and removed at close. ``aot_cache_dir`` is the kernel-build store
    every worker boots from (it overrides the worker config's)."""

    name = "socket"

    #: an organically dead worker process (a crash, an OOM kill) raises
    #: nothing in the router: only the heartbeat monitor finds it
    wants_monitor = True

    def __init__(self, devices=None, ready_timeout_s: float = 180.0,
                 rpc_timeout_s: float = 120.0, aot_cache_dir=None) -> None:
        self.devices = None if devices is None else list(devices)
        self.aot_cache_dir = aot_cache_dir
        self.ready_timeout_s = float(ready_timeout_s)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.supervisor: Optional[WorkerSupervisor] = None
        self._tmp_base: Optional[str] = None

    def _handle(self, config, name: str, proc: WorkerProcess):
        return SocketWorkerHandle(
            name, proc, self.supervisor.fingerprint_of(name),
            rpc_timeout_s=self.rpc_timeout_s,
            takeover_window_s=config.takeover_window_s)

    def make_workers(self, config, device=None) -> dict:
        from ...parallel.sharded import resolve_device

        placement = _placement(resolve_device(device), self.devices)
        base = config.log_dir
        if base is None:
            base = tempfile.mkdtemp(prefix="pyconsensus-socket-fleet-")
            self._tmp_base = base   # ours to remove at close
        self.supervisor = WorkerSupervisor(
            config.n_workers, config.worker, base, placement,
            rpc_timeout_s=self.rpc_timeout_s,
            ready_timeout_s=self.ready_timeout_s,
            aot_cache_dir=self.aot_cache_dir)
        return {name: self._handle(config, name, proc)
                for name, proc in self.supervisor.processes.items()}

    def spawn_worker(self, config, name: str,
                     device=None) -> SocketWorkerHandle:
        """One more worker process, spawned by the same supervisor on the
        next placement in turn and shipping to the same standby root."""
        if self.supervisor is None:
            raise InputError(
                "socket transport has no supervisor yet: spawn_worker is "
                "only valid after make_workers", worker=name)
        proc = self.supervisor.spawn_worker(name)
        return self._handle(config, name, proc)

    def close(self) -> None:
        if self.supervisor is not None:
            self.supervisor.close()
            self.supervisor = None
        if self._tmp_base is not None:
            shutil.rmtree(self._tmp_base, ignore_errors=True)
            self._tmp_base = None
