"""``ConsensusFleet`` — N serve workers behind a consistent-hash router
with ledger-backed hot-standby failover
(``pyconsensus_tpu/serve/fleet.py``).

The contract, the reference's:

    **any worker can die mid-traffic and every accepted request either
    resolves with the bits a single worker would return, or sheds with
    a structured PYC-coded error carrying an honest ``retry_after_s`` —
    never a silent drop, never corrupted state.**

- **placement** (``serve.placement``): sessions and, for spread,
  stateless requests map to workers through one consistent-hash ring;
  a membership change moves only the dead worker's keys.
- **replication log** (``serve.failover``): every session mutation is
  durable (ledger checkpoint + staged-block journal on a shared
  directory) before it is acknowledged.
- **failover**: a worker death (``kill_worker``, heartbeat loss, or
  discovery at routing time) fences the worker, sheds its queued
  requests as ``WorkerLostError`` (PYC501), opens a takeover window in
  which its sessions answer ``FailoverInProgressError`` (PYC502),
  verifies each session's log (a corrupt one surfaces PYC301 instead)
  and replays it onto its new ring owner, resumed bit for bit.
- **admission** (``serve.admission.ClusterCapacity``): cluster-wide
  sheds quote retry hints scaled by the surviving capacity; per-worker
  queue depths export as gauges.

The router speaks to its workers through ``serve.transport``. With
``FleetConfig.transport="inprocess"`` (default) they are in-process
``ConsensusService`` instances (``InProcessTransport``), every one on the
fleet's ``device`` (None: the card; ``"cpu"`` on request), and their
batcher threads share one interpreter. With ``transport="socket"`` (or a
``SocketTransport(devices=...)``) they are OS processes behind the socket
RPC protocol, one a card (every worker on the CPU when ``device`` is the
CPU), each with its own interpreter and metric registry, their
replication logs shipped to the standby's disk before each write is
acknowledged (``serve.transport.supervisor`` / ``.shipping``). Routing,
admission and failover are the same code over both. An adopting worker
warms from the kernel-build store (``ServeConfig.aot_cache_dir``,
``serve/aotcache.py``) inside the takeover window (``_warm_standby``),
and a worker with ``hot_sessions > 0`` hydrates its cold sessions from
its view of the log (``serve/stateplane.py``). With
``ServeConfig.flightrec_dir`` the router keeps a flight recorder
(``<flightrec_dir>/router``, ``obs/flightrec.py``) and dumps it at every
takeover and every completed drain; each socket worker keeps its own.
``serve/autoscale.py``'s ``AutoScaler`` grows and shrinks the fleet
through :meth:`ConsensusFleet.add_worker`, :meth:`drain_worker` and
:meth:`rebalance_to`.

Fault sites ``fleet.route`` / ``fleet.heartbeat`` / ``fleet.takeover`` /
``fleet.ledger_replay`` inject worker loss, heartbeat flap and torn
ledger replication deterministically; ``state.migrate`` fires at the top
of every session relocation (takeover, drain and rebalancing all pass
through :meth:`ConsensusFleet._relocate_session`).

Lock order (outermost first): ``AutoScaler._lock`` (one membership
change in flight, held across ``add_worker`` and ``drain_worker``), a
worker's ``declare_lock``, then ``ConsensusFleet._lock``, then
``HashRing._lock`` or ``ClusterCapacity._lock``. The fleet lock is never
held across a call into a worker, so no router lock waits on the card.
"""

from __future__ import annotations

import pathlib
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from .. import obs
from ..faults import (CheckpointCorruptionError, FailoverInProgressError,
                      InputError, PlacementError, ServiceOverloadError,
                      WorkerLostError)
from ..faults import plan as _faults
from ..parallel.sharded import resolve_device
from .admission import ClusterCapacity
from .failover import DurableSession, replay_session
from .placement import DEFAULT_VNODES, HashRing
from .service import ConsensusService, ServeConfig
from .transport.base import WorkerBase, resolve_transport

__all__ = ["FleetConfig", "FleetWorker", "ConsensusFleet"]

# The fleet's lock hierarchy, declared for the port's static analysis
# (CL801 flags any acquisition contradicting an order below, even
# without a full cycle) and mirrored at runtime by the lock witness: a
# worker's declare lock is always outermost — the takeover path holds
# it across fleet-state, ring, and capacity updates.
# consensus-lint: lock-order WorkerBase.declare_lock < ConsensusFleet._lock
# consensus-lint: lock-order ConsensusFleet._lock < HashRing._lock
# consensus-lint: lock-order ConsensusFleet._lock < ClusterCapacity._lock
# The autoscaler's control lock is OUTERMOST of all: one membership
# change in flight means the loop holds its lock across
# add_worker/drain_worker, which take a worker's declare lock and then
# the fleet lock.
# consensus-lint: lock-order AutoScaler._lock < WorkerBase.declare_lock


@dataclass(frozen=True)
class FleetConfig:
    """Fleet policy (the reference's keys). ``worker`` is the per-worker
    :class:`ServeConfig`: every worker runs the same one, so any worker
    returns the same bits."""

    #: worker count (names ``w0..w{n-1}``)
    n_workers: int = 3
    #: per-worker service policy
    worker: ServeConfig = field(default_factory=ServeConfig)
    #: shared replication-log directory (required for fleet sessions: a
    #: session that is not durable cannot survive its worker)
    log_dir: Optional[str] = None
    #: heartbeat staleness beyond which a worker is declared dead
    heartbeat_timeout_s: float = 2.0
    #: monitor scan period (``monitor=True`` runs a background thread;
    #: otherwise call :meth:`ConsensusFleet.check_workers` yourself)
    heartbeat_interval_s: float = 0.5
    monitor: bool = False
    #: the takeover-window estimate quoted in PYC501/PYC502 retry hints
    takeover_window_s: float = 1.0
    #: healthy-fleet base retry hint of cluster-wide sheds
    base_retry_s: float = 0.25
    #: virtual points per worker on the placement ring
    vnodes: int = DEFAULT_VNODES
    #: stateless requests spill to the next ring arc when the owner's
    #: queue is full (sessions never spill: they are sticky)
    spillover: bool = True
    #: worker transport: ``"inprocess"``, ``"socket"`` (one worker process
    #: a card) or a ready ``serve.transport.base.Transport``
    transport: object = "inprocess"


class FleetWorker(WorkerBase):
    """One in-process worker: a named :class:`ConsensusService` on
    ``device`` plus the liveness bookkeeping the router needs.
    ``hard_kill`` is the in-process SIGKILL model: fence (no result is
    delivered after it, no new work), then shed everything queued as
    ``WorkerLostError``."""

    #: its metrics are the process-wide ``obs.REGISTRY``, which the
    #: fleet's merged view already holds under ``worker="router"``
    shares_process_registry = True

    def __init__(self, name: str, config: ServeConfig, log_dir=None,
                 device=None) -> None:
        super().__init__(name)
        self.service = ConsensusService(config, device=device)
        self._log_dir = log_dir
        if log_dir is not None and hasattr(self.service.sessions,
                                           "hydrator"):
            # a tiered store: cold sessions hydrate from this worker's
            # view of the log, through the executable provider, device
            # and dtype a takeover would use
            from .stateplane import hydrate_session

            self.service.sessions.hydrator = (
                lambda session_name: hydrate_session(
                    log_dir, session_name,
                    executable_provider=(
                        self.service.incremental_executable_for),
                    device=self.service.device,
                    dtype=self.service.dtype))

    # -- lifecycle ------------------------------------------------------

    def start(self, warmup: bool = True) -> None:
        self.service.start(warmup=warmup)

    def close(self, drain: bool = True,
              timeout: Optional[float] = 60.0) -> None:
        if self.alive:
            self.service.close(drain=drain, timeout=timeout)
        # a closed worker is not alive: a drained worker is reported
        # honestly and never re-drained or re-declared
        self.alive = False

    # -- liveness -------------------------------------------------------

    def heartbeat(self) -> bool:
        """Record one liveness beat. Returns False (the beat is lost)
        when the worker is dead or the ``fleet.heartbeat`` fault site
        raises; the timestamp then does not advance."""
        if not self.alive:
            return False
        start = time.monotonic()
        try:
            _faults.fire("fleet.heartbeat")
        except Exception:   # noqa: BLE001 — a lost probe, not a fault
            return False
        latency = time.monotonic() - start
        self.last_heartbeat_latency_s = latency
        obs.histogram(
            "pyconsensus_fleet_heartbeat_seconds",
            "router-observed heartbeat round-trip latency by worker",
            labels=("worker",)).observe(latency, worker=self.name)
        self.last_heartbeat = time.monotonic()
        return True

    def queue_depth(self) -> int:
        return len(self.service.queue)

    def hard_kill(self, retry_after_s: float) -> int:
        """Fence, then shed. The batcher is fenced first: a dispatch in
        flight on the device finishes, but its callers get the retryable
        ``WorkerLostError``, never the late result. Then admission
        drains, the queue closes and every queued request sheds as
        PYC501. Returns the number of queued requests shed. Idempotent."""
        if not self.alive:
            return 0
        self.alive = False

        def lost(req, why="was in flight"):
            return WorkerLostError(
                f"worker {self.name!r} died while this request {why}",
                worker=self.name, tenant=req.tenant,
                retry_after_s=retry_after_s)
        self.service.batcher.fence(lost)
        self.service.admission.start_drain()
        self.service.queue.close()
        shed = 0
        for req in self.service.queue.drain_pending():
            if not req.future.done():
                req.future.set_exception(lost(req, "was queued"))
                shed += 1
        return shed

    # -- the request plane ----------------------------------------------

    def submit_stateless(self, reports, tenant: str, **kwargs):
        return self.service.submit(reports=reports, tenant=tenant,
                                   **kwargs)

    def submit_session(self, session: str, tenant: str, **kwargs):
        return self.service.submit(session=session, tenant=tenant,
                                   **kwargs)

    # -- the session plane ----------------------------------------------

    def create_session(self, name: str, n_reporters: int,
                       kwargs: dict) -> None:
        """A durable session on the shared log directory, with this
        worker's device, dtype, incremental policy and executable
        provider."""
        kwargs = self.service.session_defaults(dict(kwargs))
        session = DurableSession.create(self._log_dir, name,
                                        int(n_reporters), **kwargs)
        self.service.sessions.add(session)

    def adopt_session(self, name: str) -> None:
        """Verify + replay ``name``'s log from the shared directory onto
        this worker's device (the takeover path and the cross-fleet
        resume)."""
        session = replay_session(
            self._log_dir, name,
            executable_provider=self.service.incremental_executable_for,
            device=self.service.device, dtype=self.service.dtype)
        self.service.sessions.add(session)

    def evict_session(self, name: str) -> None:
        """Drop the fenced in-memory object after its log replayed
        elsewhere: a session lives in exactly one store. A request for it
        still queued here answers its fence (retryable), not "unknown
        session"."""
        try:
            stale = self.service.sessions.get(name)
        except Exception:   # noqa: BLE001 — gone already, or its fence
            return
        self.service.sessions.remove(
            name, moved=getattr(stale, "fenced", None))

    def fence_session(self, name: str, exc: BaseException) -> None:
        """Fence this worker's in-memory session object BEFORE a standby
        replays its log: a mutation that completed its journal write is
        read by the replay; anything later raises ``exc`` and was never
        acknowledged."""
        try:
            stale = self.service.sessions.get(name)
        except InputError:
            return      # not in this store (e.g. a retried stranded take)
        fence = getattr(stale, "fence", None)
        if fence is not None:
            fence(exc)

    def append(self, session: str, reports_block, event_bounds=None,
               append_id: Optional[str] = None) -> int:
        target = self.service.sessions.get(session)
        if append_id is not None:
            return target.append(reports_block, event_bounds,
                                 append_id=append_id)
        return target.append(reports_block, event_bounds)

    def session_state(self, name: str) -> dict:
        return self.service.sessions.get(name).state()

    def warm_from_disk(self) -> int:
        """Adopt the configured keys whose entries are in the kernel
        store (``ConsensusService.warm_from_disk``)."""
        return self.service.warm_from_disk()

    def warm(self, shapes, has_na: bool) -> int:
        from .cli import warm_for_shapes

        return warm_for_shapes(self.service, shapes, has_na)

    def launch_counts(self) -> dict:
        """Its launches are the process's own
        (``ops.cuda_kernels.launch_counts``)."""
        return {}

    # -- telemetry ------------------------------------------------------

    def metrics_snapshot(self) -> dict:
        """This worker's registry snapshot. In-process workers share the
        process-wide ``obs.REGISTRY``, so every handle answers the same
        process view."""
        return {"worker": self.name, "metrics": obs.REGISTRY.snapshot()}

    def metrics_render(self) -> dict:
        """This worker's Prometheus text exposition (the same
        process-wide view as :meth:`metrics_snapshot`), as the socket
        handle's ``metrics_render`` answers it."""
        return {"worker": self.name, "text": obs.render_prom()}


class ConsensusFleet:
    """The replicated serve fleet (see module docstring).

    Quick use::

        from pyconsensus_tpu_torch.serve import ConsensusFleet, FleetConfig

        fleet = ConsensusFleet(FleetConfig(
            n_workers=3, log_dir="/shared/fleet-log")).start()
        fleet.create_session("btc-settles", n_reporters=50)
        fleet.append("btc-settles", block)
        result = fleet.submit(session="btc-settles").result(timeout=60)
        fleet.kill_worker("w1")        # chaos: sessions fail over
        fleet.close(drain=True)

    ``device`` (None: the card, raising without one; ``"cpu"`` on
    request) is every in-process worker's; a socket fleet places one
    worker process on each of its transport's cards, or every worker on
    the CPU."""

    def __init__(self, config: Optional[FleetConfig] = None,
                 device=None) -> None:
        self.config = config or FleetConfig()
        if self.config.n_workers < 1:
            raise InputError("a fleet needs at least one worker")
        self.device = resolve_device(device)
        self.transport = resolve_transport(self.config.transport)
        self.workers = self.transport.make_workers(self.config,
                                                   device=self.device)
        self.ring = HashRing(self.workers, vnodes=self.config.vnodes)
        self.capacity = ClusterCapacity(self.config.base_retry_s)
        for name in self.workers:
            self.capacity.register(name, self.config.worker.max_queue)
        #: session name -> owning worker name (None while failed)
        self._sessions: dict = {}           # guarded-by: _lock
        #: sessions currently replaying onto their standby (fenced)
        self._migrating: set = set()        # guarded-by: _lock
        #: session name -> CheckpointCorruptionError (refused takeovers)
        self._failed_sessions: dict = {}    # guarded-by: _lock
        self._lock = threading.RLock()
        #: worker names continue ``w<i>`` past the boot-time fleet and a
        #: name is never reused (a replacement must not inherit a dead
        #: worker's metric series or capacity tombstone)
        self._next_worker_id = len(self.workers)    # guarded-by: _lock
        self._seq = 0                               # guarded-by: _lock
        #: trace-id counter of session submits, apart from ``_seq`` so
        #: tracing never perturbs stateless routing keys
        self._trace_seq = 0                         # guarded-by: _lock
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._failovers = obs.counter(
            "pyconsensus_failovers_total",
            "worker-loss takeovers performed by the fleet")
        self._migrated = obs.counter(
            "pyconsensus_sessions_migrated_total",
            "sessions replayed onto a standby worker")
        self._rebalanced = obs.counter(
            "pyconsensus_sessions_rebalanced_total",
            "sessions live-migrated between two healthy workers "
            "(voluntary placement rebalancing, e.g. after a scale-up)")
        #: the router's flight recorder, dumped at every takeover and
        #: drain, so a kill -9 run leaves the router's last moments
        #: beside the victim's boot artifact
        self._recorder = None
        if self.config.worker.flightrec_dir:
            self._recorder = obs.FlightRecorder(
                pathlib.Path(self.config.worker.flightrec_dir) / "router",
                source="router")

    def _dump(self, reason: str) -> None:
        if self._recorder is None:
            return
        try:
            self._recorder.dump(reason)
        except Exception:   # noqa: BLE001 — forensics never block the
            pass            # takeover or drain they record

    # -- lifecycle ------------------------------------------------------

    def start(self, warmup: bool = True) -> "ConsensusFleet":
        for w in self.workers.values():
            w.start(warmup=warmup)
        monitor = (self.config.monitor
                   or getattr(self.transport, "wants_monitor", False))
        if monitor and self._monitor is None:
            self._monitor = threading.Thread(
                target=self._monitor_loop,
                name="pyconsensus-fleet-monitor", daemon=True)
            self._monitor.start()
        return self

    def __enter__(self) -> "ConsensusFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    def close(self, drain: bool = True,
              timeout: Optional[float] = 60.0) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        with self._lock:
            handles = list(self.workers.values())
        for w in handles:
            w.close(drain=drain, timeout=timeout)
        self.transport.close()

    # -- liveness -------------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.config.heartbeat_interval_s):
            try:
                self.check_workers()
            except Exception:   # noqa: BLE001 — the monitor must outlive
                pass            # an injected routing/takeover error

    def check_workers(self) -> list:
        """One liveness scan: beat every worker, export queue depths,
        declare dead anything fenced or heartbeat-stale, and fail over
        its sessions. Returns the names declared dead this scan."""
        dead = []
        with self._lock:        # snapshot: add_worker mutates the dict
            scan = list(self.workers.items())
        for name, w in scan:
            if w.alive:
                w.heartbeat()
                self.capacity.observe_queue_depth(name, w.queue_depth())
            if name in self.ring and (
                    not w.alive
                    or w.stale(self.config.heartbeat_timeout_s)):
                if w.alive:
                    latency = w.last_heartbeat_latency_s
                    print(f"WARNING: worker {name!r} heartbeat stale "
                          f"(> {self.config.heartbeat_timeout_s:.3f}s); "
                          f"last observed heartbeat latency "
                          + (f"{latency * 1e3:.3f}ms" if latency
                             is not None else "never measured"),
                          file=sys.stderr)
                dead.append(name)
        for name in dead:
            self._declare_dead(name)
        return dead

    def kill_worker(self, name: str) -> dict:
        """The chaos entry point: hard-kill ``name`` as a SIGKILL would
        look to the router (fence, shed queued as PYC501, fail its
        sessions over). Returns a loss summary."""
        if name not in self.workers:
            raise PlacementError(f"unknown worker {name!r}", worker=name)
        return self._declare_dead(name)

    def _declare_dead(self, name: str) -> dict:
        w = self.workers[name]
        # one declaration at a time per worker: a second declarer blocks
        # here, then finds nothing left to move
        with w.declare_lock:
            shed = w.hard_kill(self.config.takeover_window_s)
            with self._lock:
                in_ring = name in self.ring
                self.ring.remove(name)
                # stranded sessions (an earlier takeover aborted by a
                # fault) get another chance
                stranded = any(o == name
                               for o in self._sessions.values())
            self.capacity.mark_dead(name)
            self.capacity.observe_queue_depth(name, 0)
            # with an empty ring a takeover cannot land anywhere
            # (routing answers PYC503 instead)
            migrated = (self._failover(name)
                        if (in_ring or (stranded and len(self.ring)))
                        else [])
        self._dump("takeover")
        return {"worker": name, "shed_queued": shed,
                "sessions_migrated": migrated}

    # -- failover -------------------------------------------------------

    def _failover(self, dead: str) -> list:
        """Hot-standby takeover of ``dead``'s sessions: each is fenced in
        ``_migrating`` (its submits answer PYC502) while its log is
        verified and replayed onto its new ring owner. A log that fails
        verification is refused: the session is marked failed and keeps
        answering its corruption error."""
        _faults.fire("fleet.takeover")
        with self._lock:
            # claim atomically: a session already in _migrating belongs
            # to a takeover in flight
            moving = [s for s, o in self._sessions.items()
                      if o == dead and s not in self._migrating]
            self._migrating.update(moving)
        if not moving:
            self._failovers.inc()
            return []
        self.capacity.begin_takeover(self.config.takeover_window_s)
        self._failovers.inc()
        migrated = []
        warmed_owners: set = set()
        try:
            for name in moving:
                try:
                    new_owner = self.ring.owner(name)
                    if new_owner not in warmed_owners:
                        warmed_owners.add(new_owner)
                        self._warm_standby(new_owner)
                    self._relocate_session(dead, name, new_owner,
                                           WorkerLostError(
                        f"session {name!r} migrated off dead worker "
                        f"{dead!r}", worker=dead, session=name,
                        retry_after_s=self.config.takeover_window_s))
                    self._migrated.inc()
                    migrated.append((name, new_owner))
                except CheckpointCorruptionError as exc:
                    # a standby never adopts a corrupt log (the durable
                    # state on disk is left for forensics)
                    with self._lock:
                        self._sessions[name] = None
                        self._failed_sessions[name] = exc
                except PlacementError:
                    # every worker is dead: the session stays mapped to
                    # its dead owner; a restarted fleet can adopt it
                    pass
                except Exception:   # noqa: BLE001 — a transient replay
                    # failure: the session stays stranded-but-durable on
                    # the dead owner, so the next declaration retries it;
                    # routing meanwhile answers the retryable PYC501
                    pass
                finally:
                    with self._lock:
                        self._migrating.discard(name)
        finally:
            with self._lock:
                self._migrating.difference_update(moving)
            self.capacity.end_takeover()
        return migrated

    def _warm_standby(self, owner: str) -> int:
        """Warm the adopting worker's keys from the kernel store inside
        the takeover window, so its first request after the takeover
        neither builds nor runs ``nvcc``. Fail-soft: warming may shrink
        the PYC502 window, it must never abort the takeover. Returns the
        keys adopted."""
        try:
            adopted = self.workers[owner].warm_from_disk()
        except Exception as exc:   # noqa: BLE001 — the takeover wins
            print(f"WARNING: standby {owner!r} warm failed "
                  f"({type(exc).__name__}: {exc}); takeover continues",
                  file=sys.stderr)
            return 0
        if adopted:
            obs.counter(
                "pyconsensus_aot_takeover_warms_total",
                "bucket keys a standby adopted from the kernel store "
                "inside a takeover window").inc(adopted)
        return adopted

    def _relocate_session(self, src: str, name: str, target: str,
                          fence_exc: BaseException) -> None:
        """Move ONE session ``src`` -> ``target``, the primitive of every
        relocation (takeover, drain, rebalancing):

        1. the ``state.migrate`` fault site fires;
        2. the source's in-memory object is FENCED with ``fence_exc``
           before the replay reads its log;
        3. the adopter verifies + replays the log (a corrupt one refuses
           with PYC301);
        4. the fenced object leaves the source store and the ownership
           map flips.

        Raises on failure with the source store untouched past the
        fence; the caller owns the ``_migrating`` claim and the failure
        policy."""
        _faults.fire("state.migrate")
        self.workers[src].fence_session(name, fence_exc)
        self.workers[target].adopt_session(name)
        self.workers[src].evict_session(name)
        with self._lock:
            self._sessions[name] = target

    # -- elastic membership ---------------------------------------------

    def add_worker(self, name: Optional[str] = None,
                   warmup: bool = True) -> str:
        """Grow the fleet by ONE worker on the fleet's device: the
        transport spawns the handle, the fleet starts and warms it, and
        only THEN places it on the ring. Returns its name (``w<i>``
        names continue; a name is never reused)."""
        with self._lock:
            if name is None:
                while True:
                    name = f"w{self._next_worker_id}"
                    self._next_worker_id += 1
                    if name not in self.workers:
                        break
            elif name in self.workers:
                raise InputError(
                    f"worker {name!r} already exists in this fleet",
                    worker=name)
        handle = self.transport.spawn_worker(self.config, name,
                                             device=self.device)
        try:
            handle.start(warmup=warmup)
        except BaseException:
            try:
                handle.close(drain=False, timeout=5.0)
            except Exception:   # noqa: BLE001 — the start failure wins
                pass
            raise
        with self._lock:
            self.workers[name] = handle
        self._warm_standby(name)
        with self._lock:
            self.ring.add(name)
        self.capacity.register(name, self.config.worker.max_queue)
        return name

    def drain_worker(self, name: str,
                     timeout: Optional[float] = 60.0) -> dict:
        """Shrink the fleet by ONE worker, gracefully: take it off the
        ring, live-migrate each of its sessions onto the surviving ring
        owners (fence, verify + replay, evict), then drain its in-flight
        work and shut it down. Holding its declare lock throughout
        serializes the drain against a concurrent death declaration."""
        w = self.workers.get(name)
        if w is None:
            raise PlacementError(f"unknown worker {name!r}", worker=name)
        with w.declare_lock:
            with self._lock:
                in_ring = name in self.ring
                if in_ring and len(self.ring) <= 1:
                    raise PlacementError(
                        f"cannot drain {name!r}: it is the last worker "
                        f"on the ring", worker=name)
                stranded = any(o == name
                               for o in self._sessions.values())
                if not w.alive or (not in_ring and not stranded):
                    return {"worker": name, "drained": False,
                            "sessions_migrated": []}
                peers = [self.workers[p] for p in self.ring.workers()
                         if p != name] if in_ring else []
            # ring membership is not liveness: at least one surviving
            # ring peer must answer a beat right now, or the drain could
            # shut down the last live worker
            if in_ring and not any(p.heartbeat() for p in peers):
                raise PlacementError(
                    f"cannot drain {name!r}: no surviving ring peer "
                    f"answers a heartbeat (undeclared deaths?)",
                    worker=name)
            with self._lock:
                self.ring.remove(name)
            migrated = (self._failover(name) if len(self.ring) else [])
            with self._lock:
                leftover = sorted(s for s, o in self._sessions.items()
                                  if o == name)
            if leftover:
                # a transient replay failure stranded sessions on the
                # (still live) worker: the drain did not complete
                return {"worker": name, "drained": False,
                        "sessions_migrated": migrated,
                        "stranded": leftover}
            w.close(drain=True, timeout=timeout)
            # the drained worker LEFT the fleet: forget it, so its
            # tombstone does not inflate retry hints as a death's does
            self.capacity.forget(name)
            self.capacity.observe_queue_depth(name, 0)
        self._dump("drain")
        return {"worker": name, "drained": True,
                "sessions_migrated": migrated}

    # -- live rebalancing -----------------------------------------------

    def migrate_session(self, name: str,
                        target: Optional[str] = None) -> str:
        """Live-migrate one session between two healthy workers
        (``target`` defaults to the session's ring home) through
        :meth:`_relocate_session`; on an adopt failure the source
        re-adopts its own log and keeps serving. Returns the adopting
        worker's name (the source's when the session is already home)."""
        with self._lock:
            if name in self._failed_sessions:
                raise self._failed_sessions[name]
            src = self._sessions.get(name)
        if src is None:
            raise InputError(f"unknown fleet session {name!r}")
        if target is None:
            target = self.ring.owner(name)
        if target == src:
            return src
        if target not in self.workers:
            raise PlacementError(f"unknown worker {target!r}",
                                 worker=target)
        w_src = self.workers.get(src)
        if w_src is None or not w_src.alive:
            raise WorkerLostError(
                f"session {name!r} cannot rebalance: its owner {src!r} "
                f"is not alive", worker=src, session=name,
                retry_after_s=self.config.takeover_window_s)
        with w_src.declare_lock:
            with self._lock:
                if (self._sessions.get(name) != src
                        or name in self._migrating):
                    raise FailoverInProgressError(
                        f"session {name!r} is already relocating",
                        session=name,
                        retry_after_s=max(
                            self.capacity.takeover_remaining(), 0.05))
                self._migrating.add(name)
            try:
                if not (w_src.alive
                        and self.workers[target].alive):
                    raise WorkerLostError(
                        f"session {name!r} cannot rebalance "
                        f"{src!r} -> {target!r}: both ends must be "
                        f"alive", worker=(src if not w_src.alive
                                          else target), session=name,
                        retry_after_s=self.config.takeover_window_s)
                try:
                    self._relocate_session(
                        src, name, target, FailoverInProgressError(
                            f"session {name!r} is rebalancing from "
                            f"{src!r} to {target!r}", session=name,
                            reason="rebalance",
                            retry_after_s=self.config.takeover_window_s))
                except BaseException:
                    # put the source back in service from its own log
                    # (a fresh, un-fenced object); if even that fails the
                    # session is stranded-but-durable on the live source
                    try:
                        w_src.evict_session(name)
                        w_src.adopt_session(name)
                    except Exception:   # noqa: BLE001 — original error
                        pass            # wins; recovery is best-effort
                    raise
                self._rebalanced.inc()
            finally:
                with self._lock:
                    self._migrating.discard(name)
        return target

    def rebalance_to(self, target: str,
                     max_sessions: Optional[int] = None) -> list:
        """After ``target`` joined the ring, migrate the sessions whose
        ring home is now ``target`` onto it (sessions are sticky: a
        membership change alone never moves them). Per-session failures
        are swallowed (the session keeps serving where it is);
        ``max_sessions`` bounds the moves per call. Returns ``[(name,
        old_owner), ...]``."""
        if target not in self.workers:
            raise PlacementError(f"unknown worker {target!r}",
                                 worker=target)
        with self._lock:
            candidates = sorted(
                s for s, o in self._sessions.items()
                if o is not None and o != target
                and s not in self._migrating
                and s not in self._failed_sessions)
        moved = []
        for name in candidates:
            if max_sessions is not None and len(moved) >= max_sessions:
                break
            try:
                if self.ring.owner(name) != target:
                    continue
                src = self.owner_of(name)
                if self.migrate_session(name, target) == target \
                        and src != target:
                    moved.append((name, src))
            except Exception:   # noqa: BLE001 — advisory: the session
                continue        # keeps serving on its current owner
        return moved

    # -- routing --------------------------------------------------------

    def _session_worker(self, session: str,
                        _retried: bool = False) -> WorkerBase:
        """Resolve a session to its live owning worker, surfacing the
        takeover states as their structured errors."""
        with self._lock:
            if session in self._migrating:
                raise FailoverInProgressError(
                    f"session {session!r} is replaying onto its standby",
                    session=session,
                    retry_after_s=max(self.capacity.takeover_remaining(),
                                      0.05))
            if session in self._failed_sessions:
                raise self._failed_sessions[session]
            owner = self._sessions.get(session)
        if owner is None:
            raise InputError(f"unknown fleet session {session!r}")
        w = self.workers[owner]
        if not w.alive:
            if _retried:
                if not len(self.ring):
                    # every worker is dead: the non-retryable placement
                    # error, not PYC501
                    raise PlacementError(
                        f"session {session!r} has no live owner and "
                        f"the fleet has no alive workers",
                        session=session, worker=owner)
                raise WorkerLostError(
                    f"session {session!r} has no live owner (worker "
                    f"{owner!r} is dead)", worker=owner, session=session,
                    retry_after_s=self.config.takeover_window_s)
            # death discovered at routing time: fail over now, then
            # re-resolve, so the caller lands on the standby
            try:
                self._declare_dead(owner)
            except Exception as exc:  # noqa: BLE001 — an injected
                # takeover fault: this client gets the retryable loss
                raise WorkerLostError(
                    f"session {session!r} lost worker {owner!r} and its "
                    f"takeover did not complete", worker=owner,
                    session=session,
                    retry_after_s=self.config.takeover_window_s
                ) from exc
            return self._session_worker(session, _retried=True)
        return w

    def submit(self, reports=None, session: Optional[str] = None,
               tenant: str = "default", **kwargs):
        """Route one resolution into the fleet; returns the worker's
        ``Future``. Stateless requests spread over the ring and spill to
        the next arc when the owner's queue is full; session requests go
        to the session's owner. Raises PYC401 (cluster full, worker
        policy), PYC501/502 (worker loss, takeover: retryable) and
        PYC503 (no placeable worker)."""
        _faults.fire("fleet.route")
        if (reports is None) == (session is None):
            raise InputError(
                "exactly one of reports= / session= is required")
        if session is not None:
            with self._lock:
                self._trace_seq += 1
                trace_id = f"{session}:{tenant}:{self._trace_seq}"
            with obs.trace_root("fleet.submit", trace_id,
                                session=str(session), tenant=str(tenant)):
                return self._submit_session_routed(session, tenant,
                                                   kwargs)
        with self._lock:
            self._seq += 1
            key = f"~{tenant}:{self._seq}"
        # the stateless trace id is the routing key
        with obs.trace_root("fleet.submit", key, tenant=str(tenant)):
            return self._submit_stateless_routed(key, reports, tenant,
                                                 kwargs)

    def _submit_session_routed(self, session: str, tenant: str,
                               kwargs: dict):
        w = self._session_worker(session)
        try:
            return w.submit_session(session, tenant=tenant, **kwargs)
        except ServiceOverloadError as exc:
            if exc.context.get("reason") == "draining" and not w.alive:
                # lost the race with this worker's death: the retryable
                # worker-loss code (a LIVE worker's drain stays PYC401)
                raise WorkerLostError(
                    f"worker {w.name!r} died while routing session "
                    f"{session!r}", worker=w.name, session=session,
                    tenant=tenant,
                    retry_after_s=self.config.takeover_window_s
                ) from exc
            raise

    def _submit_stateless_routed(self, key: str, reports, tenant: str,
                                 kwargs: dict):
        candidates = (self.ring.preference(key) if self.config.spillover
                      else [self.ring.owner(key)])
        last_exc = None
        for name in candidates:
            w = self.workers[name]
            if not w.alive:
                continue
            try:
                return w.submit_stateless(reports, tenant=tenant,
                                          **kwargs)
            except ServiceOverloadError as exc:
                if exc.context.get("reason") not in ("queue_full",
                                                     "draining"):
                    raise          # rate limit etc.: spilling would
                last_exc = exc     # double-charge the tenant's bucket
        raise ServiceOverloadError(
            "every surviving worker's queue is full",
            reason="cluster_full", tenant=tenant,
            alive_workers=self.capacity.alive,
            alive_slots=self.capacity.alive_slots(),
            retry_after_s=self.capacity.shed_retry_after()) from last_exc

    def resolve(self, timeout: Optional[float] = None, **kwargs) -> dict:
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(**kwargs).result(timeout)

    # -- sessions -------------------------------------------------------

    def create_session(self, name: str, n_reporters: int,
                       **kwargs) -> str:
        """Create a DURABLE session placed by the ring; returns the
        owning worker's name. Requires ``FleetConfig.log_dir``."""
        if self.config.log_dir is None:
            raise InputError(
                "fleet sessions need FleetConfig.log_dir (the shared "
                "replication-log directory) — a session without a log "
                "cannot fail over")
        _faults.fire("fleet.route")
        owner = self.ring.owner(name)
        self.workers[owner].create_session(name, n_reporters, kwargs)
        with self._lock:
            self._sessions[name] = owner
        return owner

    def adopt_session(self, name: str) -> str:
        """Adopt a replication log a previous fleet (of either package)
        left in ``log_dir``: verify and replay it onto its ring owner.
        Returns the owner; refuses a corrupt log (PYC301)."""
        if self.config.log_dir is None:
            raise InputError(
                "adopt_session needs FleetConfig.log_dir (the shared "
                "replication-log directory)")
        _faults.fire("fleet.route")
        with self._lock:
            if name in self._sessions:
                raise InputError(
                    f"session {name!r} is already placed on this fleet")
        owner = self.ring.owner(name)
        self.workers[owner].adopt_session(name)
        with self._lock:
            self._sessions[name] = owner
        return owner

    def session_state(self, name: str) -> dict:
        """The owning worker's :meth:`MarketSession.state` snapshot,
        routed like any session request."""
        w = self._session_worker(name)
        return w.session_state(name)

    def append(self, session: str, reports_block, event_bounds=None,
               append_id: Optional[str] = None) -> int:
        """Append an event block to a fleet session (durable before it
        is acknowledged). A retried append (after a PYC501 whose original
        may have landed) must pass the SAME ``append_id``, and the
        standby acknowledges without folding the block twice."""
        _faults.fire("fleet.route")
        w = self._session_worker(session)
        if append_id is not None:
            return w.append(session, reports_block, event_bounds,
                            append_id=append_id)
        return w.append(session, reports_block, event_bounds)

    def owner_of(self, session: str) -> Optional[str]:
        with self._lock:
            return self._sessions.get(session)

    def sessions(self) -> dict:
        with self._lock:
            return dict(self._sessions)

    # -- telemetry ------------------------------------------------------

    def merged_registry(self) -> obs.MetricsRegistry:
        """The cluster's one metric view: the process registry under
        ``worker="router"`` plus, under a ``worker`` label, the snapshot
        of every worker with a registry of its own (a socket worker's
        process registry, over the wire). An in-process worker shares the
        process registry, so it adds nothing (its series are already the
        router's: merging them again would count each request once more a
        worker). A worker that fails to answer contributes nothing."""
        merged = obs.MetricsRegistry()
        merged.merge_snapshot(obs.REGISTRY.snapshot(), worker="router")
        with self._lock:        # snapshot: add_worker mutates the dict
            scan = sorted(self.workers.items())
        for name, w in scan:
            if getattr(w, "shares_process_registry", False):
                continue
            try:
                reply = w.metrics_snapshot()
                merged.merge_snapshot(
                    dict(reply.get("metrics") or {}),
                    worker=str(reply.get("worker", name)))
            except Exception:   # noqa: BLE001 — a dead worker must not
                continue        # take the cluster view down with it
        return merged

    def merged_snapshot(self) -> dict:
        """``merged_registry().snapshot()``."""
        return self.merged_registry().snapshot()

    def render_metrics(self) -> str:
        """Prometheus text exposition of the merged cluster view."""
        return self.merged_registry().render_prom()

    # -- introspection --------------------------------------------------

    def status(self) -> dict:
        """Operator snapshot."""
        with self._lock:
            sessions = dict(self._sessions)
            failed = sorted(self._failed_sessions)
            scan = list(self.workers.items())
        return {
            "workers": {n: {"alive": w.alive,
                            "queue_depth": w.queue_depth()}
                        for n, w in scan},
            "alive": self.capacity.alive,
            "alive_slots": self.capacity.alive_slots(),
            "sessions": sessions,
            "failed_sessions": failed,
            "failovers": obs.value("pyconsensus_failovers_total"),
            "sessions_migrated": obs.value(
                "pyconsensus_sessions_migrated_total"),
        }
