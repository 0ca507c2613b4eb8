"""The fleet's transport abstraction
(``pyconsensus_tpu/serve/transport/base.py``).

``ConsensusFleet`` routes every request through a per-worker **handle**
with one surface: liveness (``heartbeat``/``stale``/``queue_depth``/
``hard_kill``), the request plane (``submit_stateless`` /
``submit_session``) and the session plane (``create_session`` /
``append`` / ``session_state`` / ``adopt_session`` and the takeover
hooks ``fence_session`` / ``evict_session`` / ``warm_from_disk``), so the
router's placement, admission and failover are written once against it
and run unchanged over:

- :class:`InProcessTransport` (default): in-process ``ConsensusService``
  workers behind function calls, every one on the fleet's device;
- :class:`~.supervisor.SocketTransport`: workers are OS processes behind
  the socket RPC protocol (``wire.py``), one a card, supervised, beating
  over the wire, their replication logs shipped to the standby's disk.
"""

from __future__ import annotations

import threading
import time

from ...faults import InputError

__all__ = ["WorkerBase", "Transport", "InProcessTransport",
           "resolve_transport"]


class WorkerBase:
    """Liveness bookkeeping every worker handle carries: ``alive`` only
    ever goes True -> False (serialized by ``declare_lock``'s
    single-claim takeover); ``last_heartbeat`` is racy-monotonic (a stale
    read can only delay a staleness declaration by one scan)."""

    def __init__(self, name: str) -> None:
        self.name = str(name)
        self.alive = True                       # guarded-by: none
        self.last_heartbeat = time.monotonic()  # guarded-by: none
        #: round-trip latency of the last successful beat (None until
        #: one lands), logged with a staleness declaration
        self.last_heartbeat_latency_s = None    # guarded-by: none
        #: serializes concurrent death declarations for THIS worker:
        #: exactly one takeover runs; the losers observe its result
        self.declare_lock = threading.Lock()

    def stale(self, timeout_s: float) -> bool:
        return (time.monotonic() - self.last_heartbeat) > timeout_s

    def warm(self, shapes, has_na: bool) -> int:
        """Warm what requests of ``shapes`` ride on this worker, as the
        serve command line warms one service. Returns the count."""
        raise NotImplementedError

    def launch_counts(self) -> dict:
        """The kernels' launches this worker made outside the router's
        process, by name (none for a worker that runs in it)."""
        raise NotImplementedError


class Transport:
    """Factory for a fleet's worker handles. ``make_workers`` is called
    once at fleet construction with the fleet's device; ``close`` tears
    down transport-level machinery after the workers closed."""

    name = "abstract"
    #: True forces the fleet's heartbeat monitor on regardless of
    #: ``FleetConfig.monitor`` (a transport whose worker deaths are only
    #: discoverable by probing)
    wants_monitor = False

    def make_workers(self, config, device=None) -> dict:
        raise NotImplementedError

    def spawn_worker(self, config, name: str, device=None):
        """Create ONE additional, un-started worker handle after fleet
        construction (the fleet starts it and puts it on the ring).
        Transports that cannot grow raise ``InputError``."""
        raise InputError(
            f"transport {self.name!r} cannot spawn workers after fleet "
            f"construction", transport=self.name, worker=name)

    def close(self) -> None:
        """Transport-level teardown (default: nothing)."""


class InProcessTransport(Transport):
    """N in-process ``ConsensusService`` workers behind function calls,
    sharing one replication-log directory and the fleet's device."""

    name = "inprocess"

    def make_workers(self, config, device=None) -> dict:
        from ..fleet import FleetWorker

        return {f"w{i}": FleetWorker(f"w{i}", config.worker,
                                     log_dir=config.log_dir, device=device)
                for i in range(config.n_workers)}

    def spawn_worker(self, config, name: str, device=None):
        from ..fleet import FleetWorker

        return FleetWorker(name, config.worker, log_dir=config.log_dir,
                           device=device)


def resolve_transport(spec) -> Transport:
    """``FleetConfig.transport`` -> a :class:`Transport`: ``"inprocess"``
    (default), ``"socket"`` (imported only when asked for; nothing is
    spawned before the fleet's ``make_workers``) or a ready-made
    instance."""
    if isinstance(spec, Transport):
        return spec
    if spec == "inprocess" or spec is None:
        return InProcessTransport()
    if spec == "socket":
        from .supervisor import SocketTransport

        return SocketTransport()
    raise InputError(
        f"unknown fleet transport {spec!r} — choose 'inprocess', "
        f"'socket', or pass a Transport instance", transport=spec)
