"""pyconsensus_tpu_torch.serve.transport — the out-of-process fleet
(``pyconsensus_tpu/serve/transport``): socket RPC, worker-process
supervision and replication-log shipping behind the ``ConsensusFleet``
router's unchanged front door.

Layers, each its own module:

- ``wire``: length-prefixed, SHA-256-framed messages (msgpack or JSON),
  the runtime-fingerprint handshake (a worker of another toolchain or
  other kernel sources is refused at connect, PYC602), and PYC-coded
  error marshalling;
- ``rpc``: a pooled client with a dial bounded by ``retry_call``, and a
  server with a thread a connection;
- ``worker``: the ``pyconsensus-fleet-worker-torch`` process, a whole
  ``ConsensusService`` and durable sessions behind the RPC surface,
  shipping every journal record before acknowledging it;
- ``supervisor``: spawn, health-check, drain and SIGKILL the worker
  processes, one a card; ``SocketWorkerHandle`` and ``SocketTransport``;
- ``shipping``: journal records streamed to the standby's disk, checked
  before they are adopted (``adopt_shipped``);
- ``base``: the transport surface ``ConsensusFleet`` routes through.

Quick use::

    from pyconsensus_tpu_torch.serve import ConsensusFleet, FleetConfig
    from pyconsensus_tpu_torch.serve.transport import SocketTransport

    fleet = ConsensusFleet(FleetConfig(
        n_workers=4, transport=SocketTransport(devices=[0, 1, 2, 3]),
        log_dir="/var/lib/pyconsensus/fleet")).start()
    fleet.create_session("btc-settles", n_reporters=50)
    fleet.append("btc-settles", block)       # shipped before acked
    result = fleet.submit(session="btc-settles").result()
    fleet.kill_worker("w1")   # SIGKILL: the standby adopts the shipped log

``FleetConfig(transport="socket")`` puts one worker on each card the
router's process sees; ``ConsensusFleet(..., device="cpu")`` puts every
worker on the CPU.
"""

from __future__ import annotations

from .base import (InProcessTransport, Transport, WorkerBase,
                   resolve_transport)
from .rpc import RpcClient, RpcServer
from .shipping import LogShipper, ShippingReceiver, adopt_shipped
from .supervisor import SocketTransport, SocketWorkerHandle, WorkerSupervisor
from .wire import (MAX_FRAME_BYTES, WIRE_PROTOCOL_VERSION, client_hello,
                   marshal_error, recv_msg, send_msg, server_handshake,
                   unmarshal_error)

__all__ = [
    "Transport", "InProcessTransport", "WorkerBase", "resolve_transport",
    "SocketTransport", "SocketWorkerHandle", "WorkerSupervisor",
    "RpcClient", "RpcServer",
    "LogShipper", "ShippingReceiver", "adopt_shipped",
    "WIRE_PROTOCOL_VERSION", "MAX_FRAME_BYTES",
    "send_msg", "recv_msg", "marshal_error", "unmarshal_error",
    "client_hello", "server_handshake",
]
