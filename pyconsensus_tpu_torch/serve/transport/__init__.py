"""pyconsensus_tpu_torch.serve.transport — the worker-handle surface the
fleet router speaks through (``pyconsensus_tpu/serve/transport``).

The port has the in-process transport (``base.InProcessTransport``: each
worker a ``ConsensusService`` in the router's process, every worker on
the fleet's one device). The socket transport, one worker process a card
with its replication log shipped to the standby, is ``ROADMAP.md``
§A.11: ``resolve_transport("socket")`` raises naming it.
"""

from __future__ import annotations

from .base import (ROADMAP_SOCKET, InProcessTransport, Transport,
                   WorkerBase, resolve_transport)

__all__ = ["Transport", "InProcessTransport", "WorkerBase",
           "resolve_transport", "ROADMAP_SOCKET"]
