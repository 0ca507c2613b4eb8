"""Event meshes, the front door, the out-of-core driver and several
hosts of the port (see the package docstring)."""

from .distributed import initialize, is_distributed
from .mesh import EventShards, make_mesh, place_event_shards
from .plain_sharded import hybrid_sharded_consensus, plain_sharded_consensus
from .ring import ring_allreduce, ring_first_pc, ring_gram, ring_matvec
from .sharded import (ShardedOracle, resolve_auto_storage, resolve_device,
                      sharded_consensus)
from .streaming import streaming_consensus

__all__ = ["make_mesh", "place_event_shards", "EventShards",
           "sharded_consensus", "ShardedOracle", "resolve_device",
           "resolve_auto_storage", "streaming_consensus", "initialize",
           "is_distributed", "plain_sharded_consensus",
           "hybrid_sharded_consensus", "ring_allreduce", "ring_gram",
           "ring_matvec", "ring_first_pc"]
