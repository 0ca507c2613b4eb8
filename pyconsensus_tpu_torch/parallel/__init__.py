"""Event meshes, the front door, the out-of-core driver and several
hosts of the port (see the package docstring)."""

from .distributed import initialize, is_distributed
from .mesh import EventShards, make_mesh, place_event_shards
from .sharded import (ShardedOracle, resolve_auto_storage, resolve_device,
                      sharded_consensus)
from .streaming import streaming_consensus

__all__ = ["make_mesh", "place_event_shards", "EventShards",
           "sharded_consensus", "ShardedOracle", "resolve_device",
           "resolve_auto_storage", "streaming_consensus", "initialize",
           "is_distributed"]
