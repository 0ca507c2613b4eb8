"""Event meshes and the front door of the port (see the package
docstring)."""

from .mesh import EventShards, make_mesh, place_event_shards
from .sharded import (ShardedOracle, resolve_auto_storage, resolve_device,
                      sharded_consensus)

__all__ = ["make_mesh", "place_event_shards", "EventShards",
           "sharded_consensus", "ShardedOracle", "resolve_device",
           "resolve_auto_storage"]
