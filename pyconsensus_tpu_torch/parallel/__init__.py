"""Event meshes (of one controller, or across processes), the front
door, out-of-core resolution and several hosts of the port (see the
package docstring)."""

from .distributed import (initialize, is_distributed, make_hybrid_mesh,
                          make_process_mesh, num_slices)
from .mesh import (DeviceGrid, EventShards, ProcessGrid, ProcessMesh,
                   make_mesh, place_batch_event_shards, place_event_shards)
from .plain_sharded import hybrid_sharded_consensus, plain_sharded_consensus
from .ring import ring_allreduce, ring_first_pc, ring_gram, ring_matvec
from .sharded import (ShardedOracle, resolve_auto_storage, resolve_device,
                      sharded_consensus)
from .streaming import streaming_consensus

__all__ = ["make_mesh", "place_event_shards", "EventShards", "DeviceGrid",
           "place_batch_event_shards",
           "sharded_consensus", "ShardedOracle", "resolve_device",
           "resolve_auto_storage", "streaming_consensus", "initialize",
           "is_distributed", "make_process_mesh", "make_hybrid_mesh",
           "num_slices", "ProcessMesh", "ProcessGrid",
           "plain_sharded_consensus",
           "hybrid_sharded_consensus", "ring_allreduce", "ring_gram",
           "ring_matvec", "ring_first_pc"]
