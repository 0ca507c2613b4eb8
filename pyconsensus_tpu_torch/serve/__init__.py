"""pyconsensus_tpu_torch.serve — the micro-batching consensus service
(``pyconsensus_tpu/serve``) on one device or a device mesh: a bounded
request queue and a
continuous micro-batcher with shape-bucketed padding, the ``bucket_cuda``
low-latency class on the Hopper kernels, an executable cache with LRU
eviction, named market sessions with incremental ingestion (and the
warm-started ``bucket_incremental`` resolves), and deterministic
admission control.

Quick use::

    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig

    svc = ConsensusService(ServeConfig(warmup=((16, 64),))).start()
    result = svc.submit(reports=matrix).result()   # Oracle-shaped dict
    svc.close(drain=True)

``ConsensusService(config, device=None)`` serves on the card (and raises
where there is none); ``device="cpu"`` serves on the CPU.
``ConsensusService(ServeConfig(sharded_buckets=True), devices=[...])``
runs the padded buckets that divide over it on a batch x event grid of
those devices (``serve/sharded.py``; ``["cpu"] * 8`` is a 2 x 4 grid on
the CPU).

Guarantees:

- catch-snapped outcomes and iteration counts from the padded buckets
  equal a direct ``Oracle(pca_method="power")`` resolution's; continuous
  tails match to <= 1e-9 in float64. The ``bucket_cuda`` class runs the
  direct fused resolution's own function on its placement (bit for bit);
  the numpy and direct paths run the ``Oracle`` itself;
- a request's full result is a function of the request alone — never of
  the traffic, the co-batched requests, the pipeline depth or the cache
  state;
- overload is shed deterministically with ``ServiceOverloadError``
  (PYC401) at admission or at the deadline;
- incremental sessions keep the dominant eigenpair across rounds by
  warm-started power iteration, with continuous drift pinned to a band
  by an exact resolve every K rounds.

- the replicated fleet (``serve.fleet``) survives any worker's death
  mid-traffic: consistent-hash placement (``serve.placement``) moves only
  the dead worker's sessions, the replication log (``serve.failover``:
  ledger checkpoints + staged journals, the reference's layout and
  digests) resumes them bit for bit on the standby, and everything in
  between sheds with PYC5xx errors carrying an honest ``retry_after_s``.
  Its workers are in-process services on the fleet's one device
  (``serve.transport``); ``serve.loadgen`` drives a service or a fleet,
  and ``serve.cli`` (``pyconsensus-serve-torch``) is the front door.

- the fleet's workers may also be OS processes, one a card, behind the
  socket transport (``serve.transport``), their logs shipped to the
  standby's disk;
- the state plane (``serve.stateplane``) compacts a session's journal
  behind a snapshot and keeps at most ``hot_sessions`` sessions in
  memory, hydrating the rest from their logs, and the kernel-build store
  (``serve.aotcache``, ``aot_cache_dir``) lets a restarted or standby
  worker adopt the kernel libraries and its warmed keys with no
  ``nvcc``.

- the elastic fleet (``serve.autoscale``): ``AutoScaler`` reads an
  ``obs.SloMonitor``'s window and grows the fleet on a sustained breach
  (a new worker, or a process on the socket transport that adopts its
  kernels from the store), drains it on sustained idleness (every
  session live-migrated) and replaces a declared-dead worker; the
  ``/metrics`` endpoint and the flight recorder live in ``obs``.
"""

from __future__ import annotations

from ..faults import (AotCacheCorruptionError, FailoverInProgressError,
                      PlacementError, ServiceOverloadError,
                      SnapshotCorruptionError, WorkerLostError)
from .admission import AdmissionController, ClusterCapacity
from .aotcache import AOT_ENTRY, AotCache
from .autoscale import AutoScaler, AutoscaleConfig
from .cache import SINGLE_TOPOLOGY, BucketKey, ExecutableCache, warm_inputs
from .cuda import (CUDA_KERNEL_PATH, PLAIN_KERNEL_PATH, cuda_bucket_eligible,
                   cuda_bucket_params, make_cuda_bucket_executable)
from .incremental import (INCREMENTAL_KERNEL_PATH,
                          INCREMENTAL_REFRESH_DEFAULT,
                          incremental_consensus, incremental_drift_band,
                          make_incremental_executable)
from .failover import DurableSession, ReplicationLog, replay_session
from .fleet import ConsensusFleet, FleetConfig, FleetWorker
from .kernels import (SERVE_ALGORITHMS, BucketTemplates, bucket_inputs,
                      bucket_path_eligible, make_bucket_executable,
                      padded_consensus, slice_result)
from .loadgen import LoadGenerator, RateTrace
from .placement import HashRing
from .queue import RequestQueue, ResolveRequest
from .service import ConsensusService, ServeConfig
from .session import MarketSession, SessionStore, share_of
from .sharded import (make_sharded_bucket_executable, mesh_fingerprint,
                      serve_mesh, sharded_bucket_eligible)
from .stateplane import (CompactionPolicy, Compactor, TieredSessionStore,
                         hydrate_session)

__all__ = [
    "ConsensusService", "ServeConfig", "ServiceOverloadError",
    "MarketSession", "SessionStore", "share_of",
    "ResolveRequest", "RequestQueue", "AdmissionController",
    "ClusterCapacity",
    "ExecutableCache", "BucketKey", "warm_inputs", "SINGLE_TOPOLOGY",
    "padded_consensus", "make_bucket_executable", "bucket_inputs",
    "slice_result", "bucket_path_eligible", "SERVE_ALGORITHMS",
    "BucketTemplates",
    "CUDA_KERNEL_PATH", "PLAIN_KERNEL_PATH", "cuda_bucket_eligible",
    "cuda_bucket_params", "make_cuda_bucket_executable",
    "INCREMENTAL_KERNEL_PATH", "INCREMENTAL_REFRESH_DEFAULT",
    "incremental_consensus", "incremental_drift_band",
    "make_incremental_executable",
    "serve_mesh", "mesh_fingerprint", "sharded_bucket_eligible",
    "make_sharded_bucket_executable",
    "ConsensusFleet", "FleetConfig", "FleetWorker", "HashRing",
    "DurableSession", "ReplicationLog", "replay_session",
    "WorkerLostError", "FailoverInProgressError", "PlacementError",
    "LoadGenerator", "RateTrace",
    "AotCache", "AOT_ENTRY", "AotCacheCorruptionError",
    "TieredSessionStore", "CompactionPolicy", "Compactor",
    "hydrate_session", "SnapshotCorruptionError",
    "AutoScaler", "AutoscaleConfig",
]
