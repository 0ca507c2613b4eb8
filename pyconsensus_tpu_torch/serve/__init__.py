"""pyconsensus_tpu_torch.serve — the micro-batching consensus service
(``pyconsensus_tpu/serve``) on one device: a bounded request queue and a
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

The mesh-sharded buckets (``serve/sharded.py``) are ``ROADMAP.md``
§A.10; the AOT store, tiered session state, the fleet, failover,
autoscaling, placement, the load generator, the CLI and the transports
§A.11.
"""

from __future__ import annotations

from ..faults import ServiceOverloadError
from .admission import AdmissionController, ClusterCapacity
from .cache import SINGLE_TOPOLOGY, BucketKey, ExecutableCache, warm_inputs
from .cuda import (CUDA_KERNEL_PATH, PLAIN_KERNEL_PATH, cuda_bucket_eligible,
                   cuda_bucket_params, make_cuda_bucket_executable)
from .incremental import (INCREMENTAL_KERNEL_PATH,
                          INCREMENTAL_REFRESH_DEFAULT,
                          incremental_consensus, incremental_drift_band,
                          make_incremental_executable)
from .kernels import (SERVE_ALGORITHMS, BucketTemplates, bucket_inputs,
                      bucket_path_eligible, make_bucket_executable,
                      padded_consensus, slice_result)
from .queue import RequestQueue, ResolveRequest
from .service import ConsensusService, ServeConfig
from .session import MarketSession, SessionStore, share_of

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
]
