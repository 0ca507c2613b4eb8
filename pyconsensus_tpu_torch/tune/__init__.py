"""pyconsensus_tpu_torch.tune — the launch-shape autotuner and what the
port keys persisted and shared state on (``pyconsensus_tpu/tune``).

- :mod:`.autotune` — sweeps the Hopper kernels' launch shapes (the two
  tile passes' split counts, resolve's panel width) over the legal sets
  of ``ops/cuda_kernels.py``'s shape models, persists the winners keyed
  by (card generation, storage type, shape class) through
  ``io.atomic_write``, and replays them into the launches through
  ``cuda_kernels.set_tune_provider`` (:func:`install`, or the provider
  the first launch on a card loads). With no entry the built-in shapes
  serve. It also tunes the serve tier's dispatch pipeline depth
  (``ServeConfig.pipeline_depth = 0``). ``python -m
  pyconsensus_tpu_torch.tune`` re-tunes a shape.
- :mod:`.roofline` — the measured stream bandwidth and the traffic model
  that places a resolution rate against it.
- :mod:`.fingerprint` — the runtime fingerprint the fleet's wire
  handshake compares, and the card generation the winner keys carry.
"""

from __future__ import annotations

from .autotune import (FALLBACK_TABLE, TuneCache, autotune_cov,
                       autotune_pipeline_depth, autotune_resolve,
                       cache_path, default_provider, depth_candidates,
                       install, shape_class, split_class,
                       tuned_pipeline_depth)
from .fingerprint import device_generation, runtime_fingerprint
from .roofline import (bound_resolutions_per_sec, classify_regime,
                       resolution_traffic_bytes,
                       stream_bandwidth_bytes_per_s)

__all__ = ["autotune_cov", "autotune_resolve", "autotune_pipeline_depth",
           "tuned_pipeline_depth", "depth_candidates", "default_provider",
           "install", "TuneCache", "cache_path", "shape_class",
           "split_class", "FALLBACK_TABLE",
           "device_generation", "runtime_fingerprint",
           "stream_bandwidth_bytes_per_s", "resolution_traffic_bytes",
           "bound_resolutions_per_sec", "classify_regime"]
