"""PyTorch and CUDA port of ``pyconsensus_tpu`` for NVIDIA Hopper.

The port runs the ``Oracle`` with all seven of the reference's algorithms
(``backend="torch"``: the plain pipeline over the whole filled matrix,
every PCA method, scaled events, k-means and dbscan-jit on the device,
and hierarchical and dbscan on the hybrid path, distances on the device
and clustering on the host through the native runtime
(``native/cluster.cpp``); ``backend="numpy"``: the numpy pipeline), and,
through ``sharded_consensus``, the fused resolution on NaN-threaded
storage (int8 sentinel, or float32 or bfloat16 with NaN): sztorc,
fixed-variance and ica on one device, with scaled events up to E // 8
of them, and sztorc on an event mesh driven by one process
(``parallel.mesh``); the clustering variants take the plain core or the
hybrid path there. ``ShardedOracle`` is the ``Oracle`` over that
dispatch, and ``compare_algorithms`` resolves one matrix under several
algorithms. Every Pallas kernel of the JAX package has a counterpart
written by hand in CUDA for sm_90a (``csrc/``). A non-finite result
walks the reference's fallback chain (``faults``: fault plans, the error
taxonomy, retry); spans and metrics go to ``obs``. Entry points::

    from pyconsensus_tpu_torch import Oracle, ShardedOracle, sharded_consensus
    result = Oracle(reports).consensus()    # device=None: the card
    out = sharded_consensus(reports, params=ConsensusParams(
        storage_dtype="int8"))
    result = ShardedOracle(reports, storage_dtype="int8").place().consensus()
    results = compare_algorithms(reports, max_iterations=3)

The package imports torch, numpy and the standard library only (scipy or
sklearn only where the native clustering library is unavailable).
"""

from .models.pipeline import (ConsensusParams, decode_reports,
                              encode_reports, encode_reports_host,
                              lattice_exact)
from .oracle import (ALGORITHMS, BACKENDS, Oracle, assemble_result,
                     parse_event_bounds)
from .parallel.sharded import ShardedOracle, resolve_device, \
    sharded_consensus
from .sweep import compare_algorithms, disagreement_matrix

__all__ = ["Oracle", "ShardedOracle", "ALGORITHMS", "BACKENDS",
           "ConsensusParams", "sharded_consensus", "resolve_device",
           "encode_reports", "encode_reports_host", "decode_reports",
           "lattice_exact", "assemble_result", "parse_event_bounds",
           "compare_algorithms", "disagreement_matrix"]
