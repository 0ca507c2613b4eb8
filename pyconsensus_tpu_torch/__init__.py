"""PyTorch and CUDA port of ``pyconsensus_tpu`` for NVIDIA Hopper.

The port runs the ``Oracle`` (``backend="torch"``: the plain pipeline
over the whole filled matrix, every PCA method, scaled events;
``backend="numpy"``: the numpy pipeline), and, through
``sharded_consensus``, the fused resolution on NaN-threaded storage (int8
sentinel, or float32 or bfloat16 with NaN): sztorc, fixed-variance and
ica on one device, with scaled events up to E // 8 of them, and sztorc
on an event mesh driven by one process (``parallel.mesh``). Every
Pallas kernel of the JAX package has a counterpart written by hand in
CUDA for sm_90a (``csrc/``). Entry points::

    from pyconsensus_tpu_torch import Oracle, sharded_consensus
    result = Oracle(reports).consensus()    # device=None: the card
    out = sharded_consensus(reports, params=ConsensusParams(
        storage_dtype="int8"))

The package imports torch, numpy and the standard library only.
"""

from .models.pipeline import (ConsensusParams, decode_reports,
                              encode_reports, encode_reports_host,
                              lattice_exact)
from .oracle import (ALGORITHMS, BACKENDS, Oracle, assemble_result,
                     parse_event_bounds)
from .parallel.sharded import resolve_device, sharded_consensus

__all__ = ["Oracle", "ALGORITHMS", "BACKENDS", "ConsensusParams",
           "sharded_consensus", "resolve_device",
           "encode_reports", "encode_reports_host", "decode_reports",
           "lattice_exact", "assemble_result", "parse_event_bounds"]
