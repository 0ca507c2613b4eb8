"""PyTorch and CUDA port of ``pyconsensus_tpu`` for NVIDIA Hopper.

This slice ports the single-device fused sztorc resolution on
NaN-threaded storage (int8 sentinel or float32 with NaN), with the three
storage kernels of its path written by hand in CUDA for sm_90a
(``csrc/``). Entry point::

    from pyconsensus_tpu_torch import sharded_consensus, ConsensusParams
    out = sharded_consensus(reports, params=ConsensusParams(
        storage_dtype="int8"))             # device=None: the card

The package imports torch, numpy and the standard library only.
"""

from .models.pipeline import (ConsensusParams, decode_reports,
                              encode_reports, encode_reports_host,
                              lattice_exact)
from .oracle import assemble_result, parse_event_bounds
from .parallel.sharded import resolve_device, sharded_consensus

__all__ = ["ConsensusParams", "sharded_consensus", "resolve_device",
           "encode_reports", "encode_reports_host", "decode_reports",
           "lattice_exact", "assemble_result", "parse_event_bounds"]
