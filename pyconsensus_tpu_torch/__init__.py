"""PyTorch and CUDA port of ``pyconsensus_tpu`` for NVIDIA Hopper.

The port runs the ``Oracle`` with all seven of the reference's algorithms
(``backend="torch"``: the plain pipeline over the whole filled matrix,
every PCA method, scaled events, k-means and dbscan-jit on the device,
and hierarchical and dbscan on the hybrid path, distances on the device
and clustering on the host through the native runtime
(``native/cluster.cpp``); ``backend="numpy"``: the numpy pipeline), and,
through ``sharded_consensus``, the fused resolution on NaN-threaded
storage (int8 sentinel, or float32 or bfloat16 with NaN): sztorc,
fixed-variance and ica on one device and sztorc on an event mesh
driven by one process (``parallel.mesh``), with scaled events up to
E // 8 of them; every other algorithm and configuration takes the plain
core or the hybrid path, on one device or over the mesh's shards
(``parallel.plain_sharded``; ``parallel.ring`` holds the explicit ring
collectives). ``ShardedOracle`` is the ``Oracle`` over that
dispatch, and ``compare_algorithms`` resolves one matrix under several
algorithms. The collusion simulator (``sim``: ``CollusionSimulator``,
``RoundsSimulator``, ``CheckpointedSweep``) resolves a whole Monte-Carlo
sweep as one batched computation on the device, and ``ReputationLedger``
(``ledger``) and ``io`` persist reputation across rounds and report
matrices (npz and npy files shared with the JAX package; CSV through the
native loader ``native/loader.cpp``). ``serve`` runs the oracle as a
service: ``ConsensusService`` with padded shape buckets (on one device,
or split over a batch x event grid of devices, ``serve.sharded``), the
``bucket_cuda`` low-latency class on the kernels, and named market
sessions with incremental resolves, behind a replicated fleet that an
SLO autoscaler resizes (``serve.autoscale``); ``econ`` drives cartel
strategies through that front door as an adversarial market economy
(``pyconsensus-econ-torch``). ``streaming_consensus`` resolves a
matrix out of core, panel by panel from an array, a memory-mapped
``.npy`` or a ``.csv``, for every algorithm, on one device or with each
panel over an event mesh, and on one host or several
(``parallel.distributed``); ``python -m pyconsensus_tpu_torch`` is the
command line (``cli``). ``parallel.make_mesh(batch=b, event=e)`` is the
batch x event grid: its rows carry independent work (serve lanes, the
simulator's trials with ``CollusionSimulator(mesh=...)``) and its
columns split events; ``parallel.distributed.make_process_mesh`` is an
event mesh over the processes of a ``torch.distributed`` group, one a
card, with the one-controller mesh's bits on every rank. Every Pallas
kernel of the JAX
package has a counterpart
written by hand in CUDA for sm_90a (``csrc/``). A non-finite result
walks the reference's fallback chain (``faults``: fault plans, the error
taxonomy, retry); spans and metrics go to ``obs``. Entry points::

    from pyconsensus_tpu_torch import Oracle, ShardedOracle, sharded_consensus
    result = Oracle(reports).consensus()    # device=None: the card
    out = sharded_consensus(reports, params=ConsensusParams(
        storage_dtype="int8"))
    result = ShardedOracle(reports, storage_dtype="int8").place().consensus()
    results = compare_algorithms(reports, max_iterations=3)
    sweep = sim.CollusionSimulator(n_reporters=50, n_events=25).run(
        [0.0, 0.1, 0.2, 0.3, 0.4], [0.05, 0.1], n_trials=1000)
    ledger = ReputationLedger(n_reporters=50); ledger.resolve(reports)
    with ConsensusService(ServeConfig()) as svc:
        result = svc.submit(reports=reports).result()
    out = streaming_consensus("reports.npy", panel_events=8192)

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
from .parallel.streaming import streaming_consensus
from .sweep import compare_algorithms, disagreement_matrix
from .ledger import ReputationLedger
from . import io, serve, sim
from .serve import ConsensusService, ServeConfig

#: the package version (the handshake's runtime fingerprint names it)
__version__ = "0.1.0"

__all__ = ["__version__", "Oracle", "ShardedOracle", "ALGORITHMS", "BACKENDS",
           "ConsensusParams", "sharded_consensus", "streaming_consensus",
           "resolve_device",
           "encode_reports", "encode_reports_host", "decode_reports",
           "lattice_exact", "assemble_result", "parse_event_bounds",
           "compare_algorithms", "disagreement_matrix", "ReputationLedger",
           "ConsensusService", "ServeConfig", "io", "serve", "sim"]
