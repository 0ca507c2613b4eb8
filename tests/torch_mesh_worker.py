"""One rank of the port's process mesh on the CPU (not collected by
pytest): ``tests/test_torch_process_mesh.py`` starts ``world`` of these,

    python tests/torch_mesh_worker.py <host:port> <world> <rank> <shards> <out>

Each joins a gloo group through ``parallel.distributed.initialize``,
builds ``make_process_mesh(["cpu"] * shards)`` and runs every case of
:data:`CASES` on it, the same matrices on every rank (the reference's
contract, ``tests/distributed_worker.py:37-38``), then the grid cases on
``make_hybrid_mesh(batch=2)``. It pickles ``{case: {key: array}}`` to
``<out>/rank<rank>.pkl``. The cases are importable, so the test runs the
same ones on the one-controller mesh and against the reference.
"""

import pathlib
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from pyconsensus_tpu_torch import (ConsensusParams,  # noqa: E402
                                   encode_reports_host, sharded_consensus)
from pyconsensus_tpu_torch.parallel import ShardedOracle  # noqa: E402

#: the reference's power settings on the fused mesh (fixed sweeps:
#: ``tests/test_torch_mesh.py`` BASE)
FUSED = dict(algorithm="sztorc", pca_method="power", power_iters=64,
             power_tol=-1.0)


def worker_reports():
    """The reference worker's 12 x 16 matrix (``tests/
    distributed_worker.py:39-43``): no absent report."""
    rng = np.random.default_rng(0)
    truth = rng.choice([0.0, 1.0], size=16)
    reports = np.tile(truth, (12, 1))
    reports[:9] = np.abs(reports[:9] - (rng.random((9, 16)) < 0.1))
    reports[9:] = 1.0 - truth
    return reports


def nan_inputs(seed, n_scaled=0):
    """12 x 16 collusion reports (float32, a tenth absent), ``n_scaled``
    columns on [0, 4] (a span that rescales exactly in float32 and
    float64), a float64 reputation. Returns ``(reports, rep, bounds)``."""
    rng = np.random.default_rng(seed)
    truth = rng.choice([0.0, 1.0], size=16)
    reports = np.abs(np.tile(truth, (12, 1)) - (rng.random((12, 16)) < 0.1))
    reports[:3] = 1.0 - truth
    reports[rng.random((12, 16)) < 0.1] = np.nan
    bounds = None
    if n_scaled:
        bounds = [None] * 16
        for c in rng.choice(16, n_scaled, replace=False):
            reports[:, c] = np.where(np.isnan(reports[:, c]), np.nan,
                                     rng.random(12) * 4.0)
            bounds[c] = {"scaled": True, "min": 0.0, "max": 4.0}
    rep = rng.random(12) + 0.05
    return reports.astype(np.float32), rep / rep.sum(), bounds


def _radius():
    # honest pairs sit near d^2 = 0.2 E, honest-liar pairs near 0.8 E
    return (0.3 * 16) ** 0.5


#: name -> (inputs, params, how): ``inputs`` ``(reports, rep, bounds)``,
#: ``how`` "sharded" (``sharded_consensus``), "oracle" (``ShardedOracle``
#: placed once) or "int8" (``sharded_consensus`` on the int8 encoding)
def _cases():
    ref = worker_reports()
    uniform = np.full(12, 1.0 / 12)
    return {
        # reference worker phase 1: the plain core's Gram eigh
        "sztorc_eigh_gram": ((ref, uniform, None),
                             dict(algorithm="sztorc", max_iterations=2,
                                  pca_method="eigh-gram"), "sharded"),
        # phase 4: scaled events on "power", the fused mesh's gather-median
        # tail and the plain mesh core's shard-local median
        "sztorc_scaled_fused": (nan_inputs(4, 2),
                                dict(FUSED, max_iterations=2), "sharded"),
        "sztorc_scaled_plain": (nan_inputs(5, 3),
                                dict(algorithm="sztorc", max_iterations=2,
                                     pca_method="power", power_tol=-1.0,
                                     allow_fused=False), "sharded"),
        # phase 5: the fused mesh on int8 storage
        "sztorc_int8_fused": ((ref, uniform, None),
                              dict(FUSED, max_iterations=3,
                                   storage_dtype="int8"), "int8"),
        "sztorc_bf16_fused": (nan_inputs(6, 2),
                              dict(FUSED, max_iterations=2,
                                   storage_dtype="bfloat16"), "sharded"),
        # phase 6: the hybrid path, every rank clustering its own copy
        "hierarchical": ((ref, uniform, None),
                         dict(algorithm="hierarchical", max_iterations=2),
                         "sharded"),
        "fixed_variance": (nan_inputs(7),
                           dict(algorithm="fixed-variance",
                                max_iterations=3), "sharded"),
        "fixed_variance_power": (nan_inputs(8, 2),
                                 dict(algorithm="fixed-variance",
                                      max_iterations=3, pca_method="power",
                                      power_tol=-1.0), "sharded"),
        "ica": (nan_inputs(9), dict(algorithm="ica", max_iterations=3),
                "sharded"),
        "k_means": (nan_inputs(10), dict(algorithm="k-means",
                                         max_iterations=3, num_clusters=2),
                    "sharded"),
        "dbscan_jit": (nan_inputs(11), dict(algorithm="dbscan-jit",
                                            max_iterations=3,
                                            dbscan_eps=_radius()),
                       "sharded"),
        "dbscan": (nan_inputs(12), dict(algorithm="dbscan",
                                        max_iterations=2,
                                        dbscan_eps=_radius()), "sharded"),
        "oracle_sztorc": (nan_inputs(13, 2), dict(algorithm="sztorc",
                                                  max_iterations=3),
                          "oracle"),
        "oracle_int8": ((ref, uniform, None),
                        dict(FUSED, max_iterations=2,
                             storage_dtype="int8"), "oracle"),
    }


CASES = _cases()


def flat(out) -> dict:
    """A result (a flat dict of tensors, or the ``Oracle``'s nested one)
    as ``{key: numpy array}``."""
    res = {}
    for key, v in out.items():
        if isinstance(v, dict):
            res.update({f"{key}.{k}": np.asarray(w) for k, w in v.items()})
        elif isinstance(v, torch.Tensor):
            res[key] = v.detach().cpu().numpy()
        else:
            res[key] = np.asarray(v)
    return res


def run_case(name: str, mesh) -> dict:
    """Case ``name`` on ``mesh``, in float64 as the reference's x64 tests
    run."""
    (reports, rep, bounds), params, how = CASES[name]
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        if how == "oracle":
            return flat(ShardedOracle(
                reports=reports.astype(np.float64), reputation=rep,
                event_bounds=bounds, mesh=mesh, **params).place().consensus())
        x = encode_reports_host(reports) if how == "int8" else reports
        return flat(sharded_consensus(x, reputation=rep, event_bounds=bounds,
                                      params=ConsensusParams(**params),
                                      mesh=mesh))
    finally:
        torch.set_default_dtype(prev)


#: the cases resolved on ``make_hybrid_mesh(batch=2)``'s row of this rank
GRID_CASES = ("sztorc_int8_fused", "fixed_variance")


def main(argv) -> None:
    address, world, rank, shards, out = argv
    from pyconsensus_tpu_torch.parallel import distributed

    distributed.initialize(address, int(world), int(rank), device="cpu")
    mesh = distributed.make_process_mesh(["cpu"] * int(shards))
    results = {name: run_case(name, mesh) for name in CASES}
    grid = distributed.make_hybrid_mesh(batch=2, devices=["cpu"] *
                                        int(shards))
    results.update({f"grid:{name}": run_case(name, grid)
                    for name in GRID_CASES})
    results["layout"] = {
        "num_slices": np.asarray(distributed.num_slices()),
        "grid_shape": np.asarray([grid.shape["batch"],
                                  grid.shape["event"]]),
        "rows": np.asarray([[d.rank for d in row] for row in grid.rows]),
        "hybrid_is_process_mesh": np.asarray(
            distributed.make_hybrid_mesh(devices=["cpu"] * int(shards))
            == mesh)}
    path = pathlib.Path(out) / f"rank{rank}.pkl"
    with open(path, "wb") as f:
        pickle.dump(results, f)
    # leave the group together: a rank that exits with the group alive
    # can abort in the collectives' threads
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
