"""The port's clustering variants against the JAX package on the CPU.

Function by function (``pyconsensus_tpu_torch.models.clustering``
against ``pyconsensus_tpu.models.clustering``), in float64 (the x64
conftest's dtype) and float32: the numpy half bit for bit; k-means'
conformity on the same partition within a few ulps of the reference's
(the cluster masses are sums taken in another order); dbscan-jit's
labels and same-cluster matrix equal, on a matrix with squared distances
exactly on ``eps^2`` too; the pairwise distances within 1e-12 relative;
hierarchical and dbscan through the port's native library and through
scipy/sklearn equal to the reference's; the port's library on the
partition cases of ``tests/test_native.py`` against the reference's.

Then the slice: ``Oracle(device="cpu")`` and ``backend="numpy"`` for
the four algorithms against ``Oracle(backend="jax")`` and the reference's
numpy backend (the canonical matrix, the config-4 majority matrix, NaNs
with a scaled column, R = 2000 for the hybrid two): exact keys equal,
continuous keys within 1e-9 in float64 and 1e-5 in float32, the numpy
backend bit for bit; bfloat16 storage within the reference's own band
(``tests/test_oracle.py``: outcomes equal, reputation within 5e-3);
``sharded_consensus`` and ``ShardedOracle`` on one CPU device; the
refusal on a CPU mesh of 4; ``compare_algorithms`` against serial
``Oracle`` runs; the spans and counters of the hybrid path.
"""

import numpy as np
import pytest
import torch

from conftest import collusion_reports as majority_matrix
from pyconsensus_tpu import Oracle as RefOracle
from pyconsensus_tpu import _native as ref_native
from pyconsensus_tpu.models import clustering as ref_cl
from pyconsensus_tpu_torch import (ConsensusParams, Oracle, ShardedOracle,
                                   _native, compare_algorithms,
                                   disagreement_matrix, obs,
                                   sharded_consensus)
from pyconsensus_tpu_torch.models import clustering as cl
from pyconsensus_tpu_torch.models import pipeline
from pyconsensus_tpu_torch.parallel.mesh import make_mesh
from pyconsensus_tpu_torch.parallel.sharded import (resolve_auto_storage,
                                                    resolve_params)
from test_native import partitions_equal, random_dist
from test_oracle import CANONICAL
from test_torch_oracle import assert_oracles_match

CLUSTERING = ("k-means", "dbscan-jit", "hierarchical", "dbscan")
#: the config-4 knobs of tests/test_eval_configs.py
CONFIG4 = {"k-means": {"num_clusters": 2},
           "hierarchical": {"hierarchy_threshold": 1.5},
           "dbscan": {"dbscan_eps": 1.0, "dbscan_min_samples": 2},
           "dbscan-jit": {"dbscan_eps": 1.0, "dbscan_min_samples": 2}}
#: the R = 2000 knobs of tests/test_eval_configs.py (radius by geometry)
R2000 = {"hierarchical": {"hierarchy_threshold": 3.5},
         "dbscan": {"dbscan_eps": 3.0, "dbscan_min_samples": 4}}
ATOL = {torch.float64: 1e-9, torch.float32: 1e-5}


@pytest.fixture(params=[torch.float64, torch.float32],
                ids=["float64", "float32"])
def dtype(request):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(request.param)
    yield request.param
    torch.set_default_dtype(prev)


@pytest.fixture
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def np_dtype(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def lattice(seed, R, E, liars=None, continuous=0):
    """Collusion reports on the {0, 0.5, 1} lattice (half-votes sprinkled
    in), the last ``continuous`` columns uniform in [0, 1], and a
    positive reputation summing to 1."""
    rng = np.random.default_rng(seed)
    X, _ = majority_matrix(rng, R, E, liars if liars is not None
                           else max(2, R // 4))
    X[rng.random(X.shape) < 0.1] = 0.5
    if continuous:
        X[:, -continuous:] = rng.random((R, continuous))
    rep = rng.random(R) + 0.1
    return X, rep / rep.sum()


def same_partition(a, b):
    """Two conformity vectors group the reporters alike."""
    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(np.isclose(a[:, None], a[None, :], rtol=1e-6,
                                     atol=0),
                          np.isclose(b[:, None], b[None, :], rtol=1e-6,
                                     atol=0))


# -- the functions -----------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, "R+1"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_matches_reference(dtype, seed, k):
    import jax.numpy as jnp

    X, rep = lattice(seed, 30, 17, continuous=3)
    k = X.shape[0] + 1 if k == "R+1" else k
    np.testing.assert_array_equal(cl.kmeans_conformity_np(X, rep, k),
                                  ref_cl.kmeans_conformity_np(X, rep, k))
    nd = np_dtype(dtype)
    got = cl.kmeans_conformity(torch.tensor(X, dtype=dtype),
                               torch.tensor(rep, dtype=dtype), k).numpy()
    ref = np.asarray(ref_cl.kmeans_conformity_jax(jnp.asarray(X, nd),
                                                  jnp.asarray(rep, nd), k))
    assert got.dtype == ref.dtype
    assert same_partition(got, ref)
    # the same clusters' masses, summed in another order
    np.testing.assert_allclose(got, ref, rtol=4 * np.finfo(nd).eps, atol=0)


def test_kmeans_row_chunks_keep_the_labels(monkeypatch):
    """Row chunks of one row each give the one-chunk labels."""
    X, rep = lattice(3, 25, 11, continuous=2)
    Xt, rt = torch.tensor(X), torch.tensor(rep)
    whole = cl.kmeans_conformity(Xt, rt, 3)
    monkeypatch.setattr(cl, "_KMEANS_CHUNK_ELEMS", 1)
    assert torch.equal(cl.kmeans_conformity(Xt, rt, 3), whole)


def boundary_matrix():
    """A lattice matrix whose rows 0 and 1 differ by one half-step: their
    squared distance is exactly 0.25, the default ``eps^2``."""
    X = np.array([[0.0, 1.0, 0.5, 1.0],
                  [0.5, 1.0, 0.5, 1.0],
                  [0.0, 1.0, 1.0, 1.0],
                  [0.0, 0.0, 0.0, 0.0],
                  [1.0, 1.0, 1.0, 0.5],
                  [1.0, 1.0, 1.0, 1.0]])
    rep = np.array([0.3, 0.1, 0.2, 0.15, 0.1, 0.15])
    return X, rep


@pytest.mark.parametrize("case", ["boundary", "lattice", "wide"])
def test_dbscan_jit_matches_reference(dtype, case):
    import jax.numpy as jnp

    if case == "boundary":
        X, rep = boundary_matrix()
        eps, ms = 0.5, 2
    elif case == "lattice":
        X, rep = lattice(4, 40, 9)
        eps, ms = 1.0, 2
    else:
        X, rep = lattice(5, 60, 30)
        eps, ms = 1.6, 4
    d2 = ref_cl._pairwise_sq_dists_np(X)
    if case == "boundary":
        assert d2[0, 1] == 0.25
    np.testing.assert_array_equal(cl._dbscan_jit_labels_np(d2, eps, ms),
                                  ref_cl._dbscan_jit_labels_np(d2, eps, ms))
    np.testing.assert_array_equal(
        cl.dbscan_jit_conformity_np(X, rep, eps, ms),
        ref_cl.dbscan_jit_conformity_np(X, rep, eps, ms))
    nd = np_dtype(dtype)
    d2t = cl.pairwise_sq_dists(torch.tensor(X, dtype=dtype))
    same = cl.dbscan_jit_same_matrix(d2t, eps, ms, dtype).numpy()
    ref_same = np.asarray(ref_cl.dbscan_jit_same_matrix_jax(
        jnp.asarray(d2t.numpy()), eps, ms, nd))
    np.testing.assert_array_equal(same, ref_same)
    got = cl.dbscan_jit_conformity(torch.tensor(X, dtype=dtype),
                                   torch.tensor(rep, dtype=dtype), eps,
                                   ms).numpy()
    ref = np.asarray(ref_cl.dbscan_jit_conformity_jax(
        jnp.asarray(X, nd), jnp.asarray(rep, nd), eps, ms))
    np.testing.assert_allclose(got, ref, rtol=4 * np.finfo(nd).eps, atol=0)


def test_d2_threshold_is_the_reference_band(dtype):
    import jax.numpy as jnp

    nd = np_dtype(dtype)
    for top, eps in ((0.25, 0.5), (9500.0, 0.5), (3.0, 0.05), (40.0, 7.0)):
        d2 = np.array([[0.0, top], [top, 0.0]], dtype=nd)
        got = cl._d2_threshold_t(torch.tensor(d2), eps)
        ref = ref_cl._d2_threshold(jnp.asarray(d2), eps, xp=jnp)
        assert got.dtype == dtype
        assert got.item() == float(ref)
        assert cl._d2_threshold(d2, eps) == ref_cl._d2_threshold(d2, eps)


def test_pairwise_sq_dists_matches_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    X = rng.random((50, 37))
    got = cl.pairwise_sq_dists(torch.tensor(X)).numpy()
    ref = np.asarray(ref_cl.pairwise_sq_dists_jax(jnp.asarray(X)))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    assert (got >= 0).all()
    np.testing.assert_array_equal(cl._pairwise_sq_dists_np(X),
                                  ref_cl._pairwise_sq_dists_np(X))


@pytest.mark.parametrize("algo", ["hierarchical", "dbscan"])
@pytest.mark.parametrize("native", [True, False])
def test_hybrid_conformity_matches_reference(monkeypatch, algo, native):
    """The port's host clustering, through its native library and through
    scipy/sklearn (the loader patched to unavailable), against the
    reference's through its own library: equal conformity."""
    X, rep = lattice(6, 14, 6)
    if algo == "hierarchical":
        want = ref_cl.hierarchical_conformity(X, rep, 0.9)
    else:
        want = ref_cl.dbscan_conformity(X, rep, 0.8, 2)
    if not native:
        monkeypatch.setattr(_native, "avg_linkage_labels",
                            lambda *a, **k: None)
        monkeypatch.setattr(_native, "dbscan_labels", lambda *a, **k: None)
    elif _native.load() is None:
        pytest.skip("the port's native library did not build")
    obs.reset()
    if algo == "hierarchical":
        got = cl.hierarchical_conformity(X, rep, 0.9)
    else:
        got = cl.dbscan_conformity(X, rep, 0.8, 2)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    (span,) = [e for e in obs.events()
               if e["name"] == f"clustering.{algo}"]
    assert span["attrs"]["native"] is native
    assert span["attrs"]["clusters"] == len(np.unique(got))


@pytest.fixture
def both_libraries():
    if _native.load() is None or ref_native.load() is None:
        pytest.skip("a native clustering library did not build")


@pytest.mark.parametrize("seed", range(4))
def test_native_library_partitions_match_reference(both_libraries, seed):
    """The port's build of native/cluster.cpp against the reference's
    library on the partition cases of tests/test_native.py: random
    distances at three cut heights and eps radii, and heavily tied
    lattice distances."""
    rng = np.random.default_rng(seed)
    for n in (2, 3, 10, 40):
        d = random_dist(rng, n)
        for frac in (0.1, 0.4, 0.8):
            t = frac * d.max()
            assert partitions_equal(_native.avg_linkage_labels(d, t),
                                    ref_native.avg_linkage_labels(d, t))
        for eps_frac, ms in ((0.2, 2), (0.4, 3), (0.7, 5)):
            eps = eps_frac * np.median(d[d > 0])
            assert partitions_equal(_native.dbscan_labels(d, eps, ms),
                                    ref_native.dbscan_labels(d, eps, ms))
    for _ in range(10):
        n = int(rng.integers(4, 21))
        X = rng.choice([0.0, 0.5, 1.0], size=(n, int(rng.integers(3, 8))))
        d = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
        np.fill_diagonal(d, 0.0)
        t = float(rng.random()) * (d.max() + 0.1)
        assert partitions_equal(_native.avg_linkage_labels(d, t),
                                ref_native.avg_linkage_labels(d, t))
        assert partitions_equal(_native.dbscan_labels(d, t, 2),
                                ref_native.dbscan_labels(d, t, 2))
    assert _native.avg_linkage_labels(np.zeros((1, 1)), 0.5).tolist() == [0]


def test_native_library_builds_from_the_source(monkeypatch, tmp_path):
    """A first use compiles native/cluster.cpp with g++ and the Makefile's
    flags into the build directory it is given; make is never run."""
    import subprocess

    calls = []
    real = subprocess.run

    def record(argv, **kw):
        calls.append(list(argv))
        return real(argv, **kw)

    monkeypatch.setattr(_native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_lib", {})
    monkeypatch.setattr(_native.subprocess, "run", record)
    path = _native.library_path()
    assert path.parent == tmp_path and path.suffix == ".so"
    if _native.load() is None:
        pytest.skip("no C++ compiler here")
    assert path.exists() and [p.name for p in tmp_path.iterdir()] == \
        [path.name]
    (argv,) = calls
    assert "make" not in argv[0]
    assert argv[-1].endswith("native/cluster.cpp")
    assert {"-O3", "-fPIC", "-std=c++17", "-shared"} <= set(argv)
    d = random_dist(np.random.default_rng(0), 12)
    assert len(set(_native.avg_linkage_labels(d, 10 * d.max()))) == 1


# -- the slice ---------------------------------------------------------------

def nan_scaled_case():
    """Config-4 reports with NaNs and one scaled column."""
    rng = np.random.default_rng(11)
    reports, _ = majority_matrix(rng, 24, 12, 6)
    reports[rng.random(reports.shape) < 0.1] = np.nan
    reports[:, 0] = rng.uniform(10.0, 50.0, size=24)
    reports[3, 0] = np.nan
    bounds = [{"scaled": True, "min": 0.0, "max": 60.0}] + [None] * 11
    return reports, bounds


CASES = {
    "canonical": lambda: (CANONICAL, None),
    "majority": lambda: (majority_matrix(np.random.default_rng(0), R=24,
                                         E=12, liars=6)[0], None),
    "nan_scaled": nan_scaled_case,
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("algo", CLUSTERING)
def test_oracle_matches_reference(dtype, algo, case):
    reports, bounds = CASES[case]()
    kw = dict(reports=reports, event_bounds=bounds, algorithm=algo,
              max_iterations=3, **CONFIG4[algo])
    got = Oracle(device="cpu", **kw).consensus()
    assert got["agents"]["smooth_rep"].dtype == np_dtype(dtype)
    ref = RefOracle(backend="jax", **kw).consensus()
    assert_oracles_match(got, ref, bounds, atol=ATOL[dtype])
    got_np = Oracle(backend="numpy", **kw).consensus()
    ref_np = RefOracle(backend="numpy", **kw).consensus()
    for group in ("agents", "events"):
        assert set(got_np[group]) == set(ref_np[group])
        for key, a in ref_np[group].items():
            np.testing.assert_array_equal(got_np[group][key], a,
                                          err_msg=key)
    assert got_np["iterations"] == ref_np["iterations"]


@pytest.mark.parametrize("case", ["seed2120", "engineered"])
def test_dbscan_jit_eps_boundary_cases_match_reference(dtype, case):
    """The fuzz find of ``tests/test_fuzz.py`` (rng seed 2120: reporter
    pairs exactly on ``eps^2`` through a shared non-dyadic NA fill) and
    its minimal engineered matrix, through the port's torch and numpy
    backends against the reference's."""
    from test_fuzz import _random_case

    if case == "seed2120":
        reports, bounds, reputation, kwargs, _ = _random_case(
            np.random.default_rng(2120))
        assert kwargs["algorithm"] == "dbscan-jit"
    else:
        reports = np.array([[0.0, 1.0, np.nan, 1.0],
                            [0.5, 1.0, np.nan, 1.0],
                            [0.0, 1.0, 1.0, 1.0],
                            [0.0, 0.0, 0.0, 0.0],
                            [1.0, 1.0, 1.0, 0.5]])
        bounds, reputation = None, np.array([0.3, 0.1, 0.35, 0.15, 0.1])
        kwargs = {"algorithm": "dbscan-jit"}
    kw = dict(reports=reports, event_bounds=bounds, reputation=reputation,
              **kwargs)
    got = Oracle(device="cpu", **kw).consensus()
    assert_oracles_match(got, RefOracle(backend="jax", **kw).consensus(),
                         bounds, atol=ATOL[dtype])
    got_np = Oracle(backend="numpy", **kw).consensus()
    ref_np = RefOracle(backend="numpy", **kw).consensus()
    np.testing.assert_array_equal(got_np["agents"]["smooth_rep"],
                                  ref_np["agents"]["smooth_rep"])


@pytest.mark.parametrize("algo", ["hierarchical", "dbscan"])
def test_hybrid_at_r2000_matches_reference(float64, algo):
    """The hybrid two at a non-toy reporter count (2000 x 32, 400 liars,
    the radius following the geometry), float64."""
    R, E, liars = 2000, 32, 400
    reports, truth = majority_matrix(np.random.default_rng(0), R=R, E=E,
                                     liars=liars)
    kw = dict(reports=reports, algorithm=algo, **R2000[algo])
    got = Oracle(device="cpu", **kw).consensus()
    assert_oracles_match(got, RefOracle(backend="jax", **kw).consensus(),
                         atol=1e-9)
    rep = got["agents"]["smooth_rep"]
    assert rep[:R - liars].mean() > rep[R - liars:].mean()
    np.testing.assert_array_equal(got["events"]["outcomes_final"], truth)


@pytest.mark.parametrize("algo", ["k-means", "dbscan-jit"])
def test_bfloat16_storage_within_the_reference_band(float64, algo):
    reports, _ = majority_matrix(np.random.default_rng(1), R=24, E=12,
                                 liars=6)
    reports[np.random.default_rng(2).random(reports.shape) < 0.1] = np.nan
    kw = dict(reports=reports, algorithm=algo, max_iterations=2,
              storage_dtype="bfloat16", **CONFIG4[algo])
    got = Oracle(device="cpu", **kw).consensus()
    ref = RefOracle(backend="jax", **kw).consensus()
    for key in ("outcomes_final", "outcomes_adjusted"):
        np.testing.assert_array_equal(got["events"][key],
                                      ref["events"][key])
    np.testing.assert_allclose(got["agents"]["smooth_rep"],
                               ref["agents"]["smooth_rep"], atol=5e-3)
    assert got["iterations"] == ref["iterations"]


@pytest.mark.parametrize("algo", CLUSTERING)
def test_sharded_front_door_on_one_cpu_device(float64, algo):
    """``sharded_consensus`` (float32 reports, float64 reputation) and
    ``ShardedOracle`` against the reference's front door on one device;
    the hybrid two count ``path="hybrid"``."""
    from pyconsensus_tpu.parallel import ShardedOracle as RefShardedOracle
    from pyconsensus_tpu.parallel import make_mesh as ref_make_mesh
    from pyconsensus_tpu.parallel import \
        sharded_consensus as ref_sharded_consensus
    from pyconsensus_tpu.models.pipeline import \
        ConsensusParams as RefParams

    reports, _ = majority_matrix(np.random.default_rng(3), R=24, E=12,
                                 liars=6)
    reports[np.random.default_rng(4).random(reports.shape) < 0.1] = np.nan
    rep = np.random.default_rng(5).random(24) + 0.5
    knobs = dict(algorithm=algo, max_iterations=3, **CONFIG4[algo])
    mesh = ref_make_mesh(batch=1, event=1)
    before = obs.value("pyconsensus_sharded_resolutions_total",
                       path="hybrid", algorithm=algo, storage="full") or 0
    out = sharded_consensus(reports.astype(np.float32), reputation=rep,
                            params=ConsensusParams(**knobs), device="cpu")
    ref = ref_sharded_consensus(reports, reputation=rep, mesh=mesh,
                                params=RefParams(**knobs))
    assert set(out) == set(ref)
    for key, a in ref.items():
        a, b = np.asarray(a), np.asarray(out[key])
        if key in ("outcomes_adjusted", "outcomes_final", "na_row",
                   "iterations", "convergence", "quarantined_rows"):
            np.testing.assert_array_equal(b, a, err_msg=key)
        else:
            np.testing.assert_allclose(b, a, atol=1e-9, rtol=0, err_msg=key)
    after = obs.value("pyconsensus_sharded_resolutions_total",
                      path="hybrid", algorithm=algo, storage="full") or 0
    assert after - before == (algo in pipeline.HYBRID_ALGORITHMS)
    kw = dict(reports=reports, reputation=rep, **knobs)
    got = ShardedOracle(device="cpu", **kw).place().consensus()
    assert "filled" not in got
    assert_oracles_match(got, RefShardedOracle(backend="jax", mesh=mesh,
                                               **kw).consensus(), atol=1e-9)


@pytest.mark.parametrize("algo", CLUSTERING)
def test_mesh_of_four_refuses_naming_a10(algo):
    reports, _ = majority_matrix(np.random.default_rng(3), R=24, E=40,
                                 liars=6)
    mesh = make_mesh(devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A.10"):
        sharded_consensus(reports, params=ConsensusParams(algorithm=algo),
                          mesh=mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A.10"):
        ShardedOracle(reports=reports, algorithm=algo, mesh=mesh)


def test_compare_algorithms_matches_serial_oracles(float64):
    reports, bounds = nan_scaled_case()
    kw = dict(event_bounds=bounds, max_iterations=3, device="cpu",
              num_clusters=2, hierarchy_threshold=1.5, dbscan_eps=1.0)
    obs.reset()
    res = compare_algorithms(reports, backend="numpy", **kw)
    assert list(res) == sorted(pipeline.ALGORITHMS)
    names = [e["name"] for e in obs.events()]
    for span in ("sweep.compare_algorithms", "sweep.dispatch_jit",
                 "sweep.fetch_jit"):
        assert span in names
    for a, got in res.items():
        want = Oracle(reports=reports, algorithm=a, **kw).consensus()
        for group in ("agents", "events"):
            for key, v in want[group].items():
                np.testing.assert_array_equal(got[group][key], v,
                                              err_msg=f"{a} {key}")
    m = disagreement_matrix(res)
    assert m.shape == (7, 7) and (np.diag(m) == 0).all()
    assert (m == m.T).all()
    from pyconsensus_tpu.sweep import compare_algorithms as ref_compare
    from pyconsensus_tpu.sweep import disagreement_matrix as ref_matrix

    ref = ref_compare(reports, **{k: v for k, v in kw.items()
                                  if k != "device"})
    np.testing.assert_array_equal(m, ref_matrix(ref))
    with pytest.raises(ValueError, match="unknown algorithm"):
        compare_algorithms(reports, algorithms=["nope"], device="cpu")


def test_hybrid_spans_and_counters(float64):
    reports, _ = majority_matrix(np.random.default_rng(0), R=24, E=12,
                                 liars=6)
    obs.reset()
    Oracle(reports=reports, algorithm="dbscan", device="cpu",
           max_iterations=2, **CONFIG4["dbscan"]).consensus()
    tree = obs.span_tree(obs.events())
    (root,) = tree
    assert root["name"] == "oracle.consensus"
    (dispatch,) = root["children"]
    assert dispatch["name"] == "pipeline.dispatch"
    assert dispatch["attrs"]["path"] == "hybrid"
    assert [c["name"] for c in dispatch["children"]] == \
        ["hybrid.device_prep", "hybrid.cluster"]
    cluster = dispatch["children"][1]
    assert cluster["attrs"]["iterations"] == 2
    assert [c["name"] for c in cluster["children"]] == \
        ["clustering.dbscan"] * 2
    snap = obs.REGISTRY.snapshot()["pyconsensus_convergence_residual"]
    assert any('"hybrid"' in k for k in snap["series"])


def test_refusals_and_resolution():
    """int8 storage is refused on the hybrid path with the reference's
    words and off the fused path for the device two; the clustering
    variants carry nothing between iterations; the auto storage at the
    reference's bench shape is bfloat16."""
    with pytest.raises(ValueError, match="int8"):
        Oracle(reports=CANONICAL, algorithm="dbscan", storage_dtype="int8",
               device="cpu")
    with pytest.raises(ValueError, match="int8"):
        sharded_consensus(CANONICAL, device="cpu", params=ConsensusParams(
            algorithm="k-means", storage_dtype="int8"))
    with pytest.raises(ValueError, match="int8"):
        pipeline._consensus_hybrid(
            torch.tensor(CANONICAL), torch.full((6,), 1 / 6.0),
            torch.zeros(4, dtype=torch.bool), torch.zeros(4), torch.ones(4),
            ConsensusParams(algorithm="hierarchical", storage_dtype="int8"))
    for algo in CLUSTERING:
        p = ConsensusParams(algorithm=algo, any_scaled=False)
        assert pipeline._subspace_carry_shape(p, 6, 4) is None
        storage, _ = resolve_auto_storage(p, 10_000, 100_000, device="cpu")
        assert storage == "bfloat16"
        resolved = resolve_params(p._replace(storage_dtype=storage),
                                  10_000, 100_000, torch.device("cpu"))
        assert not resolved.fused_resolution
    with pytest.raises(ValueError, match="sztorc/fixed-variance/ica"):
        pipeline._check_fused_params(torch.float32, ConsensusParams(
            algorithm="k-means"))
