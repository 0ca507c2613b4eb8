"""The plain core and the clustering variants over an event mesh, against
the JAX package on the CPU.

``sharded_consensus(..., mesh=make_mesh(devices=["cpu"] * n))`` runs
every algorithm the fused mesh does not (``parallel/plain_sharded.py``):
sztorc where the fused gate closes (the Gram eigh that ``"auto"`` picks
at R <= 4096, or ``"power"`` with ``allow_fused=False``), fixed-variance
and ica on every PCA method, k-means and dbscan-jit, and hierarchical
and dbscan on the hybrid path. The filled matrix stays in shards; the
(R,)-, (R, k)- and (R, R)-sized partials fold in shard order.

The reference is ``pyconsensus_tpu.parallel.sharded_consensus`` on
``make_mesh(batch=1, event=n)`` of the 8-device CPU platform, which runs
``consensus_light_jit`` (or the hybrid path) under GSPMD, and its
``ShardedOracle``. Both get the same float32 reports (the reference casts
them to float64, the port keeps float32 storage, ``ROADMAP.md`` §C) and
a float64 reputation; scaled columns lie on [0, 4], a span that rescales
exactly in both dtypes. Exact keys must be equal and the rest within
1e-9, except where §C names the orthogonal iteration's float
sensitivity: iterated fixed-variance and ica on ``"power"`` agree to
5e-7 in float64 (``ORTH_ATOL``), and float32 runs to 2e-3. A matrix
with no absent report keeps the port's float32 storage through the
products (§C, input dtypes), so it is held to 1e-6.
"""

import numpy as np
import pytest
import torch

from conftest import collusion_reports
from pyconsensus_tpu.models.pipeline import ConsensusParams as RefParams
from pyconsensus_tpu.parallel import ShardedOracle as RefShardedOracle
from pyconsensus_tpu.parallel import make_mesh as ref_make_mesh
from pyconsensus_tpu.parallel import sharded_consensus as ref_sharded
from pyconsensus_tpu.parallel.sharded import \
    resolve_params as ref_resolve_params
from pyconsensus_tpu_torch import ConsensusParams, sharded_consensus
from pyconsensus_tpu_torch.parallel import ShardedOracle, make_mesh
from pyconsensus_tpu_torch.parallel.sharded import resolve_params

EXACT_KEYS = ("outcomes_adjusted", "outcomes_final", "na_row", "iterations",
              "convergence", "ica_converged", "quarantined_rows")
ALGORITHMS = ("sztorc", "fixed-variance", "ica", "k-means", "dbscan-jit",
              "hierarchical", "dbscan")
#: the orthogonal iteration's float64 band (``ROADMAP.md`` §C): its exit
#: may fire a sweep apart from the reference's under another summation
#: order, which moved iterated fixed-variance by 3.9e-7 on one of these
#: inputs (every other case agrees to 1e-14)
ORTH_ATOL = 5e-7


def knobs(algorithm, E):
    """Radii that follow the reports' geometry: honest pairs sit near
    d^2 = 0.2 E, honest-liar pairs near 0.8 E."""
    return {"k-means": dict(num_clusters=2),
            "dbscan-jit": dict(dbscan_eps=(0.3 * E) ** 0.5),
            "dbscan": dict(dbscan_eps=(0.3 * E) ** 0.5),
            "hierarchical": dict(hierarchy_threshold=(0.5 * E) ** 0.5),
            }.get(algorithm, {})


def mesh_inputs(seed, R, E, n_scaled=0, na_frac=0.1):
    """Collusion reports (float32) with NaN absences; ``n_scaled`` columns
    on [0, 4]. Returns ``(reports, reputation, event_bounds)``."""
    rng = np.random.default_rng(seed)
    reports, _ = collusion_reports(rng, R, E, liars=R // 5, na_frac=na_frac)
    bounds = None
    if n_scaled:
        bounds = [None] * E
        for c in rng.choice(E, n_scaled, replace=False):
            reports[:, c] = np.where(np.isnan(reports[:, c]), np.nan,
                                     rng.random(R) * 4.0)
            bounds[c] = {"scaled": True, "min": 0.0, "max": 4.0}
    rep = rng.random(R) + 0.05
    return reports.astype(np.float32), rep / rep.sum(), bounds


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def assert_close(out, ref, atol):
    assert set(out) == set(ref)
    for key, a in ref.items():
        a, b = np.asarray(a), np.asarray(out[key])
        if key in EXACT_KEYS:
            np.testing.assert_array_equal(b, a, err_msg=key)
        else:
            if key == "first_loading":
                a, b = np.abs(a), np.abs(b)
            np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=key)


def band(algorithm, pca, max_iterations):
    orth = (algorithm in ("fixed-variance", "ica") and pca == "power"
            and max_iterations > 1)
    return ORTH_ATOL if orth else 1e-9


VARIANTS = [("sztorc", "auto", {}),                      # the Gram eigh
            ("sztorc", "power", {"allow_fused": False}),
            ("fixed-variance", "auto", {}),              # E <= 1024: cov
            ("fixed-variance", "power", {}),             # orth iteration
            ("fixed-variance", "eigh-gram", {}),
            ("ica", "auto", {}),
            ("ica", "power", {}),
            ("k-means", "auto", {}),
            ("dbscan-jit", "auto", {}),
            ("hierarchical", "auto", {}),
            ("dbscan", "auto", {})]
#: (shards, events, scaled events, iterations)
SHAPES = [(2, 61, 0, 3), (4, 40, 2, 1), (8, 61, 3, 3)]
CASES = [(v, s) for v in range(len(VARIANTS)) for s in range(len(SHAPES))]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_mesh_matches_reference(case):
    """Every algorithm and PCA method on meshes of 2, 4 and 8 shards, at
    widths that divide no shard count and with scaled events, float64."""
    v, s = CASES[case]
    algorithm, pca, extra = VARIANTS[v]
    n, E, n_scaled, mi = SHAPES[s]
    reports, rep, bounds = mesh_inputs(n * 10 + E + v, 24, E, n_scaled)
    kw = dict(algorithm=algorithm, pca_method=pca, max_iterations=mi,
              power_tol=-1.0, power_iters=64, **knobs(algorithm, E), **extra)
    out = sharded_consensus(reports, reputation=rep, event_bounds=bounds,
                            params=ConsensusParams(**kw), mesh=cpu_mesh(n))
    ref = ref_sharded(reports, reputation=rep, event_bounds=bounds,
                      mesh=ref_make_mesh(batch=1, event=n),
                      params=RefParams(**kw))
    assert out["smooth_rep"].dtype == torch.float64
    assert out["outcomes_final"].shape == (E,)
    assert_close(out, ref, band(algorithm, pca, mi))


@pytest.mark.parametrize("max_iterations", [1, 3])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("algorithm", ["fixed-variance", "ica"])
def test_mesh_float32_multi_component(algorithm, n, max_iterations):
    """A float32 reputation: the port's mesh computes in float32. The
    reference's mesh in float32 is its light XLA core under GSPMD on
    float32 inputs placed event-sharded (E = 64 divides every mesh); its
    fixed-variance takes no float32 reputation under x64 and runs in
    float64. Within 2e-3."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from pyconsensus_tpu.models.pipeline import consensus_light_jit
    from pyconsensus_tpu.oracle import parse_event_bounds
    from pyconsensus_tpu.parallel.mesh import event_sharding, replicated

    E = 64
    reports, rep, bounds = mesh_inputs(n + 7, 24, E, 2)
    rep32 = rep.astype(np.float32)
    out = sharded_consensus(
        reports, reputation=rep32, event_bounds=bounds,
        params=ConsensusParams(algorithm=algorithm,
                               max_iterations=max_iterations),
        mesh=cpu_mesh(n))
    assert out["smooth_rep"].dtype == torch.float32
    mesh = ref_make_mesh(batch=1, event=n)
    cols = NamedSharding(mesh, PartitionSpec("event"))
    scaled, mins, maxs = parse_event_bounds(bounds, E)
    ref_rep = rep if algorithm == "fixed-variance" else rep32
    ref = consensus_light_jit(
        jax.device_put(jnp.asarray(reports), event_sharding(mesh)),
        jax.device_put(jnp.asarray(ref_rep), replicated(mesh)),
        jax.device_put(jnp.asarray(scaled), cols),
        jax.device_put(jnp.asarray(mins.astype(np.float32)), cols),
        jax.device_put(jnp.asarray(maxs.astype(np.float32)), cols),
        RefParams(algorithm=algorithm, max_iterations=max_iterations,
                  any_scaled=True, has_na=True))
    out.pop("quarantined_rows")
    assert_close(out, ref, 2e-3)


@pytest.mark.parametrize("algorithm", ["sztorc", "fixed-variance", "k-means",
                                       "dbscan-jit", "hierarchical",
                                       "dbscan"])
def test_mesh_bfloat16_storage(algorithm):
    """bfloat16 storage of the filled matrix on the plain mesh core and
    the hybrid path (every product reads it in the reputation's dtype),
    against the reference's bfloat16 XLA path on its mesh."""
    E = 61
    reports, rep, bounds = mesh_inputs(3, 24, E, 2)
    kw = dict(algorithm=algorithm, max_iterations=3,
              storage_dtype="bfloat16", **knobs(algorithm, E))
    out = sharded_consensus(reports, reputation=rep, event_bounds=bounds,
                            params=ConsensusParams(**kw), mesh=cpu_mesh(4))
    ref = ref_sharded(reports, reputation=rep, event_bounds=bounds,
                      mesh=ref_make_mesh(batch=1, event=4),
                      params=RefParams(**kw))
    assert_close(out, ref, 1e-9)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_mesh_matches_one_device(algorithm):
    """The mesh of four against the port's own single-device run on the
    same inputs, through ``ShardedOracle`` placed once."""
    E = 61
    reports, rep, bounds = mesh_inputs(11, 24, E, 3)
    kw = dict(reports=reports.astype(np.float64), reputation=rep,
              event_bounds=bounds, algorithm=algorithm, max_iterations=3,
              **knobs(algorithm, E))
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        one = ShardedOracle(device="cpu", **kw).consensus()
        mesh = ShardedOracle(mesh=cpu_mesh(4), **kw).place().consensus()
    finally:
        torch.set_default_dtype(prev)
    assert mesh["iterations"] == one["iterations"]
    atol = band(algorithm, "power" if E > 1024 else "auto", 3)
    for group in ("agents", "events"):
        assert set(mesh[group]) == set(one[group])
        for key, a in one[group].items():
            b = mesh[group][key]
            if key in EXACT_KEYS:
                np.testing.assert_array_equal(b, a, err_msg=key)
            elif key == "adj_first_loadings":
                assert_loading_close(b, a, atol)
            else:
                np.testing.assert_allclose(b, a, atol=atol, rtol=0,
                                           err_msg=key)


def loading_tied(a, atol) -> bool:
    """Whether the loading's two largest magnitudes lie within ``2 atol``
    of each other. Two results held to ``atol`` of each other may then
    rank them either way, and ``canon_sign`` makes the larger positive,
    so the sign is the eigensolver's last bit (``ROADMAP.md`` §C)."""
    m = np.sort(np.abs(np.asarray(a)))[::-1]
    return m.size > 1 and m[0] - m[1] <= 2 * atol


def assert_loading_close(b, a, atol):
    """``b`` against the loading ``a``: up to sign where either's two
    largest magnitudes are tied (:func:`loading_tied`), with its sign
    everywhere else."""
    a, b = np.asarray(a), np.asarray(b)
    if loading_tied(a, atol) or loading_tied(b, atol):
        b = b * (1.0 if float(np.dot(a, b)) >= 0.0 else -1.0)
    np.testing.assert_allclose(b, a, atol=atol, rtol=0,
                               err_msg="adj_first_loadings")


@pytest.mark.parametrize("seed, tied", [(11, True), (13, False)])
def test_loading_sign_rule(seed, tied):
    """The sign rule both ways on sztorc's mesh of four against one
    device. Seed 11 holds a mirror pair, events 34 and 52 at
    +-0.15555258617289577 (2.8e-17 apart on one device, equal on the
    mesh): the sign is compared up to the tie and a flip is accepted.
    Seed 13 has no tie (its two largest are 8.3e-4 apart): the sign must
    match, and a flipped loading fails."""
    reports, rep, bounds = mesh_inputs(seed, 24, 61, 3)
    kw = dict(reports=reports.astype(np.float64), reputation=rep,
              event_bounds=bounds, algorithm="sztorc", max_iterations=3)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        one = ShardedOracle(device="cpu", **kw).consensus()
        mesh = ShardedOracle(mesh=cpu_mesh(4), **kw).place().consensus()
    finally:
        torch.set_default_dtype(prev)
    a = np.asarray(one["events"]["adj_first_loadings"])
    b = np.asarray(mesh["events"]["adj_first_loadings"])
    assert loading_tied(a, 1e-9) == tied
    assert_loading_close(b, a, 1e-9)
    if tied:
        assert_loading_close(-b, a, 1e-9)
    else:
        np.testing.assert_array_equal(np.sign(b), np.sign(a))
        with pytest.raises(AssertionError):
            assert_loading_close(-b, a, 1e-9)


@pytest.mark.parametrize("algorithm", ["sztorc", "fixed-variance", "ica"])
def test_sharded_oracle_on_a_mesh_matches_reference(algorithm):
    """``ShardedOracle(mesh=)`` placed once against the reference's
    ``ShardedOracle`` on its mesh of four, with scaled events (the
    clustering variants: ``tests/test_torch_clustering.py``)."""
    from test_torch_oracle import assert_oracles_match

    reports, rep, bounds = mesh_inputs(13, 24, 40, 2)
    kw = dict(reports=reports.astype(np.float64), reputation=rep,
              event_bounds=bounds, algorithm=algorithm, max_iterations=3)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        got = ShardedOracle(mesh=cpu_mesh(4), **kw).place().consensus()
    finally:
        torch.set_default_dtype(prev)
    ref = RefShardedOracle(backend="jax",
                           mesh=ref_make_mesh(batch=1, event=4),
                           **kw).consensus()
    assert_oracles_match(got, ref, bounds, atol=1e-9)


@pytest.mark.parametrize("algorithm", ["sztorc", "ica", "dbscan-jit"])
def test_dense_matrix_on_the_mesh(algorithm):
    """No absent report: the closed form of an all-present matrix. The
    filled matrix is the float32 reports themselves here (no fill
    promotes them to the reputation's float64), so the products run in
    float32 as the port's one device runs them (§C): 1e-6 against the
    reference and against one device."""
    E = 40
    reports, rep, _ = mesh_inputs(17, 24, E, na_frac=0.0)
    kw = dict(algorithm=algorithm, max_iterations=2, **knobs(algorithm, E))
    out = sharded_consensus(reports, reputation=rep,
                            params=ConsensusParams(**kw), mesh=cpu_mesh(4))
    assert not bool(out["na_row"].any())
    ref = ref_sharded(reports, reputation=rep,
                      mesh=ref_make_mesh(batch=1, event=4),
                      params=RefParams(**kw))
    one = sharded_consensus(reports, reputation=rep,
                            params=ConsensusParams(**kw), device="cpu")
    assert_close(out, ref, 1e-6)
    assert_close(out, one, 1e-6)


@pytest.mark.parametrize("algorithm", ["fixed-variance", "k-means",
                                       "hierarchical"])
def test_int8_off_the_fused_mesh_raises_value_error(algorithm):
    """int8 storage where the mesh's fused gate closes raises the
    reference's ``ValueError``: the plain core stores continuous fills."""
    from pyconsensus_tpu_torch import encode_reports_host

    reports, rep, _ = mesh_inputs(1, 24, 40)
    p = ConsensusParams(algorithm=algorithm, pca_method="power",
                        storage_dtype="int8")
    with pytest.raises(ValueError, match="int8"):
        sharded_consensus(encode_reports_host(reports), reputation=rep,
                          params=p, mesh=cpu_mesh(4))
    with pytest.raises(ValueError, match="int8"):
        ref_sharded(encode_reports_host(reports), reputation=rep,
                    mesh=ref_make_mesh(batch=1, event=4),
                    params=RefParams(**p._asdict()))


@pytest.mark.parametrize("algorithm,pca,R,E", [
    ("sztorc", "auto", 24, 40), ("sztorc", "eigh-cov", 5000, 40),
    ("sztorc", "power-fused", 24, 40),
    ("fixed-variance", "auto", 24, 40), ("fixed-variance", "auto", 24, 2000),
    ("fixed-variance", "auto", 5000, 2000), ("ica", "power-fused", 24, 40),
    ("ica", "eigh-cov", 5000, 5000), ("k-means", "auto", 24, 40)])
def test_resolve_params_on_a_mesh_matches_reference(algorithm, pca, R, E):
    """Where the mesh's fused gate is closed on both sides (every
    algorithm but sztorc, sztorc off the power family, and sztorc's
    "power-fused" with ``allow_fused=False``), the port resolves the
    reference's PCA method, median blocking and scaled count."""
    p = dict(algorithm=algorithm, pca_method=pca, any_scaled=True,
             n_scaled=3, allow_fused=algorithm != "sztorc")
    mine = resolve_params(ConsensusParams(**p), R, E, torch.device("cpu"),
                          n_event=4)
    ref = ref_resolve_params(RefParams(**p), R, E,
                             ref_make_mesh(batch=1, event=4))
    assert not mine.fused_resolution and not ref.fused_resolution
    for field in ("pca_method", "median_block", "n_scaled"):
        assert getattr(mine, field) == getattr(ref, field), field
