"""The port's serve tier (``pyconsensus_tpu_torch.serve``) against the JAX
package's, on the CPU.

- the padded bucket path: the port's ``padded_consensus`` against the
  reference's on the same padded numpy inputs, over every default bucket
  up to 64 x 256, binary with NaN and scaled; outcomes and iterations
  equal, continuous keys within 1e-9 in float64 (the first loading within
  1e-8, where the two power loops may exit a sweep apart), and within
  the float32 band in float32;
- ``ConsensusService(device="cpu")`` against the port's and the
  reference's direct ``Oracle`` over the reference's serve corpus
  (padding equivalence, the numpy backend, the direct path, quarantine);
- determinism across batch compositions and pipeline depths 1, 2 and 3;
- admission, the queue, deadlines, drain, the PYC401 taxonomy, the LRU
  with its counters and the build invariant;
- the ``bucket_cuda`` class on the CPU (the kernels' plain versions):
  bit for bit the port's direct fused ``ShardedOracle``, and within the
  float32 kernel band of the reference's ``_consensus_core_light`` with
  fused params (Pallas in interpret mode);
- the four serve fault sites, and that the serve package loads no JAX.
"""

import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import collusion_reports
from pyconsensus_tpu import Oracle as RefOracle
from pyconsensus_tpu.models.pipeline import ConsensusParams as RefParams
from pyconsensus_tpu.models.pipeline import \
    _consensus_core_light as ref_core_light
from pyconsensus_tpu.serve import kernels as ref_kernels
from pyconsensus_tpu_torch import ConsensusParams, Oracle, ShardedOracle, obs
from pyconsensus_tpu_torch.faults import (ERROR_CODES, ConsensusError,
                                          InputError, ServiceOverloadError)
from pyconsensus_tpu_torch.serve import (CUDA_KERNEL_PATH, PLAIN_KERNEL_PATH,
                                         BucketKey, BucketTemplates,
                                         ConsensusService, ExecutableCache,
                                         RequestQueue, ResolveRequest,
                                         ServeConfig, bucket_inputs,
                                         bucket_path_eligible,
                                         cuda_bucket_eligible,
                                         cuda_bucket_params,
                                         padded_consensus, slice_result)
from pyconsensus_tpu_torch.serve.kernels import place_bucket_operands

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the continuous band against direct resolution in float64 (the
#: reference's SERVE_ATOL): the padded path against the port's direct
#: ``Oracle``, and the service against both packages' Oracles
SERVE_ATOL = 1e-9
#: the band between the port's padded path and the reference's on one
#: padded input, the reference's SERVE_ATOL too
REF_ATOL = 1e-9
#: scaled outcomes unscale by ``x * (max - min) + min``, which XLA may
#: contract into one fused multiply-add: an ulp of the unscaled value,
#: here up to 15 on a span of 20 (float64 eps, then float32's)
UNSCALE_ATOL = 20 * 2.0 ** -52
UNSCALE_ATOL_F32 = 20 * 2.0 ** -23
#: the same band in float32 (padded float32 reductions in another order)
F32_ATOL = 2e-5
#: the bucket_cuda class against the reference's interpreted kernels
#: (both accumulate in float32 inside the kernels)
FUSED_ATOL = 1e-4

_EXACT_KEYS = (("events", "outcomes_final"),
               ("events", "outcomes_adjusted"))
_BAND_KEYS = (("agents", "smooth_rep"), ("agents", "this_rep"),
              ("agents", "reporter_bonus"), ("agents", "relative_part"),
              ("agents", "participation_rows"),
              ("events", "outcomes_raw"), ("events", "certainty"),
              ("events", "consensus_reward"), ("events", "author_bonus"),
              ("events", "participation_columns"))
_FLAT_EXACT = ("outcomes_adjusted", "outcomes_final", "iterations",
               "convergence", "na_row")
_FLAT_BAND = ("old_rep", "this_rep", "smooth_rep", "outcomes_raw",
              "certainty", "consensus_reward", "participation_columns",
              "participation_rows", "na_bonus_rows", "reporter_bonus",
              "na_bonus_cols", "author_bonus", "avg_certainty",
              "percent_na")


@pytest.fixture(autouse=True)
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _get(result, path):
    section, key = path
    return np.asarray(result[section][key])


def cpu_service(cfg=None):
    return ConsensusService(cfg or ServeConfig(), device="cpu")


def serve_one(reports, bounds=None, cfg=None, backend=None, **kw):
    with cpu_service(cfg) as svc:
        return svc.submit(reports=reports, event_bounds=bounds,
                          backend=backend, **kw).result(timeout=120)


def assert_serve_parity(got, ref, atol=SERVE_ATOL):
    for path in _EXACT_KEYS:
        np.testing.assert_array_equal(_get(got, path), _get(ref, path),
                                      err_msg=str(path))
    assert got["iterations"] == ref["iterations"]
    assert got["convergence"] == ref["convergence"]
    for path in _BAND_KEYS:
        np.testing.assert_allclose(_get(got, path), _get(ref, path),
                                   atol=atol, rtol=0, err_msg=str(path))
    assert got["certainty"] == pytest.approx(ref["certainty"], abs=atol)
    assert got["participation"] == pytest.approx(ref["participation"],
                                                 abs=atol)


def assert_bitwise(a, b):
    for path in _EXACT_KEYS + _BAND_KEYS:
        np.testing.assert_array_equal(_get(a, path), _get(b, path),
                                      err_msg=str(path))
    assert a["certainty"] == b["certainty"]
    assert a["iterations"] == b["iterations"]


def scaled_fixture(rng, R, E, n_scaled):
    reports, _ = collusion_reports(rng, R, E, liars=max(2, R // 4),
                                   na_frac=0.12)
    cols = rng.choice(E, n_scaled, replace=False)
    bounds = [None] * E
    for c in cols:
        bounds[c] = {"scaled": True, "min": -5.0, "max": 15.0}
        with np.errstate(invalid="ignore"):
            reports[:, c] = reports[:, c] * 20.0 - 5.0
    return reports, bounds


# -- the padded bucket path against the reference's ------------------------

#: every default bucket up to 64 x 256
DEFAULT_BUCKETS = [(r, e) for r in (8, 16, 32, 64)
                   for e in (16, 32, 64, 128, 256)]


def _request(kind, rb, eb, seed):
    """A request that pads into (rb, eb): binary with NaN, or a sixth of
    its events scaled. ``"scaled"`` events carry continuous values (the
    truth on [-5, 15] plus noise); ``"scaled_lattice"`` is the
    reference's fixture, whose values map to exactly 0 and 1, so a
    column's fill is an exact ratio k / n that can sit one ulp either
    side of the agreement tolerance (0.9 against an outcome of 1.0)."""
    rng = np.random.default_rng(seed)
    R, E = max(5, rb - 3), max(8, eb - 5)
    if kind == "binary":
        reports, _ = collusion_reports(rng, R, E, liars=max(2, R // 4),
                                       na_frac=0.15)
        bounds = None
    else:
        reports, bounds = scaled_fixture(rng, R, E, max(1, E // 6))
        if kind == "scaled":
            cols = [j for j, b in enumerate(bounds) if b is not None]
            reports[:, cols] += rng.uniform(-0.5, 0.5, (R, len(cols)))
    return reports, bounds


def _params(reports, bounds, bucket_rows, cls, **kw):
    from pyconsensus_tpu_torch.oracle import parse_event_bounds
    from pyconsensus_tpu_torch.ops.torch_kernels import gather_median_pays

    R, E = reports.shape
    scaled, mins, maxs = parse_event_bounds(bounds, E)
    n_sc = int(scaled.sum())
    p = cls(algorithm="sztorc", pca_method="power",
            has_na=bool(np.isnan(reports).any()) or bucket_rows > R,
            any_scaled=bool(scaled.any()),
            n_scaled=n_sc if gather_median_pays(n_sc, E) else 0, **kw)
    return p, scaled, mins, maxs


def _ref_padded(reports, rep, scaled, mins, maxs, rb, eb, p, f32=False):
    inputs = list(ref_kernels.bucket_inputs(reports, rep, scaled, mins, maxs,
                                            rb, eb, has_na=p.has_na))
    if f32:
        E = reports.shape[1]
        seed = np.zeros(eb, np.float32)
        seed[:E] = ref_kernels._seed_host(E, "float32")
        inputs = [a.astype(np.float32) if a.dtype == np.float64 else a
                  for a in inputs[:-1]] + [seed]
    out = ref_kernels.make_bucket_executable(p)(
        *[jnp.asarray(a) for a in inputs], p)
    return slice_result({k: np.asarray(v) for k, v in out.items()},
                        *reports.shape)


#: the first loading is the power iterate where the loop exits (at the
#: 8 eps alignment floor): on some inputs the two packages' loops exit a
#: sweep apart (test_padded_power_exits_a_sweep_apart), which leaves the
#: loading up to ~2.5e-9 apart where it is a reduction order apart at
#: equal sweeps; a warm loop that exits a sweep apart moves this_rep too
#: (1.3e-9 on the reference's scaled fixture at 8 x 256, iteration 2)
LOADING_ATOL = 1e-8


def _assert_flat(got, ref, atol, loading_atol=LOADING_ATOL, scaled=None,
                 unscale_atol=UNSCALE_ATOL):
    """Key by key; ``scaled`` (a mask) holds the unscaled outcomes of
    those columns to ``unscale_atol``."""
    for k in _FLAT_EXACT:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        if k == "outcomes_final" and scaled is not None:
            np.testing.assert_allclose(a[scaled], b[scaled], rtol=0,
                                       atol=unscale_atol, err_msg=k)
            a, b = a[~scaled], b[~scaled]
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in _FLAT_BAND:
        np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64),
                                   np.asarray(ref[k], dtype=np.float64),
                                   atol=atol, rtol=0, err_msg=k)
    np.testing.assert_allclose(np.abs(got["first_loading"]),
                               np.abs(ref["first_loading"]),
                               atol=max(atol, loading_atol), rtol=0)


def _port_direct(reports, bounds, **kw):
    """The port's direct ``Oracle(pca_method="power")`` as a flat dict."""
    o = Oracle(reports=reports, event_bounds=bounds, device="cpu",
               pca_method="power", **kw)
    return o._fetch_raw()


@pytest.mark.parametrize("kind", ["binary", "scaled"])
@pytest.mark.parametrize("bucket", DEFAULT_BUCKETS)
def test_padded_consensus_matches_reference(kind, bucket):
    rb, eb = bucket
    reports, bounds = _request(kind, rb, eb, seed=rb * 1000 + eb)
    R, E = reports.shape
    rep = np.full(R, 1.0 / R)
    p, scaled, mins, maxs = _params(reports, bounds, rb, ConsensusParams,
                                    max_iterations=2)
    rp = _params(reports, bounds, rb, RefParams, max_iterations=2)[0]
    got = slice_result(padded_consensus(
        *bucket_inputs(reports, rep, scaled, mins, maxs, rb, eb,
                       has_na=p.has_na), p), R, E)
    ref = _ref_padded(reports, rep, scaled, mins, maxs, rb, eb, rp)
    _assert_flat(got, ref, REF_ATOL, scaled=scaled)
    _assert_flat(got, _port_direct(reports, bounds, max_iterations=2),
                 SERVE_ATOL, loading_atol=SERVE_ATOL)


@pytest.mark.parametrize("bucket", [(8, 256), (16, 128), (32, 64)])
def test_padded_lattice_scaled_matches_the_direct_oracles(bucket):
    """The reference's scaled fixture: the padded path equals the port's
    direct ``Oracle`` within the band on every key, and the reference's
    padded path on outcomes, iterations and reputations. Its certainty
    may differ from the reference's by a whole report's weight where a
    fill k / n lands one ulp either side of the tolerance
    (``ROADMAP.md`` §C): the port's fill and the reference's sum the
    reputation in another order."""
    rb, eb = bucket
    reports, bounds = _request("scaled_lattice", rb, eb, seed=rb * 1000 + eb)
    R, E = reports.shape
    rep = np.full(R, 1.0 / R)
    p, scaled, mins, maxs = _params(reports, bounds, rb, ConsensusParams,
                                    max_iterations=2)
    rp = _params(reports, bounds, rb, RefParams, max_iterations=2)[0]
    got = slice_result(padded_consensus(
        *bucket_inputs(reports, rep, scaled, mins, maxs, rb, eb,
                       has_na=p.has_na), p), R, E)
    _assert_flat(got, _port_direct(reports, bounds, max_iterations=2),
                 SERVE_ATOL, loading_atol=SERVE_ATOL)
    ref = _ref_padded(reports, rep, scaled, mins, maxs, rb, eb, rp)
    for k in _FLAT_EXACT:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # its second, warm power loop exits a sweep apart at 8 x 256
    for k in ("this_rep", "smooth_rep", "outcomes_raw"):
        np.testing.assert_allclose(got[k], ref[k], atol=LOADING_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("kind", ["binary", "scaled"])
@pytest.mark.parametrize("bucket", [(8, 16), (16, 64), (64, 256)])
def test_padded_consensus_matches_reference_float32(kind, bucket):
    rb, eb = bucket
    reports, bounds = _request(kind, rb, eb, seed=7 * rb + eb)
    R, E = reports.shape
    rep = np.full(R, 1.0 / R)
    p, scaled, mins, maxs = _params(reports, bounds, rb, ConsensusParams)
    rp = _params(reports, bounds, rb, RefParams)[0]
    got = slice_result(padded_consensus(
        *bucket_inputs(reports, rep, scaled, mins, maxs, rb, eb,
                       has_na=p.has_na, dtype=torch.float32), p), R, E)
    assert got["smooth_rep"].dtype == np.float32
    ref = _ref_padded(reports, rep, scaled, mins, maxs, rb, eb, rp,
                      f32=True)
    _assert_flat(got, ref, F32_ATOL, scaled=scaled,
                 unscale_atol=UNSCALE_ATOL_F32)


def _power_both(filled, rep, seed, p, tol=None, n_iters=None):
    """The cold first power loop of the padded path in both packages on
    the same filled matrix: ``(ref_loading, ref_sweeps, port_loading,
    port_sweeps)``. The reference's is its ``_masked_power_scores``
    covariance application under ``jax_kernels._power_loop``."""
    from pyconsensus_tpu.ops import jax_kernels as jk
    from pyconsensus_tpu_torch.serve import kernels as sk

    tol = p.power_tol if tol is None else tol
    n_iters = n_iters or p.power_iters
    f, r = jnp.asarray(filled.numpy()), jnp.asarray(rep.numpy())
    mu, denom = jk._mu_denom(f, r)

    def apply_cov(v):
        t = jnp.matmul(f, v, preferred_element_type=f.dtype) - mu @ v
        rt = r * t
        return (jnp.matmul(f.T, rt, preferred_element_type=f.dtype)
                - mu * jnp.sum(rt)) / denom

    zero = jnp.zeros(f.shape[1], f.dtype)
    ref, ref_sweeps = jk._power_loop(apply_cov, f.shape[1], f.dtype,
                                     n_iters, tol, v_init=zero,
                                     base=jnp.asarray(seed.numpy()))
    F, Rp = filled[None], rep[None]
    mu_t = sk.fsum(Rp[:, :, None] * F, 1)
    denom_t = sk.guard(1.0 - sk.fsum(Rp * Rp, 1))
    port, sweeps = sk._lane_power(sk._cov_operands(F, mu_t, Rp, denom_t),
                                  seed[None], torch.zeros_like(seed)[None],
                                  n_iters, tol)
    return np.asarray(ref), int(ref_sweeps), port[0].numpy(), sweeps[0]


@pytest.mark.parametrize("kind,bucket", [("binary", (8, 128)),
                                         ("binary", (64, 256)),
                                         ("scaled", (16, 256)),
                                         ("scaled", (32, 128))])
def test_padded_power_exits_a_sweep_apart(kind, bucket):
    """Where the first loading leaves the 1e-9 band: on these corpus
    inputs the two packages' cold power loops, on the same filled matrix,
    exit one sweep apart at the 8 eps alignment floor, and their
    loadings move by more than 1e-10. Run for the same number of sweeps
    (no exit test) they agree to a reduction order."""
    from pyconsensus_tpu_torch.ops import torch_kernels as tk

    rb, eb = bucket
    reports, bounds = _request(kind, rb, eb, seed=rb * 1000 + eb)
    R, E = reports.shape
    p, scaled, mins, maxs = _params(reports, bounds, rb, ConsensusParams,
                                    max_iterations=2)
    rpt, rep, sc, mn, mx, _, _, seed = bucket_inputs(
        reports, np.full(R, 1.0 / R), scaled, mins, maxs, rb, eb,
        has_na=p.has_na)
    rep = tk.normalize(rep)
    rescaled = tk.rescale(rpt, sc, mn, mx) if p.any_scaled else rpt
    filled = tk.interpolate_masked(rescaled, rep, sc, p.catch_tolerance)[0]
    ref, ref_sweeps, port, port_sweeps = _power_both(filled, rep, seed, p)
    assert abs(ref_sweeps - port_sweeps) == 1
    gap = np.max(np.abs(np.abs(ref) - np.abs(port)))
    assert 1e-10 < gap < LOADING_ATOL
    n = min(ref_sweeps, port_sweeps)
    ref, _, port, _ = _power_both(filled, rep, seed, p, tol=-1.0,
                                  n_iters=n)
    np.testing.assert_allclose(port, ref, atol=1e-14, rtol=0)


def test_padded_exact_fit_equals_unpadded_oracle_bits():
    """A request that fills its bucket exactly pads nothing: its outcomes
    and its continuous keys land within one reduction order of the
    direct ``Oracle(pca_method="power")``."""
    rng = np.random.default_rng(3)
    reports, _ = collusion_reports(rng, 16, 64, liars=4, na_frac=0.1)
    got = serve_one(reports, cfg=ServeConfig(row_buckets=(16,),
                                             event_buckets=(64,)))
    ref = Oracle(reports=reports, device="cpu",
                 pca_method="power").consensus()
    assert_serve_parity(got, ref)


# -- the service against the direct Oracles (the reference's corpus) -------


class TestPaddingEquivalence:
    #: ladders forcing four different buckets around a 13 x 52 request
    BUCKETS = [(13, 52), (16, 64), (32, 128), (64, 256)]

    def _cfg(self, rb, eb):
        return ServeConfig(row_buckets=(rb,), event_buckets=(eb,),
                           batch_window_ms=0.0)

    @pytest.mark.parametrize("bucket", BUCKETS)
    def test_binary_na_every_bucket(self, rng, bucket):
        reports, _ = collusion_reports(rng, 13, 52, liars=4, na_frac=0.15)
        ref = RefOracle(reports=reports, backend="jax",
                        pca_method="power").consensus()
        port = Oracle(reports=reports, device="cpu",
                      pca_method="power").consensus()
        got = serve_one(reports, cfg=self._cfg(*bucket))
        assert_serve_parity(got, ref)
        assert_serve_parity(got, port)

    @pytest.mark.parametrize("bucket", BUCKETS)
    def test_scaled_every_bucket(self, rng, bucket):
        reports, bounds = scaled_fixture(rng, 13, 52, n_scaled=6)
        ref = RefOracle(reports=reports, event_bounds=bounds, backend="jax",
                        pca_method="power").consensus()
        port = Oracle(reports=reports, event_bounds=bounds, device="cpu",
                      pca_method="power").consensus()
        got = serve_one(reports, bounds, cfg=self._cfg(*bucket))
        assert_serve_parity(got, ref)
        assert_serve_parity(got, port)

    @pytest.mark.parametrize("trial", range(4))
    def test_property_random_shapes(self, trial):
        rng = np.random.default_rng(4200 + trial)
        R = int(rng.integers(5, 40))
        E = int(rng.integers(8, 130))
        na = float(rng.uniform(0.0, 0.3))
        it = int(rng.integers(1, 5))
        reports, _ = collusion_reports(rng, R, E, liars=max(2, R // 4),
                                       na_frac=na)
        ref = RefOracle(reports=reports, backend="jax", pca_method="power",
                        max_iterations=it).consensus()
        port = Oracle(reports=reports, device="cpu", pca_method="power",
                      max_iterations=it).consensus()
        got = serve_one(reports, max_iterations=it)
        assert_serve_parity(got, ref)
        assert_serve_parity(got, port)

    def test_float32_service_against_the_direct_oracle(self, rng):
        torch.set_default_dtype(torch.float32)
        reports, _ = collusion_reports(rng, 20, 70, liars=5, na_frac=0.1)
        got = serve_one(reports, max_iterations=3)
        port = Oracle(reports=reports, device="cpu", pca_method="power",
                      max_iterations=3).consensus()
        ref = RefOracle(reports=reports, backend="jax", pca_method="power",
                        max_iterations=3).consensus()
        assert got["agents"]["smooth_rep"].dtype == np.float32
        assert_serve_parity(got, port, atol=F32_ATOL)
        assert_serve_parity(got, ref, atol=F32_ATOL)

    def test_numpy_backend_bit_identical(self, rng):
        """The numpy path dispatches the Oracle graph itself."""
        reports, _ = collusion_reports(rng, 11, 30, liars=3, na_frac=0.2)
        ref = RefOracle(reports=reports, backend="numpy").consensus()
        port = Oracle(reports=reports, backend="numpy").consensus()
        got = serve_one(reports, backend="numpy")
        assert_bitwise(got, port)
        assert_bitwise(got, ref)

    def test_direct_path_bit_identical(self, rng):
        """A bucket-ineligible algorithm rides the direct path: the port's
        Oracle itself."""
        reports, _ = collusion_reports(rng, 10, 24, liars=3, na_frac=0.1)
        port = Oracle(reports=reports, device="cpu",
                      algorithm="k-means").consensus()
        ref = RefOracle(reports=reports, backend="jax",
                        algorithm="k-means").consensus()
        got = serve_one(reports, algorithm="k-means")
        assert_bitwise(got, port)
        np.testing.assert_array_equal(
            _get(got, ("events", "outcomes_final")),
            _get(ref, ("events", "outcomes_final")))

    def test_quarantine_matches_oracle(self, rng):
        reports, _ = collusion_reports(rng, 12, 32, liars=3, na_frac=0.1)
        reports[4, 7] = np.inf
        ref = RefOracle(reports=reports, backend="jax",
                        pca_method="power").consensus()
        port = Oracle(reports=reports, device="cpu",
                      pca_method="power").consensus()
        got = serve_one(reports)
        np.testing.assert_array_equal(got["quarantined_rows"],
                                      ref["quarantined_rows"])
        np.testing.assert_array_equal(got["quarantined_rows"],
                                      port["quarantined_rows"])
        assert_serve_parity(got, ref)

    def test_oversize_request_takes_direct_path(self, rng):
        cfg = ServeConfig(row_buckets=(8,), event_buckets=(16,),
                          batch_window_ms=0.0)
        reports, _ = collusion_reports(rng, 12, 40, liars=3, na_frac=0.1)
        port = Oracle(reports=reports, device="cpu").consensus()
        before = obs.value("pyconsensus_serve_requests_total",
                           path="direct", outcome="ok") or 0
        got = serve_one(reports, cfg=cfg)
        assert_bitwise(got, port)
        assert obs.value("pyconsensus_serve_requests_total", path="direct",
                         outcome="ok") == before + 1


# -- determinism -----------------------------------------------------------


class TestDeterminism:
    def test_same_bits_across_batch_compositions(self, rng):
        reports, _ = collusion_reports(rng, 12, 48, liars=4, na_frac=0.1)
        others = [collusion_reports(np.random.default_rng(50 + i), 12, 48,
                                    liars=4, na_frac=0.1)[0]
                  for i in range(5)]
        cfg = ServeConfig(batch_window_ms=20.0, max_batch=8)
        outs = [serve_one(reports, cfg=cfg)]
        with cpu_service(cfg) as svc:
            futs = [svc.submit(reports=m) for m in [reports] + others]
            outs.append(futs[0].result(timeout=120))
        # alone in a capacity-1 service too: lanes run the unbatched path
        outs.append(serve_one(reports, cfg=ServeConfig(max_batch=1)))
        outs.append(serve_one(reports, cfg=cfg))
        for other in outs[1:]:
            assert_bitwise(outs[0], other)

    @pytest.mark.parametrize("depth", [1, 2, 3])
    def test_pipeline_depths_give_the_same_bits(self, depth):
        mats = [collusion_reports(np.random.default_rng(300 + i),
                                  10 + i % 3, 40 + 4 * (i % 2), liars=3,
                                  na_frac=0.1)[0] for i in range(10)]
        def run(d):
            cfg = ServeConfig(pipeline_depth=d, batch_window_ms=1.0,
                              max_batch=4)
            with cpu_service(cfg) as svc:
                assert svc.pipeline_depth == d
                futs = [svc.submit(reports=m) for m in mats]
                return [f.result(timeout=120) for f in futs]

        base = run(1)
        for a, b in zip(base, run(depth)):
            assert_bitwise(a, b)

    def test_depth_zero_resolves_to_two(self):
        assert cpu_service(ServeConfig(pipeline_depth=0)).pipeline_depth == 2

    def test_concurrent_clients_get_their_own_results(self):
        N = 12
        matrices = [collusion_reports(np.random.default_rng(900 + i),
                                      10 + (i % 3), 40 + 4 * (i % 4),
                                      liars=3, na_frac=0.1)[0]
                    for i in range(N)]
        refs = [Oracle(reports=m, device="cpu",
                       pca_method="power").consensus() for m in matrices]
        with cpu_service(ServeConfig(batch_window_ms=5.0)) as svc:
            futs = [None] * N

            def client(i):
                futs[i] = svc.submit(reports=matrices[i])

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(N)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            results = [f.result(timeout=120) for f in futs]
        for got, ref in zip(results, refs):
            assert_serve_parity(got, ref)

    def test_template_reuse_restores_pad_defaults(self, rng):
        """A lane refilled with a smaller request carries none of the
        larger one's values: the template equals a fresh padding."""
        big, _ = collusion_reports(rng, 14, 60, liars=3, na_frac=0.2)
        small, _ = collusion_reports(rng, 6, 20, liars=2, na_frac=0.2)
        tmpl = BucketTemplates(16, 64, 1, device="cpu")
        for m in (big, small):
            R, E = m.shape
            tmpl.fill_lane(0, m, np.full(R, 1.0 / R), np.zeros(E, bool),
                           np.zeros(E), np.ones(E), has_na=True)
        placed = place_bucket_operands(tmpl)
        R, E = small.shape
        fresh = bucket_inputs(small, np.full(R, 1.0 / R), np.zeros(E, bool),
                              np.zeros(E), np.ones(E), 16, 64, has_na=True)
        for a, b in zip(placed, fresh):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        # the placement is a copy: refilling leaves it alone
        tmpl.fill_lane(0, big, np.full(14, 1 / 14), np.zeros(60, bool),
                       np.zeros(60), np.ones(60), has_na=True)
        np.testing.assert_array_equal(placed[0].numpy(), fresh[0].numpy())


# -- admission, the queue, the cache ---------------------------------------


class TestAdmission:
    def test_error_taxonomy(self):
        assert ServiceOverloadError.error_code == "PYC401"
        assert ERROR_CODES["PYC401"] is ServiceOverloadError
        assert issubclass(ServiceOverloadError, ConsensusError)
        assert issubclass(ServiceOverloadError, RuntimeError)

    def test_queue_full_is_deterministic(self):
        q = RequestQueue(max_depth=2)
        q.put(ResolveRequest(reports=np.zeros((2, 2))))
        q.put(ResolveRequest(reports=np.zeros((2, 2))))
        with pytest.raises(ServiceOverloadError) as e:
            q.put(ResolveRequest(reports=np.zeros((2, 2))))
        assert e.value.context["reason"] == "queue_full"
        assert e.value.error_code == "PYC401"

    def test_queue_take_matching_keeps_fifo(self):
        q = RequestQueue(max_depth=8)
        reqs = [ResolveRequest(reports=np.zeros((2, 2))) for _ in range(5)]
        for i, r in enumerate(reqs):
            r.batch_key = i % 2
            q.put(r)
        assert q.take_matching(0, 2) == [reqs[0], reqs[2]]
        assert q.take(timeout=0) is reqs[1]
        q.close()
        assert q.drain_pending() == [reqs[3], reqs[4]]
        assert q.take(timeout=0) is None

    def test_rate_limit_sheds_over_rate_traffic(self, rng):
        reports, _ = collusion_reports(rng, 8, 24, liars=2, na_frac=0.0)
        cfg = ServeConfig(rate_limit_rps=1e-3, rate_burst=2.0)
        with cpu_service(cfg) as svc:
            svc.submit(reports=reports).result(timeout=120)
            svc.submit(reports=reports).result(timeout=120)
            with pytest.raises(ServiceOverloadError) as e:
                svc.submit(reports=reports)
        assert e.value.context["reason"] == "rate_limited"
        assert e.value.context["retry_after_s"] > 0

    def test_deadline_shed_not_hang(self, rng):
        reports, _ = collusion_reports(rng, 8, 24, liars=2, na_frac=0.0)
        with cpu_service() as svc:
            fut = svc.submit(reports=reports, deadline_ms=1e-6)
            with pytest.raises(ServiceOverloadError) as e:
                fut.result(timeout=60)
        assert e.value.context["reason"] == "deadline"

    def test_drain_finishes_queued_then_refuses(self, rng):
        reports, _ = collusion_reports(rng, 8, 24, liars=2, na_frac=0.0)
        svc = cpu_service().start()
        futs = [svc.submit(reports=reports) for _ in range(4)]
        svc.close(drain=True)
        for f in futs:
            assert f.result(timeout=60)["convergence"] in (True, False)
        with pytest.raises(ServiceOverloadError) as e:
            svc.submit(reports=reports)
        assert e.value.context["reason"] == "draining"

    def test_close_without_drain_sheds_the_queue(self, rng):
        reports, _ = collusion_reports(rng, 8, 24, liars=2, na_frac=0.0)
        svc = cpu_service()
        svc.queue.put(ResolveRequest(reports=reports))
        req = svc.queue._items[0]
        svc.close(drain=False)
        with pytest.raises(ServiceOverloadError) as e:
            req.future.result(timeout=5)
        assert e.value.context["reason"] == "draining"

    def test_a_dead_batcher_fails_its_futures(self, rng, monkeypatch):
        """A failure of the batcher loop itself ends the thread: queued
        requests get the error and later submits raise, none hangs."""
        from pyconsensus_tpu_torch.serve.batcher import Microbatcher

        def broken(self):
            import time

            time.sleep(0.2)
            raise RuntimeError("the loop broke")

        monkeypatch.setattr(Microbatcher, "_loop", broken)
        reports, _ = collusion_reports(rng, 8, 24, liars=2, na_frac=0.0)
        svc = cpu_service()
        fut = svc.submit(reports=reports)
        with pytest.raises(RuntimeError, match="loop broke"):
            fut.result(timeout=30)
        svc.batcher.join(30)
        with pytest.raises((RuntimeError, ServiceOverloadError)):
            svc.submit(reports=reports)

    def test_validation_errors_are_synchronous(self):
        svc = cpu_service()
        with pytest.raises(ValueError):
            svc.submit(reports=np.zeros((0, 3)))
        with pytest.raises(ValueError):
            svc.submit()
        with pytest.raises(ValueError):
            svc.submit(reports=np.zeros((2, 2)), session="x")
        with pytest.raises(InputError):
            svc.submit(reports=np.zeros((2, 2)), backend="tpu")


class TestCacheAndWarmup:
    def test_warmup_pins_builds_at_bucket_count(self, rng):
        cfg = ServeConfig(warmup=((16, 64), (32, 128)),
                          batch_window_ms=1.0)
        reports, _ = collusion_reports(rng, 12, 48, liars=4, na_frac=0.1)
        big, _ = collusion_reports(rng, 24, 100, liars=6, na_frac=0.1)
        before = obs.value("pyconsensus_serve_builds_total",
                           entry="serve_bucket") or 0
        with cpu_service(cfg) as svc:
            assert svc.cache.builds == 2 and len(svc.cache) == 2
            for _ in range(3):
                svc.submit(reports=reports).result(timeout=120)
                svc.submit(reports=big).result(timeout=120)
            # executables built = keys cached, none under steady traffic
            assert svc.cache.builds == len(svc.cache) == 2
            assert svc.cache.misses == 2 and svc.cache.hits >= 6
            assert svc.cache.hit_ratio() >= 0.75
        assert obs.value("pyconsensus_serve_builds_total",
                         entry="serve_bucket") == before + 2

    def test_lru_eviction(self, rng):
        cfg = ServeConfig(cache_capacity=1, batch_window_ms=0.0)
        small, _ = collusion_reports(rng, 6, 12, liars=2, na_frac=0.1)
        wide, _ = collusion_reports(rng, 6, 20, liars=2, na_frac=0.1)
        before = obs.value("pyconsensus_serve_cache_evictions_total") or 0
        with cpu_service(cfg) as svc:
            svc.submit(reports=small).result(timeout=120)
            svc.submit(reports=wide).result(timeout=120)
            assert len(svc.cache) == 1
            assert obs.value("pyconsensus_serve_cache_size") == 1
        after = obs.value("pyconsensus_serve_cache_evictions_total")
        assert after - before >= 1

    def test_bucket_key_fields(self):
        p = ConsensusParams(algorithm="sztorc", pca_method="power")
        key = BucketKey.make(16, 64, 8, p)
        assert (key.rows, key.events, key.batch) == (16, 64, 8)
        assert key.params is p
        assert key.kernel_path == PLAIN_KERNEL_PATH
        assert key == BucketKey.make(16, 64, 8, p)
        cuda = BucketKey.make(16, 64, 8, p, kernel_path=CUDA_KERNEL_PATH)
        assert cuda != key

    def test_cache_never_collides_across_kernel_paths(self):
        cache = ExecutableCache(capacity=4, device="cpu")
        p_plain = ConsensusParams(algorithm="sztorc", pca_method="power",
                                  has_na=True, any_scaled=False)
        p_cuda = cuda_bucket_params(True, {}, ())
        e1 = cache.get(BucketKey.make(8, 16, 1, p_plain))
        e2 = cache.get(BucketKey.make(8, 16, 1, p_cuda,
                                      kernel_path=CUDA_KERNEL_PATH))
        assert e1 is not e2 and len(cache) == 2
        assert cache.get(BucketKey.make(8, 16, 1, p_cuda,
                                        kernel_path=CUDA_KERNEL_PATH)) is e2
        with pytest.raises(ValueError, match="single"):
            cache.get(BucketKey.make(8, 16, 1, p_plain, topology="mesh"))
        with pytest.raises(ValueError, match="kernel path"):
            cache.get(BucketKey.make(8, 16, 1, p_plain, kernel_path="xla"))

    def test_coalescing_is_measurably_active(self, rng):
        obs.reset()
        reports, _ = collusion_reports(rng, 12, 48, liars=4, na_frac=0.1)
        cfg = ServeConfig(warmup=((16, 64),), batch_window_ms=10.0)
        with cpu_service(cfg) as svc:
            futs = [svc.submit(reports=reports) for _ in range(8)]
            for f in futs:
                f.result(timeout=120)
        snap = obs.REGISTRY.snapshot()[
            "pyconsensus_serve_batch_occupancy"]["series"]
        ser = next(iter(snap.values()))
        assert ser["sum"] / ser["count"] > 1.0


class TestRoutingAndConfig:
    def test_eligibility_rule(self):
        assert bucket_path_eligible("sztorc", "power", False, True, "")
        assert bucket_path_eligible("sztorc", "auto", True, True,
                                    "bfloat16")
        assert not bucket_path_eligible("ica", "power", False, True, "")
        assert not bucket_path_eligible("sztorc", "eigh-gram", False,
                                        True, "")
        assert not bucket_path_eligible("sztorc", "power", False, True,
                                        "int8")

    def test_json_round_trip(self, tmp_path):
        path = tmp_path / "serve.json"
        path.write_text(json.dumps({
            "row_buckets": [8, 32], "event_buckets": [64],
            "max_batch": 4, "rate_limit_rps": 10.0,
            "warmup": [[8, 64]], "pallas_warmup": [[12, 40]],
            "pallas_buckets": True, "backend": "jax"}))
        cfg = ServeConfig.load(path)
        assert cfg.row_buckets == (8, 32)
        assert cfg.warmup == ((8, 64),) and cfg.pallas_warmup == ((12, 40),)
        assert cfg.max_batch == 4
        # the reference's backend name reads as the port's
        rng = np.random.default_rng(1)
        reports, _ = collusion_reports(rng, 8, 20, liars=2, na_frac=0.1)
        with cpu_service(cfg) as svc:
            assert svc.cache.builds == 2
            assert svc.submit(reports=reports).result(60)["iterations"] == 1

    def test_reference_config_keys_load(self):
        from pyconsensus_tpu.serve import ServeConfig as RefConfig

        ref = RefConfig()
        keys = set(RefConfig.__dataclass_fields__)
        assert keys == set(ServeConfig.__dataclass_fields__)
        port = ServeConfig()
        for k in keys - {"backend"}:
            assert getattr(port, k) == getattr(ref, k), k
        assert port.backend == "torch"

    def test_unknown_key_rejected(self, tmp_path):
        path = tmp_path / "serve.json"
        path.write_text(json.dumps({"no_such_knob": 1}))
        with pytest.raises(ValueError, match="no_such_knob"):
            ServeConfig.load(path)

    def test_unsorted_ladder_rejected(self):
        with pytest.raises(ValueError, match="ascending"):
            cpu_service(ServeConfig(row_buckets=(32, 8)))

    @pytest.mark.parametrize("kw,match", [
        ({"aot_cache_dir": "/nonexistent"}, "A.11"),
        ({"hot_sessions": 4}, "A.11"),
        ({"compact_rounds": 3}, "A.11"),
        ({"compact_journal_bytes": 1024}, "A.11")])
    def test_unported_options_name_the_roadmap(self, kw, match):
        with pytest.raises(NotImplementedError, match=match):
            cpu_service(ServeConfig(**kw))

    def test_aot_store_refused_by_the_cache(self):
        with pytest.raises(NotImplementedError, match="A.11"):
            ExecutableCache(4, aot=object())

    def test_invalid_values_refused(self):
        for kw in ({"pipeline_depth": -1}, {"max_batch": 0},
                   {"incremental_refresh_every": 0},
                   {"sharded_buckets": "yes"}, {"pallas_buckets": "yes"}):
            with pytest.raises(InputError):
                cpu_service(ServeConfig(**kw))

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device works")
        with pytest.raises(RuntimeError, match="CUDA"):
            ConsensusService()
        with pytest.raises(RuntimeError, match="CUDA"):
            ConsensusService(ServeConfig(), device=None)

    @pytest.mark.parametrize("part", ["cache", "warm_inputs", "templates",
                                      "batcher"])
    def test_parts_default_to_the_card(self, part):
        """Every serve part that takes a device reads None as the card
        and raises without one: none of them quietly runs on the CPU."""
        from pyconsensus_tpu_torch.serve.batcher import Microbatcher
        from pyconsensus_tpu_torch.serve.cache import warm_inputs

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device works")
        p = ConsensusParams(algorithm="sztorc", pca_method="power",
                            has_na=True, any_scaled=False)
        make = {"cache": lambda: ExecutableCache(4),
                "warm_inputs": lambda: warm_inputs(
                    BucketKey.make(8, 16, 1, p)),
                "templates": lambda: BucketTemplates(8, 16, 1),
                "batcher": lambda: Microbatcher(None, None, ServeConfig(),
                                                None, None)}[part]
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        # warm() on an explicit CPU cache still runs
        ExecutableCache(4, device="cpu").warm(BucketKey.make(8, 16, 1, p))


# -- the bucket_cuda class on the CPU ---------------------------------------


def _binary(seed, R, E, na_frac=0.1):
    rng = np.random.default_rng(seed)
    return collusion_reports(rng, R, E, liars=max(2, R // 5),
                             na_frac=na_frac)[0]


class TestCudaTier:
    def test_gate_modes(self):
        args = dict(algorithm="sztorc", pca_method="auto", any_scaled=False,
                    storage_dtype="", max_events=4096, device="cpu")
        assert cuda_bucket_eligible(16, 64, mode=True, **args)
        assert not cuda_bucket_eligible(16, 64, mode=False, **args)
        # "auto" engages on an sm_90 card only
        assert not cuda_bucket_eligible(16, 64, mode="auto", **args)
        with pytest.raises(ValueError):
            cuda_bucket_eligible(16, 64, mode="yes", **args)

    def test_gate_scope(self):
        base = dict(algorithm="sztorc", pca_method="power",
                    any_scaled=False, storage_dtype="", mode=True,
                    max_events=4096, device="cpu")
        assert cuda_bucket_eligible(16, 64, **base)
        assert cuda_bucket_eligible(1024, 4096, **base)
        assert not cuda_bucket_eligible(16, 64, **{**base,
                                                   "any_scaled": True})
        assert not cuda_bucket_eligible(16, 8192, **base)
        assert not cuda_bucket_eligible(16, 64, **{**base,
                                                   "algorithm": "k-means"})
        assert not cuda_bucket_eligible(16, 64, **{**base,
                                                   "pca_method": "eigh-gram"})
        # resolve's panel fit at a huge roster
        assert not cuda_bucket_eligible(60_000, 64, **base)
        assert cuda_bucket_eligible(200_000, 64, **{**base,
                                                    "storage_dtype": "int8"})

    def test_default_config_on_the_cpu_stays_padded(self):
        before = obs.value("pyconsensus_serve_requests_total",
                           path="bucket_cuda", outcome="ok") or 0
        serve_one(_binary(1, 14, 44))
        assert (obs.value("pyconsensus_serve_requests_total",
                          path="bucket_cuda", outcome="ok") or 0) == before

    @pytest.mark.parametrize("storage", ["", "int8"])
    @pytest.mark.parametrize("max_iterations", [1, 3])
    def test_bitwise_the_direct_fused_oracle(self, storage, max_iterations):
        reports = _binary(10 + max_iterations, 23, 61)
        kw = dict(max_iterations=max_iterations, power_tol=1e-5)
        if storage:
            kw["storage_dtype"] = storage
        before = obs.value("pyconsensus_serve_requests_total",
                           path="bucket_cuda", outcome="ok") or 0
        got = serve_one(reports, cfg=ServeConfig(pallas_buckets=True), **kw)
        assert obs.value("pyconsensus_serve_requests_total",
                         path="bucket_cuda", outcome="ok") == before + 1
        direct = ShardedOracle(reports, pca_method="power", device="cpu",
                               **kw)
        assert direct.params.fused_resolution
        assert_bitwise(got, direct.consensus())
        # and the plain core's power arm within the float32 kernel band
        plain = Oracle(reports=reports, device="cpu", pca_method="power",
                       **{k: v for k, v in kw.items()
                          if k != "storage_dtype"}).consensus()
        assert_serve_parity(got, plain, atol=FUSED_ATOL)

    @pytest.mark.parametrize("storage", ["", "int8"])
    def test_matches_the_reference_interpreted_kernels(self, storage):
        reports = _binary(20, 24, 40)
        R, E = reports.shape
        kw = dict(max_iterations=2, power_iters=64, power_tol=-1.0)
        if storage:
            kw["storage_dtype"] = storage
        got = serve_one(reports, cfg=ServeConfig(pallas_buckets=True), **kw)
        p = RefParams(algorithm="sztorc", pca_method="power",
                      fused_resolution=True, has_na=True, any_scaled=False,
                      **kw)
        ref = ref_core_light(
            jnp.asarray(reports), jnp.full((R,), 1.0 / R),
            jnp.zeros(E, bool), jnp.zeros(E), jnp.ones(E), p)
        ref = {k: np.asarray(v) for k, v in ref.items()}
        for key in ("outcomes_adjusted", "outcomes_final"):
            np.testing.assert_array_equal(got["events"][key], ref[key])
        assert got["iterations"] == int(ref["iterations"])
        np.testing.assert_allclose(got["agents"]["smooth_rep"],
                                   ref["smooth_rep"], atol=FUSED_ATOL)
        np.testing.assert_allclose(got["events"]["certainty"],
                                   ref["certainty"], atol=FUSED_ATOL)

    def test_repeat_dispatch_bitwise_and_builds_pinned(self):
        reports = _binary(5, 16, 48)
        cfg = ServeConfig(pallas_buckets=True, pallas_warmup=((16, 48),))
        with cpu_service(cfg) as svc:
            assert svc.cache.builds == 1
            outs = [svc.submit(reports=reports).result(60)
                    for _ in range(3)]
            assert svc.cache.builds == 1 and svc.cache.hits >= 3
            key = next(iter(svc.cache.keys()))
            assert key.kernel_path == CUDA_KERNEL_PATH
            assert (key.rows, key.events, key.batch) == (16, 48, 1)
        for o in outs[1:]:
            assert_bitwise(outs[0], o)

    def test_scaled_request_takes_the_padded_path(self, rng):
        reports, bounds = scaled_fixture(rng, 12, 40, n_scaled=4)
        before = obs.value("pyconsensus_serve_requests_total",
                           path="bucket", outcome="ok") or 0
        serve_one(reports, bounds, cfg=ServeConfig(pallas_buckets=True))
        assert obs.value("pyconsensus_serve_requests_total", path="bucket",
                         outcome="ok") == before + 1


# -- the fault sites -------------------------------------------------------


class TestFaultSites:
    def test_enqueue_site(self, rng):
        from pyconsensus_tpu_torch import faults

        reports, _ = collusion_reports(rng, 8, 16, liars=2, na_frac=0.0)
        plan = faults.FaultPlan(seed=1, rules=[
            {"site": "serve.enqueue", "kind": "raise", "occurrences": [0]}])
        svc = cpu_service()
        with faults.armed(plan):
            with pytest.raises(OSError):
                svc.submit(reports=reports)
        assert plan.fired == [("serve.enqueue", 0, "raise")]

    @pytest.mark.parametrize("pallas", [False, True])
    def test_dispatch_site(self, rng, pallas):
        from pyconsensus_tpu_torch import faults

        reports, _ = collusion_reports(rng, 8, 16, liars=2, na_frac=0.0)
        plan = faults.FaultPlan(seed=1, rules=[
            {"site": "serve.dispatch", "kind": "raise", "occurrences": [0]}])
        with cpu_service(ServeConfig(pallas_buckets=pallas)) as svc:
            with faults.armed(plan):
                fut = svc.submit(reports=reports)
                with pytest.raises(OSError):
                    fut.result(timeout=60)
            # the next request is served
            assert svc.submit(reports=reports).result(60)["iterations"] == 1
        assert plan.fired == [("serve.dispatch", 0, "raise")]

    def test_group_failure_resolves_every_future(self, rng):
        from pyconsensus_tpu_torch import faults

        reports, _ = collusion_reports(rng, 8, 16, liars=2, na_frac=0.0)
        plan = faults.FaultPlan(seed=1, rules=[
            {"site": "serve.dispatch", "kind": "raise", "occurrences": [0]}])
        with cpu_service(ServeConfig(batch_window_ms=30.0)) as svc:
            with faults.armed(plan):
                futs = [svc.submit(reports=reports) for _ in range(4)]
                outcomes = []
                for f in futs:
                    try:
                        f.result(timeout=30)
                        outcomes.append("ok")
                    except OSError:
                        outcomes.append("err")
        assert outcomes.count("err") >= 1
        assert set(outcomes) <= {"ok", "err"}

    def test_cache_store_site(self, rng):
        from pyconsensus_tpu_torch import faults

        reports, _ = collusion_reports(rng, 8, 16, liars=2, na_frac=0.0)
        plan = faults.FaultPlan(seed=2, rules=[
            {"site": "serve.cache_store", "kind": "raise",
             "occurrences": [0]}])
        with cpu_service() as svc:
            with faults.armed(plan):
                with pytest.raises(OSError):
                    svc.submit(reports=reports).result(timeout=60)
                assert len(svc.cache) == 0
                # the miss builds on the next request
                svc.submit(reports=reports).result(timeout=60)
            assert len(svc.cache) == 1
        assert plan.fired == [("serve.cache_store", 0, "raise")]

    def test_session_append_corruption(self):
        from pyconsensus_tpu_torch import faults
        from pyconsensus_tpu_torch.serve import MarketSession

        plan = faults.FaultPlan(seed=3, rules=[
            {"site": "serve.session_append", "kind": "nan_storm",
             "occurrences": [0], "args": {"fraction": 0.5}}])
        session = MarketSession("m", n_reporters=8, device="cpu")
        block = np.ones((8, 6))
        with faults.armed(plan):
            session.append(block)
        staged = MarketSession._staged_host(session._blocks[0])
        assert np.isnan(staged).any()
        assert not np.isnan(block).any()

    def test_same_cells_as_the_reference(self):
        """One plan poisons the same cells of an appended block in both
        packages."""
        from pyconsensus_tpu import faults as ref_faults
        from pyconsensus_tpu.serve import MarketSession as RefSession
        from pyconsensus_tpu_torch import faults
        from pyconsensus_tpu_torch.serve import MarketSession

        rule = {"site": "serve.session_append", "kind": "nan_storm",
                "occurrences": [1], "args": {"fraction": 0.3}}
        blocks = [np.ones((10, 7)), np.zeros((10, 5))]
        port = MarketSession("m", n_reporters=10, device="cpu")
        ref = RefSession("m", n_reporters=10)
        with faults.armed(faults.FaultPlan(seed=9, rules=[rule])):
            for b in blocks:
                port.append(b)
        with ref_faults.armed(ref_faults.FaultPlan(seed=9, rules=[rule])):
            for b in blocks:
                ref.append(b)
        for a, b in zip(port._blocks, ref._blocks):
            np.testing.assert_array_equal(MarketSession._staged_host(a),
                                          RefSession._staged_host(b))


def test_serve_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import pyconsensus_tpu_torch.serve\n"
        "import pyconsensus_tpu_torch.parallel.streaming\n"
        "from pyconsensus_tpu_torch.serve import ConsensusService\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pyconsensus_tpu' or m.startswith('pyconsensus_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- the small repairs the slice needed -------------------------------------


def test_power_loop_base_injection():
    """``_power_loop(base=...)``: the default draw passed explicitly
    gives the same bits; with a warm start (the seed's unit vector is
    blended in) the true-width seed zero-extended into a zero-padded
    operator follows the unpadded trajectory (two fixed sweeps: equal to
    a product's rounding, exactly zero on the pad), where the padded
    width's own draw, whose norm counts the pad entries, does not."""
    from pyconsensus_tpu_torch.ops import torch_kernels as tk
    from pyconsensus_tpu_torch.ops.prng import power_seed

    rng = np.random.default_rng(5)
    E, pad = 37, 11
    A = torch.tensor(rng.standard_normal((9, E)))
    C = A.T @ A
    Cp = torch.zeros((E + pad, E + pad), dtype=C.dtype)
    Cp[:E, :E] = C
    seed = torch.from_numpy(np.array(power_seed(E, "float64")))
    zeros = torch.zeros(pad, dtype=seed.dtype)
    warm = torch.tensor(rng.standard_normal(E))
    kw = dict(dtype=torch.float64, v_init=warm)
    a, na = tk._power_loop(lambda v: C @ v, E, 2, -1.0, "cpu", **kw)
    b, nb = tk._power_loop(lambda v: C @ v, E, 2, -1.0, "cpu", base=seed,
                           **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    kw["v_init"] = torch.cat([warm, zeros])
    c, nc = tk._power_loop(lambda v: Cp @ v, E + pad, 2, -1.0, "cpu",
                           base=torch.cat([seed, zeros]), **kw)
    assert na == nb == nc == 2
    np.testing.assert_allclose(c[:E].numpy(), a.numpy(), atol=1e-14,
                               rtol=0)
    assert not c[E:].any()
    d, _ = tk._power_loop(lambda v: Cp @ v, E + pad, 2, -1.0, "cpu", **kw)
    assert float(torch.max(torch.abs(d[:E] - a))) > 1e-6


def test_fault_sites_count_in_the_catalog_comment():
    import re

    from pyconsensus_tpu_torch import faults
    from pyconsensus_tpu_torch.faults import plan

    src = open(plan.__file__).read()
    assert int(re.search(r"The (\d+) named injection sites", src)
               .group(1)) == len(faults.FAULT_SITES) == 17
    assert {"serve.enqueue", "serve.dispatch", "serve.cache_store",
            "serve.session_append"} <= set(faults.FAULT_SITES)


def test_package_exports_the_serve_tier():
    import pyconsensus_tpu_torch as pkg
    from pyconsensus_tpu_torch import serve

    assert pkg.ConsensusService is serve.ConsensusService
    assert pkg.ServeConfig is serve.ServeConfig
    assert {"ConsensusService", "ServeConfig", "serve"} <= set(pkg.__all__)
    for name in serve.__all__:
        assert hasattr(serve, name), name
