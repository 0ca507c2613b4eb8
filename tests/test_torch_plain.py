"""The port's plain core, module by module, against the JAX package on
the CPU.

Each function of ``pyconsensus_tpu_torch.ops.torch_kernels`` that the plain
core runs (rescale and the fill, every PCA method over the dense filled
matrix, the direction fix, the weighted median, outcome resolution and the
certainty accounting) gets the same seeded numpy inputs as its
``pyconsensus_tpu.ops.jax_kernels`` counterpart, in float64 and again in
float32 (``power-fused`` runs the reference's Pallas kernels in interpret
mode). This file holds the fill and the PCA; ``tests/test_torch_resolve.py``
the median and the resolution; ``tests/test_torch_core.py`` runs the core
whole.

Bands: exact where the arithmetic is the same (rescale, snapped outcomes,
medians, masks); continuous values within 1e-9 in float64 and 1e-5 in
float32; ``power-fused`` within 1e-5, since its kernels compute in
float32. Eigenvectors compare up to sign.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyconsensus_tpu.ops import jax_kernels as jk
from pyconsensus_tpu_torch.ops import torch_kernels as tk

DTYPES = {"float64": (torch.float64, np.float64, 1e-9),
          "float32": (torch.float32, np.float32, 1e-5)}


def make_data(seed, R=24, E=40, n_scaled=5, na_frac=0.1):
    """Binary collusion reports, the first ``n_scaled`` columns scaled on
    [-5, 15] (raw values), ``na_frac`` absent. Returns ``(reports, rep,
    scaled, mins, maxs)`` in float64."""
    rng = np.random.default_rng(seed)
    truth = rng.choice([0.0, 1.0], size=E)
    reports = np.tile(truth, (R, 1))
    liars = max(2, R // 5)
    flips = rng.random((R - liars, E)) < 0.1
    reports[:R - liars] = np.abs(reports[:R - liars] - flips)
    reports[R - liars:] = 1.0 - truth
    scaled = np.zeros(E, dtype=bool)
    scaled[:n_scaled] = True
    mins = np.where(scaled, -5.0, 0.0)
    maxs = np.where(scaled, 15.0, 1.0)
    # scaled reports: the honest near 20 * truth - 5, the liars far off
    reports[:, scaled] = (20.0 * reports[:, scaled] - 5.0
                          + rng.normal(0.0, 0.5, (R, n_scaled)))
    reports[rng.random((R, E)) < na_frac] = np.nan
    rep = rng.random(R) + 0.5
    return reports, rep / rep.sum(), scaled, mins, maxs


def both(a, np_dtype, t_dtype):
    """The same numpy array as a jax array and a torch tensor."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np_dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def close(got, ref, atol, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0,
                               err_msg=msg)


def up_to_sign(got, ref, atol):
    """Columns (or a vector) equal up to one sign each."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    g2, r2 = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    for c in range(g2.shape[1]):
        s = 1.0 if np.dot(g2[:, c], r2[:, c]) >= 0 else -1.0
        np.testing.assert_allclose(s * g2[:, c], r2[:, c], atol=atol, rtol=0)


@pytest.fixture(params=sorted(DTYPES))
def dt(request):
    return DTYPES[request.param]


def filled_inputs(seed, np_dtype, t_dtype, **kw):
    """Rescaled and filled by the reference, as both array kinds."""
    reports, rep, scaled, mins, maxs = make_data(seed, **kw)
    rescaled = np.asarray(jk.rescale(jnp.asarray(reports), scaled, mins,
                                     maxs))
    filled, present = jk.interpolate_masked(jnp.asarray(rescaled),
                                            jnp.asarray(rep), scaled, 0.1)
    return (both(filled, np_dtype, t_dtype), both(rep, np_dtype, t_dtype),
            both(present, np_dtype, t_dtype), both(scaled, np_dtype,
                                                   t_dtype))


def test_rescale_and_unscale_bit_for_bit(dt):
    t_dtype, np_dtype, _ = dt
    reports, _, scaled, mins, maxs = make_data(1)
    jx, tx = both(reports, np_dtype, t_dtype)
    (jmn, tmn), (jmx, tmx) = (both(mins, np_dtype, t_dtype),
                              both(maxs, np_dtype, t_dtype))
    js, ts = both(scaled, np_dtype, t_dtype)
    ref = np.asarray(jk.rescale(jx, js, jmn, jmx))
    got = tk.rescale(tx, ts, tmn, tmx).numpy()
    np.testing.assert_array_equal(got, ref)
    out = np.linspace(0.0, 1.0, reports.shape[1]).astype(np_dtype)
    np.testing.assert_array_equal(
        tk.unscale_outcomes(torch.from_numpy(out), ts, tmn, tmx).numpy(),
        np.asarray(jk.unscale_outcomes(jnp.asarray(out), js, jmn, jmx)))


@pytest.mark.parametrize("na_frac", [0.1, 0.0])
def test_interpolate_masked_matches(dt, na_frac):
    t_dtype, np_dtype, atol = dt
    reports, rep, scaled, mins, maxs = make_data(2, na_frac=na_frac)
    rescaled = np.asarray(jk.rescale(jnp.asarray(reports), scaled, mins,
                                     maxs))
    (jx, tx), (jr, tr) = (both(rescaled, np_dtype, t_dtype),
                          both(rep, np_dtype, t_dtype))
    js, ts = both(scaled, np_dtype, t_dtype)
    f_ref, p_ref = jk.interpolate_masked(jx, jr, js, 0.1)
    f_got, p_got = tk.interpolate_masked(tx, tr, ts, 0.1)
    np.testing.assert_array_equal(p_got.numpy(), np.asarray(p_ref))
    assert f_got.dtype == t_dtype
    close(f_got, f_ref, atol)
    close(tk.interpolate(tx, tr, ts, 0.1), f_ref, atol)


def test_weighted_cov_matches(dt):
    t_dtype, np_dtype, atol = dt
    (jf, tf), (jr, tr), _, _ = filled_inputs(3, np_dtype, t_dtype)
    cov_ref, dev_ref = jk.weighted_cov(jf, jr)
    cov, dev = tk.weighted_cov(tf, tr)
    close(cov, cov_ref, atol)
    close(dev, dev_ref, atol)


@pytest.mark.parametrize("method", ["eigh-cov", "eigh-gram", "power",
                                    "auto"])
def test_weighted_prin_comp_matches(dt, method):
    t_dtype, np_dtype, atol = dt
    (jf, tf), (jr, tr), _, _ = filled_inputs(4, np_dtype, t_dtype)
    with jax.default_matmul_precision("highest"):
        l_ref, s_ref = jk.weighted_prin_comp(jf, jr, method=method,
                                             power_iters=64, power_tol=-1.0)
    loading, scores = tk.weighted_prin_comp(tf, tr, method, 64, -1.0)
    up_to_sign(loading, l_ref, atol)
    up_to_sign(scores, s_ref, atol)


def test_sztorc_scores_power_fused_matches(dt):
    """``power-fused`` is sztorc's route alone: the kernels' sweeps and
    scores pass (their plain versions here, in float32) against the
    reference's Pallas kernels in interpret mode, within 1e-5;
    ``weighted_prin_comp`` refuses it."""
    t_dtype, np_dtype, _ = dt
    (jf, tf), (jr, tr), _, _ = filled_inputs(4, np_dtype, t_dtype)
    with jax.default_matmul_precision("highest"):
        adj_ref, l_ref = jk.sztorc_scores_power_fused(jf, jr, 64, -1.0,
                                                      interpret=True)
    adj, loading = tk.sztorc_scores_power_fused(tf, tr, 64, -1.0)
    assert adj.dtype == loading.dtype == t_dtype
    up_to_sign(loading, l_ref, 1e-5)
    close(adj, adj_ref, 1e-5)
    with pytest.raises(ValueError, match="power-fused"):
        tk.weighted_prin_comp(tf, tr, "power-fused")


@pytest.mark.parametrize("method", ["eigh-cov", "eigh-gram", "power"])
def test_weighted_prin_comps_matches(dt, method):
    """Three components, a clear spectrum gap above them."""
    t_dtype, np_dtype, atol = dt
    (jf, tf), (jr, tr), _, _ = filled_inputs(5, np_dtype, t_dtype)
    with jax.default_matmul_precision("highest"):
        ref = jk.weighted_prin_comps(jf, jr, 3, method=method)
    got = tk.weighted_prin_comps(tf, tr, 3, method)
    # orthogonal iteration exits by alignment, a few eps from the eigh
    tol = atol if method != "power" else max(atol, 1e-7)
    up_to_sign(got[0][:, :1], ref[0][:, :1], tol)
    up_to_sign(got[1][:, :1], ref[1][:, :1], tol)
    close(got[2], ref[2], tol)


def test_power_warm_start_matches(dt):
    """A warm-started orthogonal iteration and power loop land where the
    reference's do."""
    t_dtype, np_dtype, atol = dt
    (jf, tf), (jr, tr), _, _ = filled_inputs(6, np_dtype, t_dtype)
    with jax.default_matmul_precision("highest"):
        l_ref, _ = jk.weighted_prin_comp(jf, jr, "power")
        warm, _ = jk.weighted_prin_comp(jf, jr, "power", v_init=l_ref)
        blk_ref = jk.weighted_prin_comps(jf, jr, 2, "power")[0]
        blk_warm = jk.weighted_prin_comps(jf, jr, 2, "power",
                                          v_init=blk_ref)[0]
    got, _ = tk.weighted_prin_comp(tf, tr, "power",
                                   v_init=torch.from_numpy(np.array(l_ref)))
    up_to_sign(got, warm, max(atol, 1e-7))
    blk = tk.weighted_prin_comps(tf, tr, 2, "power",
                                 v_init=torch.from_numpy(np.array(blk_ref)))
    up_to_sign(blk[0][:, :1], blk_warm[:, :1], max(atol, 1e-7))


def test_direction_fixed_scores_matches(dt):
    t_dtype, np_dtype, atol = dt
    (jf, tf), (jr, tr), _, _ = filled_inputs(7, np_dtype, t_dtype)
    with jax.default_matmul_precision("highest"):
        _, s = jk.weighted_prin_comp(jf, jr, "eigh-gram")
        for scores in (s, -s):
            ref = jk.direction_fixed_scores(scores, jf, jr)
            got = tk.direction_fixed_scores(
                torch.from_numpy(np.asarray(scores)), tf, tr)
            close(got, ref, atol)


def test_resolve_pca_method_routes_as_the_reference_on_the_cpu():
    cpu = torch.device("cpu")
    for R, E, m in ((50, 25, "auto"), (4096, 100_000, "auto"),
                    (10_000, 100_000, "auto"), (24, 40, "power-fused"),
                    (2048, 1024, "power-fused"), (10, 10, "eigh-gram")):
        assert (tk.resolve_pca_method(R, E, m, cpu)
                == jk.resolve_pca_method(R, E, m)), (R, E, m)
