"""The port's kernel wrappers against the Pallas kernels (interpret mode).

On the CPU each wrapper runs its plain torch version; the same numpy
inputs (float32 throughout) go through ``pyconsensus_tpu``'s Pallas
kernel with ``interpret=True``. Tolerances allow float32 sums taken in
another order and the TPU kernels' compensated dots (about 2^-17
relative): apply_weighted_cov rtol 3e-5 / atol 1e-6; scores_dirfix's
``c`` and ``o``, fill_stats and resolve rtol 1e-5 / atol 1e-6; resolve's
snapped outcomes are exact. scores_dirfix's ``t`` and ``q`` are held to
1e-5 of their largest magnitude, and ``q`` on both sides to the float32
bound of its sum against a float64 truth. apply_weighted_cov_block and storage_rows_matmat sum k-wide
products of both signs, so their outputs are held to 3e-5 of the largest
magnitude of the output (the compensated split's error scales with the
terms, not with an entry that cancels to near zero).

The multi-component functions around the kernels
(``weighted_prin_comps_storage``, ``multi_dirfix_storage``, FastICA's
one-unit loop, the fixed-variance component weights) are held against the
JAX package's functions on the same inputs: float64 within 1e-9 where the
arithmetic is the same, the orthogonal iteration within the kernels' band.

The CUDA kernels themselves are held against the plain versions on the
card in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyconsensus_tpu.models import ica as ref_ica
from pyconsensus_tpu.models import sztorc as ref_sztorc
from pyconsensus_tpu.ops import jax_kernels as jk
from pyconsensus_tpu.ops import pallas_kernels as pk
from pyconsensus_tpu_torch.models import ica as port_ica
from pyconsensus_tpu_torch.models import sztorc as port_sztorc
from pyconsensus_tpu_torch.ops import build, cuda_kernels as ck
from pyconsensus_tpu_torch.ops import torch_kernels as tk

SHAPES = [(24, 12), (23, 300), (64, 300)]


def make_storage(seed, R, E, na_frac=0.1):
    """Collusion-style binary reports with NaN non-reports, as float32
    and as int8 sentinel storage, plus f32 rep / fill / mu / v."""
    rng = np.random.default_rng(seed)
    truth = rng.choice([0.0, 1.0], size=E)
    reports = np.tile(truth, (R, 1))
    liars = max(2, R // 5)
    flips = rng.random((R - liars, E)) < 0.1
    reports[:R - liars] = np.abs(reports[:R - liars] - flips)
    reports[R - liars:] = 1.0 - truth
    reports[rng.random((R, E)) < na_frac] = np.nan
    reports[rng.random((R, E)) < 0.05] = 0.5
    x_f = reports.astype(np.float32)
    x_i = np.where(np.isnan(reports), -1,
                   np.round(np.clip(reports, 0, 1) * 2)).astype(np.int8)
    rep = rng.random(R).astype(np.float32)
    rep /= rep.sum()
    fill = rng.choice([0.0, 0.5, 1.0], size=E).astype(np.float32)
    filled = np.where(np.isnan(x_f), fill[None, :], x_f)
    mu = (rep @ filled).astype(np.float32)
    v = rng.standard_normal(E).astype(np.float32)
    return x_f, x_i, rep, fill, mu, v


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_scaled(got, ref, what, frac=3e-5):
    ref = np.asarray(ref, dtype=np.float64)
    _close(got, ref, 0, frac * max(np.abs(ref).max(), 1e-30), what)


def _close(got, ref, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(ref, dtype=np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("with_fill", [True, False])
def test_apply_weighted_cov_matches_pallas(R, E, storage, with_fill):
    x_f, x_i, rep, fill, mu, v = make_storage(R * 7 + E, R, E)
    if not with_fill:       # dense storage: absent entries filled up front
        dense = np.where(np.isnan(x_f), np.float32(0.5), x_f)
        x_f = dense
        x_i = np.round(dense * 2).astype(np.int8)
        mu = (rep @ dense).astype(np.float32)
    x = x_i if storage == "int8" else x_f
    f = fill if with_fill else None
    ref = pk.apply_weighted_cov(jnp.asarray(x), jnp.asarray(mu),
                                jnp.asarray(rep), jnp.asarray(v),
                                fill=None if f is None else jnp.asarray(f),
                                interpret=True)
    got = ck.apply_weighted_cov(_t(x), _t(mu), _t(rep), _t(v),
                                fill=None if f is None else _t(f))
    assert got.dtype == torch.float32 and got.shape == (E,)
    _close(got.numpy(), ref, 3e-5, 1e-6, "apply_weighted_cov")


@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("with_fill", [True, False])
def test_scores_dirfix_pass_matches_pallas(R, E, storage, with_fill):
    x_f, x_i, rep, fill, mu, v = make_storage(R * 11 + E, R, E)
    if not with_fill:
        x_f = np.where(np.isnan(x_f), np.float32(1.0), x_f)
        x_i = np.round(x_f * 2).astype(np.int8)
    x = x_i if storage == "int8" else x_f
    f = fill if with_fill else None
    ref = pk.scores_dirfix_pass(jnp.asarray(x), jnp.asarray(rep),
                                jnp.asarray(v),
                                fill=None if f is None else jnp.asarray(f),
                                interpret=True)
    got = ck.scores_dirfix_pass(_t(x), _t(rep), _t(v),
                                fill=None if f is None else _t(f))
    # t = X v and q = t^T X sum terms of both signs: an entry of q that
    # cancels (near -0.37 out of partial sums near 110 at 23 x 300) is
    # held to the largest magnitude, as B.6 and B.8 are
    for name, g, r in zip("tq", got, ref):
        _close_scaled(g.numpy(), r, f"scores_dirfix {name}", frac=1e-5)
    for name, g, r in zip("co", got[2:], ref[2:]):
        _close(g.numpy(), r, 1e-5, 1e-6, f"scores_dirfix {name}")
    _dirfix_q_within_float32_of_truth(x_f, fill if with_fill else None,
                                      np.asarray(ref[0]), got[1].numpy(),
                                      np.asarray(ref[1]))


def _dirfix_q_within_float32_of_truth(x_f, fill, t_ref, q_port, q_pallas):
    """Both sides' ``q`` against the float64 truth ``t_ref^T X`` (``X``
    the filled matrix, absent entries 1.0 where no fill is given): each
    entry within ``R * 2^-24`` of its terms' scale ``sum_r |t_r X_rc|``,
    the float32 bound of an R-term sum. At 23 x 300 without the fill the
    port sat at 4.34e-7 of that scale and the Pallas kernel at 1.26e-7."""
    R = x_f.shape[0]
    X = np.where(np.isnan(x_f), 1.0 if fill is None else fill[None, :],
                 x_f).astype(np.float64)
    t = t_ref.astype(np.float64)
    truth = t @ X
    scale = np.abs(t) @ np.abs(X)
    bound = R * 2.0 ** -24
    for name, q in (("port", q_port), ("pallas", q_pallas)):
        err = np.max(np.abs(q.astype(np.float64) - truth) / scale)
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
def test_resolve_certainty_fused_matches_pallas(R, E, storage):
    x_f, x_i, rep, fill, mu, v = make_storage(R * 13 + E, R, E)
    # an all-absent column exercises the tw > 0 fallback
    x_f[:, 0] = np.nan
    x_i[:, 0] = -1
    x = x_i if storage == "int8" else x_f
    total = np.float32(rep.sum())
    ref = pk.resolve_certainty_fused(jnp.asarray(x), jnp.asarray(rep),
                                     jnp.asarray(fill), jnp.asarray(total),
                                     0.1, interpret=True)
    got = ck.resolve_certainty_fused(_t(x), _t(rep), _t(fill),
                                     torch.tensor(total), 0.1)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    names = ["raw", "outcomes", "certainty", "pcol", "prow", "narow"]
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape, name
        _close(g.numpy(), r, 1e-5, 1e-6, f"resolve {name}")


def test_resolve_knife_edge_snaps_like_pallas():
    """A column whose mean sits on the catch boundary snaps identically."""
    R, E = 24, 12
    x = np.zeros((R, E), np.int8)
    x[:, 0] = np.r_[np.full(18, 2), np.zeros(6)].astype(np.int8)  # 0.75
    x[:, 1] = np.r_[np.full(14, 2), np.zeros(10)].astype(np.int8)
    rep = np.full(R, 1.0 / R, np.float32)
    fill = np.full(E, 0.5, np.float32)
    ref = pk.resolve_certainty_fused(jnp.asarray(x), jnp.asarray(rep),
                                     jnp.asarray(fill),
                                     jnp.asarray(np.float32(1.0)), 0.25,
                                     interpret=True)
    got = ck.resolve_certainty_fused(_t(x), _t(rep), _t(fill),
                                     torch.tensor(1.0), 0.25)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("emit_t", [False, True])
def test_apply_weighted_cov_block_matches_pallas(R, E, storage, emit_t):
    x_f, x_i, rep, fill, mu, v = make_storage(R * 5 + E, R, E)
    x = x_i if storage == "int8" else x_f
    V = np.random.default_rng(E).standard_normal((E, 5)).astype(np.float32)
    ref_y, ref_t = pk.apply_weighted_cov_block(
        jnp.asarray(x), jnp.asarray(mu), jnp.asarray(rep), jnp.asarray(V),
        fill=jnp.asarray(fill), interpret=True, emit_t=emit_t)
    y, t = ck.apply_weighted_cov_block(_t(x), _t(mu), _t(rep), _t(V),
                                       fill=_t(fill), emit_t=emit_t)
    assert y.shape == (E, 5) and y.dtype == torch.float32
    _close_scaled(y.numpy(), ref_y, "apply_weighted_cov_block y")
    if emit_t:
        assert t.shape == (R, 5)
        _close_scaled(t.numpy(), ref_t, "apply_weighted_cov_block t")
    else:
        assert t is None and ref_t is None


@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("narrow", [False, True])
def test_storage_rows_matmat_matches_pallas(R, E, storage, narrow):
    """A W with fewer columns than R is zero-padded, as in the Pallas
    wrapper."""
    x_f, x_i, rep, fill, mu, v = make_storage(R * 3 + E, R, E)
    x = x_i if storage == "int8" else x_f
    cols = R - 5 if narrow else R
    W = np.random.default_rng(R).standard_normal((6, cols)).astype(
        np.float32)
    ref = pk.storage_rows_matmat(jnp.asarray(x), jnp.asarray(W),
                                 fill=jnp.asarray(fill), interpret=True)
    got = ck.storage_rows_matmat(_t(x), _t(W), fill=_t(fill))
    assert got.shape == (6, E)
    _close_scaled(got.numpy(), ref, "storage_rows_matmat")


@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("with_fill", [True, False])
def test_storage_matvec_matches_pallas(R, E, storage, with_fill):
    x_f, x_i, rep, fill, mu, v = make_storage(R * 19 + E, R, E)
    if not with_fill:
        x_f = np.where(np.isnan(x_f), np.float32(0.5), x_f)
        x_i = np.round(x_f * 2).astype(np.int8)
    x = x_i if storage == "int8" else x_f
    f = fill if with_fill else None
    ref = pk.storage_matvec(jnp.asarray(x), jnp.asarray(v),
                            fill=None if f is None else jnp.asarray(f),
                            interpret=True)
    got = ck.storage_matvec(_t(x), _t(v), fill=None if f is None else _t(f))
    assert got.shape == (R,) and got.dtype == torch.float32
    _close_scaled(got.numpy(), ref, "storage_matvec")


@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("with_fill", [True, False])
@pytest.mark.parametrize("k", [1, 5, 12, 16, 17])
def test_storage_matmat_matches_pallas(R, E, storage, with_fill, k):
    """k = 16 is one group of the group loop (one launch on the card),
    k = 17 two (16 + 1 columns)."""
    x_f, x_i, rep, fill, mu, v = make_storage(R * 23 + E + k, R, E)
    if not with_fill:
        x_f = np.where(np.isnan(x_f), np.float32(1.0), x_f)
        x_i = np.round(x_f * 2).astype(np.int8)
    x = x_i if storage == "int8" else x_f
    f = fill if with_fill else None
    V = np.random.default_rng(k).standard_normal((E, k)).astype(np.float32)
    ref = pk.storage_matmat(jnp.asarray(x), jnp.asarray(V),
                            fill=None if f is None else jnp.asarray(f),
                            interpret=True)
    got = ck.storage_matmat(_t(x), _t(V), fill=None if f is None else _t(f))
    assert got.shape == (R, k) and got.dtype == torch.float32
    _close_scaled(got.numpy(), ref, "storage_matmat")


@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("k", [9, 13, 17])
def test_storage_rows_matmat_groups_match_pallas(R, E, storage, k):
    """Stacks of 9 and 13 rows (one launch of up to 16 rows) and of 17
    (the group loop: 16 rows, then 1) match the Pallas kernel."""
    x_f, x_i, rep, fill, mu, v = make_storage(R * 29 + E + k, R, E)
    x = x_i if storage == "int8" else x_f
    W = np.random.default_rng(k).standard_normal((k, R)).astype(np.float32)
    ref = pk.storage_rows_matmat(jnp.asarray(x), jnp.asarray(W),
                                 fill=jnp.asarray(fill), interpret=True)
    got = ck.storage_rows_matmat(_t(x), _t(W), fill=_t(fill))
    assert got.shape == (k, E)
    _close_scaled(got.numpy(), ref, "storage_rows_matmat")


@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
def test_fill_stats_pass_matches_pallas(R, E, storage):
    x_f, x_i, rep, fill, mu, v = make_storage(R * 17 + E, R, E)
    x_f[:, 0] = np.nan                   # an all-absent column
    x_i[:, 0] = -1
    x = x_i if storage == "int8" else x_f
    ref = pk.fill_stats_pass(jnp.asarray(x), jnp.asarray(rep),
                             interpret=True)
    got = ck.fill_stats_pass(_t(x), _t(rep))
    for name, g, r in zip(("tw", "numer"), got, ref):
        assert g.shape == (E,) and g.dtype == torch.float32
        _close(g.numpy(), r, 1e-5, 1e-6, f"fill_stats {name}")
    assert got[0][0] == 0.0


def _orth_inputs(R, E, seed):
    x_f, x_i, rep, fill, mu, v = make_storage(seed, R, E)
    rep64 = rep.astype(np.float64) / rep.astype(np.float64).sum()
    filled = np.where(np.isnan(x_f), fill[None, :], x_f).astype(np.float64)
    return x_i, fill, rep64, rep64 @ filled


@pytest.mark.parametrize("R,E,k", [(24, 16, 5), (64, 300, 3),
                                   (24, 40, 12), (64, 300, 9)])
def test_weighted_prin_comps_storage_matches_reference(R, E, k,
                                                       monkeypatch):
    """k > 8 takes the port's separable arm; the reference is forced onto
    its own separable arm there by its block-kernel gate."""
    x, fill, rep, mu = _orth_inputs(R, E, R + E)
    if k > ck.MAX_BLOCK_K:
        monkeypatch.setattr(pk, "cov_block_kernel_fits",
                            lambda *a, **kw: False)
    ref = jk.weighted_prin_comps_storage(
        jnp.asarray(x), jnp.asarray(fill), jnp.asarray(mu), jnp.asarray(rep),
        k, interpret=True)
    got = tk.weighted_prin_comps_storage(_t(x), _t(fill), _t(mu), _t(rep), k)
    loadings, scores, explained = (np.asarray(a) for a in ref)
    assert got[0].dtype == torch.float64
    _close(np.abs(got[0].numpy()), np.abs(loadings), 0, 2e-3, "loadings")
    _close(np.abs(got[1].numpy()), np.abs(scores), 0, 2e-3, "scores")
    _close(got[2].numpy(), explained, 0, 1e-5, "explained")


def test_multi_dirfix_storage_matches_reference():
    R, E = 23, 40
    x, fill, rep, mu = _orth_inputs(R, E, 9)
    scores = np.random.default_rng(1).standard_normal((R, 4))
    scores[:, 3] = 0.0                   # a zero column: sign +1, zero sums
    ref = jk.multi_dirfix_storage(jnp.asarray(scores), jnp.asarray(x),
                                  jnp.asarray(fill), jnp.asarray(mu),
                                  jnp.asarray(rep), interpret=True)
    got = tk.multi_dirfix_storage(_t(scores), _t(x), _t(fill), _t(mu),
                                  _t(rep))
    assert got.shape == (R, 4) and got.dtype == torch.float64
    _close(got.numpy(), ref, 1e-9, 1e-9, "multi_dirfix_storage")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fastica_one_unit_matches_reference(dtype, seed):
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((40, 4)) ** 3
    Z = (Z / Z.std(axis=0)).astype(dtype)
    w_ref, conv_ref = ref_ica._fastica_one_unit(
        jnp.asarray(Z), ref_ica._conv_tol(Z.dtype))
    w, conv = port_ica._fastica_one_unit(
        _t(Z), port_ica._conv_tol(_t(Z).dtype))
    assert conv == bool(conv_ref)
    atol = 1e-9 if dtype == np.float64 else 1e-4
    _close(w.numpy(), np.asarray(w_ref), 0, atol, "fastica w")


def test_fastica_chaotic_case_falls_back_to_the_first_component():
    """A tolerance no iterate can meet runs all ``ICA_ITERS`` iterations
    and returns the start vector, unconverged."""
    Z = np.random.default_rng(0).standard_normal((30, 3))
    w, conv = port_ica._fastica_one_unit(_t(Z), -1.0)
    assert not conv and w.tolist() == [1.0, 0.0, 0.0]


@pytest.mark.parametrize("explained,threshold", [
    ([0.6, 0.25, 0.1, 0.05], 0.9), ([0.95, 0.03, 0.02], 0.9),
    ([0.0, 0.0, 0.0], 0.9), ([0.3, 0.3, 0.3], 0.5)])
def test_component_weights_match_reference(explained, threshold):
    e = np.asarray(explained, np.float64)
    ref = ref_sztorc._component_weights_jax(jnp.asarray(e), threshold)
    got = port_sztorc._component_weights(_t(e), threshold)
    _close(got.numpy(), ref, 0, 1e-12, "component weights")


def test_sizing_rules_match_reference():
    for R, E, m in [(24, 16, 5), (3, 40, 5), (10000, 100000, 5), (2, 2, 9)]:
        assert port_sztorc.fixed_variance_k(R, E, m) == \
            ref_sztorc.fixed_variance_k(R, E, m)
        assert port_ica.ica_k(R, E, m) == ref_ica.ica_k(R, E, m)


def test_cpu_calls_are_not_launches():
    ck.reset_launch_counts()
    x_f, x_i, rep, fill, mu, v = make_storage(0, 24, 12)
    ck.apply_weighted_cov(_t(x_i), _t(mu), _t(rep), _t(v), _t(fill))
    ck.scores_dirfix_pass(_t(x_i), _t(rep), _t(v), _t(fill))
    ck.resolve_certainty_fused(_t(x_i), _t(rep), _t(fill), 1.0, 0.1)
    V = np.ones((12, 2), np.float32)
    ck.apply_weighted_cov_block(_t(x_i), _t(mu), _t(rep), _t(V), _t(fill))
    ck.storage_rows_matmat(_t(x_i), _t(V.T[:, :12]), _t(fill))
    ck.fill_stats_pass(_t(x_i), _t(rep))
    ck.storage_matvec(_t(x_i), _t(v), _t(fill))
    ck.storage_matmat(_t(x_i), _t(np.ones((12, 11), np.float32)), _t(fill))
    assert set(ck.launch_counts().values()) == {0}


def test_wrapper_checks_shapes():
    x_f, x_i, rep, fill, mu, v = make_storage(0, 24, 12)
    with pytest.raises(ValueError):
        ck.apply_weighted_cov(_t(x_i), _t(mu[:5]), _t(rep), _t(v))
    with pytest.raises(ValueError):
        ck.scores_dirfix_pass(_t(x_i)[0], _t(rep), _t(v))
    with pytest.raises(ValueError):
        ck.apply_weighted_cov_block(_t(x_i), _t(mu), _t(rep),
                                    _t(np.ones((11, 2), np.float32)))
    with pytest.raises(ValueError):        # W wider than R
        ck.storage_rows_matmat(_t(x_i), _t(np.ones((2, 25), np.float32)))


def test_hopper_fit_gates():
    # 10000 x C int8 panel within 227 KB: C = 16 (160 KB); f32: C = 4
    assert ck.resolve_block_cols(10000, 1) == 16
    assert ck.resolve_block_cols(10000, 4) == 4
    assert ck.resolve_block_cols(24, 1) == 32
    assert ck.resolve_kernel_fits(10000, 1)
    assert not ck.resolve_kernel_fits(300_000, 1)
    assert ck.resolve_smem_bytes(10000, 16, 1) <= ck.SMEM_PER_BLOCK
    assert ck.fused_pca_fits(100_000, 1) and ck.fused_pca_fits(100_000, 4)
    # bfloat16 storage: 8 columns a 16-byte panel row at R = 10000
    assert ck.fused_pca_fits(100_000, 2)
    assert ck.resolve_block_cols(10000, 2) == 8
    assert not ck.fused_pca_fits(100_000, 8)
    # the one-pass block kernel is instantiated for k = 1..8; the
    # uncentered products split any k into groups of at most 16 columns
    # (storage_matmat, MAX_TILE_K) or 16 rows (storage_rows_matmat,
    # MAX_ROWS_K)
    assert (ck.MAX_BLOCK_K, ck.MAX_TILE_K, ck.MAX_ROWS_K) == (8, 16, 16)
    for fits in (ck.cov_block_kernel_fits, ck.matmat_kernels_fit):
        assert fits(100_000, 1, 1) and fits(100_000, 8, 4)
        assert fits(100_000, 5, 2)
        assert not fits(100_000, 0, 1) and not fits(100_000, 5, 8)
    assert not ck.cov_block_kernel_fits(100_000, 9, 1)
    assert ck.matmat_kernels_fit(100_000, 9, 1)
    assert ck.matmat_kernels_fit(100_000, 13, 4)


@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_resolve_ring_takes_every_gated_r(itemsize):
    """The gate keeps the first resolve kernel's answers (a one-column
    panel of at most 228,096 bytes), and at every R it admits the chunk
    ring of the column kernel finds a panel width whose shared memory fits
    one block; the width only narrows as R grows."""
    top = 228096 // itemsize
    assert ck.resolve_kernel_fits(top, itemsize)
    assert not ck.resolve_kernel_fits(top + 1, itemsize)
    assert not ck.resolve_kernel_fits(1000, 8)
    widths = []
    for R in list(range(1, top, 61)) + [top]:
        C = ck.resolve_block_cols(R, itemsize)
        assert C is not None, R
        assert ck.resolve_smem_bytes(R, C, itemsize) <= ck.SMEM_PER_BLOCK
        widths.append(C)
    assert widths == sorted(widths, reverse=True)
    assert widths[-1] == 1


def test_build_sources_exist_and_name_their_pallas_kernel():
    for src in build.SOURCES:
        text = (build.CSRC / src).read_text()
        assert "pallas_kernels.py" in text and "Bound." in text
