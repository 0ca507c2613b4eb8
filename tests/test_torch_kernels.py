"""The port's kernel wrappers against the Pallas kernels (interpret mode).

On the CPU each wrapper runs its plain torch version; the same numpy
inputs (float32 throughout) go through ``pyconsensus_tpu``'s Pallas
kernel with ``interpret=True``. Tolerances allow float32 sums taken in
another order and the TPU kernels' compensated dots (about 2^-17
relative): apply_weighted_cov rtol 3e-5 / atol 1e-6, scores_dirfix and
resolve rtol 1e-5 / atol 1e-6; resolve's snapped outcomes are exact.

The CUDA kernels themselves are held against the plain versions on the
card in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyconsensus_tpu.ops import pallas_kernels as pk
from pyconsensus_tpu_torch.ops import build, cuda_kernels as ck

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
    for name, g, r in zip("tqco", got, ref):
        _close(g.numpy(), r, 1e-5, 1e-6, f"scores_dirfix {name}")


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


def test_cpu_calls_are_not_launches():
    ck.reset_launch_counts()
    x_f, x_i, rep, fill, mu, v = make_storage(0, 24, 12)
    ck.apply_weighted_cov(_t(x_i), _t(mu), _t(rep), _t(v), _t(fill))
    ck.scores_dirfix_pass(_t(x_i), _t(rep), _t(v), _t(fill))
    ck.resolve_certainty_fused(_t(x_i), _t(rep), _t(fill), 1.0, 0.1)
    assert set(ck.launch_counts().values()) == {0}


def test_wrapper_checks_shapes():
    x_f, x_i, rep, fill, mu, v = make_storage(0, 24, 12)
    with pytest.raises(ValueError):
        ck.apply_weighted_cov(_t(x_i), _t(mu[:5]), _t(rep), _t(v))
    with pytest.raises(ValueError):
        ck.scores_dirfix_pass(_t(x_i)[0], _t(rep), _t(v))


def test_hopper_fit_gates():
    # 10000 x C int8 panel within 227 KB: C = 16 (160 KB); f32: C = 4
    assert ck.resolve_block_cols(10000, 1) == 16
    assert ck.resolve_block_cols(10000, 4) == 4
    assert ck.resolve_block_cols(24, 1) == 32
    assert ck.resolve_kernel_fits(10000, 1)
    assert not ck.resolve_kernel_fits(300_000, 1)
    assert ck.resolve_smem_bytes(10000, 16, 1) <= ck.SMEM_PER_BLOCK
    assert ck.fused_pca_fits(100_000, 1) and ck.fused_pca_fits(100_000, 4)
    assert not ck.fused_pca_fits(100_000, 2)


def test_build_sources_exist_and_name_their_pallas_kernel():
    for src in build.SOURCES:
        text = (build.CSRC / src).read_text()
        assert "pallas_kernels.py" in text and "Bound." in text
