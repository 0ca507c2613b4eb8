"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA Hopper card and ``nvcc`` (the kernels
have no CPU mode) and skips elsewhere. The file imports neither JAX nor
the JAX package, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)

Tolerance: the kernels and the plain versions both sum in float32, in
different orders, so an output is held to ``3e-5`` of its largest
magnitude, floored at 1 (the reputation's total, which bounds the
certainty and participation sums; ``pcol = sum(rep) - tw`` cancels down
to a few percent of it). Resolve's snapped outcomes and its absent
counts (sums of ones) are exact.
"""

import numpy as np
import pytest
import torch

from pyconsensus_tpu_torch import (ConsensusParams, encode_reports_host,
                                   sharded_consensus)
from pyconsensus_tpu_torch.ops import build, cuda_kernels as ck

# ragged widths (E % 16 != 0) take the fill statistics' scalar loads and
# the element copies of the tile passes and of resolve's column panels, the
# rest the 16-byte ones; 1000 rows is not a multiple of resolve's 512-row
# passes nor of the 64-row tiles and chunks
SHAPES = [(24, 12), (23, 300), (64, 300), (64, 4096), (1000, 4099),
          (517, 2048)]
EXACT_KEYS = ("outcomes_adjusted", "outcomes_final", "na_row", "iterations",
              "convergence", "ica_converged")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def make_storage(seed, R, E, na_frac=0.1, dense=False):
    """Binary reports with absent entries as float32 (NaN) and int8
    sentinel storage, plus float32 rep / fill / mu / v. A fifth of the
    reporters collude on the anti-truth, so the first component is well
    separated. ``dense`` leaves no entry absent (the no-fill sweeps)."""
    rng = np.random.default_rng(seed)
    truth = rng.choice([0.0, 1.0], size=E)
    reports = np.tile(truth, (R, 1))
    flips = rng.random((R, E)) < 0.1
    reports = np.abs(reports - flips)
    reports[: R // 5] = 1.0 - truth
    if not dense:
        reports[rng.random((R, E)) < na_frac] = np.nan
    reports[rng.random((R, E)) < 0.05] = 0.5
    x_f = reports.astype(np.float32)
    x_i = encode_reports_host(reports)
    rep = rng.random(R).astype(np.float32)
    rep /= rep.sum()
    fill = rng.choice([0.0, 0.5, 1.0], size=E).astype(np.float32)
    filled = np.where(np.isnan(x_f), fill[None, :], x_f)
    mu = (rep @ filled).astype(np.float32)
    v = rng.standard_normal(E).astype(np.float32)
    return x_f, x_i, rep, fill, mu, v


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


RTOL = 3e-5


def _close(got, ref, what):
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    assert got.shape == ref.shape, what
    scale = max(ref.abs().max().item(), 1.0)
    err = (got - ref).abs().max().item()
    assert err <= RTOL * scale, f"{what}: max |diff| {err:.3e} > " \
        f"{RTOL} * {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("with_fill", [True, False])
def test_storage_sweeps_match_plain(dev, R, E, storage, with_fill):
    """The sztorc sweeps against their plain versions. Their row halves
    and storage_matvec are the row-tile pass at k = 1, whose tiling does
    not depend on k: each equals the k = 1 call of storage_matmat or
    apply_weighted_cov_block bit for bit (the covariance's column half is
    the k = 1 column-tile launch in both)."""
    x_f, x_i, rep, fill, mu, v = make_storage(R + E, R, E,
                                              dense=not with_fill)
    x = _t(x_i if storage == "int8" else x_f)
    f = _t(fill) if with_fill else None
    xd, mud, repd, vd = x.to(dev), _t(mu).to(dev), _t(rep).to(dev), \
        _t(v).to(dev)
    fd = None if f is None else f.to(dev)
    ref = ck.apply_weighted_cov(x, _t(mu), _t(rep), _t(v), f)
    got = ck.apply_weighted_cov(xd, mud, repd, vd, fd)
    _close(got, ref, "apply_weighted_cov")
    assert torch.equal(got, ck.apply_weighted_cov_block(
        xd, mud, repd, vd[:, None], fd)[0][:, 0])
    ref = ck.scores_dirfix_pass(x, _t(rep), _t(v), f)
    got = ck.scores_dirfix_pass(xd, repd, vd, fd)
    for name, g, r in zip("tqco", got, ref):
        _close(g, r, f"scores_dirfix {name}")
    t = ck.storage_matvec(xd, vd, fd)
    assert torch.equal(got[0], t)
    assert torch.equal(t, ck.storage_matmat(xd, vd[:, None], fd)[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
def test_resolve_matches_plain(dev, R, E, storage):
    x_f, x_i, rep, fill, mu, v = make_storage(R * 3 + E, R, E)
    x_f[:, 0] = np.nan                 # the tw > 0 fallback
    x_i[:, 0] = -1
    x = _t(x_i if storage == "int8" else x_f)
    ref = ck.resolve_certainty_fused(x, _t(rep), _t(fill), 1.0, 0.1)
    got = ck.resolve_certainty_fused(x.to(dev), _t(rep).to(dev),
                                     _t(fill).to(dev), 1.0, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got[1].cpu(), ref[1])
    assert torch.equal(got[5].cpu(), ref[5])
    for name, g, r in zip(["raw", "outcomes", "certainty", "pcol", "prow",
                           "narow"], got, ref):
        _close(g, r, f"resolve {name}")


@pytest.mark.cuda
def test_resolve_wide_rows_take_narrow_blocks(dev):
    """At R = 10000 the column kernel's panels are 16 bytes a row: 16
    int8 columns or 4 float32 ones, whose five chunks of 32 KB fill its
    ring; both agree with the plain version."""
    assert ck.resolve_block_cols(10000, 1) == 16
    assert ck.resolve_block_cols(10000, 4) == 4
    x_f, x_i, rep, fill, mu, v = make_storage(5, 10000, 203)
    for x in (_t(x_i), _t(x_f)):
        ref = ck.resolve_certainty_fused(x, _t(rep), _t(fill), 1.0, 0.1)
        got = ck.resolve_certainty_fused(x.to(dev), _t(rep).to(dev),
                                         _t(fill).to(dev), 1.0, 0.1)
        assert torch.equal(got[1].cpu(), ref[1])
        assert torch.equal(got[5].cpu(), ref[5])
        for g, r in zip(got, ref):
            _close(g, r, "resolve")


@pytest.mark.cuda
@pytest.mark.parametrize("max_iterations", [1, 3])
def test_pipeline_card_matches_cpu(dev, max_iterations):
    """Card and CPU agree key by key as in ``test_torch_pipeline.py``;
    power iteration runs a fixed sweep count so both stop at the same
    sweep (an early exit near its threshold could stop them one apart)."""
    x_f, x_i, rep, fill, mu, v = make_storage(11, 200, 1000, na_frac=0.02)
    p = ConsensusParams(storage_dtype="int8", pca_method="power",
                        max_iterations=max_iterations, power_iters=48,
                        power_tol=-1.0)
    ck.reset_launch_counts()
    a = sharded_consensus(_t(x_i).to(dev), params=p)
    counts = ck.launch_counts()
    for name in ("apply_weighted_cov", "scores_dirfix_pass",
                 "resolve_certainty_fused"):
        assert counts[name] > 0, counts
    b = sharded_consensus(_t(x_i), params=p, device="cpu")
    for key, va in a.items():
        if not isinstance(va, torch.Tensor):
            continue
        if key in EXACT_KEYS:
            assert torch.equal(va.cpu(), b[key]), key
        elif key == "first_loading":
            assert (va.abs().cpu() - b[key].abs()).abs().max() <= 1e-5, key
        else:
            assert (va.cpu().double() - b[key].double()).abs().max() \
                <= 1e-5, key


@pytest.mark.cuda
@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_block_sweeps_match_plain(dev, R, E, storage, k):
    """apply_weighted_cov_block with and without the centered
    projections, and storage_rows_matmat with a W narrower than R."""
    x_f, x_i, rep, fill, mu, v = make_storage(R * 7 + E + k, R, E)
    x = _t(x_i if storage == "int8" else x_f)
    rng = np.random.default_rng(k)
    V = _t(rng.standard_normal((E, k)).astype(np.float32))
    W = _t(rng.standard_normal((k, max(1, R - 3))).astype(np.float32))
    for emit_t in (False, True):
        ref = ck.apply_weighted_cov_block(x, _t(mu), _t(rep), V, _t(fill),
                                          emit_t=emit_t)
        got = ck.apply_weighted_cov_block(
            x.to(dev), _t(mu).to(dev), _t(rep).to(dev), V.to(dev),
            _t(fill).to(dev), emit_t=emit_t)
        _close(got[0], ref[0], f"apply_weighted_cov_block y k={k}")
        if emit_t:
            _close(got[1], ref[1], f"apply_weighted_cov_block t k={k}")
        else:
            assert got[1] is None
    ref = ck.storage_rows_matmat(x, W, _t(fill))
    got = ck.storage_rows_matmat(x.to(dev), W.to(dev), _t(fill).to(dev))
    _close(got, ref, f"storage_rows_matmat k={k}")


@pytest.mark.cuda
@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("with_fill", [True, False])
def test_uncentered_products_match_plain(dev, R, E, storage, with_fill):
    """storage_matvec, and storage_matmat and storage_rows_matmat at k up
    to 33 (one row-tile or column-tile launch up to 16 columns or rows,
    groups of 16 beyond). The tilings do not depend on k, so a column's
    or row's bits are the same in any launch: the first 16 at k = 17 and
    33 equal a k = 16 call, and the first 8 at k = 12 a k = 8 call."""
    x_f, x_i, rep, fill, mu, v = make_storage(R * 11 + E, R, E,
                                              dense=not with_fill)
    x = _t(x_i if storage == "int8" else x_f)
    f = _t(fill) if with_fill else None
    fd = None if f is None else f.to(dev)
    ref = ck.storage_matvec(x, _t(v), f)
    _close(ck.storage_matvec(x.to(dev), _t(v).to(dev), fd), ref,
           "storage_matvec")
    rng = np.random.default_rng(E)
    for k in (1, 5, 8, 12, 13, 16, 17, 33):
        V = _t(rng.standard_normal((E, k)).astype(np.float32))
        W = _t(rng.standard_normal((k, R)).astype(np.float32))
        got = ck.storage_matmat(x.to(dev), V.to(dev), fd)
        _close(got, ck.storage_matmat(x, V, f), f"storage_matmat k={k}")
        for n in {12: (8,), 17: (16,), 33: (16,)}.get(k, ()):
            first = ck.storage_matmat(x.to(dev), V[:, :n].to(dev), fd)
            assert torch.equal(got[:, :n], first), (k, n)
        got = ck.storage_rows_matmat(x.to(dev), W.to(dev), fd)
        _close(got, ck.storage_rows_matmat(x, W, f),
               f"storage_rows_matmat k={k}")
        for n in {12: (8,), 17: (16,), 33: (16,)}.get(k, ()):
            first = ck.storage_rows_matmat(x.to(dev), W[:n].to(dev), fd)
            assert torch.equal(got[:n], first), (k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 65, 1007])
@pytest.mark.parametrize("E", [300, 4096, 4099])
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("with_fill", [True, False])
def test_row_tile_ragged_rows(dev, R, E, storage, with_fill):
    """Row counts off the 64-row tile (one row, one past a tile, a ragged
    last tile) through the row-tile pass, uncentered and centered, with
    16-byte copies (E = 4096) and element copies (E = 300, 4099): at
    k = 16 and 8, and at k = 1 through the three wrappers whose row half
    it is (storage_matvec, scores_dirfix_pass, apply_weighted_cov)."""
    x_f, x_i, rep, fill, mu, v = make_storage(R * 13 + E, R, E,
                                              dense=not with_fill)
    x = _t(x_i if storage == "int8" else x_f)
    f = _t(fill) if with_fill else None
    fd = None if f is None else f.to(dev)
    xd, mud, repd, vd = x.to(dev), _t(mu).to(dev), _t(rep).to(dev), \
        _t(v).to(dev)
    _close(ck.storage_matvec(xd, vd, fd), ck.storage_matvec(x, _t(v), f),
           f"storage_matvec R={R}")
    for name, g, r in zip("tqco", ck.scores_dirfix_pass(xd, repd, vd, fd),
                          ck.scores_dirfix_pass(x, _t(rep), _t(v), f)):
        _close(g, r, f"scores_dirfix {name} R={R}")
    _close(ck.apply_weighted_cov(xd, mud, repd, vd, fd),
           ck.apply_weighted_cov(x, _t(mu), _t(rep), _t(v), f),
           f"apply_weighted_cov R={R}")
    rng = np.random.default_rng(R + E)
    V = _t(rng.standard_normal((E, 16)).astype(np.float32))
    _close(ck.storage_matmat(x.to(dev), V.to(dev), fd),
           ck.storage_matmat(x, V, f), f"storage_matmat R={R}")
    got = ck.apply_weighted_cov_block(x.to(dev), _t(mu).to(dev),
                                      _t(rep).to(dev), V[:, :8].to(dev), fd,
                                      emit_t=True)
    ref = ck.apply_weighted_cov_block(x, _t(mu), _t(rep), V[:, :8], f,
                                      emit_t=True)
    _close(got[0], ref[0], f"apply_weighted_cov_block y R={R}")
    _close(got[1], ref[1], f"apply_weighted_cov_block t R={R}")


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["int8", "float32"])
def test_row_tile_unaligned_vectors(dev, storage):
    """v, mu and fill that start at an odd float offset of a larger
    tensor: the wrappers copy them to a 16-byte boundary, so the pass
    keeps its 16-byte copies, agrees with the plain version and gives the
    bits of the aligned call."""
    R, E = 517, 4096
    x_f, x_i, rep, fill, mu, v = make_storage(R + E + 23, R, E)
    x = _t(x_i if storage == "int8" else x_f).to(dev)
    repd = _t(rep).to(dev)

    def odd(a):
        buf = torch.zeros(E + 3, dtype=torch.float32, device=dev)
        buf[1:E + 1] = _t(a).to(dev)
        out = buf[1:E + 1]
        assert out.data_ptr() % 16 != 0
        return out

    vo, muo, fo = odd(v), odd(mu), odd(fill)
    va, mua, fa = vo.clone(), muo.clone(), fo.clone()
    xh = x.cpu()
    got = ck.storage_matvec(x, vo, fo)
    _close(got, ck.storage_matvec(xh, _t(v), _t(fill)), "storage_matvec")
    assert torch.equal(got, ck.storage_matvec(x, va, fa))
    got = ck.scores_dirfix_pass(x, repd, vo, fo)
    ref = ck.scores_dirfix_pass(xh, _t(rep), _t(v), _t(fill))
    for name, g, r in zip("tqco", got, ref):
        _close(g, r, f"scores_dirfix {name}")
    for g, a in zip(got, ck.scores_dirfix_pass(x, repd, va, fa)):
        assert torch.equal(g, a)
    got = ck.apply_weighted_cov(x, muo, repd, vo, fo)
    _close(got, ck.apply_weighted_cov(xh, _t(mu), _t(rep), _t(v), _t(fill)),
           "apply_weighted_cov")
    assert torch.equal(got, ck.apply_weighted_cov(x, mua, repd, va, fa))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 65, 1007])
@pytest.mark.parametrize("E", [300, 4096, 4099])
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("with_fill", [True, False])
def test_col_tile_ragged(dev, R, E, storage, with_fill):
    """Row counts off the 64-row chunk (one row, one past a chunk, a
    ragged last chunk, none a multiple of 4, so W's chunks take element
    copies) and widths off the column tile through the column-tile pass
    at k = 1..16: uncentered through storage_rows_matmat, centered
    through apply_weighted_cov_block at k <= 8, with 16-byte copies of
    the X tile (E = 4096, and float32 at E = 300) and element copies
    (int8 at E = 300, E = 4099)."""
    x_f, x_i, rep, fill, mu, v = make_storage(R * 17 + E, R, E,
                                              dense=not with_fill)
    x = _t(x_i if storage == "int8" else x_f)
    f = _t(fill) if with_fill else None
    fd = None if f is None else f.to(dev)
    rng = np.random.default_rng(R * 3 + E)
    for k in (1, 5, 8, 12, 16):
        W = _t(rng.standard_normal((k, R)).astype(np.float32))
        _close(ck.storage_rows_matmat(x.to(dev), W.to(dev), fd),
               ck.storage_rows_matmat(x, W, f),
               f"storage_rows_matmat R={R} E={E} k={k}")
        if k > ck.MAX_BLOCK_K:
            continue
        V = _t(rng.standard_normal((E, k)).astype(np.float32))
        got = ck.apply_weighted_cov_block(x.to(dev), _t(mu).to(dev),
                                          _t(rep).to(dev), V.to(dev), fd)
        ref = ck.apply_weighted_cov_block(x, _t(mu), _t(rep), V, f)
        _close(got[0], ref[0],
               f"apply_weighted_cov_block y R={R} E={E} k={k}")


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["int8", "float32"])
@pytest.mark.parametrize("k", range(1, 9))
def test_centered_projections_match_uncentered(dev, storage, k):
    """The centered row-tile launch of apply_weighted_cov_block
    (``emit_t``) against the uncentered one of storage_matmat less
    ``1 (mu V)``: the same projections by the two instantiations."""
    R, E = 517, 2048
    x_f, x_i, rep, fill, mu, v = make_storage(R + E + k, R, E)
    x = _t(x_i if storage == "int8" else x_f).to(dev)
    V = _t(np.random.default_rng(k).standard_normal((E, k))
           .astype(np.float32)).to(dev)
    mud, fd = _t(mu).to(dev), _t(fill).to(dev)
    _, t = ck.apply_weighted_cov_block(x, mud, _t(rep).to(dev), V, fd,
                                       emit_t=True)
    ref = ck.storage_matmat(x, V, fd) - (mud @ V)[None, :]
    _close(t, ref, f"centered projections k={k}")


@pytest.mark.cuda
@pytest.mark.parametrize("max_iterations", [1, 3])
@pytest.mark.parametrize("reports", ["int8", "float"])
def test_virtual_mesh_card_matches_cpu(dev, max_iterations, reports):
    """Three shards on one card against three shards on the CPU: exact
    keys equal, the rest within 1e-5; the mesh runs on the uncentered
    products and resolve, not on the one-device sweeps. Float reports
    are encoded to int8 per call from shards of 16-column multiples."""
    from pyconsensus_tpu_torch.parallel.mesh import (make_mesh,
                                                     place_event_shards)

    x_f, x_i, rep, fill, mu, v = make_storage(17, 200, 1001, na_frac=0.02)
    x = x_i if reports == "int8" else x_f
    placed = place_event_shards(_t(x), make_mesh(devices=[dev] * 3))
    assert all(s.shape[1] % 16 == 0 for s in placed.shards)
    p = ConsensusParams(storage_dtype="int8", pca_method="power",
                        max_iterations=max_iterations, power_iters=48,
                        power_tol=-1.0)
    ck.reset_launch_counts()
    a = sharded_consensus(placed, params=p)
    counts = ck.launch_counts()
    for name in ("storage_matvec", "storage_rows_matmat",
                 "resolve_certainty_fused"):
        assert counts[name] > 0, counts
    assert counts["apply_weighted_cov"] == 0, counts
    assert counts["scores_dirfix_pass"] == 0, counts
    b = sharded_consensus(_t(x), params=p,
                          mesh=make_mesh(devices=["cpu"] * 3))
    assert set(a) == set(b)
    for key, va in a.items():
        if not isinstance(va, torch.Tensor):
            continue
        if key in EXACT_KEYS:
            assert torch.equal(va.cpu(), b[key]), key
        elif key == "first_loading":
            sign = 1.0 if float(va.cpu() @ b[key]) >= 0 else -1.0
            assert (va.cpu() * sign - b[key]).abs().max() <= 1e-5, key
        else:
            assert (va.cpu().double() - b[key].double()).abs().max() \
                <= 1e-5, key


@pytest.mark.cuda
@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("storage", ["int8", "float32"])
def test_fill_stats_matches_plain(dev, R, E, storage):
    x_f, x_i, rep, fill, mu, v = make_storage(R * 5 + E, R, E)
    x_f[:, 0] = np.nan
    x_i[:, 0] = -1
    x = _t(x_i if storage == "int8" else x_f)
    ref = ck.fill_stats_pass(x, _t(rep))
    got = ck.fill_stats_pass(x.to(dev), _t(rep).to(dev))
    for name, g, r in zip(("tw", "numer"), got, ref):
        _close(g, r, f"fill_stats {name}")
    assert float(got[0][0]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["fixed-variance", "ica"])
@pytest.mark.parametrize("max_iterations", [1, 3])
def test_multi_component_card_matches_cpu(dev, algorithm, max_iterations):
    """Card and CPU on the multi-component path: exact keys equal, the
    continuous ones within the 2e-3 band the CPU tests hold the port to
    against the reference (the orthogonal iteration's exit is not pinned
    to a sweep count)."""
    x_f, x_i, rep, fill, mu, v = make_storage(13, 200, 1000, na_frac=0.02)
    p = ConsensusParams(storage_dtype="int8", pca_method="power",
                        algorithm=algorithm, max_iterations=max_iterations)
    ck.reset_launch_counts()
    a = sharded_consensus(_t(x_i).to(dev), params=p)
    counts = ck.launch_counts()
    for name in ("apply_weighted_cov_block", "storage_rows_matmat",
                 "resolve_certainty_fused"):
        assert counts[name] > 0, counts
    b = sharded_consensus(_t(x_i), params=p, device="cpu")
    assert set(a) == set(b)
    for key, va in a.items():
        if not isinstance(va, torch.Tensor):
            continue
        if key in EXACT_KEYS:
            assert torch.equal(va.cpu(), b[key]), key
        elif key == "first_loading":
            assert (va.abs().cpu() - b[key].abs()).abs().max() <= 2e-3, key
        else:
            assert (va.cpu().double() - b[key].double()).abs().max() \
                <= 2e-3, key


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["fixed-variance", "ica"])
def test_separable_arm_card_matches_cpu(dev, algorithm):
    """12 components: the separable arm of the orthogonal iteration on
    the card (storage_matmat, not the block kernel) against the CPU,
    within the multi-component band. At 200 x 1000 this generator leaves
    ica's twelve-dimensional whitening space mostly noise bulk, and its
    FastICA result moves by 7e-3 between float32 and float64 summation
    on the CPU alone; at 512 x 2048 the two agree within 3e-7."""
    x_f, x_i, rep, fill, mu, v = make_storage(19, 512, 2048, na_frac=0.02)
    p = ConsensusParams(storage_dtype="int8", pca_method="power",
                        algorithm=algorithm, max_components=12)
    ck.reset_launch_counts()
    a = sharded_consensus(_t(x_i).to(dev), params=p)
    counts = ck.launch_counts()
    assert counts["storage_matmat"] > 0, counts
    assert counts["apply_weighted_cov_block"] == 0, counts
    b = sharded_consensus(_t(x_i), params=p, device="cpu")
    for key, va in a.items():
        if not isinstance(va, torch.Tensor):
            continue
        if key in EXACT_KEYS:
            assert torch.equal(va.cpu(), b[key]), key
        elif key == "first_loading":
            assert (va.abs().cpu() - b[key].abs()).abs().max() <= 2e-3, key
        else:
            assert (va.cpu().double() - b[key].double()).abs().max() \
                <= 2e-3, key


@pytest.mark.cuda
def test_no_fallback_when_library_missing(dev, monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "none")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    x_f, x_i, rep, fill, mu, v = make_storage(0, 24, 12)
    with pytest.raises(RuntimeError, match="nvcc"):
        ck.apply_weighted_cov(_t(x_i).to(dev), _t(mu).to(dev),
                              _t(rep).to(dev), _t(v).to(dev),
                              _t(fill).to(dev))


def _resolve_both(x, rep, fill, dev, tolerance=0.1):
    ref = ck.resolve_certainty_fused(x, _t(rep), _t(fill), 1.0, tolerance)
    got = ck.resolve_certainty_fused(x.to(dev), _t(rep).to(dev),
                                     _t(fill).to(dev), 1.0, tolerance)
    torch.cuda.synchronize()
    return got, ref


def _resolve_agrees(got, ref, what):
    """Snapped outcomes and absent counts equal, the rest within RTOL."""
    assert torch.equal(got[1].cpu(), ref[1]), f"{what}: outcomes"
    assert torch.equal(got[5].cpu(), ref[5]), f"{what}: absent counts"
    for name, g, r in zip(["raw", "outcomes", "certainty", "pcol", "prow",
                           "narow"], got, ref):
        _close(g, r, f"{what} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 513, 1037])
@pytest.mark.parametrize("E", [17, 203, 4099])
@pytest.mark.parametrize("storage", ["int8", "float32", "float32 offset"])
def test_resolve_ragged(dev, R, E, storage):
    """R not a multiple of the column kernel's 512-row passes, E not a
    multiple of its panel width, and (``float32 offset``) a float32 matrix
    that starts 4 bytes past a 16-byte boundary, so that no row is
    16-byte aligned and every granule takes the element copies."""
    x_f, x_i, rep, fill, mu, v = make_storage(R * 7 + E, R, E)
    x_f[:, 0] = np.nan
    x_i[:, 0] = -1
    x = _t(x_i if storage == "int8" else x_f)
    ref = ck.resolve_certainty_fused(x, _t(rep), _t(fill), 1.0, 0.1)
    xd = x.to(dev)
    if storage == "float32 offset":
        buf = torch.empty(R * E + 1, dtype=torch.float32, device=dev)
        xd = buf[1:].view(R, E)
        xd.copy_(x.to(dev))
        assert xd.is_contiguous() and xd.data_ptr() % 16 == 4
    got = ck.resolve_certainty_fused(xd, _t(rep).to(dev), _t(fill).to(dev),
                                     1.0, 0.1)
    torch.cuda.synchronize()
    _resolve_agrees(got, ref, f"resolve {storage} {R}x{E}")


@pytest.mark.cuda
@pytest.mark.parametrize("itemsize", [1, 4])
def test_resolve_largest_gated_r(dev, itemsize):
    """The largest R the gate admits (228096 int8, 57024 float32): one
    column a panel, whose chunks fill the whole ring, so the next panel's
    copies wait for walk 2 to free each slot."""
    R = 228096 // itemsize
    assert ck.resolve_kernel_fits(R, itemsize)
    assert not ck.resolve_kernel_fits(R + 1, itemsize)
    assert ck.resolve_block_cols(R, itemsize) == 1
    assert ck.resolve_smem_bytes(R, 1, itemsize) <= ck.SMEM_PER_BLOCK
    x_f, x_i, rep, fill, mu, v = make_storage(R, R, 37)
    x = _t(x_i if itemsize == 1 else x_f)
    got, ref = _resolve_both(x, rep, fill, dev)
    _resolve_agrees(got, ref, f"resolve R={R}")


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["int8", "float32"])
def test_resolve_repeats_bitwise(dev, storage):
    """Two calls give the same bits: no float atomics, and every sum's
    order is fixed by the thread mapping, not by scheduling."""
    x_f, x_i, rep, fill, mu, v = make_storage(11, 3000, 5003)
    x = _t(x_i if storage == "int8" else x_f).to(dev)
    a = ck.resolve_certainty_fused(x, _t(rep).to(dev), _t(fill).to(dev), 1.0,
                                   0.1)
    b = ck.resolve_certainty_fused(x, _t(rep).to(dev), _t(fill).to(dev), 1.0,
                                   0.1)
    for u, w in zip(a, b):
        assert torch.equal(u, w)


@pytest.mark.cuda
def test_resolve_knife_edge_snaps_like_plain(dev):
    """A column whose mean sits on the catch boundary (0.75 at tolerance
    0.25) snaps on the card as the plain version snaps it."""
    R, E = 24, 12
    x = np.zeros((R, E), np.int8)
    x[:, 0] = np.r_[np.full(18, 2), np.zeros(6)].astype(np.int8)  # 0.75
    x[:, 1] = np.r_[np.full(14, 2), np.zeros(10)].astype(np.int8)
    x[:, 2] = np.r_[np.full(6, 2), np.zeros(18)].astype(np.int8)   # 0.25
    rep = np.full(R, 1.0 / R, np.float32)
    fill = np.full(E, 0.5, np.float32)
    xf = np.where(x < 0, np.nan, x * 0.5).astype(np.float32)
    for xs in (_t(x), _t(xf)):
        got, ref = _resolve_both(xs, rep, fill, dev, tolerance=0.25)
        assert torch.equal(got[1].cpu(), ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["int8", "float32"])
def test_resolve_absent_counts_exact(dev, storage):
    """The row half's ``na_count_rows`` equals the count of sentinels
    (int8) or NaNs (float32) in each row, exactly."""
    x_f, x_i, rep, fill, mu, v = make_storage(29, 777, 40000, na_frac=0.3)
    x = _t(x_i if storage == "int8" else x_f).to(dev)
    got = ck.resolve_certainty_fused(x, _t(rep).to(dev), _t(fill).to(dev),
                                     1.0, 0.1)
    absent = (x < 0) if storage == "int8" else torch.isnan(x)
    assert torch.equal(got[5], absent.sum(dim=1).to(torch.float32))


# -- the plain core over the dense filled matrix ------------------------------

def plain_inputs(seed, R=203, E=1037, n_scaled=150):
    """Ragged shapes (R % 8 != 0, E % 16 != 0), 5% absent, the last
    ``n_scaled`` events scaled on [-5, 15] (more than E // 8, so the
    front door takes the plain core)."""
    x_f, _, rep, _, _, _ = make_storage(seed, R, E, na_frac=0.05)
    reports = x_f.astype(np.float64)
    reports[:, E - n_scaled:] = 20.0 * reports[:, E - n_scaled:] - 5.0
    bounds = ([None] * (E - n_scaled)
              + [{"scaled": True, "min": -5.0, "max": 15.0}] * n_scaled)
    return reports, bounds, rep


def _compare(a, b, atol, scaled_from):
    for key, va in a.items():
        if not isinstance(va, torch.Tensor):
            continue
        vb = b[key].cpu()
        va = va.cpu()
        if key in ("outcomes_adjusted", "outcomes_final"):
            assert torch.equal(va[:scaled_from], vb[:scaled_from]), key
            span = 20.0 if key == "outcomes_final" else 1.0
            assert (va.double() - vb.double()).abs().max() <= span * atol, key
        elif key in EXACT_KEYS:
            assert torch.equal(va, vb), key
        elif key == "first_loading":
            assert (va.abs() - vb.abs()).abs().max() <= atol, key
        else:                           # "original" keeps its NaN
            assert torch.allclose(va.double(), vb.double(), rtol=0,
                                  atol=atol, equal_nan=True), key


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["eigh-cov", "eigh-gram", "power-fused"])
@pytest.mark.parametrize("algorithm,atol", [("sztorc", 1e-5),
                                            ("fixed-variance", 2e-3),
                                            ("ica", 2e-3)])
def test_plain_core_card_matches_cpu(dev, method, algorithm, atol):
    """The Oracle's plain core on the card against its own CPU run in
    float32, with scaled events: ``power-fused`` sztorc launches
    ``apply_weighted_cov`` and ``scores_dirfix_pass`` (never resolve's
    kernel), every other arm no storage kernel."""
    from pyconsensus_tpu_torch import Oracle

    reports, bounds, rep = plain_inputs(31)
    kw = dict(reports=reports, event_bounds=bounds, reputation=rep,
              algorithm=algorithm, pca_method=method, max_iterations=3,
              power_iters=64, power_tol=-1.0)
    ck.reset_launch_counts()
    a = Oracle(backend="torch", **kw).resolve_raw()
    counts = ck.launch_counts()
    fused = algorithm == "sztorc" and method == "power-fused"
    for name, n in counts.items():
        if fused and name in ("apply_weighted_cov", "scores_dirfix_pass"):
            assert n > 0, counts
        else:
            assert n == 0, counts
    b = Oracle(backend="torch", device="cpu", **kw).resolve_raw()
    assert set(a) == set(b)
    _compare(a, b, atol, reports.shape[1] - 150)


@pytest.mark.cuda
def test_plain_core_float64_on_the_card_sweeps_in_float32(dev):
    """The kernels compute in float32, as the reference's do under x64:
    under a float64 default dtype ``power-fused`` sweeps a float32 copy
    of the filled matrix on the card, launches ``apply_weighted_cov`` and
    ``scores_dirfix_pass``, keeps its results in float64, and agrees with
    its CPU run (the kernels' plain versions) within 1e-5."""
    from pyconsensus_tpu_torch import Oracle

    reports, bounds, rep = plain_inputs(37)
    kw = dict(reports=reports, event_bounds=bounds, reputation=rep,
              pca_method="power-fused", max_iterations=3, power_iters=64,
              power_tol=-1.0)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        ck.reset_launch_counts()
        a = Oracle(**kw).resolve_raw()
        counts = ck.launch_counts()
        b = Oracle(device="cpu", **kw).resolve_raw()
    finally:
        torch.set_default_dtype(prev)
    assert counts["apply_weighted_cov"] > 0, counts
    assert counts["scores_dirfix_pass"] > 0, counts
    assert counts["resolve_certainty_fused"] == 0, counts
    assert a["smooth_rep"].dtype == torch.float64
    _compare(a, b, 1e-5, reports.shape[1] - 150)


@pytest.mark.cuda
@pytest.mark.parametrize("max_iterations", [1, 3])
def test_front_door_scaled_beyond_e8_takes_the_plain_core(dev,
                                                          max_iterations):
    """``sharded_consensus`` with more than E // 8 scaled events: the
    fused gate closes, the plain core runs sztorc's sweeps on the
    kernels over the dense filled matrix, and agrees with the CPU."""
    reports, bounds, rep = plain_inputs(41)
    p = ConsensusParams(pca_method="power-fused", power_iters=64,
                        power_tol=-1.0, max_iterations=max_iterations)
    x = reports.astype(np.float32)
    ck.reset_launch_counts()
    a = sharded_consensus(_t(x).to(dev), event_bounds=bounds, params=p)
    counts = ck.launch_counts()
    assert counts["apply_weighted_cov"] > 0, counts
    assert counts["scores_dirfix_pass"] == max_iterations, counts
    assert counts["resolve_certainty_fused"] == 0, counts
    b = sharded_consensus(x, event_bounds=bounds, params=p, device="cpu")
    _compare(a, b, 1e-5, reports.shape[1] - 150)


# -- bfloat16 storage ---------------------------------------------------------

def bf16_storage(seed, R, E, na_frac=0.1, offset=False):
    """bfloat16 storage of binary reports whose last eighth of the columns
    is scaled (continuous values in [0, 1]), NaN absent, with its first and
    last columns all absent; a fill continuous on the scaled columns.
    ``offset`` puts the matrix 2 bytes past a 16-byte boundary (a view of
    a larger buffer). Returns ``(x bf16 (CPU), rep, fill, mu, v)``."""
    x_f, _, rep, fill, _, v = make_storage(seed, R, E, na_frac=na_frac)
    rng = np.random.default_rng(seed + 1)
    n_sc = max(1, E // 8)
    x_f[:, E - n_sc:] = np.where(np.isnan(x_f[:, E - n_sc:]), np.nan,
                                 rng.random((R, n_sc)))
    x_f[:, 0] = np.nan
    x_f[:, -1] = np.nan
    fill[E - n_sc:] = rng.random(n_sc).astype(np.float32)
    x = _t(x_f).to(torch.bfloat16)
    if offset:
        buf = torch.empty(R * E + 8, dtype=torch.bfloat16)
        x = buf[1:1 + R * E].view(R, E).copy_(x)
    xf = x.float().numpy()
    mu = (rep @ np.where(np.isnan(xf), fill[None, :], xf)).astype(np.float32)
    return x, rep, fill, mu, v


def _bf16_launches(x, rep, fill, mu, v, k_block=5, k_wide=17):
    """Every wrapper over storage ``x`` (on its device): name -> output
    tuple."""
    E, R = x.shape[1], x.shape[0]
    g = torch.Generator().manual_seed(E)
    V = torch.randn((E, k_wide), generator=g).to(x.device)
    W = torch.randn((k_wide, R), generator=g).to(x.device)
    rep, fill, mu, v = (_t(a).to(x.device) for a in (rep, fill, mu, v))
    return {
        "apply_weighted_cov": (ck.apply_weighted_cov(x, mu, rep, v, fill),),
        "apply_weighted_cov dense": (ck.apply_weighted_cov(
            torch.nan_to_num(x, nan=0.5), mu, rep, v),),
        "scores_dirfix_pass": ck.scores_dirfix_pass(x, rep, v, fill),
        "storage_matvec": (ck.storage_matvec(x, v, fill),),
        "storage_matmat": (ck.storage_matmat(x, V, fill),),
        "storage_rows_matmat": (ck.storage_rows_matmat(x, W, fill),),
        "apply_weighted_cov_block": ck.apply_weighted_cov_block(
            x, mu, rep, V[:, :k_block], fill, emit_t=True),
        "resolve_certainty_fused": ck.resolve_certainty_fused(x, rep, fill,
                                                              1.0, 0.1),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("R,E", SHAPES + [(65, 4097), (1, 301)])
@pytest.mark.parametrize("offset", [False, True])
def test_bf16_launches_match_plain(dev, R, E, offset):
    """Each bfloat16 launch against its plain version at ragged R and E
    (an odd E puts every other row 2 bytes off a 16-byte boundary;
    ``offset`` the whole matrix), with NaN in the first and last column
    and continuous fills; resolve's snapped outcomes and absent counts
    exact."""
    x, rep, fill, mu, v = bf16_storage(R * 5 + E, R, E, offset=offset)
    assert (x.data_ptr() % 16 != 0) == offset
    got = _bf16_launches(x.to(dev) if not offset else _offset_on(x, dev),
                         rep, fill, mu, v)
    torch.cuda.synchronize()
    ref = _bf16_launches(x, rep, fill, mu, v)
    for name, outs in ref.items():
        for i, (a, b) in enumerate(zip(got[name], outs)):
            if b is None:
                continue
            assert torch.isfinite(a).all(), name
            _close(a, b, f"{name} [{i}]")
    for i in (1, 5):
        assert torch.equal(got["resolve_certainty_fused"][i].cpu(),
                           ref["resolve_certainty_fused"][i])


def _offset_on(x, dev):
    """``x`` on ``dev`` as a view 2 bytes past a 16-byte boundary."""
    R, E = x.shape
    buf = torch.empty(R * E + 8, dtype=x.dtype, device=dev)
    out = buf[1:1 + R * E].view(R, E)
    out.copy_(x.to(dev))
    assert out.data_ptr() % 16 == 2
    return out


@pytest.mark.cuda
def test_bf16_every_launch_counts(dev):
    """Each wrapper launches its kernel on bfloat16 storage (the counts
    rise by one a call) and none takes a plain version on the card."""
    x, rep, fill, mu, v = bf16_storage(3, 200, 1003)
    ck.reset_launch_counts()
    _bf16_launches(x.to(dev), rep, fill, mu, v)
    counts = ck.launch_counts()
    for name in ("apply_weighted_cov", "scores_dirfix_pass", "storage_matvec",
                 "storage_matmat", "storage_rows_matmat",
                 "apply_weighted_cov_block", "resolve_certainty_fused"):
        assert counts[name] >= 1, counts
    assert counts["apply_weighted_cov"] == 2 and counts["fill_stats_pass"] \
        == 0, counts
    with pytest.raises(TypeError, match="fill_stats_pass"):
        ck.fill_stats_pass(x.to(dev), _t(rep).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1003, 4096])
def test_bf16_tile_passes_are_k_independent(dev, E):
    """The row-tile and column-tile passes on bfloat16 take each output
    column or row in the same order at any k: the first columns of a
    k = 16 launch equal a k = 3 launch bit for bit, and the matvec equals
    the k = 1 block call."""
    x, rep, fill, mu, v = bf16_storage(7, 333, E)
    xd = x.to(dev)
    fd, vd = _t(fill).to(dev), _t(v).to(dev)
    g = torch.Generator().manual_seed(1)
    V = torch.randn((E, 16), generator=g).to(dev)
    W = torch.randn((16, 333), generator=g).to(dev)
    wide = ck.storage_matmat(xd, V, fd)
    assert torch.equal(wide[:, :3], ck.storage_matmat(xd, V[:, :3], fd))
    rows = ck.storage_rows_matmat(xd, W, fd)
    assert torch.equal(rows[:3], ck.storage_rows_matmat(xd, W[:3], fd))
    assert torch.equal(ck.storage_matvec(xd, vd, fd),
                       ck.storage_matmat(xd, vd[:, None], fd)[:, 0])
    mud, repd = _t(mu).to(dev), _t(rep).to(dev)
    y8 = ck.apply_weighted_cov_block(xd, mud, repd, V[:, :8], fd)[0]
    y2 = ck.apply_weighted_cov_block(xd, mud, repd, V[:, :2], fd)[0]
    assert torch.equal(y8[:, :2], y2)


@pytest.mark.cuda
def test_bf16_repeats_bitwise(dev):
    """A second call of every bfloat16 launch gives the same bits."""
    x, rep, fill, mu, v = bf16_storage(9, 1000, 4099)
    xd = x.to(dev)
    a = _bf16_launches(xd, rep, fill, mu, v)
    b = _bf16_launches(xd, rep, fill, mu, v)
    for name in a:
        for u, w in zip(a[name], b[name]):
            if u is not None:
                assert torch.equal(u, w), name


@pytest.mark.cuda
def test_bf16_resolve_largest_gated_r(dev):
    """The largest R the gate admits at bfloat16 (114,048: a one-column
    panel of 228,096 bytes), one column a panel."""
    R = 228096 // 2
    assert ck.resolve_kernel_fits(R, 2) and not ck.resolve_kernel_fits(R + 1,
                                                                        2)
    assert ck.resolve_block_cols(R, 2) == 1
    x, rep, fill, mu, v = bf16_storage(R, R, 37)
    got, ref = _resolve_both(x, rep, fill, dev)
    _resolve_agrees(got, ref, f"resolve bfloat16 R={R}")


def scaled_minority(seed, R=203, E=1037, n_scaled=100):
    """Ragged shapes, 5% absent, the last ``n_scaled`` events (at most
    E // 8) scaled on [-5, 15]: the fused path with its gather-median
    tail."""
    reports, bounds, rep = plain_inputs(seed, R, E, n_scaled)
    assert n_scaled <= E // 8
    return reports, bounds, rep


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,atol", [("sztorc", 1e-5),
                                            ("fixed-variance", 2e-3),
                                            ("ica", 2e-3)])
@pytest.mark.parametrize("storage", ["bfloat16", ""])
def test_scaled_fused_card_matches_cpu(dev, algorithm, atol, storage):
    """The fused path with scaled events on the card against its CPU run:
    the kernels launch (bfloat16 or float32 storage), the tail re-resolves
    the scaled columns, and the keys agree (binary outcomes exact)."""
    reports, bounds, rep = scaled_minority(43)
    p = ConsensusParams(algorithm=algorithm, pca_method="power",
                        storage_dtype=storage, power_iters=64,
                        power_tol=-1.0, max_iterations=3)
    x = reports.astype(np.float32)
    ck.reset_launch_counts()
    a = sharded_consensus(_t(x).to(dev), reputation=_t(rep).to(dev),
                          event_bounds=bounds, params=p)
    counts = ck.launch_counts()
    arm = ("apply_weighted_cov", "scores_dirfix_pass") \
        if algorithm == "sztorc" else ("apply_weighted_cov_block",
                                       "storage_rows_matmat")
    for name in arm + ("resolve_certainty_fused",):
        assert counts[name] > 0, counts
    b = sharded_consensus(x, reputation=rep, event_bounds=bounds, params=p,
                          device="cpu")
    _compare(a, b, atol, reports.shape[1] - 100)


@pytest.mark.cuda
@pytest.mark.parametrize("storage,matvec", [("bfloat16", ""),
                                            ("", "bfloat16")])
def test_plain_core_bf16_card_matches_cpu(dev, storage, matvec):
    """The plain core's bfloat16 filled matrix (or bfloat16 sweeps):
    ``power-fused`` sztorc sweeps it on B.1 and B.2 at bfloat16 on the
    card and agrees with its CPU run."""
    from pyconsensus_tpu_torch import Oracle

    reports, bounds, rep = plain_inputs(47)
    kw = dict(reports=reports, event_bounds=bounds, reputation=rep,
              pca_method="power-fused", max_iterations=3, power_iters=64,
              power_tol=-1.0, storage_dtype=storage, matvec_dtype=matvec)
    ck.reset_launch_counts()
    a = Oracle(**kw).resolve_raw()
    counts = ck.launch_counts()
    b = Oracle(device="cpu", **kw).resolve_raw()
    assert counts["apply_weighted_cov"] > 0, counts
    assert counts["scores_dirfix_pass"] > 0, counts
    assert counts["resolve_certainty_fused"] == 0, counts
    _compare(a, b, 1e-5, reports.shape[1] - 150)


# -- ShardedOracle and the fallback chain on the card -------------------------

def _oracle_inputs(seed, R=300, E=2000):
    """Binary collusion reports with NaN non-reports, float64 on the
    host (the Oracle's intake)."""
    x_f, _, _, _, _, _ = make_storage(seed, R, E, na_frac=0.05)
    return x_f.astype(np.float64)


def _nested_agree(got, ref, atol, what):
    """Oracle results: exact keys equal, the rest within ``atol``."""
    assert int(got["iterations"]) == int(ref["iterations"]), what
    for group in ("agents", "events"):
        assert set(got[group]) == set(ref[group]), what
        for key, a in ref[group].items():
            a, b = np.asarray(a), np.asarray(got[group][key])
            if key in EXACT_KEYS:
                assert np.array_equal(b, a), f"{what}: {key}"
            elif key == "adj_first_loadings":
                assert np.abs(np.abs(b) - np.abs(a)).max() <= atol, key
            else:
                assert np.abs(b.astype(np.float64) - a).max() <= atol, key


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_oracle_card_matches_cpu(dev, shards):
    """``ShardedOracle`` on int8 storage on the card (one shard, or a
    virtual mesh of four on card 0) against its CPU mesh: B.1-B.3 launch
    (the mesh's matvecs in place of B.1), placed or not the same bits."""
    from pyconsensus_tpu_torch import ShardedOracle
    from pyconsensus_tpu_torch.parallel import make_mesh

    reports = _oracle_inputs(61)
    kw = dict(reports=reports, storage_dtype="int8", pca_method="power",
              power_iters=48, power_tol=-1.0, max_iterations=3)
    card = ShardedOracle(mesh=make_mesh(devices=[dev] * shards), **kw)
    ck.reset_launch_counts()
    a = card.consensus()
    counts = ck.launch_counts()
    arm = ("storage_matvec", "storage_rows_matmat") if shards > 1 else (
        "apply_weighted_cov", "scores_dirfix_pass")
    for name in arm + ("resolve_certainty_fused",):
        assert counts[name] > 0, counts
    b = ShardedOracle(mesh=make_mesh(devices=["cpu"] * shards),
                      **kw).consensus()
    _nested_agree(a, b, 1e-5, f"{shards} shards")
    again = card.place().consensus()
    for group in ("agents", "events"):
        for key, v in a[group].items():
            assert np.array_equal(np.asarray(again[group][key]),
                                  np.asarray(v)), key


@pytest.mark.cuda
def test_fallback_hop_on_the_card(dev):
    """A NaN storm at the fetch walks ``power-fused -> eigh-gram`` on the
    card: one hop counted, the recovered outcomes those of a clean
    ``pca_method="eigh-gram"`` resolution on the card, and the recovered
    result the CPU recovery's within sztorc's band."""
    from pyconsensus_tpu_torch import Oracle, ShardedOracle, faults, obs

    reports = _oracle_inputs(67)
    kw = dict(reports=reports, storage_dtype="int8", max_iterations=3,
              pca_method="power-fused")
    labels = {"from": "power-fused", "to": "eigh-gram",
              "reason": "nonfinite_result"}
    storm = {"site": "oracle.raw_result", "kind": "nan_storm",
             "occurrences": [0], "args": {"fraction": 1.0}}
    got = {}
    for where in (dev, "cpu"):
        before = obs.value("pyconsensus_fallbacks_total", **labels) or 0
        oracle = ShardedOracle(device=where, **kw)
        with faults.armed(faults.FaultPlan(seed=0, rules=[storm])):
            got[str(where)] = oracle.consensus()
        assert obs.value("pyconsensus_fallbacks_total",
                         **labels) == before + 1
    clean = Oracle(reports=reports, pca_method="eigh-gram",
                   max_iterations=3).consensus()
    recovered = got[str(dev)]
    assert np.array_equal(recovered["events"]["outcomes_final"],
                          clean["events"]["outcomes_final"])
    assert np.isfinite(recovered["agents"]["smooth_rep"]).all()
    _nested_agree(recovered, got["cpu"], 1e-5, "card vs cpu recovery")


@pytest.mark.cuda
@pytest.mark.parametrize("sharded", [False, True])
def test_launch_failure_propagates_and_starts_no_rung(dev, monkeypatch,
                                                      sharded):
    """A launch that reports an error (the wrappers' error check made to
    fail) leaves ``consensus()`` as a RuntimeError; no fallback hop is
    counted and no rung runs."""
    from pyconsensus_tpu_torch import Oracle, ShardedOracle, obs

    def failed(err, what):
        raise RuntimeError(f"{what}: CUDA launch failed with error 700")

    monkeypatch.setattr(ck, "_raise_on", failed)
    reports = _oracle_inputs(71)
    oracle = (ShardedOracle(reports=reports, storage_dtype="int8",
                            pca_method="power-fused")
              if sharded else
              Oracle(reports=reports, pca_method="power-fused"))
    before = obs.REGISTRY.snapshot().get("pyconsensus_fallbacks_total")
    with pytest.raises(RuntimeError, match="launch failed"):
        oracle.consensus()
    assert obs.REGISTRY.snapshot().get(
        "pyconsensus_fallbacks_total") == before


# -- the clustering variants on the card ---------------------------------------

def _cluster_knobs(algorithm, E):
    """Radii that follow the geometry of ``make_storage``'s reports:
    honest pairs sit near d^2 = 0.17 E, honest-liar pairs near 0.8 E."""
    radius = float(np.sqrt(0.4 * E))
    return {"k-means": {"num_clusters": 2},
            "dbscan-jit": {"dbscan_eps": radius, "dbscan_min_samples": 4},
            "hierarchical": {"hierarchy_threshold": radius},
            "dbscan": {"dbscan_eps": radius,
                       "dbscan_min_samples": 4}}[algorithm]


def _same_partition(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.array_equal(np.isclose(a[:, None], a[None, :], rtol=1e-5,
                                     atol=0),
                          np.isclose(b[:, None], b[None, :], rtol=1e-5,
                                     atol=0))


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["k-means", "dbscan-jit",
                                       "hierarchical", "dbscan"])
@pytest.mark.parametrize("sharded", [False, True])
def test_clustering_card_matches_cpu(dev, algorithm, sharded):
    """The clustering variants at 512 x 2048, the ``Oracle`` (or
    ``ShardedOracle``) on the card against its CPU run in float32: exact
    keys equal, the clusters (through ``this_rep``) and the reputation's
    order equal, the rest within 1e-5; no storage kernel launches; the
    hybrid two cluster through the native library."""
    from pyconsensus_tpu_torch import Oracle, ShardedOracle, obs

    reports = _oracle_inputs(81, R=512, E=2048)
    cls = ShardedOracle if sharded else Oracle
    kw = dict(reports=reports, algorithm=algorithm, max_iterations=3,
              **_cluster_knobs(algorithm, reports.shape[1]))
    obs.reset()
    ck.reset_launch_counts()
    a = cls(**kw).consensus()
    assert not any(ck.launch_counts().values()), ck.launch_counts()
    spans = [e for e in obs.events()
             if e["name"] in ("clustering.hierarchical", "clustering.dbscan")]
    if algorithm in ("hierarchical", "dbscan"):
        assert spans and all(e["attrs"]["native"] for e in spans)
    b = cls(device="cpu", **kw).consensus()
    _nested_agree(a, b, 1e-5, algorithm)
    assert _same_partition(a["agents"]["this_rep"], b["agents"]["this_rep"])
    assert np.array_equal(np.argsort(a["agents"]["smooth_rep"],
                                     kind="stable"),
                          np.argsort(b["agents"]["smooth_rep"],
                                     kind="stable"))
