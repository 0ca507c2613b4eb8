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
