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


# -- the clustering variants on the card --------------------------------------

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


# -- every algorithm on an event mesh ----------------------------------------

MESH_FUSED = ("storage_matvec", "storage_rows_matmat",
              "resolve_certainty_fused")


def _on_card(out, dev):
    """Every tensor of a mesh result lives on the mesh's first card."""
    for key, v in out.items():
        if isinstance(v, torch.Tensor):
            assert v.device.type == dev.type, key


@pytest.mark.cuda
@pytest.mark.parametrize("storage,matvec", [("bfloat16", ""),
                                            ("bfloat16", "bfloat16"),
                                            ("", "bfloat16")])
def test_mesh_fused_scaled_card_matches_cpu(dev, storage, matvec):
    """sztorc on the fused mesh, four shards on one card, with 100 scaled
    of 1037 events (each shard's gather-median tail) against four CPU
    shards: B.5, B.6 and B.3 launch on every shard (at least one launch a
    shard a sweep), never the one-device sweeps; binary outcomes equal,
    scaled ones within 1e-5 of the span."""
    from pyconsensus_tpu_torch.parallel.mesh import make_mesh

    reports, bounds, rep = scaled_minority(53)
    p = ConsensusParams(pca_method="power", storage_dtype=storage,
                        matvec_dtype=matvec, power_iters=64, power_tol=-1.0,
                        max_iterations=3)
    x = reports.astype(np.float32)
    ck.reset_launch_counts()
    a = sharded_consensus(x, reputation=rep, event_bounds=bounds, params=p,
                          mesh=make_mesh(devices=[dev] * 4))
    counts = ck.launch_counts()
    assert counts["resolve_certainty_fused"] == 4, counts    # one a shard
    for name in MESH_FUSED:
        assert counts[name] >= 4, counts
    assert counts["apply_weighted_cov"] == 0, counts
    assert counts["scores_dirfix_pass"] == 0, counts
    _on_card(a, dev)
    b = sharded_consensus(x, reputation=rep, event_bounds=bounds, params=p,
                          mesh=make_mesh(devices=["cpu"] * 4))
    _compare(a, b, 1e-5, reports.shape[1] - 100)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,pca,atol", [
    ("sztorc", "auto", 1e-5), ("sztorc", "power", 1e-5),
    ("fixed-variance", "auto", 2e-3), ("fixed-variance", "power", 2e-3),
    ("ica", "auto", 2e-3), ("ica", "power", 2e-3), ("k-means", "auto", 1e-5),
    ("dbscan-jit", "auto", 1e-5), ("hierarchical", "auto", 1e-5),
    ("dbscan", "auto", 1e-5)])
def test_mesh_plain_card_matches_cpu(dev, algorithm, pca, atol):
    """The plain mesh core and the hybrid path, four shards on one card
    against four CPU shards, float32, scaled events beyond E // 8 and
    bfloat16 storage for the clustering variants; ``"auto"`` is the Gram
    eigh here, ``"power"`` the power loop or the orthogonal iteration
    over the shards' products: no storage kernel
    launches (the reference's XLA products), exact keys equal, the rest
    within the band (the clustering variants' partitions equal)."""
    from pyconsensus_tpu_torch.parallel.mesh import make_mesh

    reports, bounds, rep = plain_inputs(59, R=256, E=1037)
    knobs = (_cluster_knobs(algorithm, 1037)
             if algorithm in ("k-means", "dbscan-jit", "hierarchical",
                              "dbscan") else {})
    storage = "bfloat16" if knobs else ""
    p = ConsensusParams(algorithm=algorithm, pca_method=pca,
                        max_iterations=3, power_iters=64, power_tol=-1.0,
                        storage_dtype=storage, **knobs)
    x = reports.astype(np.float32)
    ck.reset_launch_counts()
    a = sharded_consensus(x, reputation=rep, event_bounds=bounds, params=p,
                          mesh=make_mesh(devices=[dev] * 4))
    assert not any(ck.launch_counts().values()), ck.launch_counts()
    _on_card(a, dev)
    b = sharded_consensus(x, reputation=rep, event_bounds=bounds, params=p,
                          mesh=make_mesh(devices=["cpu"] * 4))
    assert set(a) == set(b)
    _compare(a, b, atol, reports.shape[1] - 150)
    if knobs:
        assert _same_partition(a["this_rep"].cpu(), b["this_rep"])


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["fixed-variance", "dbscan"])
def test_sharded_oracle_mesh_card_matches_one_card(dev, algorithm):
    """``ShardedOracle(mesh=)`` on four shards of one card, placed once,
    against the one-card ``ShardedOracle``: the plain core and the hybrid
    path over shards agree with one device."""
    from pyconsensus_tpu_torch import ShardedOracle
    from pyconsensus_tpu_torch.parallel import make_mesh

    reports = _oracle_inputs(67, R=300, E=1500)
    kw = dict(reports=reports, algorithm=algorithm, max_iterations=3,
              **(_cluster_knobs(algorithm, 1500) if algorithm == "dbscan"
                 else {}))
    a = ShardedOracle(mesh=make_mesh(devices=[dev] * 4), **kw)
    got = a.place().consensus()
    one = ShardedOracle(**kw).consensus()
    _nested_agree(got, one, 2e-3 if algorithm == "fixed-variance" else 1e-5,
                  algorithm)


@pytest.mark.cuda
def test_ring_on_the_card(dev):
    """The ring over four shards of one card: the all-reduce equals the
    CPU ring bit for bit (elementwise adds in one order), the Gram and
    the first component within float32 rounding of the CPU's."""
    from pyconsensus_tpu_torch.parallel import (make_mesh, ring_allreduce,
                                                ring_first_pc, ring_gram)

    rng = np.random.default_rng(71)
    parts = rng.standard_normal((4, 203, 17)).astype(np.float32)
    card = ring_allreduce([_t(q).to(dev) for q in parts])
    cpu = ring_allreduce([_t(q) for q in parts])
    assert all(torch.equal(c.cpu(), cpu[0]) for c in card)
    X = rng.random((96, 1037)).astype(np.float32)
    rep = np.full(96, 1.0 / 96, np.float32)
    mesh, cpu_mesh = make_mesh(devices=[dev] * 4), make_mesh(
        devices=["cpu"] * 4)
    _close(ring_gram(_t(X), mesh), ring_gram(_t(X), cpu_mesh), "ring gram")
    la, sa = ring_first_pc(_t(X), _t(rep), mesh)
    lb, sb = ring_first_pc(_t(X), _t(rep), cpu_mesh)
    sign = 1.0 if float(la.cpu() @ lb) >= 0 else -1.0
    _close(la.cpu() * sign, lb, "ring loading")
    _close(sa.cpu() * sign, sb, "ring scores")


# -- the collusion simulator (no storage kernel on this path) ---------------


SIM_GRID = ((0.0, 0.1, 0.2, 0.3, 0.4), (0.05, 0.1))


@pytest.mark.cuda
def test_sim_draws_card_match_numpy(dev):
    """The keyed draws on the card equal the numpy reference bit for bit
    (float32 and float64 uniforms, per-lane keys and probabilities)."""
    from pyconsensus_tpu_torch.ops import prng

    keys = prng.fold_in(prng.key(7), np.arange(33))
    p = np.linspace(0.0, 0.9, 33)
    kt = torch.as_tensor(keys.astype(np.int64), device=dev)
    for dtype in ("float32", "float64"):
        u = prng.uniform_torch(kt, (50, 25), getattr(torch, dtype))
        np.testing.assert_array_equal(u.cpu().numpy(),
                                      prng.uniform(keys, (50, 25), dtype))
        b = prng.bernoulli_torch(kt, torch.as_tensor(p, device=dev),
                                 (50, 25), getattr(torch, dtype))
        np.testing.assert_array_equal(b.cpu().numpy(),
                                      prng.bernoulli(keys, p, (50, 25),
                                                     dtype))
    np.testing.assert_array_equal(
        prng.split_torch(kt, 4).cpu().numpy(), prng.split(keys, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("max_iterations", [1, 5])
def test_sim_sweep_card_matches_cpu(dev, max_iterations):
    """A 1,000-trial sweep at the recorded shape (50 x 25) on the card
    equals its CPU run bit for bit in float32: every contraction is an
    elementwise product and a fixed-order sum."""
    from pyconsensus_tpu_torch.ops import cuda_kernels as kernels
    from pyconsensus_tpu_torch.sim import CollusionSimulator

    kw = dict(n_reporters=50, n_events=25, max_iterations=max_iterations)
    kernels.reset_launch_counts()
    a = CollusionSimulator(**kw).run(SIM_GRID[0], SIM_GRID[1], 100, seed=4)
    assert not any(kernels.launch_counts().values())
    b = CollusionSimulator(device="cpu", **kw).run(SIM_GRID[0], SIM_GRID[1],
                                                   100, seed=4)
    for key in a:
        if key != "mean":
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("pca_method", ["power", "eigh-cov"])
def test_sim_lane_independent_of_batch_on_card(dev, pca_method):
    """One lane alone equals the same lane inside a 10,000-wide batch on
    the card, bit for bit."""
    from pyconsensus_tpu_torch.sim import CollusionSimulator
    from pyconsensus_tpu_torch.sim.collusion import flat_grid

    sim = CollusionSimulator(n_reporters=50, n_events=25, max_iterations=3,
                             pca_method=pca_method)
    _, _, glf, gvar = flat_grid(*SIM_GRID, 1000)
    wide = sim._dispatch(0, np.arange(glf.size), glf, gvar)
    for i in (0, 4321, glf.size - 1):
        one = sim._dispatch(0, np.array([i]), glf[i:i + 1], gvar[i:i + 1])
        for key in one:
            np.testing.assert_array_equal(one[key][0], wide[key][i],
                                          err_msg=f"{key} lane {i}")


@pytest.mark.cuda
def test_sim_chunked_matches_monolithic_on_card(dev, tmp_path):
    from pyconsensus_tpu_torch.sim import (CheckpointedSweep,
                                           CollusionSimulator,
                                           RoundsSimulator)

    for sim, T in ((CollusionSimulator(n_reporters=50, n_events=25), 300),
                   (RoundsSimulator(n_rounds=3, n_reporters=20,
                                    n_events=10), 40)):
        mono = sim.run(*SIM_GRID, T, seed=2)
        sweep = CheckpointedSweep(sim, *SIM_GRID, T, seed=2,
                                  checkpoint_dir=tmp_path / type(sim).__name__,
                                  trials_per_chunk=1024 if T > 100 else 7)
        sweep.run()
        got = sweep.gather()
        for key in mono:
            if key != "mean":
                np.testing.assert_array_equal(got[key], mono[key],
                                              err_msg=key)


ALGORITHMS = ("fixed-variance", "ica", "k-means", "dbscan-jit")


def _algo_knobs(algorithm, **kw):
    kw = dict(kw, algorithm=algorithm, n_reporters=50, n_events=25)
    if algorithm == "dbscan-jit":
        kw["dbscan_eps"] = float(np.sqrt(2 * 0.1 * 25))
    return kw


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,pca_method",
                         [(a, "power") for a in ALGORITHMS]
                         + [(a, "eigh-cov") for a in ALGORITHMS[:2]]
                         + [("sztorc", "eigh-cov"), ("sztorc", "eigh-gram")])
def test_sim_algorithm_card_matches_cpu(dev, algorithm, pca_method):
    """The other algorithms' sweep, and sztorc's eigh arms, on the card
    equal their CPU run bit for bit in float32 (lane arithmetic
    throughout; the eigensolves are float64 LAPACK calls on the host for
    both), with no storage kernel launched."""
    from pyconsensus_tpu_torch.ops import cuda_kernels as kernels
    from pyconsensus_tpu_torch.sim import CollusionSimulator

    kw = _algo_knobs(algorithm, max_iterations=3, pca_method=pca_method)
    kernels.reset_launch_counts()
    a = CollusionSimulator(**kw).run(SIM_GRID[0], SIM_GRID[1], 40, seed=4)
    assert not any(kernels.launch_counts().values())
    b = CollusionSimulator(device="cpu", **kw).run(SIM_GRID[0], SIM_GRID[1],
                                                   40, seed=4)
    for key in a:
        if key != "mean":
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"{algorithm} {key}")


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_sim_algorithm_lane_independent_of_batch_on_card(dev, algorithm):
    """One lane alone equals the same lane inside a 10,000-wide batch on
    the card, bit for bit."""
    from pyconsensus_tpu_torch.sim import CollusionSimulator
    from pyconsensus_tpu_torch.sim.collusion import flat_grid

    sim = CollusionSimulator(**_algo_knobs(algorithm, max_iterations=3))
    _, _, glf, gvar = flat_grid(*SIM_GRID, 1000)
    wide = sim._dispatch(0, np.arange(glf.size), glf, gvar)
    for i in (0, 4321, glf.size - 1):
        one = sim._dispatch(0, np.array([i]), glf[i:i + 1], gvar[i:i + 1])
        for key in one:
            np.testing.assert_array_equal(one[key][0], wide[key][i],
                                          err_msg=f"{key} lane {i}")


# -- the serve tier on the card --------------------------------------------


def _serve_reports(seed, R, E, na_frac=0.05):
    rng = np.random.default_rng(seed)
    truth = rng.choice([0.0, 1.0], size=E)
    reports = np.tile(truth, (R, 1))
    reports = np.abs(reports - (rng.random((R, E)) < 0.1))
    reports[: R // 5] = 1.0 - truth
    reports[rng.random((R, E)) < na_frac] = np.nan
    return reports


def _serve_bitwise(a, b):
    for group in ("agents", "events"):
        for key, v in b[group].items():
            np.testing.assert_array_equal(np.asarray(a[group][key]),
                                          np.asarray(v), err_msg=key)
    for key in ("iterations", "convergence", "certainty", "participation"):
        assert a[key] == b[key], key


def _serve_close(a, b, atol, what):
    for key in ("outcomes_adjusted", "outcomes_final"):
        np.testing.assert_array_equal(a["events"][key], b["events"][key],
                                      err_msg=f"{what} {key}")
    assert a["iterations"] == b["iterations"], what
    for group in ("agents", "events"):
        for key, v in b[group].items():
            if key in ("na_row", "adj_first_loadings"):
                continue
            np.testing.assert_allclose(
                np.asarray(a[group][key], dtype=np.float64),
                np.asarray(v, dtype=np.float64), atol=atol, rtol=0,
                err_msg=f"{what} {key}")


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["", "int8"])
@pytest.mark.parametrize("shape", [(50, 500), (200, 2000)])
def test_serve_cuda_tier_bitwise_direct_oracle(dev, storage, shape):
    """``bucket_cuda`` on the card ("auto" engages on sm_90) launches
    B.1, B.2 and B.3 and equals the direct fused ``ShardedOracle`` bit
    for bit."""
    from pyconsensus_tpu_torch import ShardedOracle
    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig

    reports = _serve_reports(11, *shape)
    kw = {"storage_dtype": storage} if storage else {}
    with ConsensusService(ServeConfig()) as svc:
        svc.submit(reports=reports, **kw).result(timeout=300)   # builds
        builds = svc.cache.builds
        ck.reset_launch_counts()
        got = svc.submit(reports=reports, **kw).result(timeout=300)
        counts = ck.launch_counts()
        assert svc.cache.builds == builds == 1
    assert counts["apply_weighted_cov"] >= 2, counts
    assert counts["scores_dirfix_pass"] == 1, counts
    assert counts["resolve_certainty_fused"] == 1, counts
    direct = ShardedOracle(reports, pca_method="power", **kw)
    assert direct.params.fused_resolution
    _serve_bitwise(got, direct.consensus())


@pytest.mark.cuda
def test_serve_padded_card_matches_cpu(dev):
    """The padded tier on the card against the CPU: no kernel launches,
    outcomes equal, continuous keys within float32's band."""
    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig

    mats = [_serve_reports(20 + i, 40 + 7 * i, 100 + 30 * i)
            for i in range(4)]
    cfg = ServeConfig(pallas_buckets=False, batch_window_ms=5.0)
    ck.reset_launch_counts()
    with ConsensusService(cfg) as svc:
        card = [f.result(timeout=300)
                for f in [svc.submit(reports=m) for m in mats]]
    assert not any(ck.launch_counts().values()), ck.launch_counts()
    with ConsensusService(cfg, device="cpu") as svc:
        cpu = [f.result(timeout=300)
               for f in [svc.submit(reports=m) for m in mats]]
    for i, (a, b) in enumerate(zip(card, cpu)):
        _serve_close(a, b, 1e-5, f"request {i}")


@pytest.mark.cuda
def test_serve_template_reuse_depth3_matches_depth1(dev):
    """Pinned templates rewritten under ``non_blocking`` uploads at depth
    3 give the bits of the synchronous depth 1."""
    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig

    mats = [_serve_reports(40 + i, 20 + (i % 4) * 3, 60 + (i % 3) * 20)
            for i in range(16)]

    def run(depth):
        cfg = ServeConfig(pallas_buckets=False, pipeline_depth=depth,
                          batch_window_ms=1.0, max_batch=4)
        with ConsensusService(cfg) as svc:
            futs = [svc.submit(reports=m) for m in mats]
            return [f.result(timeout=300) for f in futs]

    for a, b in zip(run(1), run(3)):
        _serve_bitwise(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("incremental", [False, True])
def test_serve_session_card_matches_cpu(dev, incremental):
    """A market session's rounds on the card against the CPU: no kernel
    launches, outcomes equal, reputations within float32's band."""
    from pyconsensus_tpu_torch.serve import MarketSession

    R = 96
    card = MarketSession("m", R, incremental=incremental, refresh_every=3)
    cpu = MarketSession("m", R, incremental=incremental, refresh_every=3,
                        device="cpu")
    ck.reset_launch_counts()
    for rnd in range(4):
        for b in range(3):
            block = _serve_reports(100 * rnd + b, R, 64)
            card.append(block)
            cpu.append(block)
        a, c = card.resolve(), cpu.resolve()
        assert card.last_resolve_path == cpu.last_resolve_path
        np.testing.assert_array_equal(a["outcomes_adjusted"],
                                      c["outcomes_adjusted"])
        for key in ("smooth_rep", "certainty", "reporter_bonus"):
            np.testing.assert_allclose(a[key], c[key], atol=2e-5, rtol=0,
                                       err_msg=key)
    assert not any(ck.launch_counts().values()), ck.launch_counts()


# -- the out-of-core driver ---------------------------------------------------


def _stream_reports(seed, R, E, na_frac=0.05):
    """Collusion reports: the truth flipped at 0.1 by the honest, a fifth
    of the reporters on the anti-truth, ``na_frac`` absent."""
    rng = np.random.default_rng(seed)
    truth = rng.choice([0.0, 1.0], size=E)
    reports = np.abs(np.tile(truth, (R, 1)) - (rng.random((R, E)) < 0.1))
    reports[: R // 5] = 1.0 - truth
    reports[rng.random((R, E)) < na_frac] = np.nan
    return reports


def _stream_params(algorithm, E, **kw):
    """The clustering radii follow the generator's geometry (as
    ``chip_smoke.py``'s): honest pairs near d^2 = 0.2 E, honest-liar pairs
    near 0.8 E."""
    return ConsensusParams(algorithm=algorithm, num_clusters=3,
                           dbscan_eps=float(np.sqrt(0.4 * E)),
                           hierarchy_threshold=float(np.sqrt(0.5 * E)), **kw)


def _stream_close(a, b, atol, what):
    for k in ("outcomes_adjusted", "outcomes_final", "na_row", "iterations",
              "convergence", "ica_converged"):
        if k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{what}: {k}")
    for k in ("smooth_rep", "this_rep", "certainty", "reporter_bonus",
              "participation_rows", "author_bonus"):
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0,
                                   err_msg=f"{what}: {k}")
    if "first_loading" in b:
        np.testing.assert_allclose(np.abs(a["first_loading"]),
                                   np.abs(b["first_loading"]), atol=atol,
                                   rtol=0, err_msg=f"{what}: first_loading")


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["sztorc", "fixed-variance", "ica",
                                       "k-means", "hierarchical", "dbscan",
                                       "dbscan-jit"])
def test_streaming_card_matches_cpu(dev, algorithm):
    """``streaming_consensus`` on the card against the CPU at 256 x 2048
    in float32 (ragged panels of 600): outcomes equal, continuous keys in
    the float32 band (2e-3 for fixed-variance and ica), no kernel
    launched."""
    from pyconsensus_tpu_torch import streaming_consensus

    reports = _stream_reports(7, 256, 2048)
    p = _stream_params(algorithm, 2048, max_iterations=2)
    ck.reset_launch_counts()
    card = streaming_consensus(reports, panel_events=600, params=p)
    assert not any(ck.launch_counts().values()), ck.launch_counts()
    cpu = streaming_consensus(reports, panel_events=600, params=p,
                              device="cpu")
    atol = 2e-3 if algorithm in ("fixed-variance", "ica") else 1e-5
    _stream_close(card, cpu, atol, algorithm)


@pytest.mark.cuda
def test_streaming_single_eigh_arm_at_4096(dev):
    """At R = 4096 the spectrum is one ``torch.linalg.eigh`` of the
    4096 x 4096 Gram on cuSOLVER, rank-deficient at E = 1024: outcomes
    equal to the CPU's, no orthogonal-iteration fallback."""
    from pyconsensus_tpu_torch import obs, streaming_consensus

    reports = _stream_reports(8, 4096, 1024)
    before = obs.value("pyconsensus_streaming_topk_fallback_total") or 0
    card = streaming_consensus(reports, panel_events=256)
    cpu = streaming_consensus(reports, panel_events=256, device="cpu")
    assert (obs.value("pyconsensus_streaming_topk_fallback_total") or 0) \
        == before
    assert np.isfinite(card["smooth_rep"]).all()
    _stream_close(card, cpu, 1e-5, "R = 4096")


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["sztorc", "k-means"])
def test_streaming_two_hosts_on_card(dev, algorithm):
    """Two threads as hosts on one card, each with half the panels,
    summing the stacked statistics on the card in host order: equal to
    one host."""
    import threading

    from pyconsensus_tpu_torch import streaming_consensus

    reports = _stream_reports(9, 256, 2048)
    p = _stream_params(algorithm, 2048, max_iterations=2)
    single = streaming_consensus(reports, panel_events=300, params=p)
    bar = threading.Barrier(2, timeout=120)
    contrib, summed, results, errors = {}, {}, {}, []

    def make_allreduce(i):
        def allreduce(x):
            contrib[i] = x
            bar.wait()
            if i == 0:
                summed["v"] = contrib[0] + contrib[1]
            bar.wait()
            out = summed["v"]
            bar.wait()
            return out
        return allreduce

    def host(i):
        try:
            results[i] = streaming_consensus(
                reports, panel_events=300, params=p, host_id=i, n_hosts=2,
                allreduce=make_allreduce(i))
        except Exception as exc:
            errors.append(exc)
            bar.abort()

    threads = [threading.Thread(target=host, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    for i in range(2):
        _stream_close(results[i], single, 1e-5, f"host {i}")


@pytest.mark.cuda
def test_streaming_on_a_side_stream(dev):
    """Called inside ``torch.cuda.stream(s)``, the prefetch worker uploads
    every panel on ``s``, the stream the products run on: equal to the
    result on the default stream."""
    from pyconsensus_tpu_torch import streaming_consensus

    reports = _stream_reports(10, 256, 2048)
    p = _stream_params("sztorc", 2048, max_iterations=2)
    base = streaming_consensus(reports, panel_events=300, params=p)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        out = streaming_consensus(reports, panel_events=300, params=p)
    _stream_close(out, base, 1e-6, "side stream")


def _stream_printout(text):
    """``(outcome-count line, {reporter: (smooth_rep, bonus)})`` of a
    ``python -m pyconsensus_tpu_torch --stream`` run."""
    import re

    counts = re.search(r"outcomes 0/0\.5/1: (\d+/\d+/\d+)", text)
    assert counts, text
    rows = {int(m[0]): (float(m[1]), float(m[2])) for m in
            re.findall(r"^\s+(\d+)\s+([\d.e+-]+)\s+([\d.e+-]+)\s*$", text,
                       re.M)}
    assert len(rows) == 8, text
    return counts.group(1), rows


@pytest.mark.cuda
def test_stream_processes_over_nccl(dev, tmp_path):
    """``--coordinator/--hosts/--host-id`` with one process a card: each
    joins the NCCL group on its own card (``initialize`` pins it), the
    default all-reduce gathers over NCCL, and every host prints what a
    single-host ``--stream`` run prints: the outcome counts exactly, the
    top reputations within 1e-5 (the hosts sum in another order)."""
    import os
    import socket
    import subprocess
    import sys

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = str(tmp_path / "r.npy")
    np.save(path, _stream_reports(11, 256, 2048).astype(np.float32))
    cmd = [sys.executable, "-m", "pyconsensus_tpu_torch", "--file", path,
           "--stream", "--panel-events", "300", "--iterations", "2"]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        cmd + ["--coordinator", f"localhost:{port}", "--hosts", str(n),
               "--host-id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=repo) for i in range(n)]
    runs = []
    try:
        for proc in procs:
            runs.append(proc.communicate(timeout=300))
    finally:
        for proc in procs:          # never leave a peer blocked in a
            if proc.poll() is None:  # collective
                proc.kill()
                proc.communicate()
    for proc, (out, err) in zip(procs, runs):
        assert proc.returncode == 0, out + err
    single = subprocess.run(cmd, capture_output=True, text=True, cwd=repo,
                            timeout=300)
    assert single.returncode == 0, single.stdout + single.stderr
    want_counts, want_rows = _stream_printout(single.stdout)
    for i, (out, _) in enumerate(runs):
        assert f"host {i}/{n}" in out
        counts, rows = _stream_printout(out)
        assert counts == want_counts
        assert rows.keys() == want_rows.keys()
        for rid, vals in rows.items():
            np.testing.assert_allclose(vals, want_rows[rid], atol=1e-5,
                                       rtol=0)


# -- the batch x event grid (-k "batch_mesh or serve_sharded or sim_mesh or
# stream_mesh"): over every card of the machine, or virtual devices of
# card 0 on one card ----------------------------------------------------------


def _grid_devices(n):
    """``n`` devices cycling over the machine's cards: ``n`` virtual
    devices of card 0 on one card, each card in turn on several."""
    return [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["sztorc", "fixed-variance",
                                       "k-means"])
def test_batch_mesh_grid_resolves_on_its_first_row(dev, algorithm):
    """A 2 x 2 grid resolves one matrix on its first row: bit for bit the
    1 x 2 event mesh on the same devices, and in the float32 band of two
    CPU shards."""
    from pyconsensus_tpu_torch.parallel.mesh import make_mesh

    reports = _stream_reports(30, 512, 4096).astype(np.float32)
    p = _stream_params(algorithm, 4096, max_iterations=2)
    devs = _grid_devices(4)
    grid = sharded_consensus(reports, params=p,
                             mesh=make_mesh(batch=2, devices=devs))
    row = sharded_consensus(reports, params=p,
                            mesh=make_mesh(devices=devs[:2]))
    for key, v in row.items():
        np.testing.assert_array_equal(_np(grid[key]), _np(v), err_msg=key)
    cpu = sharded_consensus(reports, params=p,
                            mesh=make_mesh(devices=["cpu"] * 2))
    for key in ("outcomes_adjusted", "outcomes_final", "iterations"):
        np.testing.assert_array_equal(_np(grid[key]), _np(cpu[key]),
                                      err_msg=key)
    np.testing.assert_allclose(_np(grid["smooth_rep"]),
                               _np(cpu["smooth_rep"]), atol=1e-5, rtol=0)


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.cuda
def test_serve_sharded_card_matches_cpu_and_one_card(dev):
    """The serve tier on a 2 x 4 grid of the card(s) against the same grid
    of CPU devices (outcomes equal, the rest within float32's band) and
    against the single-device bucket on the card (outcomes and iterations
    exact); every request rides ``bucket_sharded`` and no kernel
    launches."""
    from pyconsensus_tpu_torch import obs
    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig

    mats = [_serve_reports(60 + i, 40 + 9 * i, 200 + 40 * i)
            for i in range(6)]
    cfg = ServeConfig(sharded_buckets=True, pallas_buckets=False,
                      batch_window_ms=10.0)

    def serve(sharded=True, **where):
        c = ServeConfig(**{**cfg.__dict__, "sharded_buckets": sharded})
        with ConsensusService(c, **where) as svc:
            return svc, [f.result(timeout=300)
                         for f in [svc.submit(reports=m) for m in mats]]

    obs.reset()
    ck.reset_launch_counts()
    svc, card = serve(devices=_grid_devices(8))
    assert svc.n_devices == 8
    assert not any(ck.launch_counts().values()), ck.launch_counts()
    assert obs.value("pyconsensus_serve_requests_total",
                     path="bucket_sharded", outcome="ok") == len(mats)
    _, cpu = serve(devices=["cpu"] * 8)
    _, one = serve(sharded=False, device=dev)
    for i, (a, b, c) in enumerate(zip(card, cpu, one)):
        _serve_close(a, b, 1e-5, f"request {i}")
        for key in ("outcomes_adjusted", "outcomes_final"):
            np.testing.assert_array_equal(a["events"][key],
                                          c["events"][key])
        assert a["iterations"] == c["iterations"]


@pytest.mark.cuda
def test_serve_sharded_under_side_streams(dev):
    """The grid's executable called with a side stream current on every
    card: the rows work on the caller's stream of their cards, and the
    results equal those on the default streams bit for bit."""
    from pyconsensus_tpu_torch.parallel.mesh import make_mesh
    from pyconsensus_tpu_torch.serve import bucket_inputs
    from pyconsensus_tpu_torch.serve.sharded import \
        make_sharded_bucket_executable

    devs = _grid_devices(4)
    p = ConsensusParams(algorithm="sztorc", pca_method="power",
                        has_na=True, any_scaled=False)
    lanes = [bucket_inputs(_serve_reports(70 + i, 60, 900),
                           np.full(60, 1 / 60), np.zeros(900, bool),
                           np.zeros(900), np.ones(900), 64, 1024,
                           dtype=torch.float32) for i in range(4)]
    stacked = [torch.stack(f) for f in zip(*lanes)]
    fn = make_sharded_bucket_executable(
        p, make_mesh(batch=2, devices=devs), batched=True, capacity=4)
    base = {k: v.cpu() for k, v in fn(*stacked, p).items()}
    import contextlib

    with contextlib.ExitStack() as stack:
        for d in dict.fromkeys(torch.device(x) for x in devs):
            stack.enter_context(torch.cuda.stream(torch.cuda.Stream(d)))
        side = {k: v.cpu() for k, v in fn(*stacked, p).items()}
    for k, v in base.items():
        assert torch.equal(side[k], v), k


@pytest.mark.cuda
def test_serve_sharded_policy_on_the_cards(dev):
    """"auto" serves on one device unless ``devices=`` names several
    cards; True with no ``devices=`` spans every card from the service's
    own on, so the service's device leads the mesh."""
    from pyconsensus_tpu_torch.parallel.mesh import mesh_devices
    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig

    n = torch.cuda.device_count()
    last = torch.device("cuda", n - 1)
    assert ConsensusService(ServeConfig(), device=dev).mesh is None
    svc = ConsensusService(ServeConfig(sharded_buckets=True), device=last)
    if n == 1:
        assert svc.mesh is None
        return
    assert svc.n_devices == n and mesh_devices(svc.mesh)[0] == last
    two = ConsensusService(ServeConfig(), devices=["cuda:0", "cuda:1"])
    assert two.n_devices == 2


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["sztorc", "k-means"])
def test_sim_mesh_sweep_bitwise_on_card(dev, algorithm):
    """The 1,000-trial sweep at 50 x 25 over ``make_mesh(batch=4,
    event=1)`` of the card(s), at an uneven split too, equals the
    single-card sweep bit for bit on every key."""
    from pyconsensus_tpu_torch.parallel.mesh import make_mesh
    from pyconsensus_tpu_torch.sim import CollusionSimulator

    kw = dict(n_reporters=50, n_events=25, max_iterations=2,
              algorithm=algorithm)
    one = CollusionSimulator(**kw).run(SIM_GRID[0], SIM_GRID[1], 100, seed=5)
    for n in (4, 3):
        mesh = make_mesh(batch=n, event=1, devices=_grid_devices(n))
        got = CollusionSimulator(mesh=mesh, **kw).run(SIM_GRID[0],
                                                      SIM_GRID[1], 100,
                                                      seed=5)
        for key in one:
            if key != "mean":
                np.testing.assert_array_equal(got[key], one[key],
                                              err_msg=f"{n}: {key}")


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["sztorc", "fixed-variance",
                                       "k-means", "dbscan-jit"])
def test_stream_mesh_card_matches_cpu(dev, algorithm):
    """Panels event-sharded over four devices of the card(s) against four
    CPU shards (outcomes equal, the float32 band) and against one card
    (outcomes equal)."""
    from pyconsensus_tpu_torch import streaming_consensus
    from pyconsensus_tpu_torch.parallel.mesh import make_mesh

    reports = _stream_reports(31, 256, 2048)
    p = _stream_params(algorithm, 2048, max_iterations=2)
    ck.reset_launch_counts()
    card = streaming_consensus(reports, panel_events=600, params=p,
                               mesh=make_mesh(devices=_grid_devices(4)))
    assert not any(ck.launch_counts().values()), ck.launch_counts()
    cpu = streaming_consensus(reports, panel_events=600, params=p,
                              mesh=make_mesh(devices=["cpu"] * 4))
    atol = 2e-3 if algorithm == "fixed-variance" else 1e-5
    _stream_close(card, cpu, atol, algorithm)
    one = streaming_consensus(reports, panel_events=600, params=p)
    for k in ("outcomes_adjusted", "outcomes_final", "iterations"):
        np.testing.assert_array_equal(np.asarray(card[k]),
                                      np.asarray(one[k]), err_msg=k)


@pytest.mark.cuda
def test_stream_mesh_on_side_streams(dev):
    """Called with a side stream current on every card, the prefetch
    worker uploads each shard on its card's side stream, the stream the
    products run on: equal to the default streams' result."""
    import contextlib

    from pyconsensus_tpu_torch import streaming_consensus
    from pyconsensus_tpu_torch.parallel.mesh import make_mesh

    reports = _stream_reports(32, 256, 2048)
    p = _stream_params("sztorc", 2048, max_iterations=2)
    mesh = make_mesh(devices=_grid_devices(4))
    base = streaming_consensus(reports, panel_events=300, params=p,
                               mesh=mesh)
    with contextlib.ExitStack() as stack:
        for d in dict.fromkeys(mesh):
            stack.enter_context(torch.cuda.stream(torch.cuda.Stream(d)))
        out = streaming_consensus(reports, panel_events=300, params=p,
                                  mesh=mesh)
    _stream_close(out, base, 1e-6, "side streams")


# -- the event mesh across processes (-k process_mesh): an NCCL group of one
# over virtual shards of card 0, and one process a card ----------------------

_PROCESS_MESH_SCRIPT = """
import sys
import numpy as np
import torch
from pyconsensus_tpu_torch import ConsensusParams, sharded_consensus
from pyconsensus_tpu_torch.models.pipeline import decode_reports
from pyconsensus_tpu_torch.ops import cuda_kernels as ck
from pyconsensus_tpu_torch.parallel import distributed
from pyconsensus_tpu_torch.parallel.mesh import place_event_shards

address, world, rank, shards, path, out = sys.argv[1:]
world, rank, shards = int(world), int(rank), int(shards)
distributed.initialize(address, world, rank)
devices = ["cuda:0"] * shards if world == 1 else None
mesh = distributed.make_process_mesh(devices)
x8 = np.load(path, mmap_mode="r")
placed = place_event_shards(x8, mesh)
res = {}
for tag, x, p in (
        ("sztorc", placed, ConsensusParams(storage_dtype="int8",
                                           pca_method="power-fused",
                                           max_iterations=2,
                                           power_tol=1e-5)),
        ("fixed-variance", placed._replace(shards=tuple(
            decode_reports(s) for s in placed.shards)),
         ConsensusParams(algorithm="fixed-variance", max_iterations=2,
                         pca_method="power", power_tol=1e-5))):
    ck.reset_launch_counts()
    r = sharded_consensus(x, params=p)
    torch.cuda.synchronize()
    res[tag] = {k: v.cpu() for k, v in r.items()
                if isinstance(v, torch.Tensor)}
    res[tag + " launches"] = ck.launch_counts()
torch.save(res, out)
"""


def _process_mesh_ranks(tmp_path, world, shards, x8):
    """``world`` ranks of ``_PROCESS_MESH_SCRIPT`` over NCCL, each under a
    timeout (and killed when a peer fails): every rank's results."""
    import os
    import socket
    import subprocess
    import sys
    import time

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = str(tmp_path / "x8.npy")
    np.save(path, x8)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        address = f"localhost:{sock.getsockname()[1]}"
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PROCESS_MESH_SCRIPT, address, str(world),
         str(r), str(shards), path, outs[r]], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=repo)
        for r in range(world)]
    deadline = time.monotonic() + 300
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p in procs:
        text = p.communicate()[0]
        assert p.returncode == 0, text[-4000:]
    return [torch.load(o) for o in outs]


def _one_controller_mesh(mesh, x8):
    from pyconsensus_tpu_torch.models.pipeline import decode_reports
    from pyconsensus_tpu_torch.parallel.mesh import place_event_shards

    placed = place_event_shards(x8, mesh)
    res = {}
    for tag, x, p in (
            ("sztorc", placed, ConsensusParams(
                storage_dtype="int8", pca_method="power-fused",
                max_iterations=2, power_tol=1e-5)),
            ("fixed-variance", placed._replace(shards=tuple(
                decode_reports(s) for s in placed.shards)),
             ConsensusParams(algorithm="fixed-variance", max_iterations=2,
                             pca_method="power", power_tol=1e-5))):
        r = sharded_consensus(x, params=p)
        res[tag] = {k: v.cpu() for k, v in r.items()
                    if isinstance(v, torch.Tensor)}
    return res


def _assert_ranks_equal(ranks, want, what):
    for r, got in enumerate(ranks):
        for tag in ("sztorc", "fixed-variance"):
            differ = [k for k, v in want[tag].items()
                      if not torch.equal(got[tag][k], v)]
            assert not differ, f"{what}, rank {r}, {tag}: {differ}"
        launches = got["sztorc launches"]
        for k in ("storage_matvec", "storage_rows_matmat",
                  "resolve_certainty_fused"):
            assert launches[k] > 0, (r, launches)


@pytest.mark.cuda
def test_process_mesh_nccl_group_of_one(dev, tmp_path):
    """One process, an NCCL group of one over four virtual shards of card
    0: the gathers and the folds go through NCCL, and every key is bit
    for bit the one-controller 4-shard mesh's (int8 fused sztorc, B.5,
    B.6 and B.3 launched; fixed-variance on the plain mesh core)."""
    from pyconsensus_tpu_torch.parallel.mesh import make_mesh

    _, x8, *_ = make_storage(41, 517, 4099)
    ranks = _process_mesh_ranks(tmp_path, 1, 4, x8)
    want = _one_controller_mesh(make_mesh(devices=["cuda:0"] * 4), x8)
    _assert_ranks_equal(ranks, want, "a group of one")


@pytest.mark.cuda
def test_process_mesh_one_process_a_card(dev, tmp_path):
    """One process a card over NCCL: every rank's keys bit for bit the
    one-controller mesh over the same cards (int8 fused sztorc with B.5,
    B.6 and B.3 launched on each rank; fixed-variance)."""
    from pyconsensus_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("one process a card needs two cards or more")
    _, x8, *_ = make_storage(42, 517, 4099)
    ranks = _process_mesh_ranks(tmp_path, n, 1, x8)
    want = _one_controller_mesh(make_mesh(event=n), x8)
    _assert_ranks_equal(ranks, want, f"{n} processes")


# -- the replicated serve fleet ---------------------------------------------


def _fleet_block(k, j, R=96, e=64):
    return _serve_reports(1000 * k + j, R, e)


@pytest.mark.cuda
def test_fleet_bucket_cuda_bitwise_direct_fused_oracle(dev, tmp_path):
    """A 3-worker fleet on the card under the default config: every
    binary request rides ``bucket_cuda`` on its worker (B.1, B.2 and B.3
    launched by each) and is bit for bit the direct fused
    ``ShardedOracle``."""
    from pyconsensus_tpu_torch import ShardedOracle
    from pyconsensus_tpu_torch.serve import (ConsensusFleet, FleetConfig,
                                             ServeConfig)

    mats = [_serve_reports(70 + i, 200, 2000) for i in range(6)]
    cfg = FleetConfig(n_workers=3, log_dir=str(tmp_path / "log"),
                      worker=ServeConfig(pallas_warmup=((200, 2000),)))
    with ConsensusFleet(cfg) as fleet:
        ck.reset_launch_counts()
        futs = [fleet.submit(reports=m) for m in mats]
        got = [f.result(timeout=300) for f in futs]
        counts = ck.launch_counts()
    for k in ("apply_weighted_cov", "scores_dirfix_pass",
              "resolve_certainty_fused"):
        assert counts[k] >= len(mats), counts
    for m, g in zip(mats, got):
        _serve_bitwise(g, ShardedOracle(m, pca_method="power").consensus())


@pytest.mark.cuda
def test_fleet_kill_mid_traffic_loses_nothing_on_card(dev, tmp_path):
    """``kill_worker`` mid-traffic on the card: the load generator's
    bounded retry absorbs every shed; nothing fails, nothing is
    abandoned."""
    from pyconsensus_tpu_torch.serve import (ConsensusFleet, FleetConfig,
                                             LoadGenerator, ServeConfig)

    cfg = FleetConfig(n_workers=3, log_dir=str(tmp_path / "log"),
                      worker=ServeConfig(pallas_warmup=((200, 2000),)))
    fleet = ConsensusFleet(cfg).start()

    class KillAt:
        n = 0

        def submit(self, **kw):
            KillAt.n += 1
            if KillAt.n == 12:
                fleet.kill_worker("w1")
            return fleet.submit(**kw)
    try:
        gen = LoadGenerator(KillAt(), shapes=((200, 2000),), na_frac=0.05,
                            max_retries=6, retry_cap_s=0.5)
        stats = gen.run_closed(32, concurrency=4, timeout_s=300)
    finally:
        fleet.close(drain=True)
    assert stats["succeeded"] == 32, stats
    assert stats["failed"] == 0 and stats["abandoned"] == 0, stats
    assert not fleet.workers["w1"].alive


@pytest.mark.cuda
def test_fleet_replayed_session_bitwise_on_card(dev, tmp_path):
    """A durable session on the card killed mid-round and replayed from
    its log: every later resolve and the carried reputation are bit for
    bit the never-killed session's on the same card."""
    from pyconsensus_tpu_torch.serve import (DurableSession, MarketSession,
                                             replay_session)

    R = 96
    whole = MarketSession("ref", R)
    want = []
    for k in range(3):
        for j in range(2):
            whole.append(_fleet_block(k, j, R))
        want.append(whole.resolve())
    session = DurableSession.create(tmp_path, "s", R)
    for j in range(2):
        session.append(_fleet_block(0, j, R))
    got = [session.resolve()]
    session.append(_fleet_block(1, 0, R))
    del session                                  # the worker dies here
    standby = replay_session(tmp_path, "s")
    standby.append(_fleet_block(1, 1, R))
    got.append(standby.resolve())
    for j in range(2):
        standby.append(_fleet_block(2, j, R))
    got.append(standby.resolve())
    for g, w in zip(got, want):
        for key in ("smooth_rep", "outcomes_final", "outcomes_adjusted",
                    "certainty", "old_rep"):
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]), err_msg=key)
    np.testing.assert_array_equal(standby.reputation, whole.reputation)


# -- the socket transport: one worker process a card ------------------------

#: the router of ``test_socket_fleet_pinned_workers_bitwise``, in a fresh
#: interpreter so no other test's card work is counted against it: two
#: worker processes pinned to card 0, one ``bucket_cuda`` request each,
#: then each worker's ``stats`` and the router's own primary-context state
#: on every card (``cuDevicePrimaryCtxGetState``)
_SOCKET_ROUTER = r"""
import ctypes, pickle, sys
import numpy as np
from pyconsensus_tpu_torch.serve import ConsensusFleet, FleetConfig, ServeConfig
from pyconsensus_tpu_torch.serve.transport import SocketTransport

inp, out, log_dir = sys.argv[1:4]
mats = list(np.load(inp).values())
fleet = ConsensusFleet(FleetConfig(
    n_workers=2, transport=SocketTransport(devices=[0]), log_dir=log_dir,
    worker=ServeConfig(pallas_warmup=((200, 2000),)))).start()
try:
    before = {n: w.call("stats") for n, w in fleet.workers.items()}
    got = [w.submit_stateless(m, tenant="card").result(300)
           for m, (n, w) in zip(mats, sorted(fleet.workers.items()))]
    after = {n: w.call("stats") for n, w in fleet.workers.items()}
finally:
    fleet.close(drain=True)
cu = ctypes.CDLL("libcuda.so.1")
assert cu.cuInit(0) == 0
count = ctypes.c_int()
cu.cuDeviceGetCount(ctypes.byref(count))
active = []
for k in range(count.value):
    dev, flags, on = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
    cu.cuDeviceGet(ctypes.byref(dev), k)
    cu.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags), ctypes.byref(on))
    active.append(on.value)
with open(out, "wb") as f:
    pickle.dump({"got": got, "before": before, "after": after,
                 "active": active}, f)
"""


@pytest.mark.cuda
def test_socket_fleet_pinned_workers_bitwise(dev, tmp_path):
    """Two worker processes pinned to card 0 by ``CUDA_VISIBLE_DEVICES``:
    one ``bucket_cuda`` request each is bit for bit the direct fused
    ``ShardedOracle``, both workers' ``stats`` show B.1, B.2 and B.3
    launched by it, and the router process holds no context on any
    card."""
    import pickle
    import subprocess
    import sys

    from pyconsensus_tpu_torch import ShardedOracle
    from pyconsensus_tpu_torch.serve.transport.supervisor import \
        worker_subprocess_env

    mats = [_serve_reports(90 + i, 200, 2000) for i in range(2)]
    np.savez(tmp_path / "mats.npz", *mats)
    run = subprocess.run(
        [sys.executable, "-c", _SOCKET_ROUTER, str(tmp_path / "mats.npz"),
         str(tmp_path / "out.pkl"), str(tmp_path / "log")],
        capture_output=True, text=True, env=worker_subprocess_env(),
        timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        out = pickle.load(f)
    assert out["active"] and not any(out["active"]), out["active"]
    for name, st in out["after"].items():
        assert st["device"] == "cuda" and st["visible_devices"] == \
            (worker_subprocess_env(card=0)["CUDA_VISIBLE_DEVICES"]), st
        for k in ("apply_weighted_cov", "scores_dirfix_pass",
                  "resolve_certainty_fused"):
            assert st["launches"][k] > out["before"][name]["launches"][k], \
                (name, k, st["launches"])
    for m, g in zip(mats, out["got"]):
        _serve_bitwise(g, ShardedOracle(m, pca_method="power").consensus())


# -- the kernel-build store and the state plane --------------------------------

#: a fresh interpreter from a copy of the package without ``csrc/build/``:
#: a service with the kernel store serves ``bucket_cuda`` requests; every
#: library handed to ``ctypes.CDLL`` is recorded by the SHA-256 of its file
#: at that moment, beside the compile monitor's events and the refusals
_AOT_CHILD = r"""
import ctypes, hashlib, pickle, sys
import numpy as np
from pyconsensus_tpu_torch import obs
from pyconsensus_tpu_torch.ops import build
from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig
from pyconsensus_tpu_torch.serve.transport.worker import host_arrays

store_dir, inp, out = sys.argv[1:4]
loaded = []
real_cdll = ctypes.CDLL


def recording_cdll(path, *args, **kwargs):
    loaded.append(hashlib.sha256(open(path, "rb").read()).hexdigest())
    return real_cdll(path, *args, **kwargs)


ctypes.CDLL = recording_cdll
obs.install_compile_monitor()
mats = list(np.load(inp).values())
svc = ConsensusService(ServeConfig(pallas_buckets=True,
                                   aot_cache_dir=store_dir))
with svc:
    got = [host_arrays(svc.submit(reports=m).result(600)) for m in mats]
events = {e: obs.value("pyconsensus_jax_compile_events_total", event=e)
          for e in ("nvcc", "store_adopt", "library_load")}
with open(out, "wb") as f:
    pickle.dump({"got": got, "events": events, "loaded": loaded,
                 "digest": obs.value("pyconsensus_aot_reject_total",
                                     reason="digest"),
                 "builds": svc.cache.builds,
                 "adopted": svc.cache.adopted}, f)
"""


def _fresh_copy(root):
    """A copy of the package with no built library in it."""
    import os
    import shutil

    import pyconsensus_tpu_torch

    src = os.path.dirname(os.path.abspath(pyconsensus_tpu_torch.__file__))
    shutil.copytree(src, root / "pyconsensus_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    return root


def _run_child(copy, store_dir, mats_path, out, timeout=900):
    import os
    import pickle
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(copy)
    run = subprocess.run([sys.executable, "-c", _AOT_CHILD, str(store_dir),
                          str(mats_path), str(out)], cwd=str(copy), env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f), run.stderr


def _primed_store(tmp_path, mats):
    """This process's freshly built kernels serving ``mats`` on
    ``bucket_cuda``, with the keys and the libraries persisted into a
    store: ``(store dir, results, {library name: sha256})``."""
    import hashlib

    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig
    from pyconsensus_tpu_torch.serve.transport.worker import host_arrays

    store_dir = tmp_path / "aot"
    svc = ConsensusService(ServeConfig(pallas_buckets=True,
                                       aot_cache_dir=str(store_dir)))
    svc.warm_cuda_class([m.shape for m in mats])
    with svc:
        want = [host_arrays(svc.submit(reports=m).result(600))
                for m in mats]
    shas = {build.lib_name(s): hashlib.sha256(
        (build.BUILD_DIR / build.lib_name(s)).read_bytes()).hexdigest()
        for s in build.SOURCES}
    assert svc.cache.aot.has_libraries()
    return store_dir, want, shas


@pytest.mark.cuda
def test_aot_adoption_into_an_empty_build_directory(dev, tmp_path):
    """A fresh process from a copy of the package without ``csrc/build/``
    adopts both libraries from the store (no ``nvcc``), loads exactly the
    bytes this process built, and serves ``bucket_cuda`` results bit for
    bit this process's freshly built kernels', with the warmed keys
    adopted (``serve_bucket_aot``) and none built."""
    mats = [_serve_reports(300 + i, 200, 2000) for i in range(2)]
    store_dir, want, shas = _primed_store(tmp_path, mats)
    np.savez(tmp_path / "mats.npz", *mats)
    got, _ = _run_child(_fresh_copy(tmp_path / "copy"), store_dir,
                        tmp_path / "mats.npz", tmp_path / "out.pkl")
    assert got["events"] == {"nvcc": 0.0, "store_adopt": 2.0,
                             "library_load": 2.0}, got["events"]
    assert sorted(got["loaded"]) == sorted(shas.values())
    assert (got["builds"], got["adopted"]) == (0, 1)
    for g, w in zip(got["got"], want):
        _serve_bitwise(g, w)


@pytest.mark.cuda
def test_aot_digest_refused_library_is_never_loaded(dev, tmp_path):
    """A flipped byte in a stored library: the entry is refused with
    ``reason="digest"`` and deleted, that library's source is built again
    by ``nvcc`` (counted; the sound library is adopted), the flipped bytes
    reach no ``ctypes.CDLL``, and the kernels serve the same bits."""
    import hashlib

    from pyconsensus_tpu_torch.serve import AotCache

    mats = [_serve_reports(310, 200, 2000)]
    store_dir, want, _ = _primed_store(tmp_path, mats)
    entry = AotCache(store_dir).kernels_path()
    libs = AotCache(store_dir).verify_libraries()
    raw = bytearray(entry.read_bytes())
    raw[-1000] ^= 0x10                  # inside the last library
    entry.write_bytes(bytes(raw))
    last = build.lib_name(build.SOURCES[-1])
    flipped = bytearray(libs[last])
    flipped[-1000] ^= 0x10
    bad = hashlib.sha256(bytes(flipped)).hexdigest()
    np.savez(tmp_path / "mats.npz", *mats)
    got, stderr = _run_child(_fresh_copy(tmp_path / "copy"), store_dir,
                             tmp_path / "mats.npz", tmp_path / "out.pkl")
    assert got["digest"] == 1.0 and "refusing kernel-store entry" in stderr
    assert got["events"]["nvcc"] == 1.0
    assert got["events"]["store_adopt"] == float(len(build.SOURCES) - 1)
    assert bad not in got["loaded"] and len(got["loaded"]) == 2
    assert AotCache(store_dir).verify_libraries()      # persisted again
    _serve_bitwise(got["got"][0], want[0])


@pytest.mark.cuda
def test_stateplane_hydrated_session_on_card_equals_cpu(dev, tmp_path):
    """A compacted session evicted from a one-slot tiered store and
    hydrated on the card resolves as the same log hydrated on the CPU:
    outcomes exact, reputation within 1e-9 (float64 on both), and bit for
    bit the never-compacted session on the card."""
    import shutil

    from pyconsensus_tpu_torch.serve import (DurableSession,
                                             TieredSessionStore,
                                             hydrate_session, replay_session)

    R = 96
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        session = DurableSession.create(tmp_path / "log", "s", R)
        for j in range(2):
            session.append(_fleet_block(0, j, R))
        session.resolve()
        for j in range(2):
            session.append(_fleet_block(1, j, R))
        shutil.copytree(tmp_path / "log", tmp_path / "twin")
        session.compact()
        results = {}
        for where in ("cuda", "cpu"):
            # each device resolves (and commits) its own copy of the log
            root = tmp_path / where
            shutil.copytree(tmp_path / "log", root)
            store = TieredSessionStore(hot_capacity=1)
            store.hydrator = lambda name, root=root, where=where: \
                hydrate_session(root, name, device=where)
            store.add(replay_session(root, "s", device=where))
            store.add(DurableSession.create(root, "o", R, device=where))
            assert store.cold_names() == ["s"]
            results[where] = store.get("s").resolve()
        twin = replay_session(tmp_path / "twin", "s").resolve()
    finally:
        torch.set_default_dtype(prev)
    card, cpu = results["cuda"], results["cpu"]
    for key in ("outcomes_final", "outcomes_adjusted"):
        np.testing.assert_array_equal(np.asarray(card[key]),
                                      np.asarray(cpu[key]), err_msg=key)
    np.testing.assert_allclose(np.asarray(card["smooth_rep"]),
                               np.asarray(cpu["smooth_rep"]), rtol=0,
                               atol=1e-9)
    for key in ("smooth_rep", "outcomes_final", "certainty"):
        np.testing.assert_array_equal(np.asarray(card[key]),
                                      np.asarray(twin[key]), err_msg=key)


# -- the elastic fleet and the economy ---------------------------------------


class _Window:
    """A monitor stub: the autoscaler reads ``targets`` and ``window()``."""

    targets = {"p99_ms": 50.0}

    def __init__(self, win):
        self.win = win

    def window(self):
        return dict(self.win)


@pytest.mark.cuda
def test_autoscaled_worker_launches_the_class(dev, tmp_path):
    """A sustained breach grows a one-worker fleet on the card; the new
    worker serves a 1024 x 4096 request on ``bucket_cuda`` (B.1, B.2 and
    B.3 launched) bit for bit the direct fused ``ShardedOracle``."""
    from pyconsensus_tpu_torch import ShardedOracle
    from pyconsensus_tpu_torch.serve import (AutoScaler, AutoscaleConfig,
                                             ConsensusFleet, FleetConfig,
                                             ServeConfig)

    m = _serve_reports(91, 1024, 4096, na_frac=0.02)
    fleet = ConsensusFleet(FleetConfig(
        n_workers=1, log_dir=str(tmp_path / "log"),
        worker=ServeConfig(pallas_warmup=((1024, 4096),)))).start()
    try:
        scaler = AutoScaler(fleet, _Window({"p99_ms": 500.0}),
                            AutoscaleConfig(max_workers=2, up_signals=2,
                                            cooldown_s=0.0))
        assert scaler.evaluate(now=0.0)["action"] == "hold"
        up = scaler.evaluate(now=1.0)
        assert up["action"] == "scale_up" and up["worker"] == "w1"
        ck.reset_launch_counts()
        got = fleet.workers["w1"].submit_stateless(
            m, tenant="t").result(timeout=300)
        counts = ck.launch_counts()
    finally:
        fleet.close(drain=True)
    for k in ("apply_weighted_cov", "scores_dirfix_pass",
              "resolve_certainty_fused"):
        assert counts[k] >= 1, counts
    _serve_bitwise(got, ShardedOracle(m, pca_method="power").consensus())


@pytest.mark.cuda
def test_economy_mirrors_ride_bucket_cuda_and_repeat(dev):
    """A small economy through one service on the card under the default
    config: its binary mirrors ride ``bucket_cuda`` (B.1, B.2 and B.3
    launched), and a second run gives the same mechanism digest."""
    from pyconsensus_tpu_torch import obs
    from pyconsensus_tpu_torch.econ import MarketEconomy, build_scenario
    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig

    scenario = build_scenario(seed=3, rounds=2, markets_per_strategy=4,
                              concurrency=8)
    digests = []
    for _ in range(2):
        obs.reset()
        ck.reset_launch_counts()
        with ConsensusService(ServeConfig()) as svc:
            res = MarketEconomy(svc, scenario).run()
        digests.append(res["mechanism_digest"])
        counts = ck.launch_counts()
        assert obs.value("pyconsensus_serve_requests_total",
                         path="bucket_cuda", outcome="ok") > 0
        for k in ("apply_weighted_cov", "scores_dirfix_pass",
                  "resolve_certainty_fused"):
            assert counts[k] > 0, counts
        assert res["service"]["mirrors_abandoned"] == 0
    assert digests[0] == digests[1]


@pytest.mark.cuda
def test_two_batchers_first_linalg_calls_at_once(dev, tmp_path):
    """In a fresh process, a two-worker in-process fleet's first session
    resolves reach ``torch.linalg`` from both batcher threads at once;
    torch loads its CUDA linear-algebra library at the first call, and
    two concurrent first calls fail unless the services loaded it first."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(f"""
        import numpy as np
        from pyconsensus_tpu_torch.serve import (ConsensusFleet,
                                                 FleetConfig, ServeConfig)
        fleet = ConsensusFleet(FleetConfig(
            n_workers=2, log_dir={str(tmp_path / "log")!r},
            worker=ServeConfig(warmup=()))).start(warmup=False)
        rng = np.random.default_rng(0)
        names = [f"s{{j}}" for j in range(8)]
        for n in names:
            fleet.create_session(n, n_reporters=24)
            fleet.append(n, rng.choice([0.0, 1.0], size=(24, 48)))
        futs = [fleet.submit(session=n) for n in names]
        for f in futs:
            f.result(timeout=300)
        fleet.close(drain=True)
        print("ok")
    """)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0 and "ok" in run.stdout, run.stderr[-3000:]


# -- the launch-shape autotuner (tune/) ---------------------------------------

TUNE_SHAPES = [(24, 12), (1000, 4099), (517, 2048), (10000, 100000),
               (64, 300), (4096, 65536), (1, 70000)]


@pytest.mark.cuda
def test_split_model_matches_the_library(dev):
    """The Python copies of the library's split choices equal
    ``pyc_row_tile_splits`` and ``pyc_col_tile_splits`` over a grid of
    shapes, storage types and SM counts (the card's own among them)."""
    lib = build.load("storage_sweeps.cu")
    n_sms = (1, 7, 66, 114, 132, ck._sm_count(dev.index or 0))
    for R, E in TUNE_SHAPES + [(R, E) for R in (63, 64, 65, 8192)
                               for E in (511, 512, 513, 16384)]:
        for dtype, code in ck._STORAGE_CODES.items():
            item = torch.empty((), dtype=dtype).element_size()
            for n_sm in n_sms:
                assert ck.row_tile_splits(R, E, item, n_sm) == \
                    lib.pyc_row_tile_splits(R, E, code, n_sm), (R, E, code)
                assert ck.col_tile_splits(R, E, item, n_sm) == \
                    lib.pyc_col_tile_splits(R, E, code, n_sm), (R, E, code)


def _tune_storages(seed, R, E):
    x_f, x_i, rep, fill, mu, v = make_storage(seed, R, E)
    xb = bf16_storage(seed, R, E)[0]
    return [(_t(x_i), "int8"), (_t(x_f), "float32"), (xb, "bfloat16")], \
        rep, fill, mu, v


def _splits(kind, s):
    """A provider that sets one tile pass's split count to ``s``."""
    return lambda k, **ctx: s if k == kind else None


@pytest.mark.cuda
@pytest.mark.parametrize("R,E", [(1000, 4099), (517, 2048)])
def test_every_legal_split_and_width_agrees_with_the_builtin(dev, R, E):
    """Every legal split count of both tile passes and every legal resolve
    width gives the built-in shape's results (resolve's outcomes and
    absent counts bit for bit, every sum within the kernel band) and the
    plain versions' results within the kernel band."""
    storages, rep, fill, mu, v = _tune_storages(31, R, E)
    repd, fd, mud, vd = (_t(a).to(dev) for a in (rep, fill, mu, v))
    for x, name in storages:
        xd = x.to(dev)
        item = x.element_size()
        base = ck.apply_weighted_cov(xd, mud, repd, vd, fd)
        base_s = ck.scores_dirfix_pass(xd, repd, vd, fd)
        plain = ck.apply_weighted_cov_plain(xd, mud, repd, vd, fd)
        plain_s = ck.scores_dirfix_pass_plain(xd, repd, vd, fd)
        for kind in ("row_tile_splits", "col_tile_splits"):
            for s in ck.split_candidates(kind, R, E, item):
                with ck.tuned_shapes(_splits(kind, s)):
                    got = ck.apply_weighted_cov(xd, mud, repd, vd, fd)
                    got_s = ck.scores_dirfix_pass(xd, repd, vd, fd)
                what = f"{name} {kind}={s}"
                _close(got, base, f"{what} B.1 vs the built-in")
                _close(got, plain, f"{what} B.1 vs plain")
                for g, b, r in zip(got_s, base_s, plain_s):
                    _close(g, b, f"{what} B.2 vs the built-in")
                    _close(g, r, f"{what} B.2 vs plain")
        ref = ck.resolve_certainty_fused(xd, repd, fd, 1.0, 0.1)
        plain_r = ck.resolve_certainty_fused_plain(xd, repd, fd, 1.0, 0.1)
        for C in ck.resolve_block_candidates(R, item):
            for s in (1, ck.split_candidates("row_tile_splits", R, E,
                                             item)[-1]):
                got = ck.resolve_certainty_fused(xd, repd, fd, 1.0, 0.1,
                                                 block_cols=C, row_splits=s)
                assert torch.equal(got[1], ref[1]), (name, C, s)
                assert torch.equal(got[5], ref[5]), (name, C, s)
                for g, r, q in zip(got, ref, plain_r):
                    _close(g, r, f"{name} resolve C={C} splits={s}")
                    _close(g, q, f"{name} resolve C={C} splits={s} vs plain")


@pytest.mark.cuda
def test_tuned_shapes_reach_the_launch_and_stay_k_independent(dev):
    """Under an installed provider every tile-pass wrapper asks it for its
    pass's split count and takes it (bit for bit the sweep's explicit
    override, within the band of the plain versions), and the tiling
    stays independent of k: the first columns of a k = 16 launch equal a
    k = 3 launch, the matvec the k = 1 block call, a k = 8 block's first
    two columns a k = 2 block."""
    R, E = 1000, 4099
    storages, rep, fill, mu, v = _tune_storages(37, R, E)
    repd, fd, mud, vd = (_t(a).to(dev) for a in (rep, fill, mu, v))
    g = torch.Generator().manual_seed(2)
    V = torch.randn((E, 16), generator=g).to(dev)
    W = torch.randn((16, R), generator=g).to(dev)
    for x, name in storages:
        xd = x.to(dev)
        item = x.element_size()
        row = ck.split_candidates("row_tile_splits", R, E, item)[-1]
        col = ck.split_candidates("col_tile_splits", R, E, item)[1]

        def provider():
            asked = []

            def ask(kind, **ctx):
                asked.append(kind)
                return {"row_tile_splits": row,
                        "col_tile_splits": col}.get(kind)
            return ask, asked

        def under(call, kinds):
            ask, asked = provider()
            with ck.tuned_shapes(ask):
                out = call()
            assert set(asked) == set(kinds), (name, asked)
            return out

        both = ("row_tile_splits", "col_tile_splits")
        tuned = under(lambda: ck.apply_weighted_cov(xd, mud, repd, vd, fd),
                      both)
        assert torch.equal(tuned, ck.apply_weighted_cov(
            xd, mud, repd, vd, fd, row_splits=row, col_splits=col)), name
        wide = under(lambda: ck.storage_matmat(xd, V, fd),
                     ("row_tile_splits",))
        _close(wide, ck.storage_matmat_plain(xd, V, fd), f"{name} B.7")
        rows = under(lambda: ck.storage_rows_matmat(xd, W, fd),
                     ("col_tile_splits",))
        _close(rows, ck.storage_rows_matmat_plain(xd, W, fd), f"{name} B.6")
        vec = under(lambda: ck.storage_matvec(xd, vd, fd),
                    ("row_tile_splits",))
        y8 = under(lambda: ck.apply_weighted_cov_block(
            xd, mud, repd, V[:, :8], fd)[0], both)
        _close(y8, ck.apply_weighted_cov_block_plain(
            xd, mud, repd, V[:, :8], fd)[0], f"{name} B.8")
        with ck.tuned_shapes(provider()[0]):
            assert torch.equal(wide[:, :3], ck.storage_matmat(xd, V[:, :3],
                                                              fd))
            assert torch.equal(rows[:3], ck.storage_rows_matmat(xd, W[:3],
                                                                fd))
            assert torch.equal(vec, ck.storage_matmat(xd, vd[:, None],
                                                      fd)[:, 0])
            y2 = ck.apply_weighted_cov_block(xd, mud, repd, V[:, :2], fd)[0]
            assert torch.equal(y8[:, :2], y2)


@pytest.mark.cuda
def test_timed_sweeps_persist_and_are_served(dev, tmp_path):
    """The card's sweeps time every candidate, persist a legal winner under
    the card's generation, and a provider built from the file serves it
    to the launches; the depth sweep runs the bucket ring on the card."""
    import json

    from pyconsensus_tpu_torch.tune import (autotune_cov,
                                            autotune_pipeline_depth,
                                            autotune_resolve,
                                            default_provider,
                                            device_generation)

    path = tmp_path / "cache.json"
    cov = autotune_cov(4099, n_reporters=1000, storage_dtype="int8",
                       path=path, repeats=2)
    res = autotune_resolve(1000, n_events=4099, storage_dtype="int8",
                           path=path, repeats=2)
    for e in (*cov.values(), res):
        assert e["mode"] == "timed"
        assert e["value"] in e["candidates"]
        assert set(e["timings_ms"]) == {str(c) for c in e["candidates"]}
    raw = json.loads(path.read_text())
    gen = device_generation(dev)
    assert all(k.startswith(gen + "/") for k in raw["entries"])
    with ck.tuned_shapes(default_provider(path, device=dev)):
        assert ck.row_splits(1000, 4099, 1, 132, dev) == \
            cov["row_tile_splits"]["value"]
        assert ck.col_splits(1000, 4099, 1, 132, dev) == \
            cov["col_tile_splits"]["value"]
        assert ck.resolve_cols(1000, 1, dev) == res["value"]
    depth = autotune_pipeline_depth(32, 256, path=path, repeats=1,
                                    dispatches=4)
    assert depth["mode"] == "timed" and depth["value"] in (1, 2, 3, 4)


@pytest.mark.cuda
def test_stream_bandwidth_on_the_card(dev):
    from pyconsensus_tpu_torch.tune import stream_bandwidth_bytes_per_s

    bw = stream_bandwidth_bytes_per_s(mbytes=256, repeats=3)
    assert 1e11 < bw < 3.35e12 * 1.05


_WITNESS_SCRIPT = r"""
import importlib.util, json, sys
repo = sys.argv[1]
spec = importlib.util.spec_from_file_location(
    "boot_witness", repo + "/pyconsensus_tpu_torch/analysis/witness.py")
wmod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(wmod)
w = wmod.LockWitness().install()
sys.path.insert(0, repo)
import numpy as np
from pyconsensus_tpu_torch import obs
from pyconsensus_tpu_torch.analysis.concurrency import lock_order_edges
from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig
rng = np.random.default_rng(0)
x = rng.choice([0.0, 1.0], size=(200, 2000))
with ConsensusService(ServeConfig(), device="cuda") as svc:
    svc.submit(reports=x).result(300)
w.uninstall()
static = lock_order_edges()
w.check(static=static)
names = static["locks"]
print(json.dumps({
    "taken": sorted(names.get(k, k) for k in w.taken),
    "cuda": obs.value("pyconsensus_serve_requests_total",
                      path="bucket_cuda", outcome="ok")}))
"""


@pytest.mark.cuda
def test_the_lock_witness_sees_the_cards_locks(dev):
    """A fresh process installs the lock witness from its file before it
    imports the package, then serves one request on ``bucket_cuda``: the
    locks only the card's paths take (the kernel build, the first
    ``torch.linalg`` call, the class's executable cache, the launch
    counters) are witnessed and taken, and the observed order is
    consistent with the static graph."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _WITNESS_SCRIPT, repo],
                       capture_output=True, text=True, cwd=repo,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["cuda"] == 1.0
    assert {"build._LOCK", "service._LINALG_LOCK", "ExecutableCache._lock",
            "cuda_kernels._COUNTS_LOCK"} <= set(out["taken"])
