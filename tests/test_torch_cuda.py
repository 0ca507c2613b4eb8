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

# ragged widths (E % 16 != 0) take the scalar-load kernels, the rest the
# 16-byte ones; 1000 rows is not a multiple of the 8-row blocks
SHAPES = [(24, 12), (23, 300), (64, 300), (64, 4096), (1000, 4099),
          (517, 2048)]
EXACT_KEYS = ("outcomes_adjusted", "outcomes_final", "na_row", "iterations",
              "convergence")


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
    x_f, x_i, rep, fill, mu, v = make_storage(R + E, R, E,
                                              dense=not with_fill)
    x = _t(x_i if storage == "int8" else x_f)
    f = _t(fill) if with_fill else None
    ref = ck.apply_weighted_cov(x, _t(mu), _t(rep), _t(v), f)
    got = ck.apply_weighted_cov(x.to(dev), _t(mu).to(dev), _t(rep).to(dev),
                                _t(v).to(dev), None if f is None else f.to(dev))
    _close(got, ref, "apply_weighted_cov")
    ref = ck.scores_dirfix_pass(x, _t(rep), _t(v), f)
    got = ck.scores_dirfix_pass(x.to(dev), _t(rep).to(dev), _t(v).to(dev),
                                None if f is None else f.to(dev))
    for name, g, r in zip("tqco", got, ref):
        _close(g, r, f"scores_dirfix {name}")


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
    """At R = 10000 the int8 panel fits 16 columns of shared memory and
    the float32 one 4; both still agree with the plain version."""
    assert ck.resolve_block_cols(10000, 1) == 16
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
    assert all(n > 0 for n in counts.values()), counts
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
