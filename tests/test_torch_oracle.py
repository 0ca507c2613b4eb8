"""The port's ``Oracle`` against the JAX package's on the CPU.

``Oracle(backend="torch", device="cpu")`` in float64 (the x64 conftest's
dtype) runs against ``Oracle(backend="jax")`` on the corpora of
``tests/test_oracle.py`` (the canonical, missing and scaled fixtures at
their golden iteration counts, every ported algorithm on the canonical
matrix) and of ``tests/test_eval_configs.py`` configs 1-3. Exact keys
(snapped outcomes, binary ``outcomes_final``, ``na_row``, iterations,
convergence) equal; the rest within 1e-7, scaled outcomes within 1e-7 of
the event's range, loadings up to sign. The port's ``backend="numpy"``
must equal the reference's numpy backend bit for bit.

One known deviation (``ROADMAP.md`` §C): on the canonical matrix the
second fixed-variance component is an exact tie between the mirror
reporters 1 and 3, and which of them the eigensolver's last bit favours
decides the blend; torch's and numpy's LAPACK may round it apart, so
that case accepts either order of the two.
"""

import numpy as np
import pytest
import torch

from conftest import collusion_reports
from pyconsensus_tpu import Oracle as RefOracle
from pyconsensus_tpu.models.pipeline import ConsensusParams as RefParams
from pyconsensus_tpu.models.pipeline import consensus_np as ref_consensus_np
from pyconsensus_tpu_torch import ALGORITHMS, BACKENDS, Oracle
from pyconsensus_tpu_torch.faults.errors import InputError, NumericsError
from pyconsensus_tpu_torch.models.pipeline import ConsensusParams
from pyconsensus_tpu_torch.models.pipeline import consensus_np
from test_oracle import (CANONICAL, GOLDEN, MISSING, SCALED_BOUNDS,
                         SCALED_REPORTS)

FIXTURES = {"canonical": (CANONICAL, None), "missing": (MISSING, None),
            "scaled": (SCALED_REPORTS, SCALED_BOUNDS)}
PORTED = ("sztorc", "fixed-variance", "ica")
#: the mirror reporters of the canonical matrix
MIRROR = [0, 3, 2, 1, 4, 5]


@pytest.fixture(autouse=True)
def _float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def scaled_mask(bounds, E):
    return np.array([bool(b and b.get("scaled")) for b in
                     (bounds or [None] * E)])


def assert_oracles_match(got, ref, bounds=None, atol=1e-7, mirror=False):
    """Key by key; ``mirror`` compares the agents with the canonical
    matrix's mirror reporters exchanged and the events' continuous keys
    only where they do not move with that exchange."""
    assert int(got["iterations"]) == int(ref["iterations"])
    assert bool(got["convergence"]) == bool(ref["convergence"])
    E = np.asarray(ref["events"]["outcomes_final"]).shape[0]
    sc = scaled_mask(bounds, E)
    for group in ("agents", "events"):
        assert set(got[group]) == set(ref[group]), group
        for key, a in ref[group].items():
            a = np.asarray(a)
            b = np.asarray(got[group][key])
            if group == "agents" and mirror:
                b = b[MIRROR]
            if key in ("outcomes_adjusted", "outcomes_final"):
                np.testing.assert_array_equal(b[~sc], a[~sc], err_msg=key)
                span = np.where(sc, np.asarray(
                    [b_["max"] - b_["min"] if b_ else 1.0
                     for b_ in (bounds or [None] * E)]), 1.0)
                assert np.all(np.abs(b - a) <= atol * span), key
            elif key == "na_row":
                np.testing.assert_array_equal(b, a, err_msg=key)
            elif mirror and key in ("outcomes_raw", "adj_first_loadings"):
                continue
            elif key == "adj_first_loadings":
                np.testing.assert_allclose(np.abs(b), np.abs(a), atol=atol,
                                           rtol=0, err_msg=key)
            else:
                np.testing.assert_allclose(b, a, atol=atol, rtol=0,
                                           err_msg=key)
    for key in ("participation", "certainty"):
        assert got[key] == pytest.approx(ref[key], abs=atol)


@pytest.mark.parametrize("fixture,max_iterations", sorted(GOLDEN))
def test_golden_fixtures_match_the_jax_oracle(fixture, max_iterations):
    reports, bounds = FIXTURES[fixture]
    kw = dict(reports=reports, event_bounds=bounds,
              max_iterations=max_iterations)
    got = Oracle(backend="torch", device="cpu", **kw).consensus()
    assert_oracles_match(got, RefOracle(backend="jax", **kw).consensus(),
                         bounds)


@pytest.mark.parametrize("algo", PORTED)
@pytest.mark.parametrize("pca_method", ["auto", "eigh-gram", "power"])
def test_every_algorithm_on_the_canonical_matrix(algo, pca_method):
    kw = dict(reports=CANONICAL, algorithm=algo, pca_method=pca_method,
              max_iterations=3)
    got = Oracle(backend="torch", device="cpu", **kw).consensus()
    ref = RefOracle(backend="jax", **kw).consensus()
    if algo == "fixed-variance" and pca_method == "auto":
        # the covariance eigh ("auto" at E = 4) resolves the mirror tie by
        # its last bit (module docstring): either order of the two mirror
        # reporters
        try:
            assert_oracles_match(got, ref)
        except AssertionError:
            assert_oracles_match(got, ref, mirror=True)
    else:
        assert_oracles_match(got, ref)


def test_config1_pca_50x25(rng):
    reports, truth = collusion_reports(rng, 50, 25, 12)
    got = Oracle(reports=reports, device="cpu").consensus()
    assert_oracles_match(got, RefOracle(reports=reports,
                                        backend="jax").consensus())
    np.testing.assert_array_equal(got["events"]["outcomes_final"], truth)


def test_config2_scaled_categorical_na(rng):
    R = 12
    reports = np.concatenate([rng.choice([0.0, 1.0], size=(R, 3)),
                              rng.choice([0.0, 0.5, 1.0], size=(R, 2)),
                              rng.uniform(100.0, 500.0, size=(R, 2))],
                             axis=1)
    reports[rng.random(reports.shape) < 0.15] = np.nan
    bounds = [None] * 5 + [{"scaled": True, "min": 0.0, "max": 600.0}] * 2
    reputation = rng.random(R) + 0.2
    kw = dict(reports=reports, event_bounds=bounds, reputation=reputation)
    got = Oracle(device="cpu", **kw).consensus()
    assert_oracles_match(got, RefOracle(backend="jax", **kw).consensus(),
                         bounds)
    final = got["events"]["outcomes_final"]
    assert ((final[5:] >= 0.0) & (final[5:] <= 600.0)).all()


def test_config3_iterative_sztorc(rng):
    reports, _ = collusion_reports(rng, 30, 15, 8)
    kw = dict(reports=reports, max_iterations=100,
              convergence_tolerance=1e-3)
    got = Oracle(device="cpu", **kw).consensus()
    assert got["convergence"] and got["iterations"] > 1
    assert_oracles_match(got, RefOracle(backend="jax", **kw).consensus())


@pytest.mark.parametrize("algo", PORTED)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_numpy_backend_is_the_reference_bit_for_bit(algo, fixture):
    reports, bounds = FIXTURES[fixture]
    from pyconsensus_tpu.oracle import parse_event_bounds

    scaled, mins, maxs = parse_event_bounds(bounds, reports.shape[1])
    rep = np.full(reports.shape[0], 1.0 / reports.shape[0])
    for mi in (1, 3):
        kw = dict(algorithm=algo, max_iterations=mi)
        got = consensus_np(reports, rep, scaled, mins, maxs,
                           ConsensusParams(**kw))
        ref = ref_consensus_np(reports, rep, scaled, mins, maxs,
                               RefParams(**kw))
        assert set(got) == set(ref)
        for key, a in ref.items():
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(a), err_msg=key)
    got = Oracle(reports=reports, event_bounds=bounds, algorithm=algo,
                 backend="numpy").consensus()
    ref = RefOracle(reports=reports, event_bounds=bounds, algorithm=algo,
                    backend="numpy").consensus()
    np.testing.assert_array_equal(got["agents"]["smooth_rep"],
                                  ref["agents"]["smooth_rep"])


def test_pre_encoded_int8_reports_decode():
    from pyconsensus_tpu_torch import encode_reports_host

    enc = encode_reports_host(MISSING)
    a = Oracle(reports=enc, device="cpu").consensus()
    b = Oracle(reports=MISSING, device="cpu").consensus()
    np.testing.assert_array_equal(a["agents"]["smooth_rep"],
                                  b["agents"]["smooth_rep"])
    with pytest.warns(UserWarning, match="ambiguous"):
        Oracle(reports=(CANONICAL > 0).astype(np.int8), device="cpu")
    with pytest.raises(ValueError, match="encoded=True"):
        Oracle(reports=CANONICAL, encoded=True, device="cpu")


def test_result_dict_and_quarantine(capsys):
    reports = MISSING.copy()
    reports[2, 1] = np.inf
    r = Oracle(reports=reports, device="cpu", verbose=True).consensus()
    np.testing.assert_array_equal(r["quarantined_rows"], [2])
    assert r["agents"]["na_row"][2]
    assert isinstance(r["events"]["outcomes_final"], np.ndarray)
    assert isinstance(r["iterations"], int)
    assert "outcomes_final" in capsys.readouterr().out
    assert "ica_converged" in Oracle(reports=CANONICAL, algorithm="ica",
                                     device="cpu").consensus()
    assert BACKENDS == ("numpy", "torch")
    assert ALGORITHMS == ("sztorc", "fixed-variance", "ica", "k-means",
                          "dbscan-jit", "hierarchical", "dbscan")
    assert set(PORTED) < set(ALGORITHMS)


@pytest.mark.parametrize("case", ["clustering", "bfloat16", "matvec",
                                  "int8"])
def test_refusals_name_the_roadmap(case):
    kw = {"clustering": dict(algorithm="k-means"),
          "bfloat16": dict(storage_dtype="bfloat16"),
          "matvec": dict(matvec_dtype="bfloat16"),
          "int8": dict(storage_dtype="int8")}[case]
    o = Oracle(reports=CANONICAL, device="cpu", **kw)
    if case == "int8":
        with pytest.raises(ValueError, match="fused path"):
            o.consensus()
        return
    if case in ("bfloat16", "matvec"):
        # bfloat16 storage and the bfloat16 sweeps serve: the reference's
        # outcomes, its reputation within 1e-5
        for mi in (1, 5):
            got = Oracle(reports=CANONICAL, device="cpu", max_iterations=mi,
                         **kw).consensus()
            want = RefOracle(reports=CANONICAL, backend="jax",
                             max_iterations=mi, **kw).consensus()
            np.testing.assert_array_equal(got["events"]["outcomes_final"],
                                          want["events"]["outcomes_final"])
            np.testing.assert_allclose(got["agents"]["smooth_rep"],
                                       want["agents"]["smooth_rep"],
                                       atol=1e-5)
        return
    # clustering serves since §A.6 landed: k-means on the torch and the
    # numpy backends against the reference's
    for mi in (1, 3):
        got = Oracle(reports=CANONICAL, device="cpu", max_iterations=mi,
                     **kw).consensus()
        assert_oracles_match(got, RefOracle(reports=CANONICAL,
                                            backend="jax", max_iterations=mi,
                                            **kw).consensus())
        got = Oracle(reports=CANONICAL, backend="numpy", max_iterations=mi,
                     **kw).consensus()
        want = RefOracle(reports=CANONICAL, backend="numpy",
                         max_iterations=mi, **kw).consensus()
        np.testing.assert_array_equal(got["agents"]["smooth_rep"],
                                      want["agents"]["smooth_rep"])


@pytest.mark.parametrize("method,hops", [
    ("power", [("power", "eigh-gram"), ("torch:eigh-gram", "numpy")]),
    ("eigh-gram", [("torch:eigh-gram", "numpy")]),
    ("auto", [("torch:eigh-cov", "numpy")]),
])
def test_non_finite_result_walks_the_fallback_chain(monkeypatch, method,
                                                    hops):
    """A torch result that stays non-finite on every torch rung walks the
    reference's chain down to the numpy pipeline, hop by hop, and returns
    the numpy backend's result bit for bit."""
    from pyconsensus_tpu_torch import obs, oracle

    real = oracle.consensus_torch

    def poisoned(*a, **k):
        out = real(*a, **k)
        out["smooth_rep"] = out["smooth_rep"] * float("nan")
        return out

    monkeypatch.setattr(oracle, "consensus_torch", poisoned)
    counts = [obs.value("pyconsensus_fallbacks_total", **{
        "from": f, "to": t, "reason": "nonfinite_result"}) or 0
        for f, t in hops]
    got = Oracle(reports=CANONICAL, device="cpu", pca_method=method,
                 max_iterations=3).consensus()
    assert [obs.value("pyconsensus_fallbacks_total", **{
        "from": f, "to": t, "reason": "nonfinite_result"})
        for f, t in hops] == [c + 1 for c in counts]
    want = Oracle(reports=CANONICAL, backend="numpy",
                  max_iterations=3).consensus()
    for group in ("agents", "events"):
        for key, a in want[group].items():
            np.testing.assert_array_equal(got[group][key], a, err_msg=key)


def test_non_finite_everywhere_raises(monkeypatch):
    """When the numpy rung is non-finite too, the result is refused with
    the classified error: ConvergenceError from a power-family start."""
    from pyconsensus_tpu_torch import oracle
    from pyconsensus_tpu_torch.faults.errors import ConvergenceError

    for name in ("consensus_torch", "consensus_np"):
        real = getattr(oracle, name)

        def poisoned(*a, _real=real, **k):
            out = _real(*a, **k)
            out["smooth_rep"] = out["smooth_rep"] * float("nan")
            return out

        monkeypatch.setattr(oracle, name, poisoned)
    with pytest.raises(ConvergenceError, match="PYC202"):
        Oracle(reports=CANONICAL, device="cpu",
               pca_method="power").consensus()
    with pytest.raises(NumericsError, match="PYC201"):
        Oracle(reports=CANONICAL, device="cpu",
               pca_method="eigh-gram").consensus()


def test_validation():
    with pytest.raises(InputError):
        Oracle(device="cpu")
    with pytest.raises(InputError):
        Oracle(reports=np.zeros(4), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        Oracle(reports=CANONICAL, backend="jax")
    with pytest.raises(InputError):
        Oracle(reports=CANONICAL, reputation=-np.ones(6), device="cpu")
    assert Oracle(reports=CANONICAL, algorithm="PCA",
                  device="cpu").params.algorithm == "sztorc"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Oracle(reports=CANONICAL)


def test_n_scaled_wiring():
    """The exact scaled count where the median gathers, else 0."""
    E = 20
    few = [{"scaled": True, "min": 0.0, "max": 1.0}] * 3 + [None] * (E - 3)
    most = [{"scaled": True, "min": 0.0, "max": 1.0}] * 19 + [None]
    reports = np.random.default_rng(0).random((8, E))
    assert Oracle(reports=reports, event_bounds=few,
                  device="cpu").params.n_scaled == 3
    assert Oracle(reports=reports, event_bounds=most,
                  device="cpu").params.n_scaled == 0
