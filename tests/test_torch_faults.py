"""The port's faults (``pyconsensus_tpu_torch.faults``) and its fallback
chain, against the JAX package on the CPU.

- **The reference's suites on the port's modules.** ``tests/
  test_faults.py``'s ``TestErrorTaxonomy``, ``TestFaultPlan``,
  ``TestRetry``, ``TestQuarantine``, ``TestFallbackChain`` and
  ``TestNaNStormFuzz``, with ``Oracle(device="cpu")`` (the torch backend)
  where the reference runs ``backend="jax"``.
- **Parity.** One ``FaultPlan`` dict poisons the same cells in both
  packages (every data kind, dict payloads, seeded activation), and
  through ``Oracle`` (the reference's ``backend="jax"``, the port's
  ``device="cpu"``, float64) it walks the same hops, modulo the
  ``jax:``/``torch:`` prefix of a hop off the device backend. The
  recovered result: exact keys (snapped outcomes, ``na_row``,
  iterations, convergence) equal, continuous keys within 1e-5 for sztorc
  and 2e-3 for fixed-variance and ica (the bands of
  ``tests/test_torch_multi.py``), loadings up to sign. An exhausted
  chain raises the same code in both (PYC202 from a power-family start,
  PYC201 from an exact one).
- **ShardedOracle** against the reference's on its CPU mesh, on 1 and 4
  shards, float and int8 sentinel reports, sztorc: key by key in the same
  bands. The port's fused path (the kernels' plain versions on the CPU)
  serves where the reference's XLA path does, the reference's fused gate
  being open on a TPU only.
- **No fallback that hides a fault.** An error raised by a kernel wrapper
  propagates out of ``consensus()`` and starts no rung.
- The port's ``faults`` and ``obs`` import without JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import collusion_reports
from pyconsensus_tpu import Oracle as RefOracle
from pyconsensus_tpu import faults as ref_faults
from pyconsensus_tpu import obs as ref_obs
from pyconsensus_tpu.parallel import ShardedOracle as RefShardedOracle
from pyconsensus_tpu.parallel import make_mesh as ref_make_mesh
from pyconsensus_tpu_torch import (Oracle, ShardedOracle, encode_reports_host,
                                   faults, obs)
from pyconsensus_tpu_torch.faults import (CheckpointCorruptionError,
                                          ConsensusError, ConvergenceError,
                                          FaultPlan, InputError,
                                          NumericsError, SimulatedCrash)
from pyconsensus_tpu_torch.parallel import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CANONICAL = np.array([
    [1.0, 1.0, 0.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [1.0, 1.0, 0.0, 0.0],
    [1.0, 1.0, 1.0, 0.0],
    [0.0, 0.0, 1.0, 1.0],
    [0.0, 0.0, 1.0, 1.0],
])
#: every result key compared exactly
EXACT = ("outcomes_adjusted", "outcomes_final", "na_row")
#: the band of each algorithm's continuous keys
BANDS = {"sztorc": 1e-5, "fixed-variance": 2e-3, "ica": 2e-3}
NAN_STORM = {"site": "oracle.raw_result", "kind": "nan_storm",
             "occurrences": [0], "args": {"fraction": 1.0}}


@pytest.fixture(autouse=True)
def _clean():
    """float64 as the reference under x64; no plan leaks out of a test."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)
    faults.disarm()
    ref_faults.disarm()


def nan_matrix(seed=5, R=40, E=96, liars=8, na_frac=0.1):
    """The seeded NaN collusion matrix of the parity tests."""
    return collusion_reports(np.random.default_rng(seed), R, E, liars,
                             na_frac=na_frac)[0]


def fallbacks(registry):
    """``{(from, to, reason): count}`` of a registry's fallback hops."""
    series = registry.snapshot().get("pyconsensus_fallbacks_total",
                                     {}).get("series", {})
    return {tuple(json.loads(k)[n] for n in ("from", "to", "reason")): v
            for k, v in series.items()}


def hops_since(registry, before):
    after = fallbacks(registry)
    return {k: after[k] - before.get(k, 0.0) for k in after
            if after[k] != before.get(k, 0.0)}


def unprefixed(hops):
    return {(f.split(":")[-1], t, r): n for (f, t, r), n in hops.items()}


def assert_results_match(got, ref, atol):
    """Nested result dicts: the same agents/events keys, exact keys
    equal, the rest within ``atol`` (loadings up to sign)."""
    assert int(got["iterations"]) == int(ref["iterations"])
    assert bool(got["convergence"]) == bool(ref["convergence"])
    for group in ("agents", "events"):
        assert set(got[group]) == set(ref[group]), group
        for key, a in ref[group].items():
            a, b = np.asarray(a), np.asarray(got[group][key])
            if key in EXACT:
                np.testing.assert_array_equal(b, a, err_msg=key)
            elif key == "adj_first_loadings":
                np.testing.assert_allclose(np.abs(b), np.abs(a), rtol=0,
                                           atol=atol, err_msg=key)
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=atol,
                                           err_msg=key)
    for key in ("participation", "certainty"):
        assert got[key] == pytest.approx(ref[key], abs=atol)


# -- taxonomy --------------------------------------------------------------


class TestErrorTaxonomy:
    def test_codes_are_stable(self):
        assert ConsensusError.error_code == "PYC000"
        assert InputError.error_code == "PYC101"
        assert NumericsError.error_code == "PYC201"
        assert ConvergenceError.error_code == "PYC202"
        assert CheckpointCorruptionError.error_code == "PYC301"
        assert faults.ERROR_CODES["PYC301"] is CheckpointCorruptionError

    def test_the_references_codes_and_classes(self):
        """Every class of the reference's taxonomy, under the same code,
        name and builtin bases."""
        assert set(faults.ERROR_CODES) == set(ref_faults.ERROR_CODES)
        for code, cls in faults.ERROR_CODES.items():
            ref = ref_faults.ERROR_CODES[code]
            assert cls.__name__ == ref.__name__
            builtin = lambda c: {b for b in c.__mro__  # noqa: E731
                                 if b.__module__ == "builtins"}
            assert builtin(cls) == builtin(ref), code

    def test_backward_compatible_bases(self):
        assert issubclass(InputError, ValueError)
        assert issubclass(CheckpointCorruptionError, ValueError)
        assert issubclass(NumericsError, ArithmeticError)
        assert issubclass(ConvergenceError, NumericsError)

    def test_context_and_code_in_message(self):
        e = InputError("bad row", row=3, column=7)
        assert e.context == {"row": 3, "column": 7}
        assert "[PYC101]" in str(e) and "bad row" in str(e)

    def test_crash_is_not_an_exception(self):
        assert issubclass(SimulatedCrash, BaseException)
        assert not issubclass(SimulatedCrash, Exception)


# -- the injection core ----------------------------------------------------


class TestFaultPlan:
    def test_disarmed_hooks_are_identity(self):
        arr = np.ones((3, 3))
        assert faults.corrupt("any.site", arr) is arr
        faults.fire("any.site")
        assert faults.active_plan() is None

    def test_occurrence_indexing(self):
        plan = FaultPlan(seed=0, rules=[
            {"site": "s", "kind": "raise", "occurrences": [2],
             "args": {"error": "os_error"}}])
        with faults.armed(plan):
            faults.fire("s")
            faults.fire("s")
            with pytest.raises(OSError):
                faults.fire("s")
            faults.fire("s")
        assert plan.fired == [("s", 2, "raise")]

    def test_site_patterns_and_max_fires(self):
        plan = FaultPlan(seed=0, rules=[
            {"site": "sweep.chunk.*", "kind": "raise",
             "occurrences": [0, 1], "max_fires": 1}])
        with faults.armed(plan):
            with pytest.raises(OSError):
                faults.fire("sweep.chunk.write")
            faults.fire("sweep.chunk.write")
            faults.fire("sweep.chunk.pre_commit")
        assert len(plan.fired) == 1

    def test_probability_is_seeded_and_deterministic(self):
        def run(seed):
            plan = FaultPlan(seed=seed, rules=[
                {"site": "p", "kind": "nan_storm", "probability": 0.5,
                 "max_fires": 0, "args": {"fraction": 1.0}}])
            hits = []
            with faults.armed(plan):
                for _ in range(32):
                    out = faults.corrupt("p", np.ones(4))
                    hits.append(bool(np.isnan(out).any()))
            return hits

        a, b = run(7), run(7)
        assert a == b
        assert run(8) != a
        assert 0 < sum(a) < 32

    def test_payload_determinism_is_interleaving_independent(self):
        rules = [{"site": "a", "kind": "nan_storm", "occurrences": [1],
                  "args": {"fraction": 0.3}},
                 {"site": "b", "kind": "nan_storm", "occurrences": [0],
                  "args": {"fraction": 0.3}}]
        arr = np.ones((8, 8))
        with faults.armed(FaultPlan(seed=1, rules=rules)):
            faults.corrupt("a", arr)
            r1 = faults.corrupt("a", arr)
        with faults.armed(FaultPlan(seed=1, rules=rules)):
            faults.corrupt("a", arr)
            faults.corrupt("b", arr)
            r2 = faults.corrupt("a", arr)
        np.testing.assert_array_equal(np.isnan(r1), np.isnan(r2))

    def test_json_round_trip(self, tmp_path):
        plan = FaultPlan(seed=9, rules=[
            {"site": "x", "kind": "inf_storm", "occurrences": [0, 3],
             "args": {"fraction": 0.1}},
            {"site": "y.*", "kind": "torn_write", "probability": 0.25},
        ])
        path = plan.save(tmp_path / "plan.json")
        loaded = FaultPlan.load(path)
        assert loaded.to_dict() == plan.to_dict()
        # the same file loads in the reference to the same plan
        assert ref_faults.FaultPlan.load(path).to_dict() == plan.to_dict()

    def test_unknown_keys_rejected(self):
        with pytest.raises(ValueError, match="unknown fault-rule keys"):
            FaultPlan(rules=[{"site": "s", "kind": "raise", "bogus": 1}])
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultPlan(rules=[{"site": "s", "kind": "explode"}])

    def test_corrupt_never_mutates_input(self):
        arr = np.ones((4, 4))
        with faults.armed(FaultPlan(seed=0, rules=[
                {"site": "s", "kind": "nan_storm",
                 "args": {"fraction": 1.0}}])):
            out = faults.corrupt("s", arr)
        assert np.isnan(out).all()
        assert not np.isnan(arr).any()

    def test_drop_shard_nans_one_column_block(self):
        arr = np.ones((4, 16))
        with faults.armed(FaultPlan(seed=0, rules=[
                {"site": "s", "kind": "drop_shard",
                 "args": {"shard": 1, "n_shards": 4}}])):
            out = faults.corrupt("s", arr)
        assert np.isnan(out[:, 4:8]).all()
        assert np.isfinite(out[:, :4]).all()
        assert np.isfinite(out[:, 8:]).all()

    def test_dict_payload_poisons_floats_only(self):
        with faults.armed(FaultPlan(seed=0, rules=[
                {"site": "s", "kind": "nan_storm",
                 "args": {"fraction": 1.0}}])):
            out = faults.corrupt("s", {"x": np.ones(3),
                                       "n": np.arange(3),
                                       "flag": np.asarray(True)})
        assert np.isnan(out["x"]).all()
        np.testing.assert_array_equal(out["n"], np.arange(3))
        assert out["flag"] == np.asarray(True)

    @pytest.mark.parametrize("kind,args", [
        ("nan_storm", {"fraction": 0.3}),
        ("inf_storm", {"fraction": 0.2, "value": -np.inf}),
        ("zero_out", {"fraction": 0.25}),
        ("drop_rows", {"fraction": 0.3}),
        ("drop_rows", {"rows": [1, 5]}),
        ("drop_shard", {"n_shards": 3}),
    ])
    def test_poisons_the_same_cells_as_the_reference(self, kind, args):
        """One plan dict, the same cells in both packages: seeded
        activation, array and dict payloads, occurrence by occurrence."""
        plan_dict = {"seed": 17, "rules": [
            {"site": "oracle.reports", "kind": kind, "occurrences": [0, 2],
             "args": args},
            {"site": "oracle.raw_result", "kind": kind, "probability": 0.6,
             "max_fires": 0, "args": args}]}
        arr = np.random.default_rng(3).random((12, 10))
        payload = {"smooth_rep": arr[:, 0], "certainty": arr[0],
                   "iterations": np.asarray(3)}
        runs = []
        for pkg in (faults, ref_faults):
            plan = pkg.FaultPlan.from_dict(plan_dict)
            out = []
            with pkg.armed(plan):
                for _ in range(4):
                    out.append(pkg.corrupt("oracle.reports", arr))
                    out.append(pkg.corrupt("oracle.raw_result", payload))
            runs.append((out, plan.fired))
        (got, got_fired), (want, want_fired) = runs
        assert got_fired == want_fired
        assert any(f[0] == "oracle.raw_result" for f in got_fired)
        for g, w in zip(got, want):
            if isinstance(w, dict):
                assert set(g) == set(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                np.testing.assert_array_equal(g, w)

    def test_sites_are_the_references_and_all_reached(self):
        """Every site of the port's catalog is one of the reference's,
        and every hook call in the package names one of the catalog (and
        each catalog site is reached), read from the source."""
        import re

        assert set(faults.FAULT_SITES) <= set(ref_faults.FAULT_SITES)
        named = set()
        root = os.path.join(REPO, "pyconsensus_tpu_torch")
        for dirpath, _, files in os.walk(root):
            for f in files:
                if f.endswith(".py") and "faults" not in dirpath:
                    text = open(os.path.join(dirpath, f)).read()
                    named |= set(re.findall(
                        r"(?:corrupt|fire)\(\s*\"([a-z_.]+)\"", text))
        assert named == set(faults.FAULT_SITES)


# -- retry -----------------------------------------------------------------


class TestRetry:
    def test_transient_failure_recovers(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert faults.retry_call(flaky, base_delay=0.001) == "ok"
        assert len(calls) == 3
        assert obs.value("pyconsensus_retries_total", label="flaky") >= 2

    def test_exhaustion_reraises_last(self):
        def always():
            raise OSError("still down")

        before = obs.value("pyconsensus_retries_exhausted_total",
                           label="always") or 0
        with pytest.raises(OSError, match="still down"):
            faults.retry_call(always, retries=2, base_delay=0.001)
        assert obs.value("pyconsensus_retries_exhausted_total",
                         label="always") == before + 1

    def test_deadline_bounds_total_time(self):
        calls = []

        def always():
            calls.append(1)
            raise OSError("down")

        t0 = time.monotonic()
        with pytest.raises(OSError):
            faults.retry_call(always, retries=50, base_delay=0.2,
                              max_delay=0.2, deadline=0.3)
        assert time.monotonic() - t0 < 2.0
        assert len(calls) < 10

    def test_corruption_is_not_retried(self):
        calls = []

        def corrupt():
            calls.append(1)
            raise CheckpointCorruptionError("bad chunk")

        with pytest.raises(CheckpointCorruptionError):
            faults.retry_call(corrupt, base_delay=0.001)
        assert len(calls) == 1

    def test_jitter_is_deterministic_and_the_references(self):
        from pyconsensus_tpu.faults.retry import _sleep_for as ref_sleep_for
        from pyconsensus_tpu_torch.faults.retry import _sleep_for

        a = [_sleep_for(k, 0.05, 2.0, 3, "w") for k in range(4)]
        b = [_sleep_for(k, 0.05, 2.0, 3, "w") for k in range(4)]
        assert a == b
        assert a == [ref_sleep_for(k, 0.05, 2.0, 3, "w") for k in range(4)]
        assert a != [_sleep_for(k, 0.05, 2.0, 4, "w") for k in range(4)]
        for k, d in enumerate(a):
            assert 0.5 * min(2.0, 0.05 * 2 ** k) <= d <= min(2.0,
                                                             0.05 * 2 ** k)

    def test_decorator_form(self):
        calls = []

        @faults.retry(retries=3, base_delay=0.001)
        def flaky(x):
            calls.append(1)
            if len(calls) < 2:
                raise OSError("once")
            return x + 1

        assert flaky(1) == 2


# -- quarantine + degradation ---------------------------------------------


class TestQuarantine:
    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    def test_inf_rows_quarantined_not_poisoning(self, backend):
        poisoned = CANONICAL.copy()
        poisoned[1, 2] = np.inf
        poisoned[4, 0] = -np.inf
        kw = dict(backend=backend, max_iterations=2)
        if backend == "torch":
            kw["device"] = "cpu"
        r = Oracle(reports=poisoned, **kw).consensus()
        np.testing.assert_array_equal(r["quarantined_rows"], [1, 4])
        assert np.isfinite(r["agents"]["smooth_rep"]).all()
        assert np.isfinite(r["events"]["outcomes_final"]).all()
        nanned = CANONICAL.copy()
        nanned[[1, 4]] = np.nan
        ref = Oracle(reports=nanned, **kw).consensus()
        np.testing.assert_array_equal(r["events"]["outcomes_final"],
                                      ref["events"]["outcomes_final"])
        np.testing.assert_array_equal(r["agents"]["smooth_rep"],
                                      ref["agents"]["smooth_rep"])

    def test_quarantine_counter_emitted(self):
        before = obs.value("pyconsensus_quarantined_rows_total") or 0
        poisoned = CANONICAL.copy()
        poisoned[0, 0] = np.inf
        Oracle(reports=poisoned, device="cpu").consensus()
        assert obs.value("pyconsensus_quarantined_rows_total") == before + 1

    def test_a_refused_construction_counts_nothing(self):
        before = obs.value("pyconsensus_quarantined_rows_total") or 0
        poisoned = CANONICAL.copy()
        poisoned[0, 0] = np.inf
        with pytest.raises(ValueError):
            Oracle(reports=poisoned, device="cpu", alpha=2.0)
        assert (obs.value("pyconsensus_quarantined_rows_total")
                or 0) == before

    def test_sharded_front_end_quarantines(self):
        from pyconsensus_tpu_torch import sharded_consensus

        poisoned = CANONICAL.copy()
        poisoned[2, 1] = np.inf
        out = sharded_consensus(poisoned, device="cpu")
        np.testing.assert_array_equal(out["quarantined_rows"], [2])
        assert np.isfinite(np.asarray(out["smooth_rep"])).all()
        assert np.isfinite(np.asarray(out["outcomes_final"])).all()

    def test_sharded_reports_site(self):
        """The ``sharded.reports`` chaos site poisons the host matrix
        before quarantine, as in the reference."""
        from pyconsensus_tpu.parallel import sharded_consensus as ref_sc
        from pyconsensus_tpu_torch import sharded_consensus

        reports = nan_matrix(na_frac=0.0)
        plan_dict = {"seed": 4, "rules": [
            {"site": "sharded.reports", "kind": "inf_storm",
             "occurrences": [0], "args": {"fraction": 0.02}}]}
        outs = []
        for pkg, run in ((faults, lambda: sharded_consensus(
                reports, device="cpu")),
                         (ref_faults, lambda: ref_sc(
                             reports, mesh=ref_make_mesh(batch=1,
                                                         event=1)))):
            with pkg.armed(pkg.FaultPlan.from_dict(plan_dict)):
                outs.append(run())
        assert len(outs[0]["quarantined_rows"]) > 0
        np.testing.assert_array_equal(outs[0]["quarantined_rows"],
                                      outs[1]["quarantined_rows"])
        np.testing.assert_array_equal(
            np.asarray(outs[0]["outcomes_final"]),
            np.asarray(outs[1]["outcomes_final"]))

    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    def test_all_nan_matrix_stays_finite(self, backend):
        r = Oracle(reports=np.full((4, 3), np.nan), backend=backend,
                   device="cpu" if backend == "torch" else None).consensus()
        assert np.isfinite(r["agents"]["smooth_rep"]).all()
        assert np.isfinite(r["events"]["outcomes_final"]).all()
        assert r["participation"] == pytest.approx(0.0)

    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    def test_all_inf_matrix_degrades_to_all_nan(self, backend):
        r = Oracle(reports=np.full((4, 3), np.inf), backend=backend,
                   device="cpu" if backend == "torch" else None).consensus()
        assert np.isfinite(r["agents"]["smooth_rep"]).all()
        np.testing.assert_array_equal(r["quarantined_rows"], [0, 1, 2, 3])

    @pytest.mark.parametrize("shape", [(0, 4), (4, 0), (0, 0)])
    def test_empty_matrix_is_structured_input_error(self, shape):
        with pytest.raises(InputError, match="empty"):
            Oracle(reports=np.zeros(shape), device="cpu")

    def test_inf_reputation_is_structured_input_error(self):
        with pytest.raises(InputError, match="finite"):
            Oracle(reports=CANONICAL, device="cpu",
                   reputation=[1.0, np.inf, 1.0, 1.0, 1.0, 1.0])


class TestFallbackChain:
    def test_nonfinite_torch_result_falls_back_and_recovers(self):
        """An internal NaN storm (injected at the host fetch) walks
        power -> eigh-gram and returns a finite result, the hop counted
        in pyconsensus_fallbacks_total{from,to,reason}."""
        labels = {"from": "power", "to": "eigh-gram",
                  "reason": "nonfinite_result"}
        before = obs.value("pyconsensus_fallbacks_total", **labels) or 0
        plan = FaultPlan(seed=0, rules=[NAN_STORM])
        with faults.armed(plan):
            r = Oracle(reports=CANONICAL, device="cpu",
                       pca_method="power").consensus()
        assert plan.fired
        assert np.isfinite(r["agents"]["smooth_rep"]).all()
        assert np.isfinite(r["events"]["outcomes_final"]).all()
        assert obs.value("pyconsensus_fallbacks_total",
                         **labels) == before + 1
        clean = Oracle(reports=CANONICAL, device="cpu",
                       pca_method="eigh-gram").consensus()
        np.testing.assert_array_equal(r["events"]["outcomes_final"],
                                      clean["events"]["outcomes_final"])

    def test_exact_start_falls_to_the_numpy_rung(self):
        """From an exact method the one hop is ``torch:<method> ->
        numpy``: the numpy pipeline's result, bit for bit."""
        before = fallbacks(obs.REGISTRY)
        with faults.armed(FaultPlan(seed=0, rules=[NAN_STORM])):
            r = Oracle(reports=CANONICAL, device="cpu",
                       pca_method="eigh-gram",
                       max_iterations=3).consensus()
        assert hops_since(obs.REGISTRY, before) == {
            ("torch:eigh-gram", "numpy", "nonfinite_result"): 1.0}
        want = Oracle(reports=CANONICAL, backend="numpy",
                      max_iterations=3).consensus()
        for group in ("agents", "events"):
            for key, a in want[group].items():
                np.testing.assert_array_equal(r[group][key], a,
                                              err_msg=key)

    def test_exhausted_chain_raises_convergence_error(self, monkeypatch):
        oracle = Oracle(reports=CANONICAL, device="cpu",
                        pca_method="power")
        bad = {"smooth_rep": np.full(6, np.nan)}
        monkeypatch.setattr(Oracle, "_resolve_once",
                            lambda self, update: bad)
        with faults.armed(FaultPlan(seed=0, rules=[NAN_STORM])):
            with pytest.raises(ConvergenceError) as ei:
                oracle.consensus()
        assert ei.value.error_code == "PYC202"

    def test_exhausted_chain_on_exact_method_is_numerics_error(
            self, monkeypatch):
        oracle = Oracle(reports=CANONICAL, device="cpu",
                        pca_method="eigh-gram")
        bad = {"smooth_rep": np.full(6, np.nan)}
        monkeypatch.setattr(Oracle, "_resolve_once",
                            lambda self, update: bad)
        with faults.armed(FaultPlan(seed=0, rules=[NAN_STORM])):
            with pytest.raises(NumericsError) as ei:
                oracle.consensus()
        assert not isinstance(ei.value, ConvergenceError)
        assert ei.value.error_code == "PYC201"

    def test_numpy_backend_has_no_rung(self):
        """The numpy backend's result is returned as it is, as in the
        reference (the chain starts from the device backend only)."""
        with faults.armed(FaultPlan(seed=0, rules=[NAN_STORM])):
            r = Oracle(reports=CANONICAL, backend="numpy").consensus()
        assert np.isnan(r["agents"]["smooth_rep"]).all()

    @pytest.mark.parametrize("method", ["power-fused", "power", "eigh-gram",
                                        "eigh-cov", "auto"])
    def test_steps_are_the_references(self, method):
        got = faults.fallback_steps(method, "torch")
        want = ref_faults.fallback_steps(method, "jax")
        assert [(f.replace("torch:", "jax:"), t, u) for f, t, u in got] \
            == want
        assert faults.fallback_steps(method, "numpy") == \
            ref_faults.fallback_steps(method, "numpy") == []

    @pytest.mark.parametrize("sharded", [False, True])
    def test_a_kernel_error_propagates_and_starts_no_rung(self, monkeypatch,
                                                          sharded):
        """No fallback that hides a fault: an error raised by a kernel
        wrapper leaves ``consensus()`` as it is, and no hop is counted."""
        from pyconsensus_tpu_torch.ops import cuda_kernels as ck

        def broken(*args, **kwargs):
            raise RuntimeError("scores_dirfix_pass: CUDA launch failed "
                               "with error 700")

        monkeypatch.setattr(ck, "scores_dirfix_pass", broken)
        reports = nan_matrix()
        oracle = (ShardedOracle(reports=reports, pca_method="power-fused",
                                storage_dtype="int8", device="cpu")
                  if sharded else
                  Oracle(reports=reports, pca_method="power-fused",
                         device="cpu"))
        before = fallbacks(obs.REGISTRY)
        with pytest.raises(RuntimeError, match="launch failed"):
            oracle.consensus()
        assert hops_since(obs.REGISTRY, before) == {}


# -- parity of the chain with the reference --------------------------------

CHAIN_CASES = ([("canonical", "sztorc", m)
                for m in ("auto", "power", "power-fused", "eigh-gram")]
               + [("nan", "sztorc", m)
                  for m in ("auto", "power", "power-fused", "eigh-gram")]
               + [("nan", a, m) for a in ("fixed-variance", "ica")
                  for m in ("power", "auto")])


def _matrix(name):
    return CANONICAL if name == "canonical" else nan_matrix()


@pytest.mark.parametrize("matrix,algorithm,method", CHAIN_CASES)
def test_chain_matches_the_reference(matrix, algorithm, method):
    """The same plan through the reference's ``Oracle(backend="jax")`` and
    the port's ``Oracle(device="cpu")``: the same poisoned result, the
    same hops (modulo ``jax:``/``torch:``), and recovered results within
    the algorithm's band."""
    kw = dict(reports=_matrix(matrix), algorithm=algorithm,
              pca_method=method, max_iterations=3)
    plan_dict = {"seed": 2, "rules": [NAN_STORM]}
    results, hops, fired = [], [], []
    for pkg, registry, make in (
            (faults, obs.REGISTRY, lambda: Oracle(device="cpu", **kw)),
            (ref_faults, ref_obs.REGISTRY,
             lambda: RefOracle(backend="jax", **kw))):
        oracle = make()
        before = fallbacks(registry)
        plan = pkg.FaultPlan.from_dict(plan_dict)
        with pkg.armed(plan):
            results.append(oracle.consensus())
        hops.append(hops_since(registry, before))
        fired.append(plan.fired)
    assert fired[0] == fired[1] == [("oracle.raw_result", 0, "nan_storm")]
    assert len(hops[0]) == 1
    assert unprefixed(hops[0]) == unprefixed(hops[1])
    assert [f for f, _, _ in hops[0]] == [
        f.replace("jax:", "torch:") for f, _, _ in hops[1]]
    assert_results_match(results[0], results[1], BANDS[algorithm])


@pytest.mark.parametrize("method,code", [("power", "PYC202"),
                                         ("power-fused", "PYC202"),
                                         ("eigh-gram", "PYC201"),
                                         ("auto", "PYC201")])
def test_exhausted_chain_matches_the_reference(monkeypatch, method, code):
    bad = {"smooth_rep": np.full(40, np.nan)}
    errors = []
    for pkg, cls, kw in ((faults, Oracle, dict(device="cpu")),
                         (ref_faults, RefOracle, dict(backend="jax"))):
        monkeypatch.setattr(cls, "_resolve_once", lambda self, update: bad)
        oracle = cls(reports=nan_matrix(), pca_method=method, **kw)
        with pkg.armed(pkg.FaultPlan(seed=0, rules=[NAN_STORM])):
            with pytest.raises(ArithmeticError) as ei:
                oracle.consensus()
        errors.append(ei.value)
    assert [e.error_code for e in errors] == [code, code]
    assert type(errors[0]).__name__ == type(errors[1]).__name__


# -- NaN-storm fuzz --------------------------------------------------------


class TestNaNStormFuzz:
    """Seeded FaultPlan NaN/Inf storms through both backends of the port
    and of the reference: finite, quarantine-consistent outputs, the same
    quarantine decisions in both packages, and exact replay."""

    @pytest.mark.parametrize("seed", range(6))
    def test_storm_is_finite_consistent_and_replayable(self, seed):
        rng = np.random.default_rng(100 + seed)
        reports = rng.choice([0.0, 0.5, 1.0], size=(10, 8))
        plan_dict = {"seed": seed, "rules": [
            {"site": "oracle.reports", "kind": "nan_storm",
             "occurrences": [0], "args": {"fraction": 0.15}},
            {"site": "oracle.reports", "kind": "inf_storm",
             "occurrences": [1], "args": {"fraction": 0.1}},
        ]}

        def resolve(pkg, cls, occurrence_shift=0, **kw):
            plan = pkg.FaultPlan.from_dict(plan_dict)
            with pkg.armed(plan):
                if occurrence_shift:
                    pkg.corrupt("oracle.reports", reports)
                return cls(reports=reports, max_iterations=2,
                           **kw).consensus(), plan

        for occ in (0, 1):
            r_np, p_np = resolve(faults, Oracle, occ, backend="numpy")
            r_t, p_t = resolve(faults, Oracle, occ, device="cpu")
            r_ref, p_ref = resolve(ref_faults, RefOracle, occ,
                                   backend="jax")
            for r in (r_np, r_t):
                assert np.isfinite(r["agents"]["smooth_rep"]).all()
                assert np.isfinite(r["events"]["outcomes_final"]).all()
            for r in (r_t, r_ref):
                np.testing.assert_array_equal(r_np["quarantined_rows"],
                                              r["quarantined_rows"])
            assert p_np.fired == p_t.fired == p_ref.fired
            np.testing.assert_array_equal(r_t["events"]["outcomes_final"],
                                          r_ref["events"]["outcomes_final"])
            r_again, _ = resolve(faults, Oracle, occ, backend="numpy")
            np.testing.assert_array_equal(
                r_np["events"]["outcomes_final"],
                r_again["events"]["outcomes_final"])
            np.testing.assert_array_equal(r_np["agents"]["smooth_rep"],
                                          r_again["agents"]["smooth_rep"])


# -- ShardedOracle ---------------------------------------------------------

_REF_SHARDED = {}


def _ref_sharded(n, form, max_iterations):
    """The reference's ShardedOracle on its CPU mesh of ``n`` event
    shards (its XLA path: its fused gate opens on a TPU only), cached."""
    key = (n, form, max_iterations)
    if key not in _REF_SHARDED:
        reports = nan_matrix()
        if form == "int8":
            reports = encode_reports_host(reports)
        _REF_SHARDED[key] = RefShardedOracle(
            reports=reports, backend="jax", pca_method="power",
            power_iters=64, power_tol=-1.0, max_iterations=max_iterations,
            mesh=ref_make_mesh(batch=1, event=n)).consensus()
    return _REF_SHARDED[key]


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("storage", ["", "int8"])
@pytest.mark.parametrize("max_iterations", [1, 3])
def test_sharded_oracle_matches_the_reference(n, form, storage,
                                              max_iterations):
    reports = nan_matrix()
    if form == "int8":
        reports = encode_reports_host(reports)
    oracle = ShardedOracle(reports=reports, pca_method="power",
                           power_iters=64, power_tol=-1.0,
                           max_iterations=max_iterations,
                           storage_dtype=storage,
                           mesh=make_mesh(devices=["cpu"] * n))
    assert oracle.params.fused_resolution
    got = oracle.consensus()
    want = _ref_sharded(n, form, max_iterations)
    assert_results_match(got, want, BANDS["sztorc"])
    assert "original" not in got and "filled" not in got
    # placed once: the same bits on the next resolutions
    again = oracle.place().consensus()
    for group in ("agents", "events"):
        for key, a in got[group].items():
            np.testing.assert_array_equal(again[group][key], a,
                                          err_msg=key)


def test_sharded_oracle_plain_core_matches_the_reference():
    """Where the fused gate closes on one device ("auto" at R <= 4096 is
    the Gram eigh), the plain core serves, as the reference's XLA path."""
    kw = dict(reports=nan_matrix(), max_iterations=3)
    oracle = ShardedOracle(device="cpu", **kw)
    assert not oracle.params.fused_resolution
    assert oracle.params.pca_method == "eigh-gram"
    want = RefShardedOracle(backend="jax", mesh=ref_make_mesh(batch=1,
                                                              event=1),
                            **kw).consensus()
    assert_results_match(oracle.consensus(), want, BANDS["sztorc"])


def test_sharded_oracle_chain_matches_the_reference():
    """A NaN storm at the fetch: ``power-fused -> eigh-gram`` on the
    ShardedOracle of both packages, the port's rung on the plain core
    without the (R, E) outputs."""
    kw = dict(reports=nan_matrix(), pca_method="power-fused",
              max_iterations=3)
    results, hops = [], []
    for pkg, registry, make in (
            (faults, obs.REGISTRY,
             lambda: ShardedOracle(device="cpu", storage_dtype="int8",
                                   **kw)),
            (ref_faults, ref_obs.REGISTRY,
             lambda: RefShardedOracle(backend="jax",
                                      mesh=ref_make_mesh(batch=1, event=1),
                                      **kw))):
        oracle = make()
        before = fallbacks(registry)
        with pkg.armed(pkg.FaultPlan(seed=0, rules=[NAN_STORM])):
            results.append(oracle.consensus())
        hops.append(hops_since(registry, before))
    assert hops[0] == hops[1] == {
        ("power-fused", "eigh-gram", "nonfinite_result"): 1.0}
    assert_results_match(results[0], results[1], BANDS["sztorc"])
    assert "filled" not in results[0]


def test_sharded_oracle_refusals():
    with pytest.raises(ValueError, match="backend"):
        ShardedOracle(reports=CANONICAL, backend="numpy")
    with pytest.raises(ValueError, match="either"):
        ShardedOracle(reports=CANONICAL, device="cpu",
                      mesh=make_mesh(devices=["cpu"]))
    # the plain core on a mesh of more than one shard is not ported
    with pytest.raises(NotImplementedError, match="§A.10"):
        ShardedOracle(reports=nan_matrix(),
                      mesh=make_mesh(devices=["cpu"] * 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedOracle(reports=CANONICAL)


# -- imports ---------------------------------------------------------------


def test_faults_and_obs_import_without_jax():
    """In a process where ``import jax`` fails, the port and every module
    this slice adds import, and nothing of the JAX package loads."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import pyconsensus_tpu_torch\n"
        "import pyconsensus_tpu_torch.obs, pyconsensus_tpu_torch.faults\n"
        "from pyconsensus_tpu_torch.obs import metrics, sinks, tracer\n"
        "from pyconsensus_tpu_torch.faults import (degrade, errors, plan,\n"
        "                                          retry)\n"
        "from pyconsensus_tpu_torch.parallel import ShardedOracle\n"
        "bad = [m for m in sys.modules if m == 'pyconsensus_tpu'"
        " or m.startswith('pyconsensus_tpu.')"
        " or (m.startswith('jax.') and sys.modules[m] is not None)]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
