"""The port's market sessions, the incremental tier and the Gram algebra
(``pyconsensus_tpu_torch.serve.session``, ``serve.incremental``,
``parallel.streaming``) against the JAX package's, on the CPU.

Sessions resolve off statistics folded at append time; their results are
held against the reference's ``MarketSession``, its
``streaming_consensus`` over the same block split and the direct
``Oracle`` of both packages: outcomes and iterations exactly, continuous
keys within ``REF_ATOL`` (two eigensolvers, float64). The incremental
tier's warm resolves stay within ``incremental_drift_band`` of the exact
resolve of the same statistics, and its exact refreshes are the exact
path bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import collusion_reports
from pyconsensus_tpu import Oracle as RefOracle
from pyconsensus_tpu.models.pipeline import ConsensusParams as RefParams
from pyconsensus_tpu.parallel import streaming as ref_streaming
from pyconsensus_tpu.parallel import streaming_consensus
from pyconsensus_tpu.serve import MarketSession as RefSession
from pyconsensus_tpu.serve.incremental import \
    incremental_consensus as ref_incremental_consensus
from pyconsensus_tpu_torch import Oracle, ReputationLedger, obs
from pyconsensus_tpu_torch.faults import CheckpointCorruptionError, InputError
from pyconsensus_tpu_torch.parallel import streaming as st
from pyconsensus_tpu_torch.serve import (INCREMENTAL_KERNEL_PATH, BucketKey,
                                         ConsensusService, MarketSession,
                                         ServeConfig, SessionStore,
                                         incremental_consensus,
                                         incremental_drift_band, share_of)
from pyconsensus_tpu_torch.serve.cache import SINGLE_TOPOLOGY
from pyconsensus_tpu_torch.serve.incremental import incremental_params
from torch_witness import torch_lock_witness  # noqa: F401


@pytest.fixture(autouse=True)
def _witnessed(torch_lock_witness):
    """Every test here runs under the port's lock witness (the
    counterpart of the reference's test_serve_incremental opt-in)."""
    yield


#: continuous keys against the reference (float64; torch's and XLA's
#: eigensolvers and reductions agree to about 1e-14 here)
REF_ATOL = 1e-9
#: float32 sessions against the reference's float64 ones
F32_ATOL = 1e-4
CONT_KEYS = ("smooth_rep", "this_rep", "certainty", "consensus_reward",
             "reporter_bonus", "author_bonus", "first_loading")
EXACT_KEYS = ("outcomes_adjusted", "outcomes_final", "iterations",
              "convergence", "na_row")


@pytest.fixture(autouse=True)
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def blk(R, e, seed, na_frac=0.1):
    r = np.random.default_rng(seed)
    b = r.choice([0.0, 1.0], size=(R, e)).astype(np.float64)
    if na_frac:
        b[r.random((R, e)) < na_frac] = np.nan
    return b


def collusion_blocks(seed, R, width, n):
    rng = np.random.default_rng(seed)
    return [collusion_reports(rng, R, width, liars=max(2, R // 4),
                              na_frac=0.1)[0] for _ in range(n)]


def session(name, R, **kw):
    return MarketSession(name, R, device="cpu", **kw)


def drift_between(a, b):
    return max(float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k]))))
               for k in CONT_KEYS)


def assert_flat_match(got, ref, atol=REF_ATOL, loading_sign=True):
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(ref[k]), err_msg=k)
    for k in CONT_KEYS + ("participation_columns", "participation_rows",
                          "outcomes_raw", "avg_certainty", "percent_na"):
        a, b = np.asarray(got[k], float), np.asarray(ref[k], float)
        if k == "first_loading" and loading_sign:
            a, b = np.abs(a), np.abs(b)
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)


def _outcomes(result):
    return np.asarray(result["events"]["outcomes_adjusted"])


# -- the Gram algebra against the reference's -----------------------------


def _panel_args(reports, dtype=torch.float64):
    R, E = reports.shape
    rep = np.random.default_rng(R + E).random(R)
    rep /= rep.sum()
    t = dict(panel=torch.tensor(reports, dtype=dtype),
             rep=torch.tensor(rep, dtype=dtype),
             scaled=torch.zeros(E, dtype=torch.bool),
             mins=torch.zeros(E, dtype=dtype), maxs=torch.ones(E, dtype=dtype),
             valid=torch.ones(E, dtype=torch.bool))
    j = dict(panel=jnp.asarray(reports), rep=jnp.asarray(rep),
             scaled=jnp.zeros(E, bool), mins=jnp.zeros(E), maxs=jnp.ones(E),
             valid=jnp.ones(E, bool))
    return t, j


class TestGramAlgebra:
    @pytest.mark.parametrize("tail", [0, 5])
    def test_pass1_panel_matches_reference(self, rng, tail):
        reports, _ = collusion_reports(rng, 14, 40, liars=4, na_frac=0.15)
        t, j = _panel_args(reports)
        if tail:
            t["valid"][-tail:] = False
            j["valid"] = j["valid"].at[-tail:].set(False)
        for with_s, with_gm in ((True, True), (False, True), (True, False)):
            got = st._pass1_panel(t["panel"], t["rep"], t["rep"],
                                  t["scaled"], t["mins"], t["maxs"],
                                  t["valid"], 0.1, with_s, with_gm)
            ref = ref_streaming._pass1_panel(
                j["panel"], j["rep"], j["rep"], j["scaled"], j["mins"],
                j["maxs"], j["valid"], 0.1, with_s, with_gm)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-13, rtol=0)

    def test_pass2_panel_matches_reference(self, rng):
        reports, _ = collusion_reports(rng, 14, 40, liars=4, na_frac=0.15)
        t, j = _panel_args(reports)
        u = np.random.default_rng(3).standard_normal(14)
        final = t["rep"] * 0.9 + 0.1 / 14
        got = st._pass2_panel(t["panel"], t["rep"], t["rep"], final,
                              torch.tensor(u), t["scaled"], t["mins"],
                              t["maxs"], 0.1)
        ref = ref_streaming._pass2_panel(
            j["panel"], j["rep"], j["rep"], jnp.asarray(final.numpy()),
            jnp.asarray(u), j["scaled"], j["mins"], j["maxs"], 0.1)
        for i, (a, b) in enumerate(zip(got, ref)):
            if i in (0, 1, 2):                 # outcomes: exact
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-13, rtol=0)

    def _stats(self, rng, R=16, E=64):
        reports, _ = collusion_reports(rng, R, E, liars=4, na_frac=0.1)
        t, j = _panel_args(reports)
        G, M, S = st._pass1_panel(t["panel"], t["rep"], t["rep"],
                                  t["scaled"], t["mins"], t["maxs"],
                                  t["valid"], 0.1, True)
        return G, M, S, t["rep"]

    @pytest.mark.parametrize("k", [1, 2, 3])
    def test_gram_top_components_matches_reference(self, rng, k):
        G, M, _, rep = self._stats(rng)
        got = st.gram_top_components(G, M, rep, k)
        ref = ref_streaming.gram_top_components(
            jnp.asarray(G.numpy()), jnp.asarray(M.numpy()),
            jnp.asarray(rep.numpy()), k)
        scores, explained, U, nAu = got
        np.testing.assert_allclose(explained.numpy(), np.asarray(ref[1]),
                                   atol=1e-12)
        np.testing.assert_allclose(nAu.numpy(), np.asarray(ref[3]),
                                   atol=1e-12)
        # eigenvectors up to sign
        for c in range(k):
            s = np.sign(float(U[:, c] @ torch.tensor(np.asarray(ref[2])[:, c])))
            np.testing.assert_allclose(s * U[:, c].numpy(),
                                       np.asarray(ref[2])[:, c], atol=1e-10)
            np.testing.assert_allclose(s * scores[:, c].numpy(),
                                       np.asarray(ref[0])[:, c], atol=1e-10)

    def test_delta_form_equals_materialized_update(self, rng):
        G, M, _, rep = self._stats(rng)
        dG, dM, _, _ = self._stats(np.random.default_rng(7))
        a = st.gram_top_components(G + dG, M + dM, rep, 2)
        b = st.gram_top_components(G, M, rep, 2, delta=(dG, dM))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y.numpy())

    def test_warm_pc_matches_reference(self, rng):
        G, M, _, rep = self._stats(rng)
        _, _, U, _ = st.gram_top_components(G, M, rep, 1)
        stale = U[:, 0] + 0.05 * torch.tensor(rng.standard_normal(16))
        u, sweeps = st.gram_warm_pc(G, rep, stale, n_iters=512)
        ru, rsweeps = ref_streaming.gram_warm_pc(
            jnp.asarray(G.numpy()), jnp.asarray(rep.numpy()),
            jnp.asarray(stale.numpy()), n_iters=512)
        assert sweeps == int(rsweeps) and sweeps > 0
        np.testing.assert_allclose(u.numpy(), np.asarray(ru), atol=1e-12)
        assert abs(float(u @ U[:, 0])) >= 1.0 - 1e-9
        # no warm start: the cold seed, bit for bit the zero start
        a, _ = st.gram_warm_pc(G, rep, None)
        b, _ = st.gram_warm_pc(G, rep, torch.zeros(16, dtype=G.dtype))
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_warm_start_requires_k1(self, rng):
        G, M, _, rep = self._stats(rng)
        with pytest.raises(ValueError, match="k=1"):
            st.gram_top_components(G, M, rep, 2, warm_u=G[:, 0])

    def test_sym_topk_matches_reference(self, rng):
        G, _, _, rep = self._stats(rng, R=24, E=80)
        lam, V = st._sym_topk(G, 3)
        rlam, rV = ref_streaming._sym_topk(jnp.asarray(G.numpy()), 3)
        np.testing.assert_allclose(lam.numpy(), np.asarray(rlam), rtol=1e-6)
        ev = torch.linalg.eigvalsh(G).flip(0)[:3]
        np.testing.assert_allclose(lam.numpy(), ev.numpy(), rtol=1e-6)
        align = np.abs(np.sum(V.numpy() * np.asarray(rV), axis=0))
        assert np.all(align >= 1.0 - 1e-6)
        bad = G.clone()
        bad[0, 0] = float("nan")
        assert torch.isnan(st._sym_topk(bad, 2)[0]).all()

    def test_gram_dirfix_matches_reference(self, rng):
        G, M, S, rep = self._stats(rng)
        scores = st.gram_top_components(G, M, rep, 1)[0][:, 0]
        got = st.gram_dirfix(scores, rep, S)
        ref = ref_streaming.gram_dirfix(jnp.asarray(scores.numpy()),
                                        jnp.asarray(rep.numpy()),
                                        jnp.asarray(S.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=1e-14)

    def test_incremental_consensus_matches_reference(self, rng):
        G, M, S, rep = self._stats(rng)
        U = st.gram_top_components(G, M, rep, 1)[2]
        warm = U[:, 0] + 0.02 * torch.tensor(rng.standard_normal(16))
        p = incremental_params(0.1, 0.1, 1e-6)
        got = incremental_consensus(G, M, S, rep, warm, p)
        rp = RefParams(**p._asdict())
        ref = ref_incremental_consensus(
            *(jnp.asarray(t.numpy()) for t in (G, M, S, rep, warm)), rp)
        for k in ("this_rep", "smooth_rep", "u", "u_over_nAu",
                  "warm_alignment", "delta"):
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(ref[k]), atol=1e-12,
                                       err_msg=k)
        assert int(got["sweeps"]) == int(ref["sweeps"])

    def test_drift_band_by_dtype(self):
        assert incremental_drift_band(torch.float64) == 1e-6
        assert incremental_drift_band(torch.float32) == 2e-3


# -- sessions against the reference ---------------------------------------


class TestSessions:
    @pytest.mark.parametrize("staging", [True, False])
    def test_matches_reference_session_and_streaming(self, staging):
        R, width, n = 14, 16, 3
        blocks = collusion_blocks(11, R, width, n)
        full = np.concatenate(blocks, axis=1)
        port = session("m", R, encoded_staging=staging)
        ref = RefSession("m", n_reporters=R, encoded_staging=staging)
        for b in blocks:
            port.append(b)
            ref.append(b)
        assert (port._blocks[0].dtype == torch.int8) == staging
        got, want = port.resolve(), ref.resolve()
        assert_flat_match(got, want)
        stream = streaming_consensus(
            full, panel_events=width,
            params=RefParams(algorithm="sztorc", max_iterations=1))
        assert_flat_match(got, {**stream, "first_loading":
                                stream["first_loading"]})
        np.testing.assert_array_equal(port.reputation, got["smooth_rep"])

    def test_outcomes_match_the_oracles(self, rng):
        R = 12
        b1, _ = collusion_reports(rng, R, 10, liars=3, na_frac=0.1)
        b2, _ = collusion_reports(rng, R, 14, liars=3, na_frac=0.1)
        sess = session("m", R)
        sess.append(b1)
        sess.append(b2)
        flat = sess.resolve()
        full = np.concatenate([b1, b2], axis=1)
        for ref in (Oracle(reports=full, device="cpu").consensus(),
                    RefOracle(reports=full, backend="jax").consensus()):
            np.testing.assert_array_equal(flat["outcomes_adjusted"],
                                          _outcomes(ref))
            np.testing.assert_allclose(flat["smooth_rep"],
                                       ref["agents"]["smooth_rep"],
                                       atol=REF_ATOL)

    def test_reputation_carries_and_round_closes(self, rng):
        R = 10
        sess = session("m", R)
        b1, _ = collusion_reports(rng, R, 12, liars=3, na_frac=0.0)
        sess.append(b1)
        r1 = sess.resolve()
        np.testing.assert_array_equal(sess.reputation, r1["smooth_rep"])
        assert sess.n_events == 0
        with pytest.raises(ValueError):
            sess.resolve()
        b2, _ = collusion_reports(rng, R, 12, liars=3, na_frac=0.0)
        sess.append(b2)
        r2 = sess.resolve()
        ref2 = Oracle(reports=b2, reputation=r1["smooth_rep"],
                      device="cpu").consensus()
        np.testing.assert_array_equal(r2["outcomes_adjusted"],
                                      _outcomes(ref2))

    def test_multi_round_trajectory_matches_reference(self):
        R = 12
        port, ref = session("m", R), RefSession("m", n_reporters=R)
        for k in range(4):
            for b in collusion_blocks(40 + k, R, 9, 2):
                port.append(b)
                ref.append(b)
            assert_flat_match(port.resolve(), ref.resolve())
        np.testing.assert_allclose(port.reputation, ref.reputation,
                                   atol=REF_ATOL)

    def test_ledger_integration(self, rng, tmp_path):
        R = 8
        ledger = ReputationLedger(n_reporters=R, device="cpu")
        sess = session("m", R, ledger=ledger)
        b, _ = collusion_reports(rng, R, 10, liars=2, na_frac=0.1)
        sess.append(b)
        sess.resolve()
        assert ledger.round == 1 and len(ledger.history) == 1
        np.testing.assert_array_equal(ledger.reputation, sess.reputation)
        ledger.save(tmp_path / "state.npz")
        resumed = ReputationLedger.load(tmp_path / "state.npz", device="cpu")
        np.testing.assert_array_equal(resumed.reputation, ledger.reputation)
        assert resumed.round == 1
        # the reference loads the port's checkpoint
        from pyconsensus_tpu import ReputationLedger as RefLedger

        np.testing.assert_array_equal(
            RefLedger.load(tmp_path / "state.npz").reputation,
            ledger.reputation)

    def test_scaled_blocks(self, rng):
        R = 12
        block, _ = collusion_reports(rng, R, 16, liars=3, na_frac=0.12)
        bounds = [None] * 16
        for c in (1, 5, 9, 13):
            bounds[c] = {"scaled": True, "min": -5.0, "max": 15.0}
            block[:, c] = block[:, c] * 20.0 - 5.0
        sess = session("m", R)
        sess.append(block, event_bounds=bounds)
        assert sess._blocks[0].dtype == np.float64      # off the lattice
        flat = sess.resolve()
        ref = RefSession("m", n_reporters=R)
        ref.append(block, event_bounds=bounds)
        want = ref.resolve()
        binary = np.asarray([b is None for b in bounds])
        np.testing.assert_array_equal(flat["outcomes_adjusted"][binary],
                                      want["outcomes_adjusted"][binary])
        np.testing.assert_allclose(flat["outcomes_final"],
                                   want["outcomes_final"], atol=1e-12)
        np.testing.assert_allclose(flat["smooth_rep"], want["smooth_rep"],
                                   atol=REF_ATOL)

    def test_shape_validation(self):
        sess = session("m", 6)
        with pytest.raises(ValueError):
            sess.append(np.zeros((5, 3)))
        with pytest.raises(InputError):
            session("m", 0)

    def test_direct_fallback_for_iterated_resolve(self, rng):
        R = 10
        b1, _ = collusion_reports(rng, R, 8, liars=3, na_frac=0.1)
        b2, _ = collusion_reports(rng, R, 8, liars=3, na_frac=0.1)
        sess = session("m", R)
        sess.append(b1)
        sess.append(b2)
        flat = sess.resolve(max_iterations=3)
        full = np.concatenate([b1, b2], axis=1)
        port = Oracle(reports=full, device="cpu",
                      max_iterations=3).consensus()
        np.testing.assert_array_equal(flat["smooth_rep"],
                                      port["agents"]["smooth_rep"])
        assert flat["iterations"] == port["iterations"]
        ref = RefOracle(reports=full, backend="jax",
                        max_iterations=3).consensus()
        np.testing.assert_array_equal(flat["outcomes_adjusted"],
                                      _outcomes(ref))
        np.testing.assert_array_equal(sess.reputation, flat["smooth_rep"])
        assert sess.last_resolve_path == "direct"

    def test_float32_session_against_reference(self):
        torch.set_default_dtype(torch.float32)
        R = 16
        port, ref = session("m", R), RefSession("m", n_reporters=R)
        assert port.dtype == torch.float32
        for b in collusion_blocks(5, R, 20, 3):
            port.append(b)
            ref.append(b)
        got, want = port.resolve(), ref.resolve()
        assert got["smooth_rep"].dtype == np.float64
        assert_flat_match(got, want, atol=F32_ATOL)

    def test_share_of_and_store(self):
        assert share_of([0.5, 0.25, 0.25], [0]) == 0.5
        assert share_of([0.0, 0.0], [0]) == 0.0
        store = SessionStore()
        store.create("a", 4, device="cpu")
        with pytest.raises(InputError):
            store.create("a", 4, device="cpu")
        with pytest.raises(InputError):
            store.get("b")
        assert store.names() == ["a"]
        store.remove("a")
        assert store.names() == []

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device works")
        with pytest.raises(RuntimeError, match="CUDA"):
            MarketSession("m", 4)


# -- the incremental tier's staleness contract ----------------------------


class TestStalenessContract:
    def test_refresh_every_one_is_bitwise_the_plain_session(self):
        R = 12
        plain = session("p", R)
        inc = session("i", R, incremental=True, refresh_every=1)
        for k in range(3):
            b = blk(R, 10, 100 + k)
            plain.append(b)
            inc.append(b)
            a, c = plain.resolve(), inc.resolve()
            for key in ("smooth_rep", "outcomes_adjusted",
                        "outcomes_final", "certainty", "iterations"):
                np.testing.assert_array_equal(np.asarray(a[key]),
                                              np.asarray(c[key]))
            assert inc.last_resolve_path == "incremental_exact"

    @pytest.mark.parametrize("block_events", [1, 6, 24])
    @pytest.mark.parametrize("refresh_every", [2, 3, 5])
    def test_drift_band_and_refresh_bitwise(self, block_events,
                                            refresh_every):
        R = 14
        inc = session("inc", R, incremental=True,
                      refresh_every=refresh_every)
        ref = RefSession("inc", R, incremental=True,
                         refresh_every=refresh_every)
        band = incremental_drift_band(torch.float64)
        saw_warm = saw_refresh = False
        for k in range(2 * refresh_every + 1):
            b = blk(R, block_events, 31 * block_events + k)
            inc.append(b)
            ref.append(b)
            exact_same_stats = inc.peek_resolve()
            got = inc.resolve()
            want = ref.resolve()
            assert inc.last_resolve_path == ref.last_resolve_path
            np.testing.assert_array_equal(got["outcomes_adjusted"],
                                          want["outcomes_adjusted"])
            assert drift_between(got, want) <= band
            if inc.last_resolve_path == "incremental":
                saw_warm = True
                assert drift_between(got, exact_same_stats) <= band
                np.testing.assert_array_equal(
                    got["outcomes_adjusted"],
                    exact_same_stats["outcomes_adjusted"])
                assert got["iterations"] == \
                    exact_same_stats["iterations"] == 1
            else:
                saw_refresh = True
                assert inc.last_resolve_path == "incremental_exact"
                for key in ("smooth_rep", "outcomes_adjusted",
                            "certainty", "iterations"):
                    np.testing.assert_array_equal(
                        np.asarray(got[key]),
                        np.asarray(exact_same_stats[key]))
        assert saw_refresh
        assert saw_warm == (refresh_every > 1)

    def test_exact_refresh_matches_oracle_both_backends(self):
        R = 12
        sess = session("m", R, incremental=True, refresh_every=2)
        for k in range(4):
            b = blk(R, 16, 900 + k)
            rep_in = sess.reputation.copy()
            sess.append(b)
            got = sess.resolve()
            if sess.last_resolve_path != "incremental_exact":
                continue
            for backend in ("torch", "numpy"):
                ref = Oracle(reports=b, reputation=rep_in, backend=backend,
                             device="cpu" if backend == "torch" else None
                             ).consensus()
                np.testing.assert_array_equal(
                    got["outcomes_adjusted"], _outcomes(ref),
                    err_msg=f"round {k} backend {backend}")
                assert got["iterations"] == ref["iterations"]

    def test_cadence_state_and_counters(self):
        R = 10
        before_w = obs.value("pyconsensus_incremental_resolves_total",
                             mode="warm") or 0
        before_e = obs.value("pyconsensus_incremental_resolves_total",
                             mode="exact") or 0
        before_k = obs.value("pyconsensus_kernel_path_total",
                             path=INCREMENTAL_KERNEL_PATH) or 0
        sess = session("m", R, incremental=True, refresh_every=3)
        expect = ["incremental_exact", "incremental", "incremental",
                  "incremental_exact", "incremental"]
        ages = [0, 1, 2, 0, 1]
        for k, (path, age) in enumerate(zip(expect, ages)):
            sess.append(blk(R, 8, 50 + k))
            sess.resolve()
            assert sess.last_resolve_path == path
            st_ = sess.state()["incremental"]
            assert st_["enabled"] and st_["refresh_every"] == 3
            assert st_["rounds_since_exact"] == age
            assert st_["has_warm_start"]
            assert st_["warm_u"].shape == (R,)
        warm = (obs.value("pyconsensus_incremental_resolves_total",
                          mode="warm") or 0) - before_w
        exact = (obs.value("pyconsensus_incremental_resolves_total",
                           mode="exact") or 0) - before_e
        kp = (obs.value("pyconsensus_kernel_path_total",
                        path=INCREMENTAL_KERNEL_PATH) or 0) - before_k
        assert (warm, exact) == (3, 2)
        assert kp == 3
        assert obs.value("pyconsensus_incremental_drift") is not None

    def test_direct_resolve_invalidates_warm_state(self):
        R = 10
        sess = session("m", R, incremental=True, refresh_every=4)
        sess.append(blk(R, 8, 1))
        sess.resolve()
        sess.append(blk(R, 8, 2))
        sess.resolve(max_iterations=3)
        assert sess.last_resolve_path == "direct"
        assert not sess.state()["incremental"]["has_warm_start"]
        sess.append(blk(R, 8, 3))
        sess.resolve()
        assert sess.last_resolve_path == "incremental_exact"

    def test_peek_resolve_mutates_nothing(self):
        R = 10
        sess = session("m", R, incremental=True, refresh_every=4)
        sess.append(blk(R, 8, 1))
        st0 = sess.state()
        first = sess.peek_resolve()
        again = sess.peek_resolve()
        st1 = sess.state()
        assert st0["rounds_resolved"] == st1["rounds_resolved"] == 0
        assert st0["staged_blocks"] == st1["staged_blocks"] == 1
        assert sess.last_resolve_path is None
        np.testing.assert_array_equal(first["smooth_rep"],
                                      again["smooth_rep"])

    def test_float32_drift_band(self):
        """The float32 band on collusion rounds (a clear eigengap, the
        signal the band is sized for). On gapless random blocks a float32
        warm loading drifts further: 2.3e-3 on ``blk(14, 12, 71)``, the
        same in the reference run with JAX in float32 (``ROADMAP.md``
        §C)."""
        torch.set_default_dtype(torch.float32)
        R = 14
        inc = session("m", R, incremental=True, refresh_every=3)
        band = incremental_drift_band(torch.float32)
        for k in range(5):
            inc.append(collusion_blocks(70 + k, R, 12, 1)[0])
            exact = inc.peek_resolve()
            got = inc.resolve()
            assert drift_between(got, exact) <= band
            np.testing.assert_array_equal(got["outcomes_adjusted"],
                                          exact["outcomes_adjusted"])


# -- the service tier ------------------------------------------------------


class TestServiceTier:
    def test_sessions_ride_bucket_incremental(self):
        R = 12
        base_req = obs.value("pyconsensus_serve_requests_total",
                             path="bucket_incremental", outcome="ok") or 0
        base_b = obs.value("pyconsensus_serve_builds_total",
                           entry="serve_bucket_incremental") or 0
        svc = ConsensusService(ServeConfig(
            incremental_sessions=True, incremental_refresh_every=3,
            batch_window_ms=1.0), device="cpu").start(warmup=False)
        svc.create_session("m", n_reporters=R)
        ref = RefSession("m", R, incremental=True, refresh_every=3)
        paths = []
        for k in range(4):
            b = blk(R, 8, 70 + k)
            svc.append("m", b)
            ref.append(b)
            got = svc.submit(session="m").result(timeout=120)
            want = ref.resolve()
            paths.append(svc.sessions.get("m").last_resolve_path)
            np.testing.assert_array_equal(_outcomes(got),
                                          want["outcomes_adjusted"])
            np.testing.assert_allclose(got["agents"]["smooth_rep"],
                                       want["smooth_rep"],
                                       atol=incremental_drift_band(
                                           torch.float64))
        svc.close(drain=True)
        assert paths == ["incremental_exact", "incremental",
                         "incremental", "incremental_exact"]
        got = (obs.value("pyconsensus_serve_requests_total",
                         path="bucket_incremental", outcome="ok") or 0) \
            - base_req
        assert got == 4
        # one build for the (roster, params) key, none after it
        builds = (obs.value("pyconsensus_serve_builds_total",
                            entry="serve_bucket_incremental") or 0) - base_b
        assert builds == 1 and svc.cache.builds == 1

    def test_incremental_executables_live_in_the_cache(self):
        svc = ConsensusService(ServeConfig(
            incremental_sessions=True, batch_window_ms=1.0), device="cpu")
        svc.create_session("m", n_reporters=10)
        svc.append("m", blk(10, 8, 3))
        svc.start(warmup=False)
        svc.submit(session="m").result(timeout=120)
        svc.append("m", blk(10, 8, 4))
        svc.submit(session="m").result(timeout=120)
        svc.close(drain=True)
        p = incremental_params(0.1, 0.1, 1e-6)
        key = BucketKey.make(10, 0, 1, p, SINGLE_TOPOLOGY,
                             kernel_path=INCREMENTAL_KERNEL_PATH)
        assert key in svc.cache.keys()

    def test_plain_sessions_keep_the_session_path(self):
        R = 10
        base = obs.value("pyconsensus_serve_requests_total",
                         path="session", outcome="ok") or 0
        svc = ConsensusService(ServeConfig(batch_window_ms=1.0),
                               device="cpu").start(warmup=False)
        svc.create_session("m", n_reporters=R)
        assert svc.sessions.get("m").device == torch.device("cpu")
        svc.append("m", blk(R, 8, 5))
        svc.submit(session="m").result(timeout=120)
        assert svc.sessions.get("m").last_resolve_path == "stats"
        with pytest.raises(InputError):
            svc.submit(session="nope")
        svc.close(drain=True)
        got = (obs.value("pyconsensus_serve_requests_total",
                         path="session", outcome="ok") or 0) - base
        assert got == 1

    def test_refresh_cadence_zero_refused_pyc101(self):
        with pytest.raises(InputError) as ei:
            ConsensusService(ServeConfig(incremental_refresh_every=0),
                             device="cpu")
        assert ei.value.error_code == "PYC101"
        with pytest.raises(InputError) as ei:
            session("m", 8, incremental=True, refresh_every=0)
        assert ei.value.error_code == "PYC101"


# -- durability ------------------------------------------------------------


class TestDurability:
    def test_ledger_aux_round_trips_warm_state(self, tmp_path):
        R = 8
        ledger = ReputationLedger(n_reporters=R, device="cpu")
        sess = session("m", R, ledger=ledger, incremental=True,
                       refresh_every=5)
        for k in range(3):
            sess.append(blk(R, 8, 20 + k))
            sess.resolve()
        assert "incremental_warm_u" in ledger.aux
        ledger.save(tmp_path / "state.npz")
        resumed_ledger = ReputationLedger.load(tmp_path / "state.npz",
                                               device="cpu")
        resumed = session("m", R, ledger=resumed_ledger, incremental=True,
                          refresh_every=5)
        np.testing.assert_array_equal(resumed._warm_u, sess._warm_u)
        assert resumed._rounds_since_exact == sess._rounds_since_exact
        b = blk(R, 8, 99)
        sess.append(b)
        resumed.append(b)
        a, c = sess.resolve(), resumed.resolve()
        np.testing.assert_array_equal(a["smooth_rep"], c["smooth_rep"])
        assert sess.last_resolve_path == resumed.last_resolve_path \
            == "incremental"

    def test_reference_checkpoint_resumes_in_the_port(self, tmp_path):
        """A warm session checkpointed by the reference resumes in the
        port on the same trajectory (outcomes equal, reputation within
        the drift band)."""
        from pyconsensus_tpu import ReputationLedger as RefLedger

        R = 8
        rl = RefLedger(n_reporters=R)
        rs = RefSession("m", R, ledger=rl, incremental=True,
                        refresh_every=5)
        for k in range(2):
            rs.append(blk(R, 8, 60 + k))
            rs.resolve()
        rl.save(tmp_path / "ref.npz")
        port = session("m", R, ledger=ReputationLedger.load(
            tmp_path / "ref.npz", device="cpu"), incremental=True,
            refresh_every=5)
        b = blk(R, 8, 77)
        port.append(b)
        rs.append(b)
        got, want = port.resolve(), rs.resolve()
        assert port.last_resolve_path == rs.last_resolve_path == \
            "incremental"
        np.testing.assert_array_equal(got["outcomes_adjusted"],
                                      want["outcomes_adjusted"])
        assert drift_between(got, want) <= incremental_drift_band(
            torch.float64)

    def test_plain_session_writes_no_aux(self, tmp_path):
        R = 8
        ledger = ReputationLedger(n_reporters=R, device="cpu")
        sess = session("m", R, ledger=ledger)
        sess.append(blk(R, 8, 1))
        sess.resolve()
        assert ledger.aux == {}

    def test_corrupt_warm_aux_refused(self, tmp_path):
        R = 8
        ledger = ReputationLedger(n_reporters=R, device="cpu")
        ledger.aux["incremental_warm_u"] = np.zeros(R + 3)
        with pytest.raises(CheckpointCorruptionError):
            session("m", R, ledger=ledger, incremental=True)
