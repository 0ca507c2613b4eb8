"""bfloat16 storage and scaled events in the port, against the JAX package
on the CPU.

Every input is made with numpy from a seed and goes to both packages; the
reference's Pallas kernels run with ``interpret=True``. bfloat16 matrices
are made once in torch and handed to JAX by their float32 values (exact,
since every value is on the bfloat16 lattice).

- **The kernels on bfloat16 storage.** Each wrapper's plain version
  against its Pallas kernel, with NaN absent entries and a fill whose
  scaled columns are continuous. ``apply_weighted_cov``,
  ``scores_dirfix_pass`` and ``resolve_certainty_fused`` fill with the
  float32 fill (``pallas_kernels._decode_block``); ``storage_matvec``,
  ``storage_matmat``, ``storage_rows_matmat`` and
  ``apply_weighted_cov_block`` with the fill rounded to bfloat16
  (``_decode_filled_bf16``). Bands as in ``tests/test_torch_kernels.py``:
  the TPU kernels' compensated bfloat16 dots are good to about 2^-17, so
  the covariance sweep is held to rtol 3e-5 (atol 1e-6) and resolve to
  rtol 1e-5 (atol 1e-6). The scores pass and the block products sum
  products of both signs of continuous bfloat16 values, where the
  compensated split's error scales with the terms (one ``q`` entry that
  cancelled to 1e-2 of its terms moved by 4.8e-6), so their outputs are
  held to 3e-5 of the output's largest magnitude. Resolve's snapped
  outcomes and absent counts are exact.
- **The fused slice.** ``sharded_consensus(device="cpu")`` against
  ``pipeline._consensus_core_fused`` with 1-5 scaled columns (at most
  E // 8, one of them the last column), bfloat16 and float32 storage,
  sztorc, fixed-variance and ica, a float64 and a float32 reputation,
  ``max_iterations`` 1 and 3, ``power_tol=-1``. Binary outcomes,
  ``na_row``, ``iterations``, ``convergence`` and ``ica_converged`` are
  exact; the scaled outcomes (``outcomes_final`` over the span of 20) and
  every continuous key within 1e-5 for sztorc and within 2e-3 for
  fixed-variance and ica (their orthogonal iteration's band,
  ``tests/test_torch_multi.py``).
- **The plain core on bfloat16.** ``_consensus_core`` (scaled events
  beyond E // 8 close the fused gate) against ``consensus_light_jit``:
  exact keys as above, continuous keys within 1e-5 for sztorc and 2e-3
  for fixed-variance and ica. sztorc's ``"power"`` arm on bfloat16
  operands keeps 1e-4 on every continuous key but the loading, whose
  band after 64 forced sweeps is measured from the reference itself
  (:func:`reference_loading_move`); at 8 sweeps and one iteration its
  loading is held to sztorc's 1e-5. The reference's own
  ``TestStorageDtype`` contract holds on the port's ``Oracle``:
  bfloat16 outcomes equal full-precision ones, ``smooth_rep`` within
  5e-3.
- **``resolve_auto_storage``** answers as the reference's, whose fused
  gate opens on a TPU only (its ``jax.default_backend`` is set to
  ``"tpu"`` for the comparison).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import collusion_reports
from pyconsensus_tpu import Oracle as RefOracle
from pyconsensus_tpu.models.pipeline import ConsensusParams as RefParams
from pyconsensus_tpu.models.pipeline import (_consensus_core_fused,
                                             consensus_light_jit)
from pyconsensus_tpu.ops import pallas_kernels as pk
from pyconsensus_tpu.parallel import sharded as ref_sharded
from pyconsensus_tpu.parallel.mesh import make_mesh as ref_make_mesh
from pyconsensus_tpu_torch import ConsensusParams, Oracle, sharded_consensus
from pyconsensus_tpu_torch.oracle import parse_event_bounds
from pyconsensus_tpu_torch.ops import cuda_kernels as ck
from pyconsensus_tpu_torch.parallel.sharded import (resolve_auto_storage,
                                                    resolve_params)

SHAPES = [(24, 16), (23, 300), (64, 301)]
EXACT_KEYS = ("outcomes_adjusted", "outcomes_final", "na_row", "iterations",
              "convergence", "ica_converged")
BF16 = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(x):
    """A torch tensor as a JAX array of the same dtype (bfloat16 through
    its exact float32 values)."""
    if x.dtype == BF16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _close(got, ref, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(ref, dtype=np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _close_scaled(got, ref, what, frac=3e-5):
    ref = np.asarray(ref, dtype=np.float64)
    _close(got, ref, 0, frac * max(np.abs(ref).max(), 1e-30), what)


def make_bf16_storage(seed, R, E, n_scaled=None, na_frac=0.1):
    """Binary reports with NaN absent entries and a few scaled columns of
    continuous rescaled values in [0, 1], as bfloat16 storage, plus a
    float32 rep, a fill (lattice values on binary columns, continuous ones
    on the scaled columns, which bfloat16 does not hold), mu of the
    float32-filled matrix and a vector v."""
    rng = np.random.default_rng(seed)
    n_scaled = max(1, E // 8) if n_scaled is None else n_scaled
    truth = rng.choice([0.0, 1.0], size=E)
    reports = np.abs(np.tile(truth, (R, 1)) - (rng.random((R, E)) < 0.1))
    reports[: R // 5] = 1.0 - truth
    reports[rng.random((R, E)) < 0.05] = 0.5
    scaled = np.zeros(E, bool)
    scaled[-n_scaled:] = True
    reports[:, scaled] = rng.random((R, n_scaled))
    reports[rng.random((R, E)) < na_frac] = np.nan
    x = _t(reports.astype(np.float32)).to(BF16)
    rep = rng.random(R).astype(np.float32)
    rep /= rep.sum()
    fill = rng.choice([0.0, 0.5, 1.0], size=E).astype(np.float32)
    fill[scaled] = rng.random(n_scaled).astype(np.float32)
    xf = x.float().numpy()
    filled = np.where(np.isnan(xf), fill[None, :], xf)
    mu = (rep @ filled).astype(np.float32)
    v = rng.standard_normal(E).astype(np.float32)
    return x, rep, fill, mu, v


# -- the kernels on bfloat16 storage ------------------------------------------

@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("with_fill", [True, False])
def test_sweeps_match_pallas(R, E, with_fill):
    """apply_weighted_cov and scores_dirfix_pass on bfloat16 storage, with
    the float32 fill or on a dense matrix (``fill=None``, the plain core's
    sweeps)."""
    x, rep, fill, mu, v = make_bf16_storage(R * 7 + E, R, E)
    if not with_fill:
        x = torch.where(torch.isnan(x), torch.tensor(0.25, dtype=BF16), x)
        mu = (rep @ x.float().numpy()).astype(np.float32)
    f = _t(fill) if with_fill else None
    jf = jnp.asarray(fill) if with_fill else None
    ref = pk.apply_weighted_cov(_j(x), jnp.asarray(mu), jnp.asarray(rep),
                                jnp.asarray(v), fill=jf, interpret=True)
    got = ck.apply_weighted_cov(x, _t(mu), _t(rep), _t(v), fill=f)
    assert got.dtype == torch.float32 and got.shape == (E,)
    _close(got.numpy(), ref, 3e-5, 1e-6, "apply_weighted_cov")
    ref = pk.scores_dirfix_pass(_j(x), jnp.asarray(rep), jnp.asarray(v),
                                fill=jf, interpret=True)
    got = ck.scores_dirfix_pass(x, _t(rep), _t(v), fill=f)
    for name, g, r in zip("tqco", got, ref):
        _close_scaled(g.numpy(), r, f"scores_dirfix {name}")


@pytest.mark.parametrize("R,E", SHAPES)
def test_resolve_matches_pallas(R, E):
    x, rep, fill, mu, v = make_bf16_storage(R * 13 + E, R, E)
    x[:, 0] = float("nan")                   # the tw > 0 fallback
    total = np.float32(rep.sum())
    ref = pk.resolve_certainty_fused(_j(x), jnp.asarray(rep),
                                     jnp.asarray(fill), jnp.asarray(total),
                                     0.1, interpret=True)
    got = ck.resolve_certainty_fused(x, _t(rep), _t(fill),
                                     torch.tensor(total), 0.1)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))
    for name, g, r in zip(["raw", "outcomes", "certainty", "pcol", "prow",
                           "narow"], got, ref):
        assert g.shape == r.shape, name
        _close(g.numpy(), r, 1e-5, 1e-6, f"resolve {name}")


@pytest.mark.parametrize("R,E", SHAPES)
@pytest.mark.parametrize("k", [5, 17])
def test_products_match_pallas(R, E, k):
    """storage_matvec, storage_matmat (k = 17: two groups),
    storage_rows_matmat and apply_weighted_cov_block (k = 5, with its
    projections) on bfloat16 storage, where the reference rounds the fill
    to bfloat16."""
    x, rep, fill, mu, v = make_bf16_storage(R * 3 + E + k, R, E)
    rng = np.random.default_rng(k)
    V = rng.standard_normal((E, k)).astype(np.float32)
    W = rng.standard_normal((k, R)).astype(np.float32)
    jx, jfill = _j(x), jnp.asarray(fill)
    _close_scaled(ck.storage_matvec(x, _t(v), _t(fill)).numpy(),
                  pk.storage_matvec(jx, jnp.asarray(v), fill=jfill,
                                    interpret=True), "storage_matvec")
    _close_scaled(ck.storage_matmat(x, _t(V), _t(fill)).numpy(),
                  pk.storage_matmat(jx, jnp.asarray(V), fill=jfill,
                                    interpret=True), "storage_matmat")
    _close_scaled(ck.storage_rows_matmat(x, _t(W), _t(fill)).numpy(),
                  pk.storage_rows_matmat(jx, jnp.asarray(W), fill=jfill,
                                         interpret=True),
                  "storage_rows_matmat")
    V5 = V[:, :5]
    ref_y, ref_t = pk.apply_weighted_cov_block(
        jx, jnp.asarray(mu), jnp.asarray(rep), jnp.asarray(V5), fill=jfill,
        interpret=True, emit_t=True)
    y, t = ck.apply_weighted_cov_block(x, _t(mu), _t(rep), _t(V5),
                                       fill=_t(fill), emit_t=True)
    _close_scaled(y.numpy(), ref_y, "apply_weighted_cov_block y")
    _close_scaled(t.numpy(), ref_t, "apply_weighted_cov_block t")


def test_two_fill_forms():
    """On bfloat16 storage the uncentered products and the block
    covariance take the fill rounded to bfloat16, bit for bit what they
    compute from a pre-rounded fill, and not what the float32 fill gives;
    the sweeps and resolve take the float32 fill. Other storage never
    rounds the fill."""
    R, E = 40, 64
    x, rep, fill, mu, v = make_bf16_storage(5, R, E)
    f, f16 = _t(fill), _t(fill).to(BF16).float()
    assert not torch.equal(f, f16)
    V = _t(np.ones((E, 3), np.float32))
    W = _t(np.ones((3, R), np.float32))
    rounds = {
        "storage_matvec": lambda g: ck.storage_matvec(x, _t(v), g),
        "storage_matmat": lambda g: ck.storage_matmat(x, V, g),
        "storage_rows_matmat": lambda g: ck.storage_rows_matmat(x, W, g),
        "apply_weighted_cov_block": lambda g: ck.apply_weighted_cov_block(
            x, _t(mu), _t(rep), V, g)[0],
    }
    for name, fn in rounds.items():
        assert torch.equal(fn(f), fn(f16)), name
        xf = x.float()
        assert torch.equal(ck._lattice_fill(xf, f), f), name
    x_gap = x.clone()
    x_gap[:, -1] = float("nan")
    keeps = {
        "apply_weighted_cov": lambda g: ck.apply_weighted_cov(
            x, _t(mu), _t(rep), _t(v), g),
        "scores_dirfix_pass": lambda g: ck.scores_dirfix_pass(
            x, _t(rep), _t(v), g)[0],
        # the raw mean of an all-absent column is its fill
        "resolve_certainty_fused": lambda g: ck.resolve_certainty_fused(
            x_gap, _t(rep), g, 1.0, 0.1)[0],
    }
    for name, fn in keeps.items():
        assert not torch.equal(fn(f), fn(f16)), name


def test_fill_stats_pass_refuses_bfloat16():
    """The reference runs the fill-statistics kernel on int8 alone; the
    port's takes int8 and float32 and refuses bfloat16 on any device."""
    x, rep, *_ = make_bf16_storage(0, 24, 16)
    with pytest.raises(TypeError, match="fill_stats_pass"):
        ck.fill_stats_pass(x, _t(rep))


# -- the fused slice ----------------------------------------------------------

def make_scaled_reports(seed, R, E, cols):
    """Collusion-style binary reports with NaN non-reports; the ``cols``
    columns are scaled events on [-5, 15]: honest reporters spread near
    the true end, the colluding fifth anywhere. Returns ``(reports,
    event_bounds)``."""
    rng = np.random.default_rng(seed)
    truth = rng.choice([0.0, 1.0], size=E)
    reports = np.tile(truth, (R, 1))
    liars = max(2, R // 5)
    flips = rng.random((R - liars, E)) < 0.1
    reports[:R - liars] = np.abs(reports[:R - liars] - flips)
    reports[R - liars:] = 1.0 - truth
    bounds = [None] * E
    for c in cols:
        honest = rng.random(R) * 0.3 + (0.6 if truth[c] else 0.1)
        honest[R - liars:] = rng.random(liars)
        reports[:, c] = 20.0 * honest - 5.0
        bounds[c] = {"scaled": True, "min": -5.0, "max": 15.0}
    reports[rng.random((R, E)) < 0.1] = np.nan
    return reports, bounds


def assert_parity(out, ref, scaled, atol, loading_atol=None):
    """Exact keys equal on the binary events; the scaled events' outcomes
    (``outcomes_final`` over the span of 20) and every continuous key
    within ``atol``; ``first_loading`` up to sign, within
    ``loading_atol`` (default ``atol``)."""
    assert set(ref) <= set(out)
    for key, a in ref.items():
        a = np.asarray(a)
        b = np.asarray(out[key].cpu() if isinstance(out[key], torch.Tensor)
                       else out[key])
        if key in EXACT_KEYS:
            if a.shape == scaled.shape:
                np.testing.assert_array_equal(b[~scaled], a[~scaled],
                                              err_msg=key)
                span = 20.0 if key == "outcomes_final" else 1.0
                _close(b[scaled] / span, a[scaled] / span, 0, atol, key)
            else:
                np.testing.assert_array_equal(b, a, err_msg=key)
        elif key == "first_loading":
            _close(np.abs(b), np.abs(a), 0,
                   atol if loading_atol is None else loading_atol, key)
        else:
            _close(b, a, 0, atol, key)


FUSED_CASES = [(algo, storage, rep_dtype, mi)
               for algo in ("sztorc", "fixed-variance", "ica")
               for storage in ("bfloat16", "")
               for rep_dtype in (np.float64, np.float32)
               for mi in (1, 3)]


@pytest.mark.parametrize("case", range(len(FUSED_CASES)))
def test_fused_scaled_matches_reference(case):
    """The fused path with 1-5 scaled events (E // 8 = 6), one of them the
    last column: the kernels on bfloat16 or float32 storage, then the
    gather-median tail."""
    algo, storage, rep_dtype, mi = FUSED_CASES[case]
    R, E = 31, 48
    n_sc = 1 + case % 5
    cols = sorted({E - 1, *np.random.default_rng(case).choice(
        E - 1, n_sc - 1, replace=False).tolist()})
    reports, bounds = make_scaled_reports(case, R, E, cols)
    rep = np.random.default_rng(R + case).random(R).astype(rep_dtype)
    scaled, mins, maxs = parse_event_bounds(bounds, E)
    kw = dict(algorithm=algo, pca_method="power", power_iters=64,
              power_tol=-1.0, max_iterations=mi, storage_dtype=storage)
    p = resolve_params(ConsensusParams(**kw)._replace(
        any_scaled=True, n_scaled=len(cols)), R, E, torch.device("cpu"))
    assert p.fused_resolution
    out = sharded_consensus(reports.astype(np.float32), reputation=rep,
                            event_bounds=bounds,
                            params=ConsensusParams(**kw), device="cpu")
    # under x64 the reference's iterated fixed-variance refuses a float32
    # reputation (tests/test_torch_multi.py): it runs in float64 there
    ref_rep = (rep.astype(np.float64)
               if algo == "fixed-variance" and mi > 1 else rep)
    ref = _consensus_core_fused(
        jnp.asarray(reports.astype(np.float32)), jnp.asarray(ref_rep),
        jnp.asarray(scaled), jnp.asarray(mins.astype(np.float32)),
        jnp.asarray(maxs.astype(np.float32)),
        RefParams(**kw, any_scaled=True, n_scaled=len(cols), has_na=True,
                  fused_resolution=True))
    assert out["smooth_rep"].dtype == torch.from_numpy(rep).dtype
    assert_parity(out, ref, scaled, 1e-5 if algo == "sztorc" else 2e-3)


@pytest.mark.parametrize("storage", ["bfloat16", ""])
def test_fused_scaled_recovers_the_truth(storage):
    """A larger matrix: every binary outcome is the truth and every scaled
    one lands at its honest end, on both storages; the bfloat16 run's
    binary outcomes equal the float32 run's."""
    R, E = 64, 400
    cols = list(range(E - 50, E))
    reports, bounds = make_scaled_reports(3, R, E, cols)
    outs = {}
    for st in ("bfloat16", ""):
        p = ConsensusParams(pca_method="power", storage_dtype=st,
                            power_tol=1e-5)
        outs[st] = sharded_consensus(reports.astype(np.float32),
                                     event_bounds=bounds, params=p,
                                     device="cpu")
    out = outs[storage]
    honest = np.nanmedian(reports[: -(R // 5)], axis=0)
    final = out["outcomes_final"].numpy()
    binary = np.ones(E, bool)
    binary[cols] = False
    np.testing.assert_array_equal(final[binary], np.round(honest[binary]))
    assert np.all(np.abs(final[cols] - honest[cols]) < 3.0)
    np.testing.assert_array_equal(outs["bfloat16"]["outcomes_adjusted"]
                                  [binary], outs[""]["outcomes_adjusted"]
                                  [binary])


# -- the plain core on bfloat16 -----------------------------------------------

PLAIN_CASES = [("sztorc", "power-fused", "bfloat16", ""),
               ("sztorc", "power-fused", "", "bfloat16"),
               ("sztorc", "power", "bfloat16", ""),
               ("sztorc", "power", "", "bfloat16"),
               ("sztorc", "eigh-gram", "bfloat16", ""),
               ("fixed-variance", "eigh-cov", "bfloat16", ""),
               ("fixed-variance", "power", "bfloat16", ""),
               ("fixed-variance", "eigh-gram", "bfloat16", ""),
               ("ica", "power", "bfloat16", ""),
               ("ica", "eigh-cov", "bfloat16", "")]


#: the reporters whose reputation :func:`reference_loading_move` nudges
NUDGED = (0, 7, 20)
#: the band of sztorc's bfloat16 "power" loading over the reference's own
#: move under those nudges
LOADING_FACTOR = 4


def _plain_core_pair(algo, method, storage, matvec, power_iters,
                     max_iterations):
    """The plain-core case of the tests below: returns ``(out, run_ref,
    rep, scaled)``, where ``run_ref(rep)`` resolves the same inputs with
    the reference (``consensus_light_jit``) at reputation ``rep``."""
    R, E = 31, 48
    cols = list(range(E - 8, E))
    reports, bounds = make_scaled_reports(R + E, R, E, cols)
    rep = np.random.default_rng(1).random(R)
    scaled, mins, maxs = parse_event_bounds(bounds, E)
    kw = dict(algorithm=algo, pca_method=method, power_iters=power_iters,
              power_tol=-1.0, max_iterations=max_iterations,
              storage_dtype=storage, matvec_dtype=matvec)
    p = resolve_params(ConsensusParams(**kw)._replace(
        any_scaled=True, n_scaled=len(cols)), R, E, torch.device("cpu"))
    assert not p.fused_resolution and p.pca_method == method
    out = sharded_consensus(reports.astype(np.float32), reputation=rep,
                            event_bounds=bounds,
                            params=ConsensusParams(**kw), device="cpu")

    def run_ref(r):
        return consensus_light_jit(
            jnp.asarray(reports.astype(np.float32)), jnp.asarray(r),
            jnp.asarray(scaled), jnp.asarray(mins.astype(np.float32)),
            jnp.asarray(maxs.astype(np.float32)),
            RefParams(**kw, any_scaled=True, n_scaled=len(cols),
                      has_na=True))

    return out, run_ref, rep, scaled


def reference_loading_move(run_ref, rep, base):
    """The largest move of the reference's own ``first_loading`` (up to
    sign) when one reporter's reputation moves by one ulp
    (``np.nextafter``), over the reporters :data:`NUDGED`."""
    base = np.abs(np.asarray(base["first_loading"], dtype=np.float64))
    move = 0.0
    for i in NUDGED:
        nudged = rep.copy()
        nudged[i] = np.nextafter(nudged[i], np.inf)
        got = np.abs(np.asarray(run_ref(nudged)["first_loading"],
                                dtype=np.float64))
        move = max(move, float(np.max(np.abs(got - base))))
    return move


@pytest.mark.parametrize("algo,method,storage,matvec", PLAIN_CASES)
def test_plain_core_bf16_matches_reference(algo, method, storage, matvec):
    """8 scaled events of 48 (beyond E // 8) close the fused gate: the
    plain core stores the filled matrix in bfloat16 (or narrows sztorc's
    sweeps with ``matvec_dtype``), three iterations of 64 forced sweeps.

    sztorc's ``"power"`` loading is held to the reference's own
    sensitivity, not to a fixed band. Each sweep rounds ``v`` and ``rt``
    to bfloat16; the full-precision centering terms (``mu @ v``,
    ``mu * sum(rt)``) then amplify a last-bit float64 difference about
    three times a sweep until bfloat16 roundings flip. The port matches
    the reference to about 1e-15 before the first flip, and after 64
    sweeps the reference itself moves its loading by up to 2.8e-4 when
    one reporter's reputation moves by one ulp, outcomes unchanged. So
    the band is ``LOADING_FACTOR`` (4) times the reference's own move
    under one-ulp nudges at the reporters ``NUDGED``, and never below
    the arm's 1e-4; every other continuous key keeps 1e-4, every exact
    key stays equal. ``test_plain_core_bf16_power_short_sweeps`` keeps
    the tight band where no rounding has flipped."""
    out, run_ref, rep, scaled = _plain_core_pair(algo, method, storage,
                                                 matvec, 64, 3)
    ref = run_ref(rep)
    atol = (2e-3 if algo != "sztorc" else 1e-4 if method == "power"
            else 1e-5)
    loading_atol = None
    if algo == "sztorc" and method == "power":
        loading_atol = max(1e-4, LOADING_FACTOR * reference_loading_move(
            run_ref, rep, ref))
    assert_parity(out, ref, scaled, atol, loading_atol)


@pytest.mark.parametrize("storage,matvec", [("bfloat16", ""),
                                            ("", "bfloat16")])
def test_plain_core_bf16_power_short_sweeps(storage, matvec):
    """sztorc's bfloat16 ``"power"`` arm at 8 sweeps and one iteration,
    before the roundings flip: the loading within sztorc's 1e-5, as
    every other continuous key and the other sztorc arms."""
    out, run_ref, rep, scaled = _plain_core_pair("sztorc", "power",
                                                 storage, matvec, 8, 1)
    assert_parity(out, run_ref(rep), scaled, 1e-5)


class TestStorageDtype:
    """The reference's ``tests/test_oracle.py`` TestStorageDtype contract,
    on the port's ``Oracle``: bfloat16 storage keeps the catch-snapped
    outcomes of the full-precision run."""

    def test_binary_outcomes_identical(self, rng):
        reports, _ = collusion_reports(rng, 50, 25, 10)
        full = Oracle(reports=reports, device="cpu",
                      max_iterations=3).consensus()
        compact = Oracle(reports=reports, device="cpu", max_iterations=3,
                         storage_dtype="bfloat16").consensus()
        np.testing.assert_array_equal(full["events"]["outcomes_final"],
                                      compact["events"]["outcomes_final"])
        np.testing.assert_allclose(compact["agents"]["smooth_rep"],
                                   full["agents"]["smooth_rep"], atol=5e-3)

    def test_with_missing_entries(self, rng):
        reports, _ = collusion_reports(rng, 50, 25, 10)
        reports[rng.random(reports.shape) < 0.1] = np.nan
        full = Oracle(reports=reports, device="cpu").consensus()
        compact = Oracle(reports=reports, device="cpu",
                         storage_dtype="bfloat16").consensus()
        np.testing.assert_array_equal(full["events"]["outcomes_final"],
                                      compact["events"]["outcomes_final"])
        np.testing.assert_array_equal(full["agents"]["na_row"],
                                      compact["agents"]["na_row"])

    @pytest.mark.parametrize("method", ["power", "power-fused"])
    def test_power_path_storage(self, rng, method):
        reports, _ = collusion_reports(rng, 50, 25, 10)
        full = Oracle(reports=reports, device="cpu",
                      pca_method=method).consensus()
        compact = Oracle(reports=reports, device="cpu", pca_method=method,
                         storage_dtype="bfloat16").consensus()
        np.testing.assert_array_equal(full["events"]["outcomes_final"],
                                      compact["events"]["outcomes_final"])

    @pytest.mark.parametrize("algo", ["sztorc", "fixed-variance", "ica"])
    def test_every_algorithm_runs_compact(self, rng, algo):
        reports, _ = collusion_reports(rng, 50, 25, 10)
        full = Oracle(reports=reports, device="cpu", algorithm=algo,
                      max_iterations=2).consensus()
        compact = Oracle(reports=reports, device="cpu", algorithm=algo,
                         max_iterations=2,
                         storage_dtype="bfloat16").consensus()
        np.testing.assert_array_equal(full["events"]["outcomes_final"],
                                      compact["events"]["outcomes_final"],
                                      err_msg=algo)

    def test_matches_the_reference_compact_run(self, rng):
        """The port's bfloat16 Oracle against the reference's."""
        reports, _ = collusion_reports(rng, 50, 25, 10)
        reports[rng.random(reports.shape) < 0.1] = np.nan
        kw = dict(reports=reports, storage_dtype="bfloat16",
                  max_iterations=3)
        a = Oracle(device="cpu", **kw).consensus()
        b = RefOracle(backend="jax", **kw).consensus()
        np.testing.assert_array_equal(a["events"]["outcomes_final"],
                                      b["events"]["outcomes_final"])
        np.testing.assert_allclose(a["agents"]["smooth_rep"],
                                   b["agents"]["smooth_rep"], atol=1e-5)


# -- resolve_auto_storage -----------------------------------------------------

AUTO_CASES = [
    # (algorithm, pca_method, R, E, any_scaled, allow_fused, n_event)
    ("sztorc", "auto", 10_000, 100_000, False, True, 1),
    ("sztorc", "auto", 10_000, 100_000, True, True, 1),
    ("sztorc", "auto", 4096, 100_000, False, True, 1),
    ("sztorc", "eigh-cov", 10_000, 1000, False, True, 1),
    ("sztorc", "power-fused", 10_000, 100_000, False, False, 1),
    ("sztorc", "power", 2000, 5000, False, True, 1),
    ("fixed-variance", "auto", 10_000, 50_000, False, True, 1),
    ("ica", "auto", 10_000, 50_000, False, True, 1),
    ("fixed-variance", "auto", 10_000, 1000, False, True, 1),
    ("sztorc", "auto", 10_000, 100_000, False, True, 4),
    ("ica", "power", 10_000, 50_000, False, True, 4),
]


@pytest.mark.parametrize("case", AUTO_CASES)
def test_resolve_auto_storage_answers_as_the_reference(case, monkeypatch):
    algo, method, R, E, any_scaled, allow_fused, n_event = case
    kw = dict(algorithm=algo, pca_method=method, any_scaled=any_scaled,
              n_scaled=1 if any_scaled else 0, allow_fused=allow_fused)
    got, why = resolve_auto_storage(ConsensusParams(**kw), R, E, "cpu",
                                    n_event)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want, _ = ref_sharded.resolve_auto_storage(
        RefParams(**kw), R, E, ref_make_mesh(event=n_event))
    assert got == want, why
    # what it picks resolves: the fused path for int8, and the storage is
    # one the port takes
    if n_event == 1:
        p = resolve_params(ConsensusParams(**kw)._replace(
            storage_dtype=got), R, E, torch.device("cpu"))
        assert p.fused_resolution or got == "bfloat16"


def test_params_carry_bf16_from_reference():
    """``convert.params_from_reference`` carries the reference's bfloat16
    storage and matvec cast, and the front door takes them."""
    from pyconsensus_tpu_torch.convert import params_from_reference

    ref = RefParams(storage_dtype="bfloat16", matvec_dtype="bfloat16",
                    pca_method="power-fused")
    p = params_from_reference(ref._asdict())
    assert p._asdict() == ref._asdict()
    q = resolve_params(p._replace(any_scaled=False), 10_000, 100_000,
                       torch.device("cpu"))
    assert q.fused_resolution
    with pytest.raises(ValueError, match="matvec_dtype"):
        resolve_params(p._replace(matvec_dtype="float16", any_scaled=False),
                       24, 40, torch.device("cpu"))
