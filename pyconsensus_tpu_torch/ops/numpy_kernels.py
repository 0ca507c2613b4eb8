"""NumPy kernels of the consensus pipeline: the port's numpy backend.

A copy of ``pyconsensus_tpu/ops/numpy_kernels.py`` (the JAX package's
correctness anchor), kept here so that the port never imports the JAX
package: same functions, same arithmetic in the same order, so
``consensus_np`` gives the reference's bits. The tie bands live in
``constants.py``, shared with the torch kernels.

Conventions
-----------
- ``reports``: float64 array, shape (R, E). Rows = reporters, columns =
  events. ``NaN`` marks a non-report. Binary events take values in
  {0, 0.5, 1}; scaled events are raw reals rescaled into [0, 1] via
  ``event_bounds``.
- ``reputation``: float64 array, shape (R,), non-negative, sums to 1.
- ``scaled``: bool array, shape (E,). True where the event is scaled
  (continuous, resolved by weighted median) rather than binary/categorical
  (resolved by weighted mean + catch-snap).
"""

from __future__ import annotations

import numpy as np

from .constants import CATCH_TIE_ATOL, DIRFIX_TIE_ATOL, MEDIAN_TIE_ATOL

__all__ = [
    "normalize",
    "canon_sign",
    "catch",
    "rescale",
    "unscale_outcomes",
    "interpolate",
    "weighted_cov",
    "weighted_prin_comp",
    "weighted_median",
    "direction_fixed_scores",
    "row_reward_weighted",
    "smooth",
    "resolve_outcomes",
    "certainty_and_bonuses",
]


def normalize(v: np.ndarray) -> np.ndarray:
    """Rescale ``v`` to sum to 1 (SURVEY.md §2 #6, the R ``GetWeight`` rule).

    Plain ``v / sum(v)``; a vector with negative entries and a negative sum
    normalizes back to a non-negative weighting (which is why a global sign
    flip of adjusted scores is a no-op through ``row_reward_weighted``). A
    zero-sum vector is returned unchanged — callers guard degenerate cases
    explicitly (see ``row_reward_weighted``).
    """
    v = np.asarray(v, dtype=np.float64)
    total = v.sum()
    if total == 0.0:
        return v.copy()
    return v / total


def canon_sign(v: np.ndarray) -> np.ndarray:
    """Canonicalize an eigenvector's arbitrary sign: flip so the
    largest-|value| entry is positive (first-argmax tie-break, mirrored in the
    jax kernel). Used on *reported* loadings so both backends expose the same
    vector; scores go through the direction fix instead."""
    v = np.asarray(v, dtype=np.float64)
    s = np.sign(v[np.argmax(np.abs(v))])
    return v * (1.0 if s == 0.0 else s)


def catch(x, tolerance: float):
    """Snap a consensus value toward {0, 0.5, 1} (SURVEY.md §2 #6).

    ``x < 0.5 - tolerance -> 0``; ``x > 0.5 + tolerance -> 1``; else
    ``0.5``. Boundary decisions are banded by :data:`CATCH_TIE_ATOL`
    (shared with the jax and Pallas mirrors) so reduction-order ulp
    noise cannot flip a knife-edge snap. Works elementwise on arrays.
    """
    x = np.asarray(x, dtype=np.float64)
    return np.where(x < 0.5 - tolerance - CATCH_TIE_ATOL, 0.0,
                    np.where(x > 0.5 + tolerance + CATCH_TIE_ATOL, 1.0, 0.5))


def rescale(reports: np.ndarray, scaled: np.ndarray, mins: np.ndarray,
            maxs: np.ndarray) -> np.ndarray:
    """Map scaled-event columns into [0, 1]: ``(x - min) / (max - min)``
    (SURVEY.md §2 #1). Binary columns pass through. NaNs stay NaN."""
    reports = np.asarray(reports, dtype=np.float64)
    span = np.where(scaled, maxs - mins, 1.0)
    span = np.where(span == 0.0, 1.0, span)
    out = np.where(scaled[None, :], (reports - np.where(scaled, mins, 0.0)[None, :]) / span[None, :], reports)
    return out


def unscale_outcomes(outcomes: np.ndarray, scaled: np.ndarray, mins: np.ndarray,
                     maxs: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rescale` on per-event outcomes: scaled events map back
    through ``x * (max - min) + min`` (SURVEY.md §2 #8, outcomes_final)."""
    return np.where(scaled, outcomes * (maxs - mins) + mins, outcomes)


def interpolate(reports: np.ndarray, reputation: np.ndarray, scaled: np.ndarray,
                tolerance: float) -> np.ndarray:
    """Fill NaN entries with the reputation-weighted column mean over the
    reporters who did report (SURVEY.md §3.4):

        fill[j] = sum_k rep[k] * reports[k, j] / sum_k rep[k]   over non-NaN k

    Binary columns snap the fill through :func:`catch`; scaled columns keep the
    raw weighted mean. A column with no reports at all fills with 0.5.
    Returns ``reports_filled`` (dense, no NaN).
    """
    reports = np.asarray(reports, dtype=np.float64)
    rep = np.asarray(reputation, dtype=np.float64)
    present = ~np.isnan(reports)                       # (R, E)
    active_rep = present * rep[:, None]                # (R, E)
    denom = active_rep.sum(axis=0)                     # (E,)
    numer = (np.where(present, reports, 0.0) * rep[:, None]).sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        fill = np.where(denom > 0.0, numer / denom, 0.5)
    fill = np.where(scaled, fill, catch(fill, tolerance))
    return np.where(present, reports, fill[None, :])


def weighted_cov(reports_filled: np.ndarray, reputation: np.ndarray):
    """Reputation-weighted covariance of the filled reports (SURVEY.md §3.5).

    mu = rep^T X (weighted column means); D = X - mu; then

        cov = D^T diag(rep) D / (1 - sum(rep^2))

    Returns ``(cov, deviations)`` where ``deviations`` is the centered matrix D
    (R, E) and ``cov`` is (E, E). The ``1 - sum(rep^2)`` denominator is the
    unbiased weighted normalization.
    """
    X = np.asarray(reports_filled, dtype=np.float64)
    rep = np.asarray(reputation, dtype=np.float64)
    mu = rep @ X                                       # (E,)
    dev = X - mu[None, :]                              # (R, E)
    denom = 1.0 - float(np.sum(rep ** 2))
    if denom == 0.0:
        denom = 1.0  # single-reporter degenerate case
    cov = (dev * rep[:, None]).T @ dev / denom         # (E, E)
    return cov, dev


def weighted_prin_comp(reports_filled: np.ndarray, reputation: np.ndarray):
    """First principal component of the weighted covariance (SURVEY.md §2 #4).

    Returns ``(loading, scores)``: ``loading`` is the E-vector first
    eigenvector of the weighted covariance; ``scores = deviations @ loading``
    is the per-reporter projection. Sign is arbitrary (fixed downstream by
    :func:`direction_fixed_scores`).
    """
    cov, dev = weighted_cov(reports_filled, reputation)
    eigvals, eigvecs = np.linalg.eigh(cov)
    loading = eigvecs[:, -1]                           # largest eigenvalue
    scores = dev @ loading
    return loading, scores


def weighted_prin_comps(reports_filled: np.ndarray, reputation: np.ndarray,
                        n_components: int):
    """Top-``n_components`` principal components, with explained-variance
    fractions. Used by the ``fixed-variance`` algorithm variant
    (SURVEY.md §2 #10). Returns ``(loadings (E, k), scores (R, k),
    explained (k,))`` ordered by descending eigenvalue."""
    cov, dev = weighted_cov(reports_filled, reputation)
    eigvals, eigvecs = np.linalg.eigh(cov)
    order = np.argsort(eigvals)[::-1][:n_components]
    loadings = eigvecs[:, order]
    eig = np.clip(eigvals[order], 0.0, None)
    total = eigvals.clip(0.0, None).sum()
    explained = eig / total if total > 0 else np.zeros_like(eig)
    scores = dev @ loadings
    return loadings, scores, explained


def weighted_median(values: np.ndarray, weights: np.ndarray) -> float:
    """Weighted median by sorted cumulative weight (SURVEY.md §2 #8).

    Sort values; find the first value where the cumulative normalized weight
    reaches 0.5. If the cumulative weight hits 0.5 exactly at a sample
    (to :data:`MEDIAN_TIE_ATOL` — see its sizing note), return the
    midpoint of that value and the next (the standard lower/upper-median
    midpoint rule, matching the ``weightedstats`` dependency of the
    reference). Implemented identically (same comparisons, same midpoint rule)
    in the JAX backend so backend outcomes agree bit-identically.
    """
    values = np.asarray(values, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    total = weights.sum()
    if total <= 0.0:
        return 0.5
    order = np.argsort(values, kind="stable")
    v = values[order]
    w = weights[order] / total
    cw = np.cumsum(w)
    # first index where the cumulative weight reaches 0.5 — less the tie
    # tolerance, so a true tie that lands one ulp BELOW 0.5 still selects
    # the tie index (and then midpoints) instead of skipping past it
    idx = int(np.searchsorted(cw, 0.5 - MEDIAN_TIE_ATOL))
    if idx >= len(v):
        idx = len(v) - 1
    if abs(cw[idx] - 0.5) <= MEDIAN_TIE_ATOL and idx + 1 < len(v):
        return 0.5 * (v[idx] + v[idx + 1])
    return float(v[idx])


def direction_fixed_scores(scores: np.ndarray, reports_filled: np.ndarray,
                           reputation: np.ndarray) -> np.ndarray:
    """Resolve PCA sign ambiguity (the ``nonconformity`` step, SURVEY.md §2 #5).

    Candidate orientations ``set1 = scores + |min(scores)|`` and
    ``set2 = scores - max(scores)`` imply two outcome vectors; whichever lies
    closer (squared distance) to the current reputation-weighted outcomes
    ``old = rep^T X`` wins. Ties — banded by :data:`DIRFIX_TIE_ATOL`,
    see its sizing note — go to ``set1``.

    The chosen orientation is returned in its NON-NEGATIVE form: when
    ``set2`` (entrywise <= 0) wins, ``-set2 = max(scores) - scores`` is
    returned instead. Through ``row_reward_weighted``'s normalize a global
    sign flip is an exact no-op for a single component, and the
    non-negative convention keeps multi-component blends (fixed-variance)
    on the reputation simplex — a mixed-sign blend of raw set1/set2
    vectors can otherwise produce negative reputation entries.
    """
    # canonicalize the eigensolver's arbitrary sign BEFORE building the
    # candidates: when the two orientations are exactly equidistant (the
    # DIRFIX_TIE_ATOL band), "pick set1" is not sign-invariant — set1
    # built from -scores is the OTHER orientation — so without this a
    # tie's winner depends on which sign the backend's eigensolver
    # happened to return (round-4 fuzz seed 1989: numpy eigh-cov and the
    # jax Gram path returned opposite signs on a symmetric matrix and
    # resolved opposite outcomes). Away from the band the winner is
    # sign-invariant, so this changes nothing.
    s = canon_sign(np.asarray(scores, dtype=np.float64))
    set1 = s + np.abs(np.min(s))
    set2 = s - np.max(s)
    old = reputation @ reports_filled
    new1 = normalize(set1) @ reports_filled
    new2 = normalize(set2) @ reports_filled
    d1 = np.sum((new1 - old) ** 2)
    d2 = np.sum((new2 - old) ** 2)
    return set1 if d1 - d2 <= DIRFIX_TIE_ATOL * (d1 + d2) else -set2


def row_reward_weighted(adj_scores: np.ndarray, reputation: np.ndarray) -> np.ndarray:
    """Convert direction-fixed scores into the new reputation weighting
    (SURVEY.md §2 #6, symbol ``row_reward_weighted`` from BASELINE.json):

        normalize(adj_scores * rep / mean(rep))

    If all adjusted scores are zero (no disagreement direction — e.g. a
    unanimous reports matrix), reputation is returned unchanged.
    """
    rep = np.asarray(reputation, dtype=np.float64)
    adj = np.asarray(adj_scores, dtype=np.float64)
    if np.max(np.abs(adj)) == 0.0:
        return rep.copy()
    return normalize(adj * (rep / np.mean(rep)))


def smooth(this_rep: np.ndarray, old_rep: np.ndarray, alpha: float) -> np.ndarray:
    """Blend new reputation with prior: ``alpha*this + (1-alpha)*old``
    (SURVEY.md §2 #6, the ``smooth`` step)."""
    return alpha * np.asarray(this_rep, dtype=np.float64) + (1.0 - alpha) * np.asarray(old_rep, dtype=np.float64)


def resolve_outcomes(reports: np.ndarray, reports_filled: np.ndarray,
                     smooth_rep: np.ndarray, scaled: np.ndarray,
                     tolerance: float):
    """Per-event outcome resolution (SURVEY.md §2 #8).

    For each event, reputation is restricted to the reporters who actually
    reported (non-NaN in the *original* matrix) and renormalized; binary
    events resolve by weighted mean, scaled events by weighted median. Returns
    ``(outcomes_raw, outcomes_adjusted)`` where adjusted = catch-snapped for
    binary events, raw for scaled.
    """
    reports = np.asarray(reports, dtype=np.float64)
    R, E = reports.shape
    present = ~np.isnan(reports)
    outcomes_raw = np.empty(E, dtype=np.float64)
    for j in range(E):
        mask = present[:, j]
        w = smooth_rep * mask
        tw = w.sum()
        if tw <= 0.0:
            # nobody reported: fall back to the filled column under full rep
            w = smooth_rep
            col = reports_filled[:, j]
            outcomes_raw[j] = float(w @ col / w.sum())
            continue
        col = reports_filled[:, j]
        if scaled[j]:
            outcomes_raw[j] = weighted_median(col[mask], w[mask])
        else:
            outcomes_raw[j] = float((w @ col) / tw)
    outcomes_adjusted = np.where(scaled, outcomes_raw, catch(outcomes_raw, tolerance))
    return outcomes_raw, outcomes_adjusted


def certainty_and_bonuses(reports: np.ndarray, reports_filled: np.ndarray,
                          smooth_rep: np.ndarray, outcomes_adjusted: np.ndarray,
                          scaled: np.ndarray, tolerance: float):
    """Certainty, participation accounting and bonuses (SURVEY.md §2 #9).

    - ``certainty[j]``: total smoothed reputation sitting on the winning
      outcome — reporters whose filled report equals the adjusted outcome
      (binary), or lies within ``tolerance`` of it (scaled).
    - ``consensus_reward = normalize(certainty)``.
    - ``participation_columns = 1 - smooth_rep^T NA``;
      ``participation_rows = 1 - NA consensus_reward``;
      ``percent_na = 1 - mean(participation_columns)``.
    - ``reporter_bonus`` blends NA-participation weight with smoothed rep by
      ``percent_na``; ``author_bonus`` does the same on the column side.

    Returns a dict of all of the above.
    """
    reports = np.asarray(reports, dtype=np.float64)
    na_mat = np.isnan(reports).astype(np.float64)
    agree = np.where(
        scaled[None, :],
        np.abs(reports_filled - outcomes_adjusted[None, :]) <= tolerance,
        reports_filled == outcomes_adjusted[None, :],
    )
    certainty = (agree * smooth_rep[:, None]).sum(axis=0)          # (E,)
    consensus_reward = normalize(certainty)
    avg_certainty = float(np.mean(certainty))

    participation_columns = 1.0 - smooth_rep @ na_mat              # (E,)
    participation_rows = 1.0 - na_mat @ consensus_reward           # (R,)
    percent_na = 1.0 - float(np.mean(participation_columns))

    na_bonus_rows = normalize(participation_rows)
    reporter_bonus = na_bonus_rows * percent_na + smooth_rep * (1.0 - percent_na)
    na_bonus_cols = normalize(participation_columns)
    author_bonus = na_bonus_cols * percent_na + consensus_reward * (1.0 - percent_na)

    return {
        "certainty": certainty,
        "consensus_reward": consensus_reward,
        "avg_certainty": avg_certainty,
        "participation_columns": participation_columns,
        "participation_rows": participation_rows,
        "percent_na": percent_na,
        "na_bonus_rows": na_bonus_rows,
        "reporter_bonus": reporter_bonus,
        "na_bonus_cols": na_bonus_cols,
        "author_bonus": author_bonus,
    }
