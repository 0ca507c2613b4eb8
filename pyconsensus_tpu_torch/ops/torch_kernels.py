"""Plain torch counterparts of ``pyconsensus_tpu/ops/jax_kernels.py``:
for the fused paths, sztorc's power iteration and the storage-mode
orthogonal iteration of the multi-component variants; for the plain core
(``models.pipeline._consensus_core``), rescale, the fill, every PCA method
over the dense filled matrix, the direction fix, the weighted median,
outcome resolution and the certainty accounting.

Each function mirrors the JAX function of the same name, including its
dtype promotions: the JAX reference promotes an f32 kernel result divided
by an f64 scalar to f64, while torch keeps a 0-dim operand from widening
a vector, so the casts below are written out where the two differ.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .constants import CATCH_TIE_ATOL, DIRFIX_TIE_ATOL, MEDIAN_TIE_ATOL
from .prng import orth_seed, power_seed

__all__ = ["normalize", "canon_sign_factor", "canon_sign", "catch_tie_atol",
           "catch", "matvec_narrow", "sztorc_scores_power_fused",
           "sztorc_dirfix", "weighted_prin_comps_storage",
           "multi_dirfix_storage", "row_reward_weighted", "smooth",
           "rescale", "unscale_outcomes", "interpolate_masked",
           "interpolate", "weighted_cov", "resolve_pca_method",
           "weighted_prin_comp", "weighted_prin_comps",
           "direction_fixed_scores", "gather_median_pays",
           "weighted_median_cols", "resolve_outcomes",
           "certainty_and_bonuses"]

#: sweep budget of the multi-component orthogonal iteration
_ORTH_ITERS = 96
#: relative Ritz-value stability that counts a noise-bulk column as settled
_RITZ_RTOL = 1e-6
#: fraction of the dominant Ritz value under which a column counts as
#: noise bulk
_BULK_FLOOR = 5e-3


def normalize(v: torch.Tensor) -> torch.Tensor:
    """``v / sum(v)``; the zero-sum vector comes back unchanged."""
    total = v.sum()
    safe = torch.where(total == 0.0, torch.ones_like(total), total)
    return torch.where(total == 0.0, v, v / safe)


def canon_sign_factor(v: torch.Tensor) -> torch.Tensor:
    """The ±1 that makes the entry of largest magnitude positive (first
    argmax on ties; a zero entry counts as +1)."""
    s = torch.sign(v[torch.argmax(torch.abs(v))])
    return torch.where(s == 0.0, torch.ones_like(s), s)


def canon_sign(v: torch.Tensor) -> torch.Tensor:
    return v * canon_sign_factor(v)


def catch_tie_atol(dtype: torch.dtype) -> float:
    """The catch band for ``dtype`` arithmetic: ``CATCH_TIE_ATOL`` floored
    at ``32 * eps(dtype)`` (≈3.8e-6 in float32)."""
    return max(CATCH_TIE_ATOL, 32.0 * float(torch.finfo(dtype).eps))


def catch(x: torch.Tensor, tolerance: float) -> torch.Tensor:
    """Snap toward {0, 0.5, 1}: a value within the band of
    ``0.5 ± tolerance`` resolves to 0.5."""
    atol = catch_tie_atol(x.dtype)
    lo = torch.tensor(0.5 - tolerance - atol, dtype=x.dtype, device=x.device)
    hi = torch.tensor(0.5 + tolerance + atol, dtype=x.dtype, device=x.device)
    half = torch.full_like(x, 0.5)
    return torch.where(x < lo, torch.zeros_like(x),
                       torch.where(x > hi, torch.ones_like(x), half))


def _decode_storage(x: torch.Tensor, fill: torch.Tensor,
                    acc: torch.dtype) -> torch.Tensor:
    """Filled view of int8 sentinel storage or NaN-threaded float storage
    in the ``acc`` dtype: the reference's XLA decode
    (``jax_kernels._decode_storage``), which the weighted column means and
    the orthogonal iteration's trace read. On float storage the fill takes
    the storage dtype first, as there (on bfloat16 it rounds). The
    kernels' plain versions decode apart (``cuda_kernels._decode`` with
    the float32 fill, ``cuda_kernels._lattice_fill``), as the Pallas
    kernels do. With ``fill`` None, ``x`` is the dense filled matrix
    itself."""
    if fill is None:
        return x.to(acc)
    if x.dtype == torch.int8:
        return torch.where(x < 0, fill.to(acc), x.to(acc) * 0.5)
    return torch.where(torch.isnan(x), fill.to(x.dtype), x).to(acc)


def _power_loop(apply_cov: Callable, E: int, n_iters: int, tol: float,
                device, v_init: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32,
                base: Optional[torch.Tensor] = None):
    """Power-iteration loop (``jax_kernels._power_loop``): one
    application to the fixed seed of ``dtype`` (blended with a warm start
    when ``v_init`` is non-zero), then sweeps until successive unit
    iterates satisfy ``|<w, v>| >= 1 - max(tol, 8 eps(dtype))``;
    ``tol < 0`` runs exactly ``n_iters`` sweeps. The kernels' loop runs in
    float32, the plain core's in the reputation dtype. The exit test reads
    one scalar back per sweep. ``base`` (an (E,) tensor) replaces the
    seed draw: the serve tier's padded buckets pass the true-width seed
    zero-extended to the bucket width, since a bucket-width draw's pad
    entries would enter the seed's norm, and so the warm-start blend.
    Returns ``(loading, n_sweeps)``."""
    no_exit = tol < 0
    tol = max(float(tol), 8.0 * float(torch.finfo(dtype).eps))
    if base is None:
        base = torch.from_numpy(power_seed(E, str(dtype).removeprefix(
            "torch.")).copy()).to(device)
    else:
        base = base.to(device=device, dtype=dtype)
    base_unit = base / torch.linalg.vector_norm(base)
    if v_init is None:
        seed = base
    else:
        v_init = v_init.to(dtype)
        n_i = torch.linalg.vector_norm(v_init)
        blended = (v_init / torch.where(n_i > 0.0, n_i, torch.ones_like(n_i))
                   + 0.25 * base_unit)
        seed = torch.where(n_i > 0.0, blended, base)
    v = apply_cov(seed)
    n0 = torch.linalg.vector_norm(v)
    v = torch.where(n0 == 0.0, base_unit.to(v.dtype),
                    v / torch.where(n0 == 0.0, torch.ones_like(n0), n0))
    # the exit threshold as the iterate dtype rounds it (a weak scalar in
    # the reference)
    thresh = torch.tensor(1.0 - tol, dtype=v.dtype).item()
    i = 0
    while i < n_iters:
        w = apply_cov(v)
        n = torch.linalg.vector_norm(w)
        w = torch.where(n == 0.0, v,
                        w / torch.where(n == 0.0, torch.ones_like(n), n))
        i += 1
        done = (not no_exit
                and torch.abs(torch.dot(w, v)).item() >= thresh)
        v = w
        if done:
            break
    return v, i


def matvec_narrow(x: torch.Tensor, matvec_dtype: str) -> torch.Tensor:
    """The matvec narrowing cast, skipped for int8 sentinel storage
    (``jax_kernels.matvec_narrow``); ``"bfloat16"`` gives the sweeps
    bfloat16 storage, which the kernels take."""
    if matvec_dtype and x.dtype != torch.int8:
        return x.to(getattr(torch, matvec_dtype))
    return x


def _dot(a: torch.Tensor, b: torch.Tensor, storage: torch.dtype,
         acc: torch.dtype) -> torch.Tensor:
    """``a @ b``, one operand the filled matrix of dtype ``storage`` and
    the other a vector or a thin block: the reference's
    ``jnp.matmul(a.astype(storage), b.astype(storage),
    preferred_element_type=acc)``. Both operands take the storage dtype
    and the result ``acc``. On bfloat16 storage the product runs in
    ``acc``, where each product of two bfloat16 values is exact and no sum
    rounds to bfloat16; on other storage in the storage dtype."""
    a, b = a.to(storage), b.to(storage)
    if storage == torch.bfloat16:
        return a.to(acc) @ b.to(acc)
    return (a @ b).to(acc)


def _mu_denom(x: torch.Tensor, fill, reputation: torch.Tensor):
    """Weighted column means of the filled matrix and the zero-guarded
    ``1 - sum(rep^2)`` denominator."""
    acc = reputation.dtype
    filled = (_decode_storage(x, fill, acc) if fill is not None
              else x.to(acc))
    mu = reputation @ filled
    return mu, _denom(reputation)


def _denom(reputation: torch.Tensor) -> torch.Tensor:
    denom = 1.0 - torch.sum(reputation ** 2)
    return torch.where(denom == 0.0, torch.ones_like(denom), denom)


def sztorc_scores_power_fused(x: torch.Tensor, reputation: torch.Tensor,
                              power_iters: int, power_tol: float,
                              matvec_dtype: str = "", fill=None, mu=None,
                              v_init=None, n_rows: Optional[int] = None):
    """The sztorc scoring step on the kernels
    (``jax_kernels.sztorc_scores_power_fused``): power iteration through
    ``apply_weighted_cov``, then ``scores_dirfix_pass`` and the O(R + E)
    direction fix on its outputs. Returns ``(adj_scores, loading)`` in the
    reputation dtype."""
    from .cuda_kernels import power_iteration_fused, scores_dirfix_pass

    acc = reputation.dtype
    if fill is None:
        mu, denom = _mu_denom(x, None, reputation)
    else:
        denom = _denom(reputation)
    xmm = matvec_narrow(x, matvec_dtype)
    if xmm.dtype == torch.float64:
        # the kernels compute in float32, as the reference's do under x64
        xmm = xmm.to(torch.float32)
    loading = power_iteration_fused(xmm, mu, denom, reputation, power_iters,
                                    power_tol, fill=fill,
                                    v_init=v_init).to(acc)
    t, q, c, o = scores_dirfix_pass(xmm, reputation, loading, fill=fill)
    if n_rows is not None:
        t = t[:n_rows]
    return sztorc_dirfix(t.to(acc), mu @ loading, q.to(acc), c.to(acc),
                         o.to(acc)), loading


def sztorc_dirfix(t: torch.Tensor, ml: torch.Tensor, q: torch.Tensor,
                  c: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The O(R + E) direction fix of sztorc's scores from the scores
    pass's contractions: ``t = filled @ loading`` (R,), ``ml = mu @
    loading``, and the (E,) ``q = t^T filled``, ``c = 1^T filled``,
    ``o = rep^T filled`` (all in the accumulation dtype). The scores
    ``t - ml`` are sign-canonical first; the two candidate distributions
    ``normalize(set1|set2) @ X`` collapse to O(E) against ``old = o``, and
    set1 wins within the banded tie ``d1 - d2 <= DIRFIX_TIE_ATOL (d1 +
    d2)``. Returns the adjusted scores (R,). The single-device path and
    the event-sharded path both end here."""
    scores = t - ml
    qs = q - ml * c                               # scores^T X
    sgn = canon_sign_factor(scores)
    scores = scores * sgn
    qs = qs * sgn
    a1 = torch.abs(torch.min(scores))
    a2 = torch.max(scores)
    set1 = scores + a1
    set2 = scores - a2
    R = scores.shape[0]
    sum_s = torch.sum(scores)
    s1_tot = sum_s + R * a1
    s2_tot = sum_s - R * a2
    set1X = qs + a1 * c
    set2X = qs - a2 * c
    one = torch.ones_like(s1_tot)
    new1 = torch.where(s1_tot == 0.0, set1X,
                       set1X / torch.where(s1_tot == 0.0, one, s1_tot))
    new2 = torch.where(s2_tot == 0.0, set2X,
                       set2X / torch.where(s2_tot == 0.0, one, s2_tot))
    d1 = torch.sum((new1 - o) ** 2)
    d2 = torch.sum((new2 - o) ** 2)
    return torch.where(d1 - d2 <= DIRFIX_TIE_ATOL * (d1 + d2), set1, -set2)


def _top_pcs_orth_iter(x: torch.Tensor, mu: torch.Tensor,
                       denom: torch.Tensor, reputation: torch.Tensor,
                       n_components: int,
                       fill: Optional[torch.Tensor] = None,
                       v_init: Optional[torch.Tensor] = None):
    """Top-``k`` principal subspace of the implicit weighted covariance of
    sentinel storage ``x`` by blocked orthogonal iteration
    (``jax_kernels._top_pcs_orth_iter``); with ``fill`` None, ``x`` is the
    dense filled matrix and each sweep is two ``torch.matmul`` products,
    the reference's XLA arm. Each sweep applies
    the covariance to the (E, k) block and re-orthonormalizes it by
    Householder QR. Where ``cov_block_kernel_fits`` holds, one sweep is
    one ``apply_weighted_cov_block``; beyond it, the separable arm takes
    two: ``T = storage_matmat(V) - 1 (mu V)``, then
    ``storage_rows_matmat((rep T)^T)^T - mu (1^T rep T)``. A column
    settles when successive blocks align (``|<q_i, v_i>| >= 1 - tol``) or
    when its Ritz value has stayed within ``_RITZ_RTOL`` of the dominant
    one for two sweeps while under ``_BULK_FLOOR`` of it, within
    ``_ORTH_ITERS`` sweeps; ``tol`` is 8 eps of the reputation dtype. The
    exit test reads one scalar back per sweep. A final Rayleigh-Ritz
    application rotates the block onto the eigenbasis of ``V^T C V``
    (falling back to the unrotated block sorted by Rayleigh quotient if
    that ``eigh`` is non-finite) and its centered projections become the
    scores on the one-pass arm (the separable arm leaves them to the
    caller's own sweep).
    ``v_init`` (E, k) warm-starts the block with the same 0.25 blend as
    the reference; an all-zero one is the cold start.

    Returns ``(loadings (E, k), eigvals (k,), trace, scores (R, k) or
    None)`` in the reputation dtype; ``trace`` is the matrix-free total
    variance."""
    from .cuda_kernels import (apply_weighted_cov_block,
                               cov_block_kernel_fits, storage_matmat,
                               storage_rows_matmat)

    acc = reputation.dtype
    R, E = x.shape
    k = int(n_components)
    dev = x.device

    if fill is None:
        # the dense filled matrix: two plain products a sweep, as in the
        # reference's XLA arm (which folds no scores out either)
        def apply_cov_block(V, emit_t=False):
            t = _dot(x, V, x.dtype, acc) - (mu @ V)[None, :]
            rt = reputation[:, None] * t
            y = (_dot(x.T, rt, x.dtype, acc)
                 - mu[:, None] * torch.sum(rt, dim=0)[None, :])
            return y / denom, None
    elif cov_block_kernel_fits(E, k, x.element_size()):
        def apply_cov_block(V, emit_t=False):
            y, t = apply_weighted_cov_block(x, mu, reputation, V.to(acc),
                                            fill=fill, emit_t=emit_t)
            return y.to(acc) / denom, (t.to(acc) if emit_t else None)
    else:
        def apply_cov_block(V, emit_t=False):
            V = V.to(acc)
            t = storage_matmat(x, V, fill=fill).to(acc) - (mu @ V)[None, :]
            rt = reputation[:, None] * t
            y = (storage_rows_matmat(x, rt.T, fill=fill).T.to(acc)
                 - mu[:, None] * torch.sum(rt, dim=0)[None, :])
            return y / denom, None

    seed = orth_seed(E, k, str(acc).removeprefix("torch."))
    V0, _ = torch.linalg.qr(torch.from_numpy(seed.copy()).to(dev))
    if v_init is not None:
        ni = torch.linalg.vector_norm(v_init)
        blended = (v_init.to(acc) / torch.where(ni > 0.0, ni,
                                                torch.ones_like(ni))
                   * torch.sqrt(torch.tensor(float(k), dtype=acc,
                                             device=dev))
                   + 0.25 * V0)
        Qw, _ = torch.linalg.qr(blended)
        # whole-block fallback: a partly non-finite QR is no orthonormal
        # block
        V0 = torch.where(torch.isfinite(Qw).all() & (ni > 0.0), Qw, V0)
    tol = 8.0 * float(torch.finfo(acc).eps)
    thresh = torch.tensor(1.0 - tol, dtype=acc, device=dev)
    tiny = torch.tensor(torch.finfo(acc).tiny, dtype=acc, device=dev)

    V = V0
    eig_prev = torch.full((k,), float("inf"), dtype=acc, device=dev)
    stable_prev = torch.zeros(k, dtype=torch.bool, device=dev)
    for _ in range(_ORTH_ITERS):
        Y = apply_cov_block(V)[0]
        eig = torch.sum(V * Y, dim=0)                 # per-column Ritz values
        Q, _ = torch.linalg.qr(Y)
        # zero-norm guard: qr of a zero block can give NaN columns
        Q = torch.where(torch.isfinite(Q), Q, V)
        align = torch.abs(torch.sum(Q * V, dim=0))
        lead = torch.maximum(torch.max(torch.abs(eig)), tiny)
        ritz_stable = torch.abs(eig - eig_prev) <= _RITZ_RTOL * lead
        negligible = torch.abs(eig) <= _BULK_FLOOR * lead
        done_col = (align >= thresh) | (ritz_stable & stable_prev
                                        & negligible)
        V, eig_prev, stable_prev = Q, eig, ritz_stable
        if bool(done_col.all().item()):
            break
    # Rayleigh-Ritz: one more application, rotated onto the eigenbasis of
    # the projected covariance; its centered projections are the scores
    Y, t_c = apply_cov_block(V, emit_t=True)
    M = V.T @ Y
    M = 0.5 * (M + M.T)
    ritz, W = torch.linalg.eigh(M)                    # ascending
    raw = torch.sum(V * Y, dim=0)
    order = torch.argsort(-raw, stable=True)
    ok = torch.isfinite(W).all() & torch.isfinite(ritz).all()
    eig = torch.where(ok, torch.clamp(ritz.flip(0), min=0.0),
                      torch.clamp(raw[order], min=0.0))
    V = torch.where(ok, (V @ W).flip(1), V[:, order])
    scores = (None if t_c is None
              else torch.where(ok, (t_c @ W).flip(1), t_c[:, order]))
    # matrix-free trace: sum_e (rep . x_e^2 - mu_e^2) / denom
    vals = _decode_storage(x, fill, acc)
    col_sq = reputation @ (vals * vals)
    trace = torch.sum(col_sq - mu * mu) / denom
    return V, eig, torch.clamp(trace, min=0.0), scores


def weighted_prin_comps_storage(x: torch.Tensor, fill: torch.Tensor,
                                mu: torch.Tensor, reputation: torch.Tensor,
                                n_components: int, v_init=None):
    """Top-k loadings, centered scores and explained-variance fractions
    straight off sentinel storage (``jax_kernels
    .weighted_prin_comps_storage``): the orthogonal iteration above, with
    the scores folded out of its final application on the one-pass arm
    and taken by one further ``storage_matmat`` sweep on the separable
    arm. Returns ``(loadings (E, k), scores (R, k), explained (k,))``."""
    from .cuda_kernels import storage_matmat

    loadings, eig, total, scores = _top_pcs_orth_iter(
        x, mu, _denom(reputation), reputation, n_components, fill,
        v_init=v_init)
    if scores is None:
        scores = (storage_matmat(x, loadings, fill=fill).to(loadings.dtype)
                  - (mu @ loadings)[None, :])
    explained = torch.where(
        total > 0.0, eig / torch.where(total > 0.0, total,
                                       torch.ones_like(total)),
        torch.zeros_like(eig))
    return loadings, scores, explained


def multi_dirfix_storage(scores: torch.Tensor, x: torch.Tensor,
                         fill: torch.Tensor, mu: torch.Tensor,
                         reputation: torch.Tensor) -> torch.Tensor:
    """Direction-fixed scores for an (R, k) block of component scores in
    one further sweep of the storage matrix
    (``jax_kernels.multi_dirfix_storage``): each column is sign-canonical
    first, then ``[scores; 1]^T filled(X)`` comes from one
    ``storage_rows_matmat`` of k + 1 rows and the two candidate
    distributions ``normalize(set1|set2) @ X`` collapse to O(k E) against
    ``old = mu``. Same banded tie-break as the single-component fix
    (``DIRFIX_TIE_ATOL``). Returns (R, k) in the reputation dtype."""
    from .cuda_kernels import storage_rows_matmat

    acc = reputation.dtype
    R, k = scores.shape
    signs = torch.stack([canon_sign_factor(scores[:, c]) for c in range(k)])
    scores = scores * signs[None, :]
    W = torch.cat([scores.T.to(acc),
                   torch.ones((1, R), dtype=acc, device=scores.device)])
    qc = storage_rows_matmat(x, W, fill=fill).to(acc)           # (k+1, E)
    q, csum = qc[:k], qc[k]
    a1 = torch.abs(torch.min(scores, dim=0).values)
    a2 = torch.max(scores, dim=0).values
    set1 = scores + a1[None, :]
    set2 = scores - a2[None, :]
    s1_tot = torch.sum(set1, dim=0)
    s2_tot = torch.sum(set2, dim=0)

    def guard(num, tot):
        # normalize()'s zero-sum guard on the collapsed projection
        return torch.where(tot[:, None] == 0.0, num,
                           num / torch.where(tot == 0.0, torch.ones_like(tot),
                                             tot)[:, None])

    new1 = guard(q + a1[:, None] * csum[None, :], s1_tot)      # (k, E)
    new2 = guard(q - a2[:, None] * csum[None, :], s2_tot)
    d1 = torch.sum((new1 - mu[None, :]) ** 2, dim=1)
    d2 = torch.sum((new2 - mu[None, :]) ** 2, dim=1)
    set1_wins = d1 - d2 <= DIRFIX_TIE_ATOL * (d1 + d2)
    return torch.where(set1_wins[None, :], set1, -set2)


def row_reward_weighted(adj_scores: torch.Tensor,
                        reputation: torch.Tensor) -> torch.Tensor:
    """``normalize(adj * rep / mean(rep))``; the reputation unchanged when
    the adjusted scores vanish."""
    degenerate = torch.max(torch.abs(adj_scores)) == 0.0
    candidate = normalize(adj_scores * (reputation / torch.mean(reputation)))
    return torch.where(degenerate, reputation, candidate)


def smooth(this_rep: torch.Tensor, old_rep: torch.Tensor,
           alpha: float) -> torch.Tensor:
    """``alpha``-blend with the prior reputation."""
    return alpha * this_rep + (1.0 - alpha) * old_rep


# -- the plain core: the whole filled matrix (``_consensus_core``) -----------
#
# The reference computes all of this in XLA outside any Pallas kernel, so
# the port's products are torch.matmul (float32-faithful: TF32 stays off)
# and its eigendecompositions torch.linalg.eigh. Column reductions over an
# (R, E) mask are products against the reputation, so each leaves at most
# one (R, E) temporary.

#: reporter count up to which "auto" takes the exact Gram eigh
#: (``jax_kernels._GRAM_EIGH_MAX_R``)
GRAM_EIGH_MAX_R = 4096
#: event count up to which "auto" takes the explicit covariance eigh
COV_EIGH_MAX_E = 1024
#: column-block width of the weighted median (``jax_kernels._MEDIAN_BLOCK``)
MEDIAN_BLOCK = 1024
#: the largest R * E at which "power-fused" runs the kernels' plain
#: versions on the CPU (the reference's interpret-mode ceiling)
_CPU_FUSED_MAX = 1 << 20


def rescale(reports: torch.Tensor, scaled: torch.Tensor, mins: torch.Tensor,
            maxs: torch.Tensor) -> torch.Tensor:
    """Scaled columns to [0, 1] by ``(x - min) / (max - min)``; binary
    columns pass through as ``(x - 0) / 1``, which is ``x`` bit for bit, so
    one (R, E) buffer serves both; NaN stays NaN."""
    span = torch.where(scaled, maxs - mins, 1.0)
    span = torch.where(span == 0.0, 1.0, span)
    return torch.sub(reports, torch.where(scaled, mins, 0.0)).div_(span)


def unscale_outcomes(outcomes: torch.Tensor, scaled: torch.Tensor,
                     mins: torch.Tensor, maxs: torch.Tensor) -> torch.Tensor:
    """Scaled outcomes map back through ``x * (max - min) + min``."""
    return torch.where(scaled, outcomes * (maxs - mins) + mins, outcomes)


def interpolate_masked(reports: torch.Tensor, reputation: torch.Tensor,
                       scaled: torch.Tensor, tolerance: float):
    """Reputation-weighted column-mean fill of NaN entries, binary fills
    catch-snapped, a column with no present mass filled with 0.5. Returns
    ``(filled, present)``: every later phase reads the mask, never the
    raw matrix again."""
    present = ~torch.isnan(reports)
    acc = torch.promote_types(reports.dtype, reputation.dtype)
    rep = reputation.to(acc)
    denom = rep @ present.to(acc)
    zeroed = torch.where(present, reports, 0.0)
    numer = rep @ zeroed.to(acc)
    fill = torch.where(denom > 0.0,
                       numer / torch.where(denom > 0.0, denom, 1.0), 0.5)
    fill = torch.where(scaled, fill, catch(fill, tolerance))
    return torch.where(present, zeroed, fill[None, :]), present


def interpolate(reports, reputation, scaled, tolerance):
    """:func:`interpolate_masked` without the mask."""
    return interpolate_masked(reports, reputation, scaled, tolerance)[0]


def weighted_cov(filled: torch.Tensor, reputation: torch.Tensor):
    """``(cov (E, E), deviations (R, E))`` of the filled matrix."""
    dev, denom = _center(filled, reputation)
    return (dev * reputation[:, None]).T @ dev / denom, dev


def _center(filled: torch.Tensor, reputation: torch.Tensor):
    mu, denom = _mu_denom(filled, None, reputation)
    return filled - mu[None, :], denom


def _first_pc_eigh_cov(dev, denom, reputation):
    cov = (dev * reputation[:, None]).T @ dev / denom
    loading = torch.linalg.eigh(cov)[1][:, -1]
    return loading, dev @ loading


def _gram_factor(dev, reputation):
    """``A = diag(sqrt(rep)) D``: ``A^T A`` is the unnormalized covariance
    and ``A A^T`` (R x R) has the same nonzero spectrum."""
    return dev * torch.sqrt(torch.clamp(reputation, min=0.0))[:, None]


def _first_pc_eigh_gram(dev, denom, reputation):
    """The Gram trick: the top eigenvector ``u`` of ``A A^T / denom`` maps
    back to the loading ``A^T u / ||A^T u||``. Never forms E x E."""
    A = _gram_factor(dev, reputation)
    u = torch.linalg.eigh((A @ A.T) / denom)[1][:, -1]
    v = A.T @ u
    norm = torch.linalg.vector_norm(v)
    loading = v / torch.where(norm == 0.0, 1.0, norm)
    return loading, dev @ loading


def _first_pc_power(filled, mu, denom, reputation, n_iters: int = 128,
                    tol: float = 0.0, v_init=None, matvec_dtype: str = ""):
    """Matrix-free power iteration in the reputation dtype: each sweep is
    two products with the raw filled matrix, centered by
    ``D v = X v - (mu . v) 1`` and ``D^T w = X^T w - mu sum(w)``.
    ``matvec_dtype`` narrows the sweeps' operand only; the scores take the
    filled matrix."""
    acc = reputation.dtype
    mm = filled.to(getattr(torch, matvec_dtype)) if matvec_dtype else filled

    def apply_cov(v):
        t = _dot(mm, v, mm.dtype, acc) - mu @ v
        rt = reputation * t
        y = _dot(rt, mm, mm.dtype, acc) - mu * torch.sum(rt)
        return y / denom

    loading, _ = _power_loop(apply_cov, filled.shape[1], n_iters, tol,
                             filled.device, v_init=v_init, dtype=acc)
    return loading, _dot(filled, loading, filled.dtype, acc) - mu @ loading


def resolve_pca_method(R: int, E: int, method: str,
                       device: torch.device) -> str:
    """Resolve ``"auto"`` by shape (E <= 1024 the covariance eigh, else
    R <= 4096 the Gram eigh, else power iteration, on the kernels where
    they serve) and downgrade a ``"power-fused"`` request that cannot run
    to ``"power"``, which computes the same loading
    (``jax_kernels.resolve_pca_method``, with "TPU" read as an sm_90
    card; any other card is refused). The kernels compute in float32
    whatever the filled matrix's dtype; on the CPU their plain versions
    serve up to the reference's interpret-mode size."""
    from .cuda_kernels import fused_pca_fits, require_hopper

    if device.type == "cpu":
        serves = R * E <= _CPU_FUSED_MAX
    else:
        require_hopper(device)
        serves = True
    if method == "auto":
        if E <= COV_EIGH_MAX_E:
            return "eigh-cov"
        if R <= GRAM_EIGH_MAX_R:
            return "eigh-gram"
        return ("power-fused" if device.type == "cuda"
                and fused_pca_fits(E, 4) else "power")
    if method == "power-fused" and not (serves and fused_pca_fits(E, 4)):
        return "power"
    return method


def weighted_prin_comp(filled: torch.Tensor, reputation: torch.Tensor,
                       method: str = "auto", power_iters: int = 128,
                       power_tol: float = 0.0, v_init=None,
                       matvec_dtype: str = ""):
    """First principal component of the reputation-weighted covariance
    (``jax_kernels.weighted_prin_comp``) by ``"eigh-cov"``,
    ``"eigh-gram"`` or ``"power"``, ``"auto"`` resolved by
    :func:`resolve_pca_method`. ``"power-fused"`` is sztorc's alone and
    scores through :func:`sztorc_scores_power_fused`. ``matvec_dtype``
    narrows the power sweeps' operand. Returns ``(loading (E,), scores (R,))``,
    the sign fixed downstream."""
    R, E = filled.shape
    method = resolve_pca_method(R, E, method, filled.device)
    if method == "power":
        mu, denom = _mu_denom(filled, None, reputation)
        return _first_pc_power(filled, mu, denom, reputation,
                               power_iters, power_tol, v_init=v_init,
                               matvec_dtype=matvec_dtype)
    dev, denom = _center(filled, reputation)
    if method == "eigh-cov":
        return _first_pc_eigh_cov(dev, denom, reputation)
    if method == "eigh-gram":
        return _first_pc_eigh_gram(dev, denom, reputation)
    raise ValueError(f"PCA method {method!r}: weighted_prin_comp takes "
                     "eigh-cov, eigh-gram or power (power-fused scores "
                     "through sztorc_scores_power_fused)")


def _explained(eig, total):
    return torch.where(total > 0.0, eig / torch.where(total > 0.0, total,
                                                      1.0),
                       torch.zeros_like(eig))


def weighted_prin_comps(filled: torch.Tensor, reputation: torch.Tensor,
                        n_components: int, method: str = "auto",
                        v_init=None):
    """Top-k loadings, scores and explained-variance fractions
    (``jax_kernels.weighted_prin_comps``): the covariance eigh at
    E <= 1024, the Gram eigh at R <= 4096, orthogonal iteration beyond,
    and orthogonal iteration for any power-family request. ``v_init``
    warm-starts the orthogonal iteration; the eigh arms ignore it.
    Returns ``(loadings (E, k), scores (R, k), explained (k,))``."""
    R, E = filled.shape
    k = int(n_components)
    if method in ("power", "power-fused") or (
            method == "auto" and E > COV_EIGH_MAX_E and R > GRAM_EIGH_MAX_R):
        mu, denom = _mu_denom(filled, None, reputation)
        loadings, eig, total, _ = _top_pcs_orth_iter(
            filled, mu, denom, reputation, k, v_init=v_init)
        scores = (_dot(filled, loadings, filled.dtype, loadings.dtype)
                  - (mu @ loadings)[None, :])
        return loadings, scores, _explained(eig, total)
    dev, denom = _center(filled, reputation)
    if method == "auto":
        method = "eigh-cov" if E <= COV_EIGH_MAX_E else "eigh-gram"
    if method == "eigh-cov":
        eigvals, eigvecs = torch.linalg.eigh(
            (dev * reputation[:, None]).T @ dev / denom)
        loadings = eigvecs.flip(1)[:, :k]
    elif method == "eigh-gram":
        A = _gram_factor(dev, reputation)
        eigvals, eigvecs = torch.linalg.eigh((A @ A.T) / denom)
        V = A.T @ eigvecs.flip(1)[:, :k]
        norms = torch.linalg.vector_norm(V, dim=0)
        loadings = V / torch.where(norms == 0.0, 1.0, norms)[None, :]
    else:
        raise ValueError(f"unknown PCA method: {method!r}")
    eig = torch.clamp(eigvals.flip(0)[:k], min=0.0)
    total = torch.sum(torch.clamp(eigvals, min=0.0))
    return loadings, dev @ loadings, _explained(eig, total)


def direction_fixed_scores(scores: torch.Tensor, filled: torch.Tensor,
                           reputation: torch.Tensor) -> torch.Tensor:
    """The PCA direction fix (``jax_kernels.direction_fixed_scores``):
    sign-canonical scores, then the orientation whose outcome vector lies
    closer to ``old = rep^T X`` wins, ``set1`` within the banded tie, in
    its non-negative form. The three projections are one (3, R) x (R, E)
    product."""
    acc = scores.dtype
    scores = canon_sign(scores)
    set1 = scores + torch.abs(torch.min(scores))
    set2 = scores - torch.max(scores)
    W = torch.stack([reputation.to(acc), normalize(set1), normalize(set2)])
    old, new1, new2 = _dot(W, filled, filled.dtype, acc)
    d1 = torch.sum((new1 - old) ** 2)
    d2 = torch.sum((new2 - old) ** 2)
    return torch.where(d1 - d2 <= DIRFIX_TIE_ATOL * (d1 + d2), set1, -set2)


def gather_median_pays(n_scaled: int, n_events: int) -> bool:
    """Whether the weighted median runs on a gather of the scaled columns
    alone rather than on every column: any count up to 9/10 of the events
    (``jax_kernels.gather_median_pays``)."""
    return 0 < n_scaled and n_scaled * 10 <= n_events * 9


def weighted_median_cols(values: torch.Tensor, weights: torch.Tensor,
                         present: torch.Tensor,
                         block_cols: int = MEDIAN_BLOCK) -> torch.Tensor:
    """Per-column weighted median (``jax_kernels.weighted_median_cols``):
    absent entries sort last with weight 0. ``weights`` is (R,) or
    (R, E). Above ``block_cols`` columns it runs a block of columns at a
    time, so the sort's temporaries stay one (R, block) slab; each
    column's answer is the same either way. Returns (E,)."""
    E = values.shape[1]
    if block_cols <= 0 or E <= block_cols:
        return _weighted_median_cols_block(values, weights, present)

    def cols(a, s):
        return a if a.dim() == 1 else a[:, s:s + block_cols]

    return torch.cat([_weighted_median_cols_block(
        cols(values, s), cols(weights, s), cols(present, s))
        for s in range(0, E, block_cols)])


def _weighted_median_cols_block(values, weights, present):
    """The weighted median of one block of columns: a stable sort of the
    values (absent ones +inf), the weights gathered by the same
    permutation, the first cumulative weight at or past 0.5 less the
    dtype-floored tie band, and the midpoint with the next value where
    the crossing is a tie. The block is worked column-major, one row a
    column, so the sort and the cumulative sum run along the contiguous
    dimension (a scan across rows takes over ten times as long on the
    card)."""
    dtype = torch.promote_types(values.dtype, weights.dtype)
    R = values.shape[0]
    present_t = present.T
    big = torch.where(present_t, values.T.to(dtype),
                      float("inf")).contiguous()              # (cols, R)
    w_all = weights[None, :] if weights.dim() == 1 else weights.T
    v, order = torch.sort(big, dim=1, stable=True)
    w = torch.gather(torch.where(present_t, w_all, 0.0), 1, order)
    total = torch.sum(w, dim=1)
    cw = torch.cumsum(w / torch.where(total > 0.0, total, 1.0)[:, None],
                      dim=1)
    tie_atol = max(MEDIAN_TIE_ATOL, 32.0 * float(torch.finfo(cw.dtype).eps))
    ge = cw >= 0.5 - tie_atol
    # argmax returns the first maximum: the first crossing
    idx = torch.argmax(ge.to(torch.uint8), dim=1)
    idx = torch.where(torch.any(ge, dim=1), idx, R - 1)

    def take(a, i):
        return torch.gather(a, 1, i[:, None])[:, 0]

    cw_i, v_i = take(cw, idx), take(v, idx)
    v_n = take(v, torch.clamp(idx + 1, max=R - 1))
    exact = torch.abs(cw_i - 0.5) <= tie_atol
    has_next = (idx + 1 < R) & torch.isfinite(v_n)
    med = torch.where(exact & has_next, 0.5 * (v_i + v_n), v_i)
    return torch.where(total > 0.0, med, 0.5)


def _scaled_index(scaled: torch.Tensor, n_scaled: int) -> torch.Tensor:
    """The scaled columns' indices; they must number exactly ``n_scaled``
    (a wrong count would gather the wrong columns)."""
    idx = torch.nonzero(scaled).reshape(-1)
    if idx.numel() != n_scaled:
        raise ValueError(f"n_scaled={n_scaled}, but {idx.numel()} events "
                         "are scaled")
    return idx


def resolve_outcomes(present, filled: torch.Tensor,
                     smooth_rep: torch.Tensor, scaled: torch.Tensor,
                     tolerance: float, any_scaled: bool = True,
                     has_na: bool = True, median_block: int = MEDIAN_BLOCK,
                     n_scaled: int = 0):
    """Outcome resolution (``jax_kernels.resolve_outcomes``): reputation
    restricted to the present reporters, the weighted mean for binary
    columns (catch-snapped) and the weighted median for scaled ones.
    ``present`` may be None when ``has_na`` is False; ``any_scaled``
    False skips the median. ``n_scaled`` > 0 (the exact count, within
    :func:`gather_median_pays`) medians a gather of the scaled columns
    alone. Returns ``(outcomes_raw, outcomes_adjusted)``."""
    acc = smooth_rep.dtype
    R, E = filled.shape
    full_total = torch.sum(smooth_rep)
    full_mean = (_dot(smooth_rep, filled, filled.dtype, acc)
                 / torch.where(full_total == 0.0, 1.0, full_total))
    if has_na:
        pw = present.to(acc)
        tw = smooth_rep @ pw
        pw.mul_(filled)                         # present * filled, in place
        mean_present = (smooth_rep @ pw) / torch.where(tw > 0.0, tw, 1.0)
        del pw
        means = torch.where(tw > 0.0, mean_present, full_mean)
    else:
        tw = full_total.expand(E)
        means = full_mean
    if not any_scaled:
        outcomes_raw = means
    else:
        if gather_median_pays(n_scaled, E) and median_block > 0:
            idx = _scaled_index(scaled, n_scaled)
            pres = (present.index_select(1, idx) if has_na else
                    torch.ones((R, n_scaled), dtype=torch.bool,
                               device=filled.device))
            med_s = weighted_median_cols(filled.index_select(1, idx),
                                         smooth_rep, pres, median_block)
            # the binary positions are never read: the where below masks
            # them with the means
            medians = torch.zeros(E, dtype=med_s.dtype,
                                  device=filled.device).index_copy_(0, idx,
                                                                   med_s)
        else:
            pres = (present if has_na else
                    torch.ones((R, E), dtype=torch.bool,
                               device=filled.device))
            medians = weighted_median_cols(filled, smooth_rep, pres,
                                           median_block)
        outcomes_raw = torch.where(tw > 0.0,
                                   torch.where(scaled, medians, means), means)
    return outcomes_raw, torch.where(scaled, outcomes_raw,
                                     catch(outcomes_raw, tolerance))


def certainty_and_bonuses(present, filled: torch.Tensor,
                          smooth_rep: torch.Tensor,
                          outcomes_adjusted: torch.Tensor,
                          scaled: torch.Tensor, tolerance: float,
                          has_na: bool = True,
                          any_scaled: bool = True) -> dict:
    """Certainty, participation and bonuses
    (``jax_kernels.certainty_and_bonuses``). A binary report agrees when
    it equals the snapped outcome, a scaled one when it lies within
    ``tolerance``; the tolerance test runs on the scaled columns alone,
    and not at all when ``any_scaled`` is False. ``has_na`` False takes
    the closed form of an all-present matrix."""
    R, E = filled.shape
    dtype = smooth_rep.dtype
    agree = filled == outcomes_adjusted[None, :]
    if any_scaled:
        idx = torch.nonzero(scaled).reshape(-1)
        agree[:, idx] = (torch.abs(filled.index_select(1, idx).to(dtype)
                                   - outcomes_adjusted[idx][None, :])
                         <= tolerance)
    certainty = smooth_rep @ agree.to(dtype)
    del agree
    consensus_reward = normalize(certainty)
    if has_na:
        na = (~present).to(dtype)
        participation_columns = 1.0 - smooth_rep @ na
        participation_rows = 1.0 - na @ consensus_reward
        del na
        percent_na = 1.0 - torch.mean(participation_columns)
        na_bonus_rows = normalize(participation_rows)
        reporter_bonus = (na_bonus_rows * percent_na
                          + smooth_rep * (1.0 - percent_na))
        na_bonus_cols = normalize(participation_columns)
        author_bonus = (na_bonus_cols * percent_na
                        + consensus_reward * (1.0 - percent_na))
    else:
        dev = filled.device
        participation_columns = torch.ones(E, dtype=dtype, device=dev)
        participation_rows = torch.ones(R, dtype=dtype, device=dev)
        percent_na = torch.zeros((), dtype=dtype, device=dev)
        na_bonus_rows = torch.full((R,), 1.0 / R, dtype=dtype, device=dev)
        reporter_bonus = smooth_rep
        na_bonus_cols = torch.full((E,), 1.0 / E, dtype=dtype, device=dev)
        author_bonus = consensus_reward
    return {
        "certainty": certainty,
        "consensus_reward": consensus_reward,
        "avg_certainty": torch.mean(certainty),
        "participation_columns": participation_columns,
        "participation_rows": participation_rows,
        "percent_na": percent_na,
        "na_bonus_rows": na_bonus_rows,
        "reporter_bonus": reporter_bonus,
        "na_bonus_cols": na_bonus_cols,
        "author_bonus": author_bonus,
    }
