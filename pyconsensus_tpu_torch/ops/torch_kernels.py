"""Plain torch counterparts of ``pyconsensus_tpu/ops/jax_kernels.py`` for
the fused paths: sztorc's power iteration and the storage-mode orthogonal
iteration of the multi-component variants.

Each function mirrors the JAX function of the same name, including its
dtype promotions: the JAX reference promotes an f32 kernel result divided
by an f64 scalar to f64, while torch keeps a 0-dim operand from widening
a vector, so the casts below are written out where the two differ.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .constants import CATCH_TIE_ATOL, DIRFIX_TIE_ATOL
from .prng import orth_seed, power_seed

__all__ = ["normalize", "canon_sign_factor", "canon_sign", "catch_tie_atol",
           "catch", "matvec_narrow", "sztorc_scores_power_fused",
           "sztorc_dirfix", "weighted_prin_comps_storage",
           "multi_dirfix_storage", "row_reward_weighted", "smooth"]

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
    in the ``acc`` dtype (the plain elementwise decode)."""
    if x.dtype == torch.int8:
        return torch.where(x < 0, fill.to(acc), x.to(acc) * 0.5)
    return torch.where(torch.isnan(x), fill.to(x.dtype), x).to(acc)


def _power_loop(apply_cov: Callable, E: int, n_iters: int, tol: float,
                device, v_init: Optional[torch.Tensor] = None):
    """Power-iteration loop (``jax_kernels._power_loop``): one
    application to the fixed float32 seed (blended with a warm start when
    ``v_init`` is non-zero), then sweeps until successive unit iterates
    satisfy ``|<w, v>| >= 1 - max(tol, 8 eps_f32)``; ``tol < 0`` runs
    exactly ``n_iters`` sweeps. The exit test reads one scalar back per
    sweep. Returns ``(loading, n_sweeps)``."""
    f32 = torch.float32
    no_exit = tol < 0
    tol = max(float(tol), 8.0 * float(torch.finfo(f32).eps))
    base = torch.from_numpy(power_seed(E).copy()).to(device)
    base_unit = base / torch.linalg.vector_norm(base)
    if v_init is None:
        seed = base
    else:
        v_init = v_init.to(f32)
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
    """The matvec narrowing cast, skipped for int8 sentinel storage."""
    if matvec_dtype and x.dtype != torch.int8:
        return x.to(getattr(torch, matvec_dtype))
    return x


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
                       n_components: int, fill: torch.Tensor,
                       v_init: Optional[torch.Tensor] = None):
    """Top-``k`` principal subspace of the implicit weighted covariance of
    sentinel storage ``x`` by blocked orthogonal iteration
    (``jax_kernels._top_pcs_orth_iter``, storage mode). Each sweep applies
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

    if cov_block_kernel_fits(E, k, x.element_size()):
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
