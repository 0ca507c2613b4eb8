"""Plain torch counterparts of ``pyconsensus_tpu/ops/jax_kernels.py`` for
the fused sztorc path.

Each function mirrors the JAX function of the same name, including its
dtype promotions: the JAX reference promotes an f32 kernel result divided
by an f64 scalar to f64, while torch keeps a 0-dim operand from widening
a vector, so the casts below are written out where the two differ.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .constants import CATCH_TIE_ATOL, DIRFIX_TIE_ATOL
from .prng import power_seed

__all__ = ["normalize", "canon_sign_factor", "canon_sign", "catch_tie_atol",
           "catch", "matvec_narrow", "sztorc_scores_power_fused",
           "row_reward_weighted", "smooth"]


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
    ml = mu @ loading
    c = c.to(acc)
    scores = t.to(acc) - ml
    qs = q.to(acc) - ml * c                       # scores^T X
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
    old = o.to(acc)
    d1 = torch.sum((new1 - old) ** 2)
    d2 = torch.sum((new2 - old) ** 2)
    return torch.where(d1 - d2 <= DIRFIX_TIE_ATOL * (d1 + d2),
                       set1, -set2), loading


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
