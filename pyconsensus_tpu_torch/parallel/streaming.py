"""The Gram-statistics algebra of out-of-core consensus
(``pyconsensus_tpu/parallel/streaming.py:100-492, 948``): the part the
serve tier's market sessions score with.

Everything the sztorc scoring step needs collapses into R x R
accumulators over the event axis (R = reporters, the small axis). Per
event panel ``F_p`` (filled), ``D_p`` (centered) and
``A_p = sqrt(rep) * D_p``:

    G += A_p A_p^T          # weighted Gram: the covariance's spectrum
    M += D_p A_p^T          # gives scores = M u / ||A^T u||
    S += F_p F_p^T          # gives the direction fix in closed form

- the top eigenvector ``u`` of ``G / (1 - sum(rep^2))`` is the Gram-trick
  principal component, and ``||A^T u|| = sqrt(u^T G u)``;
- ``scores = D @ loading = M u / ||A^T u||``;
- the direction fix needs only ``||w^T F - rep^T F||^2 =
  (w - rep)^T S (w - rep)``.

:func:`_pass1_panel` folds one panel into the accumulators,
:func:`_pass2_panel` resolves one panel's outcomes with the final
reputation, and :func:`assemble_light_result` finishes the bonus
accounting on the host. The out-of-core driver itself
(``streaming_consensus``: file sources, k-means and the clustering
variants, multihost) is ``ROADMAP.md`` §A.8.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..ops import numpy_kernels as nk
from ..ops import torch_kernels as tk
from ..ops.constants import DIRFIX_TIE_ATOL
from ..ops.prng import orth_seed

__all__ = ["gram_dirfix", "gram_top_components", "gram_warm_pc",
           "gram_pc_scores", "assemble_light_result", "STREAM_EIGH_MAX_R"]

#: R above which the spectrum comes from orthogonal iteration on the
#: explicit Gram accumulator instead of ``torch.linalg.eigh`` (the
#: reference's rule, ``GRAM_EIGH_MAX_R``)
STREAM_EIGH_MAX_R = 4096


def _sym_topk(Gd: torch.Tensor, k: int, n_iters: int = 96,
              tol: float = 1e-7):
    """Top-``k`` eigenpairs of an explicit symmetric PSD matrix by blocked
    orthogonal iteration and a final Rayleigh-Ritz rotation: the fixed-key
    start block (``prng.orth_seed``), the per-column alignment exit, the
    whole-block guard against a zero product's NaN columns, and NaN
    outputs for a non-finite accumulator. Returns ``(eigvals (k,)
    descending clipped, V (R, k))``."""
    R = Gd.shape[0]
    dtype, dev = Gd.dtype, Gd.device
    v0 = torch.from_numpy(np.array(orth_seed(R, k, str(dtype).removeprefix(
        "torch.")))).to(device=dev, dtype=dtype)
    V, _ = torch.linalg.qr(v0)
    for _ in range(n_iters):
        Q, _ = torch.linalg.qr(Gd @ V)
        Q = torch.where(torch.isfinite(Q).all(), Q, V)
        align = torch.abs(torch.sum(Q * V, dim=0))
        V = Q
        if bool(torch.all(align >= 1.0 - tol)):
            break
    H = V.T @ (Gd @ V)
    hvals, W = torch.linalg.eigh((H + H.T) * 0.5)
    order = torch.argsort(hvals, descending=True)
    lam = torch.clamp(hvals[order], min=0.0)
    V = V @ W[:, order]
    finite = torch.all(torch.isfinite(Gd))
    poison = torch.tensor(float("nan"), dtype=dtype, device=dev)
    return (torch.where(finite, lam, poison),
            torch.where(finite, V, poison))


def _pass1_panel(panel, fill_rep, weight_rep, scaled, mins, maxs, valid,
                 tolerance: float, with_s: bool, with_gm: bool = True):
    """One event panel -> its (G, M, S) contributions. ``fill_rep`` is
    the round's initial reputation (the fill, reference semantics),
    ``weight_rep`` the reputation the weighted means and the Gram follow;
    ``valid`` masks a zero-padded panel tail out of every accumulator;
    ``with_s`` False returns a zero S, ``with_gm`` False zero G and M."""
    acc = weight_rep.dtype
    R = panel.shape[0]
    rescaled = tk.rescale(panel, scaled, mins, maxs)
    filled, _ = tk.interpolate_masked(rescaled, fill_rep, scaled, tolerance)
    F = torch.where(valid[None, :], filled, 0.0)
    if with_gm:
        mu = weight_rep @ F
        D = torch.where(valid[None, :], F - mu[None, :], 0.0)
        A = D * torch.sqrt(torch.clamp(weight_rep, min=0.0))[:, None]
        G = A @ A.T
        M = D @ A.T
    else:
        G = M = torch.zeros((R, R), dtype=acc, device=panel.device)
    S = F @ F.T if with_s else torch.zeros_like(G)
    return G, M, S


def _pass2_panel(panel, fill_rep, score_rep, final_rep, u_over_nAu, scaled,
                 mins, maxs, tolerance: float, with_loading: bool = True,
                 median_block: int = tk.MEDIAN_BLOCK):
    """One panel's resolution with the final reputation: ``(raw,
    adjusted, final, certainty, pcol, prow, na_count, loading)`` —
    outcomes, certainty, the reputation mass on absent entries, the
    per-row ``na @ certainty`` partials, the absent counts per row and
    the panel's slice of the first loading (``A^T u / ||A^T u||`` under
    ``score_rep``). The fill is recomputed from ``fill_rep``."""
    acc = final_rep.dtype
    rescaled = tk.rescale(panel, scaled, mins, maxs)
    filled, present = tk.interpolate_masked(rescaled, fill_rep, scaled,
                                            tolerance)
    raw, adjusted = tk.resolve_outcomes(present, filled, final_rep, scaled,
                                        tolerance, median_block=median_block)
    final = tk.unscale_outcomes(adjusted, scaled, mins, maxs)
    agree = torch.where(scaled[None, :],
                        torch.abs(filled - adjusted[None, :]) <= tolerance,
                        filled == adjusted[None, :])
    certainty = torch.sum(agree * final_rep[:, None], dim=0)
    na = (~present).to(acc)
    pcol = final_rep @ na
    prow = na @ certainty
    na_count = torch.sum(na, dim=1)
    if with_loading:
        mu = score_rep @ filled
        A = (filled - mu[None, :]) * torch.sqrt(
            torch.clamp(score_rep, min=0.0))[:, None]
        loading = A.T @ u_over_nAu
    else:
        loading = torch.zeros(panel.shape[1], dtype=acc, device=panel.device)
    return raw, adjusted, final, certainty, pcol, prow, na_count, loading


def gram_dirfix(scores, rep_ref, S):
    """The direction fix in closed form over ``S = F F^T``:
    ``||w^T F - rep^T F||^2 = (w - rep)^T S (w - rep)``, with the same
    normalize guard, banded tie and non-negative winning orientation as
    every other decision site."""
    scores = tk.canon_sign(scores)
    set1 = scores + torch.abs(torch.min(scores))
    set2 = scores - torch.max(scores)

    def sq_dist_to_old(w):
        d = w - rep_ref
        return d @ S @ d

    d1 = sq_dist_to_old(tk.normalize(set1))
    d2 = sq_dist_to_old(tk.normalize(set2))
    return torch.where(d1 - d2 <= DIRFIX_TIE_ATOL * (d1 + d2), set1, -set2)


def _gram_denom(rep_ref):
    denom = 1.0 - torch.sum(rep_ref ** 2)
    return torch.where(denom == 0.0, torch.ones_like(denom), denom)


def gram_warm_pc(G, rep_ref, warm_u, n_iters: int = 96, tol: float = 0.0):
    """Dominant eigenpair of ``Gd = G / (1 - sum(rep^2))`` by power
    iteration warm-started from ``warm_u`` (the previous round's
    principal component), through ``torch_kernels._power_loop``'s warm
    blend: a stale vector cannot pass the exit while it sits on a demoted
    eigenvector, because the cold seed is mixed back in. ``warm_u`` None
    or zero is the cold start bit for bit. Returns ``(u, sweeps)``."""
    Gd = G / _gram_denom(rep_ref)
    return tk._power_loop(lambda v: Gd @ v, G.shape[0], n_iters, tol,
                          G.device, v_init=warm_u, dtype=Gd.dtype)


def gram_pc_scores(G, M, u):
    """Scores and the first-loading operand from one principal component
    of the Gram accumulator: ``||A^T u|| = sqrt(u^T G u)``,
    ``scores = M (u / ||A^T u||)``. Returns ``(scores (R,), u_over_nAu
    (R,), nAu)``."""
    nAu = torch.sqrt(torch.clamp(u @ (G @ u), min=0.0))
    u_over_nAu = u / torch.where(nAu == 0.0, torch.ones_like(nAu), nAu)
    return M @ u_over_nAu, u_over_nAu, nAu


def gram_top_components(G, M, rep_ref, k: int, warm_u=None, delta=None,
                        warm_iters: int = 96, warm_tol: float = 0.0):
    """Top-k scores and explained fractions off the Gram accumulator.
    Returns ``(scores (R, k), explained (k,), U (R, k), nAu (k,))``.
    ``delta = (dG, dM)`` folds an appended block's contributions in
    first; ``warm_u`` (k = 1 only) takes the dominant component from
    :func:`gram_warm_pc` instead of the eigensolver. Above
    ``STREAM_EIGH_MAX_R`` reporters the subspace comes from
    :func:`_sym_topk` and the total variance from ``trace(Gd)``."""
    if delta is not None:
        dG, dM = delta
        G = G + dG
        M = M + dM
    R = G.shape[0]
    Gd = G / _gram_denom(rep_ref)
    if warm_u is not None:
        if k != 1:
            raise ValueError(
                f"gram_top_components: an eigenpair warm start serves "
                f"the dominant component only (k=1), got k={k}")
        u, _ = gram_warm_pc(G, rep_ref, warm_u, n_iters=warm_iters,
                            tol=warm_tol)
        U = u[:, None]
        lam = torch.clamp(u @ (Gd @ u), min=0.0)[None]
        total = torch.clamp(torch.trace(Gd), min=0.0)
        scores_1, _, nAu_1 = gram_pc_scores(G, M, u)
        scores, nAu = scores_1[:, None], nAu_1[None]
    else:
        if R <= STREAM_EIGH_MAX_R:
            eigvals, eigvecs = torch.linalg.eigh(Gd)
            lam = torch.clamp(eigvals.flip(0)[:k], min=0.0)
            U = eigvecs.flip(1)[:, :k]
            total = torch.sum(torch.clamp(eigvals, min=0.0))
        else:
            obs.counter(
                "pyconsensus_streaming_topk_fallback_total",
                "streamed spectra taken via orthogonal iteration instead "
                "of eigh (R > STREAM_EIGH_MAX_R)").inc()
            lam, U = _sym_topk(Gd, k)
            total = torch.clamp(torch.trace(Gd), min=0.0)
        nAu = torch.sqrt(torch.clamp(torch.sum(U * (G @ U), dim=0),
                                     min=0.0))
        scores = M @ (U / torch.where(nAu == 0.0, torch.ones_like(nAu),
                                      nAu)[None, :])
    explained = torch.where(total > 0.0,
                            lam / torch.where(total > 0.0, total,
                                              torch.ones_like(total)),
                            torch.zeros_like(lam))
    return scores, explained, U, nAu


def assemble_light_result(old_rep, this_rep, smooth_rep, na_count,
                          outcomes_raw, outcomes_adjusted, outcomes_final,
                          iterations, converged, certainty, pcols, prow,
                          result_extra=None) -> dict:
    """The bonus accounting (numpy semantics) from the panel-accumulated
    host pieces, and the light result dict. ``pcols`` is
    ``participation_columns``; ``prow`` the per-row ``na @ certainty``
    partials. Tensors among the inputs are fetched to the host."""
    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else v

    total_cert = certainty.sum()
    consensus_reward = nk.normalize(certainty)
    participation_rows = 1.0 - (prow if total_cert == 0.0
                                else prow / total_cert)
    percent_na = 1.0 - pcols.mean()
    na_bonus_rows = nk.normalize(participation_rows)
    smooth_np = np.asarray(host(smooth_rep), dtype=float)
    reporter_bonus = (na_bonus_rows * percent_na
                      + smooth_np * (1.0 - percent_na))
    na_bonus_cols = nk.normalize(pcols)
    author_bonus = (na_bonus_cols * percent_na
                    + consensus_reward * (1.0 - percent_na))
    return {
        "old_rep": host(old_rep),
        "this_rep": np.asarray(host(this_rep), dtype=float),
        "smooth_rep": smooth_np,
        "na_row": na_count > 0,
        "outcomes_raw": outcomes_raw,
        "outcomes_adjusted": outcomes_adjusted,
        "outcomes_final": outcomes_final,
        "iterations": iterations,
        "convergence": converged,
        "certainty": certainty,
        "consensus_reward": consensus_reward,
        "avg_certainty": float(certainty.mean()),
        "participation_columns": pcols,
        "participation_rows": participation_rows,
        "percent_na": float(percent_na),
        "na_bonus_rows": na_bonus_rows,
        "reporter_bonus": reporter_bonus,
        "na_bonus_cols": na_bonus_cols,
        "author_bonus": author_bonus,
        **(result_extra or {}),
    }
