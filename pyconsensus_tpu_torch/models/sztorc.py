"""PCA scoring (``pyconsensus_tpu/models/sztorc.py``): ``sztorc`` by the
first principal component and ``fixed-variance``, which blends the
direction-fixed scores of the top components, each weighted by its
explained variance, until ``variance_threshold`` of the spectrum is
covered.

Three forms of each: numpy (the numpy backend), torch over the dense
filled matrix (the plain core) and, for fixed-variance, torch straight off
sentinel storage (the fused path), where the subspace comes from the
storage orthogonal iteration and all k direction fixes share one further
storage sweep.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..ops import numpy_kernels as nk
from ..ops import torch_kernels as tk

__all__ = ["sztorc_scores_np", "fixed_variance_scores_np", "sztorc_scores",
           "fixed_variance_scores", "fixed_variance_k",
           "fixed_variance_scores_storage"]


def sztorc_scores_np(reports_filled, reputation):
    """Direction-fixed first-component scores (numpy). Returns
    ``(adj_scores, loading)``."""
    with obs.span("np.scores", algorithm="sztorc"):
        loading, scores = nk.weighted_prin_comp(reports_filled, reputation)
        return (nk.direction_fixed_scores(scores, reports_filled,
                                          reputation), loading)


def _component_weights_np(explained, variance_threshold):
    """Include component c while the explained variance before it is under
    ``variance_threshold`` (component 0 always); weight the included ones
    by their explained share."""
    cum_before = np.concatenate([[0.0], np.cumsum(explained)[:-1]])
    include = cum_before < variance_threshold
    include[0] = True
    w = explained * include
    total = w.sum()
    return w / total if total > 0 else include / include.sum()


def fixed_variance_scores_np(reports_filled, reputation, variance_threshold,
                             max_components):
    """``fixed-variance`` (numpy). Returns ``(adj_scores, loading 0)``."""
    k = min(max_components, min(reports_filled.shape))
    with obs.span("np.scores", algorithm="fixed-variance", components=k):
        loadings, scores, explained = nk.weighted_prin_comps(reports_filled,
                                                             reputation, k)
        w = _component_weights_np(explained, variance_threshold)
        adj = np.zeros(reports_filled.shape[0], dtype=np.float64)
        for c in range(k):
            adj_c = nk.direction_fixed_scores(scores[:, c], reports_filled,
                                              reputation)
            adj = adj + w[c] * adj_c
        return adj, loadings[:, 0]


def sztorc_scores(filled: torch.Tensor, reputation: torch.Tensor,
                  pca_method: str = "auto", power_iters: int = 128,
                  power_tol: float = 0.0, v_init=None,
                  matvec_dtype: str = ""):
    """Direction-fixed first-component scores over the dense filled
    matrix. Where the method resolves to ``"power-fused"`` the sweeps run
    on ``apply_weighted_cov`` and the scores and direction fix on one
    ``scores_dirfix_pass``. ``v_init`` warm-starts the power-family
    methods; ``matvec_dtype`` narrows their sweeps' operand. Returns
    ``(adj_scores, loading)``."""
    method = tk.resolve_pca_method(*filled.shape, pca_method, filled.device)
    if method == "power-fused":
        return tk.sztorc_scores_power_fused(filled, reputation, power_iters,
                                            power_tol, matvec_dtype,
                                            v_init=v_init)
    loading, scores = tk.weighted_prin_comp(filled, reputation, method,
                                            power_iters, power_tol,
                                            v_init=v_init,
                                            matvec_dtype=matvec_dtype)
    return tk.direction_fixed_scores(scores, filled, reputation), loading


def fixed_variance_scores(filled: torch.Tensor, reputation: torch.Tensor,
                          variance_threshold: float, max_components: int,
                          pca_method: str = "auto", v_init=None):
    """``fixed-variance`` over the dense filled matrix. Returns
    ``(adj_scores, loadings (E, k))``: the full block is the iterated
    pipeline's warm start (the eigh methods ignore it)."""
    k = fixed_variance_k(*filled.shape, max_components)
    loadings, scores, explained = tk.weighted_prin_comps(
        filled, reputation, k, pca_method, v_init=v_init)
    w = _component_weights(explained, variance_threshold)
    adj_all = torch.stack([tk.direction_fixed_scores(scores[:, c], filled,
                                                     reputation)
                           for c in range(k)], dim=1)
    return adj_all @ w, loadings


def fixed_variance_k(n_reporters: int, n_events: int,
                     max_components: int) -> int:
    """The component count ``fixed-variance`` extracts; also the width of
    the iterated pipeline's (E, k) warm-start carry."""
    return int(min(max_components, min(n_reporters, n_events)))


def _component_weights(explained: torch.Tensor,
                       variance_threshold: float) -> torch.Tensor:
    """The blend weights: components are included while the variance
    explained before them is under the threshold (the first always), and
    weighted by their explained share; uniform over the included ones
    when that share is zero."""
    cum_before = torch.cat([torch.zeros(1, dtype=explained.dtype,
                                        device=explained.device),
                            torch.cumsum(explained, dim=0)[:-1]])
    include = cum_before < variance_threshold
    include[0] = True
    inc = include.to(explained.dtype)
    w = explained * inc
    total = torch.sum(w)
    return torch.where(total > 0.0,
                       w / torch.where(total > 0.0, total,
                                       torch.ones_like(total)),
                       inc / torch.sum(inc))


def fixed_variance_scores_storage(x: torch.Tensor, fill: torch.Tensor,
                                  mu: torch.Tensor, reputation: torch.Tensor,
                                  variance_threshold: float,
                                  max_components: int, v_init=None):
    """``fixed-variance`` scoring straight off sentinel storage. Returns
    ``(adj_scores (R,), loadings (E, k))``: the full block is the iterated
    pipeline's warm start."""
    k = fixed_variance_k(*x.shape, max_components)
    loadings, scores, explained = tk.weighted_prin_comps_storage(
        x, fill, mu, reputation, k, v_init=v_init)
    w = _component_weights(explained, variance_threshold)
    adj_all = tk.multi_dirfix_storage(scores, x, fill, mu, reputation)
    return adj_all @ w, loadings
