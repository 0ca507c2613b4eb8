"""The ``fixed-variance`` scorer on sentinel storage
(``pyconsensus_tpu/models/sztorc.py``, storage variant).

It blends the direction-fixed scores of the top components, each weighted
by its explained variance, until ``variance_threshold`` of the spectrum is
covered. The subspace comes from the storage orthogonal iteration and all
k direction fixes share one further storage sweep.
"""

from __future__ import annotations

import torch

from ..ops import torch_kernels as tk

__all__ = ["fixed_variance_k", "fixed_variance_scores_storage"]


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
