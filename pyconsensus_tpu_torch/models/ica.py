"""The ``ica`` scorer (``pyconsensus_tpu/models/ica.py``): one-unit
FastICA (tanh contrast, start at the first whitened component) on the
reputation-weighted top-``k`` subspace, in numpy (the numpy backend), in
torch over the dense filled matrix (the plain core) and in torch straight
off sentinel storage (the fused path).

The loop stops once successive unit iterates align to
``|<w_next, w>| >= 1 - tol``. If ``ICA_ITERS`` pass without that, the
iteration is chaotic for this matrix and the scorer falls back to the
first whitened component; it reports which happened (``converged``), and
the pipeline surfaces that as ``ica_converged``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import numpy_kernels as nk
from ..ops import torch_kernels as tk

__all__ = ["ICA_ITERS", "ica_k", "ica_scores_np", "ica_scores",
           "ica_scores_storage"]

ICA_ITERS = 128
_EPS = 1e-12


def _conv_tol(dtype: torch.dtype) -> float:
    """The alignment tolerance: 1e-12, floored at 32 eps of ``dtype``."""
    return max(1e-12, 32.0 * float(torch.finfo(dtype).eps))


def _canon_signs_np(Z):
    """The numpy form of :func:`_canon_signs`."""
    idx = np.argmax(np.abs(Z), axis=0)
    signs = np.sign(Z[idx, np.arange(Z.shape[1])])
    signs = np.where(signs == 0.0, 1.0, signs)
    return Z * signs[None, :]


def ica_scores_np(reports_filled, reputation, max_components):
    """``ica`` (numpy). Returns ``(adj_scores, converged)``."""
    k = max(int(min(max_components, min(reports_filled.shape) - 1)), 1)
    _, scores, _ = nk.weighted_prin_comps(reports_filled, reputation, k)
    std = np.sqrt(np.clip(np.var(scores, axis=0), _EPS, None))
    Z = _canon_signs_np(scores / std[None, :])
    R = Z.shape[0]
    tol = _conv_tol(torch.float64)              # the numpy path is float64
    w0 = np.zeros(k)
    w0[0] = 1.0
    w = w0
    converged = False
    for _ in range(ICA_ITERS):
        g = np.tanh(Z @ w)
        w_new = (Z.T @ g) / R - (1.0 - g ** 2).mean() * w
        norm = np.linalg.norm(w_new)
        w_next = w_new / norm if norm > _EPS else w
        align = abs(float(np.dot(w_next, w)))
        w = w_next
        if align >= 1.0 - tol:
            converged = True
            break
    if not converged:
        w = w0
    return (nk.direction_fixed_scores(Z @ w, reports_filled, reputation),
            converged)


def _canon_signs(Z: torch.Tensor) -> torch.Tensor:
    """Flip each column so that its largest-magnitude entry is positive
    (first index on ties; a zero entry counts as positive)."""
    idx = torch.argmax(torch.abs(Z), dim=0)
    signs = torch.sign(Z[idx, torch.arange(Z.shape[1], device=Z.device)])
    signs = torch.where(signs == 0.0, torch.ones_like(signs), signs)
    return Z * signs[None, :]


def ica_k(n_reporters: int, n_events: int, max_components: int) -> int:
    """The width of the whitening subspace ``ica`` extracts from."""
    return max(int(min(max_components, min(n_reporters, n_events) - 1)), 1)


def _fastica_one_unit(Z: torch.Tensor, tol: float):
    """One-unit FastICA on a whitened (R, k) block. The exit test reads
    one scalar back per iteration. Returns ``(w (k,), converged)``, where
    ``w`` is the start vector ``e_0`` when the loop did not converge."""
    R, k = Z.shape
    w0 = torch.zeros(k, dtype=Z.dtype, device=Z.device)
    w0[0] = 1.0
    eps = torch.tensor(_EPS, dtype=Z.dtype, device=Z.device)
    thresh = torch.tensor(1.0 - tol, dtype=Z.dtype, device=Z.device)
    w = w0
    for _ in range(ICA_ITERS):
        g = torch.tanh(Z @ w)
        w_new = (Z.T @ g) / R - torch.mean(1.0 - g ** 2) * w
        norm = torch.linalg.vector_norm(w_new)
        w_next = torch.where(norm > eps,
                             w_new / torch.where(norm > eps, norm,
                                                 torch.ones_like(norm)), w)
        done = bool((torch.abs(torch.dot(w_next, w)) >= thresh).item())
        w = w_next
        if done:
            return w, True
    return w0, False


def ica_scores_storage(x: torch.Tensor, fill: torch.Tensor, mu: torch.Tensor,
                       reputation: torch.Tensor, max_components: int,
                       v_init=None):
    """``ica`` scoring straight off sentinel storage: the whitening
    subspace from the storage orthogonal iteration, FastICA on the small
    whitened block, and the direction fix of the extracted component in
    one further storage sweep. Returns ``(adj_scores (R,), converged,
    loadings (E, k))``."""
    k = ica_k(*x.shape, max_components)
    loadings, scores, _ = tk.weighted_prin_comps_storage(
        x, fill, mu, reputation, k, v_init=v_init)
    std = torch.sqrt(torch.clamp(torch.var(scores, dim=0, correction=0),
                                 min=_EPS))
    Z = _canon_signs(scores / std[None, :])
    w, converged = _fastica_one_unit(Z, _conv_tol(Z.dtype))
    s = Z @ w
    adj = tk.multi_dirfix_storage(s[:, None], x, fill, mu, reputation)[:, 0]
    return adj, converged, loadings


def ica_scores(filled: torch.Tensor, reputation: torch.Tensor,
               max_components: int, pca_method: str = "auto", v_init=None):
    """``ica`` over the dense filled matrix: the whitening subspace from
    ``weighted_prin_comps``, FastICA on the whitened block, and the
    direction fix of the extracted component. Returns ``(adj_scores,
    converged, loadings (E, k))``."""
    k = ica_k(*filled.shape, max_components)
    loadings, scores, _ = tk.weighted_prin_comps(filled, reputation, k,
                                                 pca_method, v_init=v_init)
    std = torch.sqrt(torch.clamp(torch.var(scores, dim=0, correction=0),
                                 min=_EPS))
    Z = _canon_signs(scores / std[None, :])
    w, converged = _fastica_one_unit(Z, _conv_tol(Z.dtype))
    return (tk.direction_fixed_scores(Z @ w, filled, reputation), converged,
            loadings)
