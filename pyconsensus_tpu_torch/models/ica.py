"""The ``ica`` scorer on sentinel storage (``pyconsensus_tpu/models/ica.py``,
storage variant): one-unit FastICA (tanh contrast, start at the first
whitened component) on the reputation-weighted top-``k`` subspace.

The loop stops once successive unit iterates align to
``|<w_next, w>| >= 1 - tol``. If ``ICA_ITERS`` pass without that, the
iteration is chaotic for this matrix and the scorer falls back to the
first whitened component; it reports which happened (``converged``), and
the pipeline surfaces that as ``ica_converged``.
"""

from __future__ import annotations

import torch

from ..ops import torch_kernels as tk

__all__ = ["ICA_ITERS", "ica_k", "ica_scores_storage"]

ICA_ITERS = 128
_EPS = 1e-12


def _conv_tol(dtype: torch.dtype) -> float:
    """The alignment tolerance: 1e-12, floored at 32 eps of ``dtype``."""
    return max(1e-12, 32.0 * float(torch.finfo(dtype).eps))


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
