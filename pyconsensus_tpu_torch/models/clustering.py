"""Clustering consensus variants (``pyconsensus_tpu/models/clustering.py``):
k-means, dbscan-jit, hierarchical and dbscan over reporter rows.

Scoring rule, shared by every variant: cluster the reporter rows of the
filled reports matrix; a reporter's raw score ("conformity") is the total
reputation mass of its own cluster. The conformity vector then feeds the
same ``row_reward_weighted -> smooth`` steps as the PCA scores.

Two halves:

- the host half, in numpy, a copy of the reference's: the band helpers
  (``_d2_threshold``, ``_linkage_threshold``, the single source of truth
  that every backend applies), the seeding, ``kmeans_conformity_np``,
  ``dbscan_jit_conformity_np``, and ``hierarchical_conformity`` and
  ``dbscan_conformity``, which cluster a supplied (R, R) distance matrix
  on the host through the native runtime (``native/cluster.cpp``, loaded
  by :mod:`pyconsensus_tpu_torch._native`) or, without it, scipy and
  sklearn;
- the torch half, on the device: :func:`pairwise_sq_dists` (one
  ``X Xᵀ`` product), :func:`kmeans_conformity` (fixed-iteration Lloyd in
  the reputation dtype, the reference's seeding, first-argmin tie-break
  and weighted/plain/keep update) and :func:`dbscan_jit_same_matrix`
  (min-label propagation with pointer jumping, a loop that stops when no
  label changed).

The products are ``torch.matmul`` with TF32 off, as the plain core runs
them; no hand-written kernel is on this path, because the reference's
clustering reaches no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "kmeans_conformity_np", "kmeans_conformity",
    "hierarchical_conformity", "dbscan_conformity",
    "dbscan_jit_conformity_np", "dbscan_jit_conformity",
    "dbscan_jit_same_matrix", "pairwise_sq_dists",
]

KMEANS_ITERS = 32

#: The DBSCAN membership band: a pair is within ``eps`` when its squared
#: distance is at most ``eps^2 + DBSCAN_D2_ATOL * max(1, max(d2))``, the
#: band capped at ``DBSCAN_D2_RTOL_CAP * eps^2``. The {0, 0.5, 1} report
#: lattice puts true distances exactly on the default ``eps^2``, where two
#: backends' Gram expansions round apart; the band moves the knife edge
#: off the lattice's levels and the cap keeps it a tie-breaker, never a
#: wider radius.
DBSCAN_D2_ATOL = 1e-6
DBSCAN_D2_RTOL_CAP = 1e-3

#: The same band for the average-linkage cut height.
HIER_T_ATOL = 1e-6
HIER_T_RTOL_CAP = 1e-3

#: elements of k-means' (rows, k, E) difference per row chunk (1 GiB of
#: float32): each row's sum over E keeps its form, the temporary stays
#: bounded at any R
_KMEANS_CHUNK_ELEMS = 1 << 28


def _linkage_threshold(d, t: float) -> float:
    """Banded cut height for average-linkage clustering: the single source
    of truth both host backends share."""
    return float(t) + min(HIER_T_ATOL * max(1.0, float(np.max(d, initial=0.0))),
                          HIER_T_RTOL_CAP * float(t))


def _d2_threshold(d2, eps, xp=np):
    """The banded membership threshold, shared by every backend.
    ``initial`` guards the zero-reporter (0, 0) matrix."""
    e2 = eps * eps
    return e2 + xp.minimum(
        DBSCAN_D2_ATOL * xp.maximum(1.0, xp.max(d2, initial=0.0)),
        DBSCAN_D2_RTOL_CAP * e2)


def _d2_threshold_t(d2: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`_d2_threshold` on a tensor: the same expression in ``d2``'s
    dtype, the Python scalars rounded to it as the reference's weak
    scalars are."""
    e2 = eps * eps
    top = torch.clamp(torch.max(d2), min=0.0)
    one = torch.ones((), dtype=d2.dtype, device=d2.device)
    cap = torch.tensor(DBSCAN_D2_RTOL_CAP * e2, dtype=d2.dtype,
                       device=d2.device)
    return e2 + torch.minimum(DBSCAN_D2_ATOL * torch.maximum(one, top), cap)


def _seed_indices(n_rows: int, k: int) -> np.ndarray:
    """Deterministic seeding: k evenly spaced reporter rows."""
    return np.floor(np.linspace(0, n_rows - 1, k)).astype(np.int64)


def _cluster_mass(labels: np.ndarray, reputation: np.ndarray) -> np.ndarray:
    """conformity[i] = total reputation of reporter i's cluster."""
    mass = {}
    for lbl, rep in zip(labels, reputation):
        mass[lbl] = mass.get(lbl, 0.0) + float(rep)
    return np.array([mass[lbl] for lbl in labels], dtype=np.float64)


# -- the host half (numpy) ---------------------------------------------------

def kmeans_conformity_np(reports_filled, reputation, num_clusters,
                         n_iters: int = KMEANS_ITERS):
    """Fixed-iteration Lloyd k-means (numpy); reputation-weighted centroid
    updates; empty clusters keep their previous centroid."""
    X = np.asarray(reports_filled, dtype=np.float64)
    rep = np.asarray(reputation, dtype=np.float64)
    R = X.shape[0]
    k = int(min(num_clusters, R))
    centroids = X[_seed_indices(R, k)].copy()
    for _ in range(n_iters):
        d2 = ((X[:, None, :] - centroids[None, :, :]) ** 2).sum(axis=2)
        labels = np.argmin(d2, axis=1)
        for c in range(k):
            sel = labels == c
            w = rep[sel]
            if w.sum() > 0:
                centroids[c] = (X[sel] * w[:, None]).sum(axis=0) / w.sum()
            elif sel.any():
                centroids[c] = X[sel].mean(axis=0)
    # the final assignment against the final centroids, as the torch half
    # assigns after its loop
    d2 = ((X[:, None, :] - centroids[None, :, :]) ** 2).sum(axis=2)
    labels = np.argmin(d2, axis=1)
    return _cluster_mass(labels, rep)


def _pairwise_sq_dists_np(X: np.ndarray) -> np.ndarray:
    """Host form of :func:`pairwise_sq_dists` (same clamping)."""
    sq = (X ** 2).sum(axis=1)
    return np.clip(sq[:, None] + sq[None, :] - 2.0 * X @ X.T, 0.0, None)


def _dbscan_jit_labels_np(d2: np.ndarray, eps: float,
                          min_samples: int) -> np.ndarray:
    """Deterministic DBSCAN labelling: every cluster is labelled by the
    smallest core-point index it contains, border points take the minimum
    label among their core neighbours, and noise points become singletons
    labelled by their own index."""
    R = d2.shape[0]
    nbr = d2 <= _d2_threshold(d2, eps)          # includes self
    core = nbr.sum(axis=1) >= min_samples
    adj = nbr & core[None, :] & core[:, None]
    labels = np.where(core, np.arange(R), R)
    while True:
        cand = np.where(adj, labels[None, :], R).min(axis=1)
        new = np.minimum(labels, cand)
        valid = new < R
        jumped = np.where(valid, new[np.where(valid, new, 0)], new)
        if np.array_equal(jumped, labels):
            break
        labels = jumped
    border_mass = nbr & core[None, :]
    border_label = np.where(border_mass, labels[None, :], R).min(axis=1)
    is_border = (~core) & (border_label < R)
    out = np.where(core, labels,
                   np.where(is_border, border_label, np.arange(R)))
    return out.astype(np.int64)


def dbscan_jit_conformity_np(reports_filled, reputation, eps, min_samples,
                             sq_dists=None):
    """``dbscan-jit`` conformity on the host. ``sq_dists`` may supply the
    (R, R) squared distances; the reports matrix is then never read."""
    rep = np.asarray(reputation, dtype=np.float64)
    d2 = (np.asarray(sq_dists, dtype=np.float64) if sq_dists is not None
          else _pairwise_sq_dists_np(
              np.asarray(reports_filled, dtype=np.float64)))
    labels = _dbscan_jit_labels_np(d2, float(eps), int(min_samples))
    return _cluster_mass(labels, rep)


def hierarchical_conformity(reports_filled, reputation, threshold,
                            sq_dists=None):
    """Average-linkage agglomerative clustering cut at distance
    ``threshold`` (host side); ``sq_dists`` may supply the device's
    :func:`pairwise_sq_dists`. The merge loop runs in the native runtime
    (NN-chain) when its library loads, else in scipy (``linkage(method=
    "average")`` and ``fcluster(criterion="distance")``); both give the
    same partitions."""
    from .. import _native, obs

    X = np.asarray(reports_filled, dtype=np.float64)
    rep = np.asarray(reputation, dtype=np.float64)
    if X.shape[0] == 1:
        return rep.copy()
    with obs.span("clustering.hierarchical", reporters=rep.shape[0]) as sp:
        if sq_dists is None:
            sq_dists = _pairwise_sq_dists_np(X)
        d = np.sqrt(np.asarray(sq_dists, dtype=np.float64))
        np.fill_diagonal(d, 0.0)
        t_eff = _linkage_threshold(d, threshold)
        labels = _native.avg_linkage_labels(d, t_eff)
        sp.set_attr("native", labels is not None)
        if labels is None:
            from scipy.cluster.hierarchy import fcluster, linkage
            from scipy.spatial.distance import squareform

            Z = linkage(squareform(d, checks=False), method="average")
            labels = fcluster(Z, t=t_eff, criterion="distance")
        sp.set_attr("clusters", int(len(np.unique(labels))))
    return _cluster_mass(labels, rep)


def dbscan_conformity(reports_filled, reputation, eps, min_samples,
                      sq_dists=None):
    """DBSCAN over reporter rows (host side, over a supplied or host
    distance matrix). Noise points (label -1) count as singleton
    clusters. The BFS expansion runs in the native runtime when its
    library loads, else in sklearn (``DBSCAN(metric="precomputed")``)."""
    from .. import _native, obs

    X = np.asarray(reports_filled, dtype=np.float64)
    rep = np.asarray(reputation, dtype=np.float64)
    with obs.span("clustering.dbscan", reporters=rep.shape[0]) as sp:
        if sq_dists is None:
            sq_dists = _pairwise_sq_dists_np(X)
        d2 = np.asarray(sq_dists, dtype=np.float64)
        d = np.sqrt(d2)
        # the eps^2 band of the jit variant: the device's and the host's
        # distances differ at the last ulp where the lattice puts pairs
        eps_eff = float(np.sqrt(_d2_threshold(d2, float(eps))))
        labels = _native.dbscan_labels(d, eps_eff, min_samples)
        sp.set_attr("native", labels is not None)
        if labels is None:
            from sklearn.cluster import DBSCAN

            labels = DBSCAN(eps=eps_eff, min_samples=min_samples,
                            metric="precomputed").fit(d).labels_
        # noise -> unique singleton labels
        labels = labels.astype(np.int64)
        next_label = labels.max() + 1 if labels.size else 0
        out = labels.copy()
        for i, lbl in enumerate(labels):
            if lbl == -1:
                out[i] = next_label
                next_label += 1
        sp.set_attr("clusters", int(len(np.unique(out))))
    return _cluster_mass(out, rep)


# -- the torch half (the device) ---------------------------------------------

def pairwise_sq_dists(reports_filled: torch.Tensor) -> torch.Tensor:
    """(R, R) squared distances between reporter rows by the Gram
    expansion ``|x|² + |y|² − 2 x·y``, clamped at 0: the O(R² E) part of
    the distance-based variants, one product on the device."""
    sq = torch.sum(reports_filled ** 2, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (reports_filled
                                            @ reports_filled.T)
    return torch.clamp(d2, min=0.0)


def _kmeans_assign(X: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """The nearest centroid of each row by the direct form
    ``sum_e (x_e - c_e)²``, the first on a tie; rows in chunks that bound
    the (rows, k, E) difference."""
    R, E = X.shape
    k = centroids.shape[0]
    step = max(1, _KMEANS_CHUNK_ELEMS // max(1, k * E))
    labels = []
    for r0 in range(0, R, step):
        diff = X[r0:r0 + step, None, :] - centroids[None, :, :]
        labels.append(torch.argmin(torch.sum(diff.pow_(2), dim=2), dim=1))
        del diff
    return torch.cat(labels) if labels else torch.zeros(
        0, dtype=torch.int64, device=X.device)


def kmeans_conformity(reports_filled: torch.Tensor,
                      reputation: torch.Tensor, num_clusters: int,
                      n_iters: int = KMEANS_ITERS) -> torch.Tensor:
    """Fixed-iteration Lloyd k-means (``kmeans_conformity_jax``): the
    reference's seeding, first-argmin assignment, and update (the
    reputation-weighted mean, the plain mean where a cluster has no
    reputation mass, the old centroid where it has no member), then one
    assignment after the loop. Runs in the reputation dtype."""
    acc = reputation.dtype
    X = reports_filled.to(acc)
    R = X.shape[0]
    k = int(min(num_clusters, R))
    seeds = torch.as_tensor(_seed_indices(R, k), device=X.device)
    centroids = X[seeds]
    ks = torch.arange(k, device=X.device)
    for _ in range(n_iters):
        labels = _kmeans_assign(X, centroids)
        onehot = (labels[:, None] == ks[None, :]).to(acc)
        w = onehot * reputation[:, None]                # (R, k)
        wsum = torch.sum(w, dim=0)                      # (k,)
        weighted = w.T @ X                              # (k, E)
        counts = torch.sum(onehot, dim=0)
        plain = onehot.T @ X / torch.clamp(counts, min=1.0)[:, None]
        one = torch.ones_like(wsum)
        centroids = torch.where(
            wsum[:, None] > 0.0,
            weighted / torch.where(wsum > 0.0, wsum, one)[:, None],
            torch.where(counts[:, None] > 0.0, plain, centroids))
    labels = _kmeans_assign(X, centroids)
    onehot = (labels[:, None] == ks[None, :]).to(acc)
    mass = torch.sum(onehot * reputation[:, None], dim=0)      # (k,)
    return mass[labels]


def dbscan_jit_same_matrix(d2: torch.Tensor, eps: float, min_samples: int,
                           dtype: torch.dtype) -> torch.Tensor:
    """The reputation-independent half of :func:`dbscan_jit_conformity`
    (``dbscan_jit_same_matrix_jax``): core points are rows with at least
    ``min_samples`` neighbours within the banded ``eps``; clusters are the
    connected components of the core-core graph, found by min-label
    propagation with pointer jumping (O(log R) rounds of an O(R²)
    relaxation, until no label changes); border points take the least
    label among their core neighbours, noise points are singletons.
    Returns the (R, R) same-cluster matrix in ``dtype``."""
    R = d2.shape[0]
    nbr = d2 <= _d2_threshold_t(d2, float(eps))
    core = torch.sum(nbr, dim=1) >= min_samples
    adj = nbr & core[None, :] & core[:, None]
    idx = torch.arange(R, device=d2.device)
    none = torch.full((), R, dtype=idx.dtype, device=d2.device)
    labels = torch.where(core, idx, none)
    while True:
        cand = torch.where(adj, labels[None, :], none).amin(dim=1)
        new = torch.minimum(labels, cand)
        # pointer jump: a label is a core index and labels[label] <= label,
        # so one gather halves the remaining propagation distance
        valid = new < R
        jumped = torch.where(valid, new[torch.where(valid, new, 0)], new)
        changed = bool(torch.any(jumped != labels))
        labels = jumped
        if not changed:
            break
    border_label = torch.where(nbr & core[None, :], labels[None, :],
                               none).amin(dim=1)
    is_border = (~core) & (border_label < R)
    final = torch.where(core, labels,
                        torch.where(is_border, border_label, idx))
    return (final[:, None] == final[None, :]).to(dtype)


def dbscan_jit_conformity(reports_filled: torch.Tensor,
                          reputation: torch.Tensor, eps: float,
                          min_samples: int,
                          sq_dists: torch.Tensor = None) -> torch.Tensor:
    """``dbscan-jit`` conformity on the device
    (``dbscan_jit_conformity_jax``): the same-cluster matrix of
    :func:`dbscan_jit_same_matrix` times the reputation. ``sq_dists`` may
    supply the (R, R) squared distances; the reports are then not read."""
    acc = reputation.dtype
    d2 = (sq_dists if sq_dists is not None
          else pairwise_sq_dists(reports_filled.to(acc)))
    return dbscan_jit_same_matrix(d2, eps, min_samples, acc) @ reputation
