"""The plain core and the hybrid path over an event mesh, one controller
driving every shard (or each rank of a process mesh its own, every rank
computing the first device's work on the same bits; the hybrid path's
ranks each cluster their own copy of the folded distances, as the
reference's ``_consensus_hybrid`` does): the counterpart of the reference's
``consensus_light_jit`` under GSPMD (``pyconsensus_tpu/parallel/
sharded.py:636-643`` over ``models/pipeline.py _consensus_core``) and of
its hybrid path on a placed mesh (``sharded.py:600-614``).

The filled matrix lives as shards, in the layout of ``parallel/
fused_sharded.py``: ``parts[i]`` (R, W_i) on ``mesh[i]``, every (R,)-,
(E,)- and (E, k)-sized vector on the mesh's first device, scattered to
the shards and gathered back (``mesh.scatter``/``mesh.gather``).

- Column-local, on each shard: rescale, the fill
  (``tk.interpolate_masked``), the storage cast, the weighted column
  means, the weighted median (``tk.resolve_outcomes``, unblocked as
  ``effective_median_block`` says for a mesh), the certainty of each
  event (``tk.certainty_cols``), the participation of each event, and
  k-means' centroid updates.
- Folded in shard order on the first device (``mesh.fold``, never
  atomics): the (R,) products of the power sweeps and of the scores, the
  absent rows (as OR), each reporter's participation, the (R, k)
  products of the orthogonal iteration, the (R, R) Gram of
  ``"eigh-gram"`` and of the distances (dbscan-jit, hierarchical,
  dbscan), and k-means' (R, k) centroid distances.
- Gathered, not folded: the (E,) iterate of the power loop, the (E, k)
  block of the orthogonal iteration (its Householder QR and the
  Rayleigh-Ritz ``eigh`` run on the first device, as the reference's
  GSPMD gathers there), the direction fix's (3k, E) projections, and
  ``"eigh-cov"``'s centered matrix (its E x E covariance; ``"auto"``
  picks it at E <= 1024 only).

The products are ``torch.matmul`` on each shard (``tk._dot``'s storage
rule): the reference computes them in XLA, outside any Pallas kernel.
A pad column holds the present value 0 in every row: its centered value
is 0, so it adds nothing to a product, a distance or a centroid, and
every gather drops its outcome, certainty and participation before any
cross-column sum.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..models import clustering as cl
from ..models.ica import _EPS, _canon_signs, _conv_tol, _fastica_one_unit
from ..models.ica import ica_k
from ..models.pipeline import (_ICA_WARM_START, HYBRID_ALGORITHMS,
                               ConsensusParams, _check_plain_params,
                               _subspace_carry_shape, cluster_on_host,
                               iterate_scores)
from ..models.sztorc import _component_weights, fixed_variance_k
from ..ops import torch_kernels as tk
from ..ops.constants import DIRFIX_TIE_ATOL
from .mesh import (EventShards, effective_median_block, fold, gather,
                   scatter, scatter_bounds)

__all__ = ["plain_sharded_consensus", "hybrid_sharded_consensus"]


class _Filled:
    """The filled matrix of one resolution as its shards, with the moves
    between them and the first device."""

    def __init__(self, placed: EventShards, parts: list, acc: torch.dtype):
        self.placed, self.parts, self.acc = placed, parts, acc
        self.dev0 = placed.home
        self.R, self.E = placed.shape

    def rows(self, t: torch.Tensor) -> list:
        """An (R,)-, (R, k)- or (k, R)-sized tensor on every shard."""
        return [t.to(x.device, non_blocking=True) for x in self.parts]

    def cols(self, v: torch.Tensor) -> list:
        """An (E,) vector or (E, k) block as per-shard slices."""
        return scatter(v, self.placed)

    def gather(self, pieces, dim: int = -1) -> torch.Tensor:
        return gather(pieces, self.placed, dim)

    def fold(self, pieces) -> torch.Tensor:
        return fold(pieces, self.dev0, self.placed.mesh)

    def times(self, V: torch.Tensor, parts=None) -> torch.Tensor:
        """``filled @ V`` for V (E,) or (E, k): (R,) or (R, k)."""
        return self.fold([tk._dot(x, v, x.dtype, self.acc) for x, v in
                          zip(parts or self.parts, self.cols(V))])

    def times_t(self, W: torch.Tensor, parts=None) -> torch.Tensor:
        """``W @ filled`` for W (R,) or (k, R): (E,) or (k, E)."""
        return self.gather([tk._dot(w, x, x.dtype, self.acc) for x, w in
                            zip(parts or self.parts, self.rows(W))])

    def t_times(self, T: torch.Tensor) -> torch.Tensor:
        """``filled^T @ T`` for T (R, k): (E, k)."""
        return self.gather([tk._dot(x.T, t, x.dtype, self.acc) for x, t in
                            zip(self.parts, self.rows(T))], dim=0)

    def mu(self, rep: torch.Tensor) -> torch.Tensor:
        """The weighted column means (``tk._mu_denom``), (E,)."""
        return self.gather([r @ x.to(self.acc)
                            for x, r in zip(self.parts, self.rows(rep))])

    def centered(self, mu: torch.Tensor) -> list:
        """The per-shard deviations ``filled - mu`` (``tk._center``)."""
        return [x - m[None, :] for x, m in zip(self.parts, self.cols(mu))]


# -- scoring ------------------------------------------------------------------

def _gram(m: _Filled, devs: list, rep: torch.Tensor, denom: torch.Tensor):
    """The factors ``A_i = diag(sqrt(rep)) D_i`` and the (R, R) Gram
    ``sum_i A_i A_i^T / denom``, folded in shard order."""
    root = torch.sqrt(torch.clamp(rep, min=0.0))
    As = [d * s[:, None] for d, s in zip(devs, m.rows(root))]
    return As, m.fold([a @ a.T for a in As]) / denom


def _normalized_back(m: _Filled, As: list, U: torch.Tensor) -> torch.Tensor:
    """``A^T U`` gathered to the first device, each column to unit
    norm (the Gram trick's map back)."""
    V = m.gather([a.T @ u for a, u in zip(As, m.rows(U))], dim=0)
    norms = torch.linalg.vector_norm(V, dim=0)
    return V / torch.where(norms == 0.0, 1.0, norms)


def _first_pc(m: _Filled, rep: torch.Tensor, p: ConsensusParams, v_init):
    """sztorc's first component by ``"power"`` or ``"eigh-gram"``
    (``tk.weighted_prin_comp``). Returns ``(loading (E,), scores (R,))``."""
    mu, denom = m.mu(rep), tk._denom(rep)
    if p.pca_method == "power":
        mm = [tk.matvec_narrow(x, p.matvec_dtype) for x in m.parts]

        def apply_cov(v):
            rt = rep * (m.times(v, mm) - mu @ v)
            return (m.times_t(rt, mm) - mu * torch.sum(rt)) / denom

        loading, _ = tk._power_loop(apply_cov, m.E, p.power_iters,
                                    p.power_tol, m.dev0, v_init=v_init,
                                    dtype=m.acc)
        return loading, m.times(loading) - mu @ loading
    if p.pca_method != "eigh-gram":
        raise ValueError(f"pca_method={p.pca_method!r} on an event mesh: "
                         "sztorc takes power or eigh-gram")
    devs = m.centered(mu)
    As, G = _gram(m, devs, rep, denom)
    loading = _normalized_back(m, As, torch.linalg.eigh(G)[1][:, -1:])[:, 0]
    return loading, m.fold([d @ v for d, v in zip(devs, m.cols(loading))])


def _prin_comps(m: _Filled, rep: torch.Tensor, k: int, method: str,
                v_init):
    """Top-k loadings, scores and explained-variance fractions
    (``tk.weighted_prin_comps``) by ``"power"`` (orthogonal iteration),
    ``"eigh-gram"`` or ``"eigh-cov"``."""
    mu, denom = m.mu(rep), tk._denom(rep)
    if method == "power":
        def apply_cov_block(V, emit_t=False):
            rt = rep[:, None] * (m.times(V) - (mu @ V)[None, :])
            return (m.t_times(rt) - mu[:, None]
                    * torch.sum(rt, dim=0)[None, :]) / denom, None

        loadings, eig, _ = tk.orth_iter_block(apply_cov_block, m.E, k,
                                              m.acc, m.dev0, v_init)
        # matrix-free trace: sum_e (rep . x_e^2 - mu_e^2) / denom
        col_sq = m.gather([r @ (v * v) for v, r in zip(
            (x.to(m.acc) for x in m.parts), m.rows(rep))])
        total = torch.clamp(torch.sum(col_sq - mu * mu) / denom, min=0.0)
        scores = m.times(loadings) - (mu @ loadings)[None, :]
        return loadings, scores, tk._explained(eig, total)
    devs = m.centered(mu)
    if method == "eigh-gram":
        As, G = _gram(m, devs, rep, denom)
        eigvals, eigvecs = torch.linalg.eigh(G)
        loadings = _normalized_back(m, As, eigvecs.flip(1)[:, :k])
        scores = m.fold([d @ v for d, v in zip(devs, m.cols(loadings))])
    elif method == "eigh-cov":
        dev = m.gather(devs)
        eigvals, eigvecs = torch.linalg.eigh(
            (dev * rep[:, None]).T @ dev / denom)
        loadings = eigvecs.flip(1)[:, :k]
        scores = dev @ loadings
    else:
        raise ValueError(f"pca_method={method!r} on an event mesh: the "
                         "multi-component variants take power, eigh-gram "
                         "or eigh-cov")
    eig = torch.clamp(eigvals.flip(0)[:k], min=0.0)
    total = torch.sum(torch.clamp(eigvals, min=0.0))
    return loadings, scores, tk._explained(eig, total)


def _dirfix(m: _Filled, scores: torch.Tensor,
            rep: torch.Tensor) -> torch.Tensor:
    """``tk.direction_fixed_scores`` of each column of ``scores`` (R, k),
    every projection in one pass over the shards: the (1 + 2k, R) stack
    of the reputation and each column's two candidates."""
    acc = scores.dtype
    sets = []
    for c in range(scores.shape[1]):
        s = tk.canon_sign(scores[:, c])
        sets.append((s + torch.abs(torch.min(s)), s - torch.max(s)))
    W = torch.stack([rep.to(acc)] + [tk.normalize(v) for pair in sets
                                     for v in pair])
    proj = m.times_t(W)
    old = proj[0]
    out = []
    for c, (set1, set2) in enumerate(sets):
        d1 = torch.sum((proj[1 + 2 * c] - old) ** 2)
        d2 = torch.sum((proj[2 + 2 * c] - old) ** 2)
        out.append(torch.where(d1 - d2 <= DIRFIX_TIE_ATOL * (d1 + d2),
                               set1, -set2))
    return torch.stack(out, dim=1)


def _kmeans(m: _Filled, rep: torch.Tensor, num_clusters: int):
    """``cl.kmeans_conformity``: each shard keeps its columns of the
    centroids; the (R, k) distances fold over the shards."""
    X = [x.to(m.acc) for x in m.parts]
    k = int(min(num_clusters, m.R))
    seeds = torch.as_tensor(cl._seed_indices(m.R, k))
    C = [x[seeds.to(x.device)] for x in X]
    reps = m.rows(rep)

    def assign():
        return torch.argmin(m.fold([cl.kmeans_sq_dists(x, c)
                                    for x, c in zip(X, C)]), dim=1)

    for _ in range(cl.KMEANS_ITERS):
        C = [cl.kmeans_update(x, lab, r, c)
             for x, lab, r, c in zip(X, m.rows(assign()), reps, C)]
    return cl.kmeans_mass(assign(), rep, k)


def _sq_dists(m: _Filled, parts=None) -> torch.Tensor:
    """The (R, R) squared distances between reporter rows, their squared
    norms and Gram folded over the shards (``cl.pairwise_sq_dists``)."""
    parts = parts or [x.to(m.acc) for x in m.parts]
    return cl.sq_dists_from(m.fold([torch.sum(x ** 2, dim=1)
                                    for x in parts]),
                            m.fold([x @ x.T for x in parts]))


def _scorer(m: _Filled, p: ConsensusParams):
    """``scores(rep, v_init) -> (adj, carry or None, ica flag or None)``,
    the mesh's counterpart of ``pipeline._scores``."""
    if p.algorithm == "k-means":
        return lambda rep, v_init: (_kmeans(m, rep, p.num_clusters), None,
                                    None)
    if p.algorithm == "dbscan-jit":
        # the distances are the same every iteration: one Gram
        d2 = _sq_dists(m)
        return lambda rep, v_init: (cl.dbscan_jit_conformity(
            None, rep, p.dbscan_eps, p.dbscan_min_samples, sq_dists=d2),
            None, None)
    if p.algorithm == "sztorc":
        def sztorc(rep, v_init):
            loading, scores = _first_pc(m, rep, p, v_init)
            return _dirfix(m, scores[:, None], rep)[:, 0], loading, None
        return sztorc
    if p.algorithm == "fixed-variance":
        k = fixed_variance_k(m.R, m.E, p.max_components)

        def fixed_variance(rep, v_init):
            loadings, scores, explained = _prin_comps(m, rep, k,
                                                      p.pca_method, v_init)
            w = _component_weights(explained, p.variance_threshold)
            return _dirfix(m, scores, rep) @ w, loadings, None
        return fixed_variance
    k = ica_k(m.R, m.E, p.max_components)

    def ica(rep, v_init):
        loadings, scores, _ = _prin_comps(
            m, rep, k, p.pca_method, v_init if _ICA_WARM_START else None)
        std = torch.sqrt(torch.clamp(torch.var(scores, dim=0, correction=0),
                                     min=_EPS))
        Z = _canon_signs(scores / std[None, :])
        w, converged = _fastica_one_unit(Z, _conv_tol(Z.dtype))
        adj = _dirfix(m, (Z @ w)[:, None], rep)[:, 0]
        return adj, (loadings if _ICA_WARM_START else None), converged
    return ica


# -- the pipelines ------------------------------------------------------------

def _fill_shards(placed: EventShards, old_rep: torch.Tensor, bounds: list,
                 p: ConsensusParams, has_na: bool, any_scaled: bool,
                 cast: bool = True) -> tuple:
    """Per shard: rescale, the fill and the storage cast (``cast``).
    Returns ``(filled parts, present parts or None)``; each shard's
    temporaries are dropped before the next."""
    filled, presents = [], []
    for x, (sc, lo, hi) in zip(placed.shards, bounds):
        r = old_rep.to(x.device, non_blocking=True)
        x = tk.rescale(x, sc, lo, hi) if any_scaled else x
        if has_na:
            x, present = tk.interpolate_masked(x, r, sc, p.catch_tolerance)
            presents.append(present)
        if cast and p.storage_dtype:
            x = x.to(getattr(torch, p.storage_dtype))
        filled.append(x)
    return filled, (presents if has_na else None)


def _bounds(placed: EventShards, scaled, mins, maxs):
    """The per-shard bounds and the (E,) ones on the first device."""
    dev0 = placed.home
    return (scatter_bounds(scaled, mins, maxs, placed),
            torch.as_tensor(np.asarray(scaled, dtype=bool), device=dev0),
            torch.as_tensor(np.asarray(mins), dtype=torch.float32,
                            device=dev0),
            torch.as_tensor(np.asarray(maxs), dtype=torch.float32,
                            device=dev0))


def _back_half(m: _Filled, presents, bounds: list, rep: torch.Tensor,
               scaled0, mins0, maxs0, p: ConsensusParams) -> dict:
    """Outcomes, certainty, participation and bonuses with the final
    reputation: the column halves on each shard, the rest on the first
    device (``tk.resolve_outcomes``, ``tk.certainty_and_bonuses``).
    ``presents`` None takes the closed form of an all-present matrix."""
    any_scaled = p.any_scaled
    median_block = effective_median_block(p.median_block, m.placed.mesh)
    reps = m.rows(rep)
    pres = presents or [None] * len(m.parts)
    raws, adjs, certs = [], [], []
    for x, pr, r, (sc, _, _) in zip(m.parts, pres, reps, bounds):
        raw, adj = tk.resolve_outcomes(pr, x, r, sc, p.catch_tolerance,
                                       any_scaled=any_scaled,
                                       has_na=p.has_na,
                                       median_block=median_block,
                                       n_scaled=0)
        raws.append(raw)
        adjs.append(adj)
        certs.append(tk.certainty_cols(pr, x, r, adj, sc, p.catch_tolerance,
                                       any_scaled))
    adjusted = m.gather(adjs)
    certainty = m.gather(certs)
    reward = tk.normalize(certainty)
    out = {
        "outcomes_raw": m.gather(raws),
        "outcomes_adjusted": adjusted,
        "outcomes_final": (tk.unscale_outcomes(adjusted, scaled0, mins0,
                                               maxs0)
                           if any_scaled else adjusted),
    }
    if presents is None:
        out["na_row"] = torch.zeros(m.R, dtype=torch.bool, device=m.dev0)
        out.update(tk.dense_bonuses(rep, certainty, reward))
        return out
    acc = rep.dtype
    pcols, prows, narows = [], [], []
    for pr, r, cr in zip(presents, reps, m.cols(reward)):
        na = (~pr).to(acc)
        pcols.append(1.0 - r @ na)
        prows.append(na @ cr)
        narows.append((~pr).any(dim=1).to(torch.int32))
    out["na_row"] = m.fold(narows) > 0
    out.update(tk.bonuses(rep, certainty, reward, m.gather(pcols),
                          1.0 - m.fold(prows)))
    return out


def plain_sharded_consensus(placed: EventShards, reputation: torch.Tensor,
                            scaled, mins, maxs, p: ConsensusParams) -> dict:
    """Resolve one oracle on the plain core with its events sharded over
    ``placed.mesh``: sztorc (power or eigh-gram), fixed-variance and ica
    (power, eigh-gram or eigh-cov), k-means and dbscan-jit, on float32 or
    bfloat16 shards, scaled events at any count. ``scaled``, ``mins`` and
    ``maxs`` are the (E,) host bounds, ``p`` resolved by the front door.
    Returns the light result dict on the mesh's first device, with every
    (E,) vector over the real events."""
    _check_plain_params(placed, p)
    dev0 = placed.home
    with obs.span("plain_sharded.dispatch", algorithm=p.algorithm,
                  event_shards=len(placed.mesh), reporters=placed.shape[0],
                  events=placed.n_events):
        old_rep = tk.normalize(reputation.to(dev0))
        bounds, scaled0, mins0, maxs0 = _bounds(placed, scaled, mins, maxs)
        parts, presents = _fill_shards(placed, old_rep, bounds, p, p.has_na,
                                       p.any_scaled)
        m = _Filled(placed, parts, old_rep.dtype)
        rep, this_rep, loading, converged, iters, ica_conv = iterate_scores(
            _scorer(m, p), _subspace_carry_shape(p, m.R, m.E), old_rep, p)
        result = {"old_rep": old_rep, "this_rep": this_rep,
                  "smooth_rep": rep, "iterations": iters,
                  "convergence": converged}
        result.update(_back_half(m, presents, bounds, rep, scaled0, mins0,
                                 maxs0, p))
        if loading is not None:
            result["first_loading"] = tk.canon_sign(loading)
        if p.algorithm == "ica":
            result["ica_converged"] = torch.tensor(bool(ica_conv),
                                                   device=dev0)
        return result


def hybrid_sharded_consensus(placed: EventShards, reputation: torch.Tensor,
                             scaled, mins, maxs, p: ConsensusParams) -> dict:
    """hierarchical and dbscan with their events sharded over
    ``placed.mesh`` (``pipeline._consensus_hybrid`` over shards): rescale
    and the fill on each shard, the (R, R) squared distances as per-shard
    partials folded in shard order (``hybrid.device_prep``, which waits
    for them), the host clustering unchanged (``hybrid.cluster``), then
    outcomes and certainty on each shard with the host's reputation."""
    if p.algorithm not in HYBRID_ALGORITHMS:
        raise ValueError(f"algorithm={p.algorithm!r} is not a hybrid one")
    if p.storage_dtype == "int8" or placed.dtype == torch.int8:
        raise ValueError(
            "storage_dtype='int8' is not supported by the hybrid "
            "clustering path: the interpolated fill values are continuous "
            "— use storage_dtype='bfloat16'")
    dev0 = placed.home
    with obs.span("hybrid.device_prep", algorithm=p.algorithm,
                  event_shards=len(placed.mesh)) as sp:
        old_rep = tk.normalize(reputation.to(dev0))
        bounds, scaled0, mins0, maxs0 = _bounds(placed, scaled, mins, maxs)
        parts, presents = _fill_shards(placed, old_rep, bounds, p, True,
                                       True, cast=False)
        m = _Filled(placed, parts, old_rep.dtype)
        sq_dev = sp.observe(_sq_dists(m, parts))
        # the host clusters float64 distances whatever the storage; the
        # device phases after it read the compact filled matrix
        if p.storage_dtype:
            m.parts = [x.to(getattr(torch, p.storage_dtype)) for x in parts]
        del parts
    sq = sq_dev.to("cpu", torch.float64).numpy()
    del sq_dev
    rep, this_rep, iterations, converged = cluster_on_host(sq, old_rep, p)
    acc = old_rep.dtype
    rep_dev = torch.as_tensor(rep, dtype=acc, device=dev0)
    result = {
        "old_rep": old_rep,
        "this_rep": torch.as_tensor(this_rep, dtype=acc, device=dev0),
        "smooth_rep": rep_dev,
        "iterations": torch.tensor(iterations, dtype=torch.int32,
                                   device=dev0),
        "convergence": torch.tensor(converged, device=dev0),
    }
    result.update(_back_half(m, presents, bounds, rep_dev, scaled0, mins0,
                             maxs0, p))
    return result
