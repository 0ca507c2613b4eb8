"""The event-sharded fused pipeline (``pyconsensus_tpu/parallel/
fused_sharded.py``): sztorc with power iteration over an event mesh, one
controller driving every shard, or every rank of a process mesh driving
its own (``parallel/mesh.py``: there each rank runs the (R,)- and
(E,)-sized work below on the same gathered and folded bits).

Each shard runs only the storage contractions and the column-local
arithmetic on its own device: rescale and the gather of its own scaled
columns, the fill statistics and the storage cast (``_fill_stats``),
``storage_matvec`` and ``storage_rows_matmat`` for every power sweep and
for the scores pass, ``resolve_certainty_fused`` for the back half, and
the gather-median tail of its scaled columns (``_scaled_tail``).
Everything (R,)- or (E,)-sized runs once on the mesh's first device: the
power loop (the single-device ``_power_loop``; the reference's
``_sharded_power`` mirrors it), the direction fix, the sign of the
gathered loading, row reward, smooth and the bonuses, through the same
helpers as the single-device path. (E,) vectors are scattered to the
shards and gathered back (``mesh.scatter``/``mesh.gather``); (R,)
partials are summed as a left fold in shard order (``mesh.fold``), never
with atomics or collectives, so a run gives the same bits every time.

Storage is int8 sentinel storage, float32 or bfloat16 with NaN for
absence, and ``matvec_dtype="bfloat16"`` narrows the sweeps' copy as on
one device. Scaled events (at most E // 8, the front door's gate) need
the float reports: each shard rescales its raw block into a new buffer,
gathers the scaled columns it owns (their indices a host count per
shard, taken once a call), casts, and drops the rescaled buffer. After
resolve, each shard re-resolves its own scaled columns and corrects its
``prow`` part before the fold: no value of a scaled column crosses the
mesh.

As on the TPU, the one-pass covariance application cannot serve a shard:
``t = X v`` is a sum across shards that must be complete before the
second contraction ``X^T (rep t)`` starts, so a sweep is two passes of
the storage with an (R,) fold between them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..models.pipeline import (ConsensusParams, _assemble,
                               _check_fused_params, _fill_stats, _masked_mu,
                               _redistribute, _scaled_tail)
from ..ops import torch_kernels as tk
from ..ops.cuda_kernels import (resolve_certainty_fused, storage_matvec,
                                storage_rows_matmat)
from .mesh import (EventShards, fold, gather, scatter, scatter_bounds,
                   shard_counts)

__all__ = ["fused_sharded_consensus"]


def fused_sharded_consensus(placed: EventShards, reputation: torch.Tensor,
                            p: ConsensusParams, scaled=None, mins=None,
                            maxs=None) -> dict:
    """Resolve one oracle with its events sharded over ``placed.mesh``:
    the light result dict on the mesh's first device, with every (E,)
    vector over the real events. ``p`` must already be resolved
    (``sharded_consensus`` does that): sztorc, a power-family PCA
    method; with ``p.any_scaled``, the (E,) host ``scaled``, ``mins`` and
    ``maxs`` and ``p.n_scaled`` their count."""
    _check_fused_params(placed.dtype, p)
    if p.algorithm != "sztorc":
        raise ValueError(
            "the event-sharded fused path scores with sztorc power "
            f"iteration only; algorithm={p.algorithm!r} must route through "
            "sharded_consensus, which gates on this")
    if p.pca_method not in ("power", "power-fused"):
        raise ValueError(
            "the event-sharded fused path requires a power-family "
            f"pca_method, got {p.pca_method!r}")
    if p.any_scaled and (scaled is None or mins is None or maxs is None):
        raise ValueError("any_scaled=True needs the (scaled, mins, maxs) "
                         "event vectors; sharded_consensus passes them")
    # dispatch only: the span observes nothing, so it adds no wait for the
    # devices (the power loop's own exit tests read the card as ever)
    with obs.span("fused_sharded.dispatch", event_shards=len(placed.mesh),
                  reporters=placed.shape[0], events=placed.n_events):
        return _resolve(placed, reputation, p, scaled, mins, maxs)


def _shard_inputs(placed: EventShards, reps: list, p: ConsensusParams,
                  scaled, mins, maxs) -> list:
    """Per shard: the scaled columns' bounds, indices and gathered
    rescaled reports (None without), and ``_fill_stats``' storage and
    fill. The rescaled float buffer of a shard lives only until its cast
    is made."""
    if p.any_scaled:
        bounds = scatter_bounds(scaled, mins, maxs, placed)
        host = np.asarray(scaled, dtype=bool)
        counts = shard_counts(host, placed)
    out = []
    for i, (shard, r) in enumerate(zip(placed.shards, reps)):
        sc = lo = hi = gathered = idx = None
        if p.any_scaled:
            sc, lo, hi = bounds[i]
            shard = tk.rescale(shard, sc, lo, hi)          # NaN stays NaN
            if counts[i]:
                o, w = placed.local_offsets[i], placed.local_widths[i]
                idx = torch.as_tensor(np.nonzero(host[o:o + w])[0],
                                      device=shard.device)
                gathered = shard.index_select(1, idx)
        x, fill, tw0, numer0 = _fill_stats(shard, r, p.catch_tolerance,
                                           p.storage_dtype, sc)
        del shard
        out.append({"x": x, "fill": fill, "tw0": tw0, "numer0": numer0,
                    "bounds": (sc, lo, hi), "idx": idx,
                    "gathered": gathered})
    return out


def _resolve(placed: EventShards, reputation: torch.Tensor,
             p: ConsensusParams, scaled, mins, maxs) -> dict:
    """The body of :func:`fused_sharded_consensus`, under its span."""
    dev0 = placed.home
    E = placed.n_events
    old_rep = tk.normalize(reputation.to(dev0))
    acc = old_rep.dtype

    def on_shards(v):
        """An (R,)-sized vector or stack copied to every shard device."""
        return [v.to(s.device, non_blocking=True) for s in placed.shards]

    parts = _shard_inputs(placed, on_shards(old_rep), p, scaled, mins,
                          maxs)
    xs = [sh["x"] for sh in parts]
    fills = [sh["fill"] for sh in parts]
    fill, tw0, numer0 = (gather([sh[k] for sh in parts], placed)
                         for k in ("fill", "tw0", "numer0"))
    mu1 = numer0 + (torch.sum(old_rep) - tw0) * fill
    xms = [tk.matvec_narrow(x, p.matvec_dtype) for x in xs]

    def matvec(vs):
        """``filled(X) v`` (R,) from the per-shard slices ``vs``."""
        return fold([storage_matvec(x, v, fill=f).to(acc)
                     for x, v, f in zip(xms, vs, fills)], dev0, placed.mesh)

    def rows_matmat(W):
        """``W filled(X)`` (k, E) for a (k, R) stack on the first
        device."""
        return gather([storage_rows_matmat(x, w, fill=f)
                       for x, w, f in zip(xms, on_shards(W), fills)],
                      placed).to(acc)

    def scores_at(rep_k, mu_k, v_init=None):
        denom = tk._denom(rep_k)

        def apply_cov(v):
            v = v.to(acc)
            rt = rep_k * (matvec(scatter(v, placed)) - mu_k @ v)
            y = rows_matmat(rt[None, :])[0] - mu_k * torch.sum(rt)
            return y / denom

        loading = tk._power_loop(apply_cov, E, p.power_iters, p.power_tol,
                                 dev0, v_init=v_init)[0].to(acc)
        t = matvec(scatter(loading, placed))
        qoc = rows_matmat(torch.stack([t, rep_k, torch.ones_like(t)]))
        return (tk.sztorc_dirfix(t, mu_k @ loading, qoc[0], qoc[2], qoc[1]),
                loading, None)

    def masked_mu(rep_k):
        return gather([_masked_mu(x, f, r)
                       for x, f, r in zip(xs, fills, on_shards(rep_k))],
                      placed)

    rep, this_rep, loading, converged, iters, _ = _redistribute(
        scores_at, masked_mu, old_rep, mu1, (E,), p)
    total = torch.sum(rep)
    cols = [[] for _ in range(5)]           # raw, adjusted, cert, pcol, final
    prows, narows = [], []
    for sh, r in zip(parts, on_shards(rep)):
        raw, adjusted, certainty, pcol, prow, narow = \
            resolve_certainty_fused(sh["x"], r, sh["fill"],
                                    total.to(r.device),
                                    float(p.catch_tolerance))
        raw, adjusted, certainty, prow = (t.to(acc) for t in
                                          (raw, adjusted, certainty, prow))
        final = adjusted
        if sh["gathered"] is not None:
            # the shard's own scaled columns, prow corrected before the fold
            _, lo, hi = sh["bounds"]
            raw, adjusted, certainty, prow, final = _scaled_tail(
                p, sh["gathered"], sh["idx"], r, sh["fill"], lo, hi, raw,
                adjusted, certainty, prow)
        for col, t in zip(cols, (raw, adjusted, certainty, pcol, final)):
            col.append(t)
        prows.append(prow)
        narows.append(narow)
    raw, adjusted, certainty, pcol, final = (gather(c, placed) for c in cols)
    return _assemble(p, old_rep, this_rep, rep, loading, converged, iters,
                     True, raw, adjusted, certainty, pcol,
                     fold(prows, dev0, placed.mesh),
                     fold(narows, dev0, placed.mesh),
                     final if p.any_scaled else None)
