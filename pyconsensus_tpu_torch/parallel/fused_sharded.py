"""The event-sharded fused pipeline (``pyconsensus_tpu/parallel/
fused_sharded.py``): sztorc with power iteration over an event mesh, one
controller driving every shard.

Each shard runs only the storage contractions and the column-local
arithmetic on its own device: the fill statistics (``_fill_stats``),
``storage_matvec`` and ``storage_rows_matmat`` for every power sweep and
for the scores pass, and ``resolve_certainty_fused`` for the back half.
Everything (R,)- or (E,)-sized runs once on the mesh's first device: the
power loop (the single-device ``_power_loop``; the reference's
``_sharded_power`` mirrors it), the direction fix, the sign of the
gathered loading, row reward, smooth and the bonuses, through the same
helpers as the single-device path. (E,) vectors are scattered to the
shards and gathered back (``mesh.scatter``/``mesh.gather``); (R,)
partials are summed as a left fold in shard order (``mesh.fold``), never
with atomics or collectives, so a run gives the same bits every time.

As on the TPU, the one-pass covariance application cannot serve a shard:
``t = X v`` is a sum across shards that must be complete before the
second contraction ``X^T (rep t)`` starts, so a sweep is two passes of
the storage with an (R,) fold between them.
"""

from __future__ import annotations

import torch

from .. import obs
from ..models.pipeline import (ROADMAP_BF16, ROADMAP_SCALED_FUSED,
                               ConsensusParams, _assemble,
                               _check_fused_params, _fill_stats, _masked_mu,
                               _redistribute)
from ..ops import torch_kernels as tk
from ..ops.cuda_kernels import (resolve_certainty_fused, storage_matvec,
                                storage_rows_matmat)
from .mesh import EventShards, fold, gather, scatter

__all__ = ["fused_sharded_consensus"]


def fused_sharded_consensus(placed: EventShards, reputation: torch.Tensor,
                            p: ConsensusParams) -> dict:
    """Resolve one oracle with its events sharded over ``placed.mesh``:
    the light result dict on the mesh's first device, with every (E,)
    vector over the real events. ``p`` must already be resolved
    (``sharded_consensus`` does that): sztorc, a power-family PCA
    method, binary events, int8 or float32 storage."""
    _check_fused_params(placed.dtype, p)
    if p.any_scaled or p.n_scaled:
        raise NotImplementedError(f"scaled events on an event mesh: "
                                  f"{ROADMAP_SCALED_FUSED}")
    if "bfloat16" in (p.storage_dtype, p.matvec_dtype):
        raise NotImplementedError(f"bfloat16 on an event mesh: "
                                  f"{ROADMAP_BF16}")
    if p.algorithm != "sztorc":
        raise ValueError(
            "the event-sharded fused path scores with sztorc power "
            f"iteration only; algorithm={p.algorithm!r} must route through "
            "sharded_consensus, which gates on this")
    if p.pca_method not in ("power", "power-fused"):
        raise ValueError(
            "the event-sharded fused path requires a power-family "
            f"pca_method, got {p.pca_method!r}")
    # dispatch only: the span observes nothing, so it adds no wait for the
    # devices (the power loop's own exit tests read the card as ever)
    with obs.span("fused_sharded.dispatch", event_shards=len(placed.mesh),
                  reporters=placed.shape[0], events=placed.n_events):
        return _resolve(placed, reputation, p)


def _resolve(placed: EventShards, reputation: torch.Tensor,
             p: ConsensusParams) -> dict:
    """The body of :func:`fused_sharded_consensus`, under its span."""
    dev0 = placed.mesh[0]
    E = placed.n_events
    old_rep = tk.normalize(reputation.to(dev0))
    acc = old_rep.dtype

    def on_shards(v):
        """An (R,)-sized vector or stack copied to every shard device."""
        return [v.to(s.device, non_blocking=True) for s in placed.shards]

    stats = [_fill_stats(shard, r, p.catch_tolerance, p.storage_dtype)
             for shard, r in zip(placed.shards, on_shards(old_rep))]
    xs = [st[0] for st in stats]
    fills = [st[1] for st in stats]
    fill, tw0, numer0 = (gather([st[i] for st in stats], placed)
                         for i in (1, 2, 3))
    mu1 = numer0 + (torch.sum(old_rep) - tw0) * fill
    xms = [tk.matvec_narrow(x, p.matvec_dtype) for x in xs]

    def matvec(vs):
        """``filled(X) v`` (R,) from the per-shard slices ``vs``."""
        return fold([storage_matvec(x, v, fill=f).to(acc)
                     for x, v, f in zip(xms, vs, fills)], dev0)

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
    outs = [resolve_certainty_fused(x, r, f, total.to(x.device),
                                    float(p.catch_tolerance))
            for x, r, f in zip(xs, on_shards(rep), fills)]
    raw, adjusted, certainty, pcol = (gather([o[i] for o in outs], placed)
                                      for i in range(4))
    prow = fold([o[4].to(acc) for o in outs], dev0)
    narow = fold([o[5] for o in outs], dev0)
    return _assemble(p, old_rep, this_rep, rep, loading, converged, iters,
                     True, raw, adjusted, certainty, pcol, prow, narow)
