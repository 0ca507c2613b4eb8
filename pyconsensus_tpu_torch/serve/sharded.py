"""The mesh-sharded padded buckets (``pyconsensus_tpu/serve/sharded.py``):
the padded bucket path of ``serve/kernels.py`` over a batch x event
grid of devices driven by one controller.

The lanes of a dispatch are data-parallel over the grid's ``"batch"``
rows (lane ``b`` of a key of capacity ``B`` on row ``b // (B / batch)``,
``parallel/mesh.py place_batch_event_shards``), and each row splits the
bucket's events over its ``"event"`` devices, 16-column padded. Within a
row the layout is the fused mesh's (``parallel/fused_sharded.py``):

- column-local, on each shard: rescale, the NA fill and the storage
  cast, the weighted column means, the power sweep's ``X^T (rep t)``
  half, the direction fix's projections, the outcomes (the weighted
  median unblocked, as ``effective_median_block`` says for a mesh), the
  certainty and the participation of each column;
- folded in shard order on the row's first device (``mesh.fold``, never
  atomics): the (n, R) products over the events, which are the sweep's
  ``t = X v``, the scores ``X loading``, each row's ``na @ reward`` and
  the absent rows;
- on the row's first device: the (n, E) iterate and its norm, the power
  loop's exit test, the direction fix's sums, the reputation update and
  every cross-column aggregate, on the gathered (E,) vectors.

The rows run in order on the caller's thread, on its current stream of
each card, and their results are joined on the grid's first device.

The contract (``tests/test_torch_serve_sharded.py``), as the reference's:

- catch-snapped outcomes and iteration counts equal the single-device
  bucket's and a direct ``Oracle(pca_method="power")``'s exactly;
- continuous tails within 1e-9 of them in float64. They are not bit for
  bit: ``ops/lanes.py fsum`` adds entry ``i`` to ``i + n // 2``, so on one
  device contiguous shards combine elementwise before the in-shard sum,
  an order a per-shard sum and a fold cannot reproduce;
- a request gives the same bits alone or in any coalesced batch on the
  same topology: a lane's arithmetic reads its own slices alone.

Pad columns (the bucket's and the shards') are present zeros: their
deviation column is exactly zero, so they add nothing to a fold, and
the validity masks take them out of every cross-column aggregate as on
one device. The routing rule (:func:`sharded_bucket_eligible`): sztorc
on ``"power"``, no int8 storage, the bucket's events divisible over the
event axis and the capacity over the batch axis. Smaller buckets stay on
the single-device path, the low-latency class, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.pipeline import ConsensusParams
from ..ops import torch_kernels as tk
from ..ops.lanes import fsum, guard
from ..parallel.mesh import (fold, gather, make_mesh, mesh_devices,
                             mesh_shape, place_batch_event_shards,
                             refuse_process_mesh, scatter)
from . import kernels as sk

__all__ = ["SINGLE_TOPOLOGY", "serve_mesh", "mesh_fingerprint",
           "topology_event_shards", "topology_n_devices",
           "sharded_bucket_eligible", "make_sharded_bucket_executable",
           "padded_consensus_lane"]

#: the topology fingerprint of a single-device bucket executable (the
#: reference's value): the default BucketKey topology
SINGLE_TOPOLOGY = "single"


def _device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def mesh_fingerprint(mesh) -> str:
    """``"<device-kind>:<batch>x<event>"``, the BucketKey topology of a
    mesh-sharded bucket executable (the kind is the card's name with
    spaces as ``-``, or ``cpu``): an executable built for one layout or
    card is never served on another."""
    b, e = mesh_shape(mesh)
    kind = _device_kind(mesh_devices(mesh)[0]).replace(" ", "-")
    return f"{kind}:{b}x{e}"


def _topology_shape(topology: str):
    if topology == SINGLE_TOPOLOGY:
        return 1, 1
    b, e = topology.rsplit(":", 1)[1].split("x")
    return int(b), int(e)


def topology_event_shards(topology: str) -> int:
    """The event-axis width a BucketKey topology encodes (1 for the
    single-device class): the ``pyconsensus_mesh_event_shards`` value of a
    bucketed dispatch."""
    return _topology_shape(topology)[1]


def topology_n_devices(topology: str) -> int:
    """The devices a BucketKey topology spans (1 for single-device)."""
    b, e = _topology_shape(topology)
    return b * e


def serve_mesh(max_batch: int, devices=None, mesh_batch: int = 0):
    """The serving mesh over ``devices`` (None: every card, raising
    without one), or None for fewer than two devices. ``mesh_batch``
    pins the batch axis; 0 picks 2 x (n/2) when n >= 4 is even and the
    capacity is even (the 2x4 layout on eight devices), else a pure event
    mesh 1 x n, as the reference does."""
    devices = list(devices) if devices is not None else list(make_mesh())
    n = len(devices)
    if n < 2:
        return None
    if mesh_batch:
        batch = int(mesh_batch)
        if n % batch or max_batch % batch:
            raise ValueError(
                f"mesh_batch={batch} must divide both the device count "
                f"({n}) and max_batch ({max_batch})")
    else:
        batch = 2 if (n >= 4 and n % 2 == 0 and max_batch % 2 == 0) else 1
    return make_mesh(batch=batch, event=n // batch, devices=devices)


def sharded_bucket_eligible(events: int, batch_capacity: int,
                            p: ConsensusParams, mesh) -> bool:
    """Whether a (bucket, capacity, params) rides the mesh-sharded
    executable (the one copy of the rule, shared by the service and the
    tests): a mesh, the padded path's params (sztorc, ``"power"``, no
    int8 storage), the bucket's events divisible over the event axis
    and the capacity over the batch axis."""
    if mesh is None:
        return False
    n_batch, n_event = mesh_shape(mesh)
    return (p.algorithm in sk.SERVE_ALGORITHMS
            and p.pca_method == "power"
            and p.storage_dtype != "int8"
            and events % n_event == 0
            and batch_capacity % n_batch == 0)


# -- the lanes of one grid row --------------------------------------------


class _LaneShards:
    """An (n, R, E) lane stack as its event shards (n, R, W_i), with the
    moves between them and the row's first device. ``stack[lanes]``
    selects lanes on every shard (a list of indices, or a bool mask on
    any device)."""

    def __init__(self, shards, placed) -> None:
        self.shards = list(shards)
        self.placed = placed
        self.dev0 = placed.mesh[0]

    def __getitem__(self, lanes) -> "_LaneShards":
        return _LaneShards(
            [s[lanes.to(s.device) if isinstance(lanes, torch.Tensor)
               else lanes] for s in self.shards], self.placed)

    def rows(self, t: torch.Tensor) -> list:
        """A lane tensor without an event axis on every shard's device."""
        return [t.to(s.device, non_blocking=True) for s in self.shards]

    def cols(self, v: torch.Tensor) -> list:
        """An (n, E) lane vector as per-shard (n, W_i) slices."""
        return scatter(v, self.placed, dim=1)

    def gather(self, pieces) -> torch.Tensor:
        return gather(pieces, self.placed)

    def fold(self, pieces) -> torch.Tensor:
        return fold(pieces, self.dev0)

    def dot_rows(self, v: torch.Tensor, acc) -> torch.Tensor:
        """``x @ v`` in every lane, (n, R), folded over the shards."""
        return self.fold([sk._lane_dot_rows(x, vi, acc)
                          for x, vi in zip(self.shards, self.cols(v))])

    def dot_cols(self, w: torch.Tensor, acc) -> torch.Tensor:
        """``w @ x`` in every lane, (n, E) or (n, k, E), gathered."""
        return self.gather([sk._lane_dot_cols(wi, x, acc)
                            for x, wi in zip(self.shards, self.rows(w))])


def _apply_cov(operands, v):
    """``serve/kernels.py _apply_cov`` over the shards: ``t = X v`` folded
    on the first device, ``X^T (rep t)`` gathered there."""
    if len(operands) == 3:
        xc, rep, denom = operands
        t = xc.fold([fsum(x * vi[:, None, :], 2)
                     for x, vi in zip(xc.shards, xc.cols(v))])
        rt = rep * t
        y = xc.gather([fsum(r[:, :, None] * x, 1)
                       for x, r in zip(xc.shards, xc.rows(rt))])
        return y / denom[:, None]
    mm, mu, rep, denom = operands
    acc = rep.dtype
    t = mm.dot_rows(v, acc) - fsum(mu * v, 1)[:, None]
    rt = rep * t
    y = mm.dot_cols(rt, acc) - mu * fsum(rt, 1)[:, None]
    return y / denom[:, None]


def _masked_power_scores(filled: _LaneShards, rep_k, row_valid, seed,
                         v_init, p: ConsensusParams):
    """``serve/kernels.py _masked_power_scores`` over the shards."""
    acc = rep_k.dtype
    mu = filled.gather([fsum(r[:, :, None] * x.to(acc), 1) for x, r in
                        zip(filled.shards, filled.rows(rep_k))])
    denom = guard(1.0 - fsum(rep_k * rep_k, 1))
    mm = _LaneShards([tk.matvec_narrow(x, p.matvec_dtype)
                      for x in filled.shards], filled.placed)
    if mm.shards[0].dtype == acc:
        operands = (_LaneShards([x - m[:, None, :] for x, m in
                                 zip(mm.shards, mm.cols(mu))], mm.placed),
                    rep_k, denom)
    else:
        operands = (mm, mu, rep_k, denom)
    loading, sweeps = sk._lane_power(operands, seed.to(acc), v_init,
                                     p.power_iters, p.power_tol,
                                     apply=_apply_cov)
    scores = (filled.dot_rows(loading, acc)
              - fsum(mu * loading, 1)[:, None])
    scores = torch.where(row_valid, scores, 0.0)
    adj = sk._masked_dirfix(scores, filled, rep_k, row_valid,
                            dot_cols=lambda w, x, a: x.dot_cols(w, a))
    return adj, loading, sweeps


def padded_consensus_lane(reports, reputation, scaled, mins, maxs,
                          row_valid, col_valid, seed, p: ConsensusParams,
                          stats=None) -> dict:
    """The lanes of one grid row: ``serve/kernels.py
    padded_consensus_lanes`` with the events split over the row's event
    mesh (module docstring). ``reports`` is the row's (n, R, E) lane
    stack placed on that mesh (``place_batch_event_shards``); the other
    inputs are bucket-shaped lane stacks on any device. Returns the flat
    result dict on the mesh's first device, every entry with the leading
    lane axis. ``stats`` gains ``"sweeps"`` as on one device."""
    sk._check_bucket_params(p)
    placed = reports
    dev0 = placed.mesh[0]
    X = _LaneShards(placed.shards, placed)
    reputation, row_valid, col_valid, scaled, mins, maxs, seed = (
        a.to(dev0) for a in (reputation, row_valid, col_valid, scaled,
                             mins, maxs, seed))
    dt = reputation.dtype
    old_rep = sk._lane_prior(reputation)
    reps, scs = X.rows(old_rep), X.cols(scaled)
    filled, present = zip(*(
        sk._fill_lanes(x, r, sc, mn, mx, p) for x, r, sc, mn, mx in
        zip(X.shards, reps, scs, X.cols(mins), X.cols(maxs))))
    F = _LaneShards(filled, placed)
    this_rep, rep, loading, iters, converged, sweeps = sk._iterate_lanes(
        F, old_rep, row_valid, seed, p, scores=_masked_power_scores)
    if stats is not None:
        stats["sweeps"] = sweeps
    # column-local given the reputation; the full-width median per shard
    p_shard = p._replace(n_scaled=0, median_block=0)
    reps = F.rows(rep)
    outs = [sk._lane_outcomes(pr, x, r, sc, p_shard)
            for pr, x, r, sc in zip(present, filled, reps, scs)]
    outcomes_raw, outcomes_adjusted = (F.gather([o[i] for o in outs])
                                       for i in (0, 1))
    result = sk._lane_result(old_rep, this_rep, rep, outcomes_raw,
                             outcomes_adjusted, iters, converged, loading,
                             scaled, mins, maxs, p)
    certainty = F.gather([
        sk._lane_certainty(x, r, oa, sc, p) for x, r, oa, sc in
        zip(filled, reps, F.cols(outcomes_adjusted), scs)])
    absent = None
    if p.has_na:
        nas = [(~pr).to(dt) for pr in present]
        absent = (
            F.gather([1.0 - fsum(r[:, :, None] * na, 1)
                      for na, r in zip(nas, reps)]),
            lambda cr: F.fold([fsum(na * c[:, None, :], 2)
                               for na, c in zip(nas, F.cols(cr))]),
            F.fold([(~pr).any(dim=2).to(torch.int32)
                    for pr in present]) > 0)
    result.update(sk._bonuses(certainty, absent, rep, row_valid, col_valid,
                              placed.shards[0].shape[1]))
    return result


def make_sharded_bucket_executable(p: ConsensusParams, mesh,
                                   batched: bool = False,
                                   capacity: Optional[int] = None):
    """A fresh executable for one mesh-topology cache entry, with the
    call signature of ``serve/kernels.py make_bucket_executable``
    (``fn(*bucket_tensors, p)``): unbatched one request, batched a lane
    stack of at most ``capacity`` lanes (the key's batch capacity; None:
    the stack's lane count), lane ``b`` on grid row ``b // (capacity /
    batch)`` (``place_batch_event_shards``). The rows run in order and
    their results are joined on the grid's first device. The operands
    may lie on any device. Building compiles nothing."""
    sk._check_bucket_params(p)
    refuse_process_mesh(mesh, "the mesh-sharded serve buckets")
    built_p = p
    dev0 = mesh_devices(mesh)[0]

    def fn(reports, reputation, scaled, mins, maxs, row_valid, col_valid,
           seed, p):
        if p != built_p:
            raise ValueError(
                f"sharded bucket executable was built for params "
                f"{built_p!r} but called with {p!r}; the cache builds one "
                f"executable per params")
        args = (reports, reputation, scaled, mins, maxs, row_valid,
                col_valid, seed)
        if not batched:
            args = tuple(a[None] for a in args)
        parts = [padded_consensus_lane(placed,
                                       *(a[lo:hi] for a in args[1:]), p)
                 for lo, hi, placed in place_batch_event_shards(
                     args[0], mesh, capacity)]
        out = {k: torch.cat([part[k].to(dev0) for part in parts])
               for k in parts[0]}
        return out if batched else {k: v[0] for k, v in out.items()}

    return fn
