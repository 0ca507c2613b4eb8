"""Explicit ring collectives over an event mesh
(``pyconsensus_tpu/parallel/ring.py``), one controller driving every
shard.

The mesh's own sums are left folds in shard order on the first device
(``mesh.fold``). This module is the hand-written alternative the
reference keeps beside its GSPMD path: a bandwidth-optimal ring
all-reduce whose panels of R/n rows hop from each shard to its neighbour
by device-to-device copies.

- **Reduce-scatter, then all-gather** (:func:`ring_allreduce`): n - 1
  hops leave each device the full sum of one panel, n - 1 more circulate
  the finished panels; each hop moves 1/n of the partial, so a device
  sends 2(n - 1)/n of it in all.
- **A fixed order**: panel c is summed as the left fold ``x_c + x_{c+1}
  + ... + x_{c-1}`` (shard indices mod n), the same bits on every run.
  Panel 0 folds in shard order and equals ``mesh.fold``'s bits; the other
  panels start at their own shard, so the plain mesh core keeps
  ``mesh.fold`` and the ring stands alone, as in the reference.

:func:`ring_gram`, :func:`ring_matvec` and :func:`ring_first_pc` are the
reference's entry points over :class:`~.mesh.EventShards`; each returns
its result on the mesh's first device. ``ring_gram`` and ``ring_matvec``
count ``pyconsensus_ring_collective_hops_total`` and
``pyconsensus_ring_collective_bytes_total`` (label ``op``), as the
reference does.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .mesh import (EventShards, as_mesh, gather, place_event_shards,
                   refuse_process_mesh, scatter)

__all__ = ["ring_allreduce", "ring_gram", "ring_matvec", "ring_first_pc"]


def _record_ring(op: str, payload_elems: int, itemsize: int, n: int) -> None:
    """One ring all-reduce in wire terms: 2(n - 1) hops moving 1/n of the
    payload each, 2(n - 1)/n of the tensor per device."""
    if n <= 1:
        return
    from .. import obs

    obs.counter(
        "pyconsensus_ring_collective_hops_total",
        "ppermute hops dispatched by the explicit ring collectives",
        labels=("op",)).inc(2 * (n - 1), op=op)
    obs.counter(
        "pyconsensus_ring_collective_bytes_total",
        "per-device wire bytes dispatched by the explicit ring "
        "collectives (2(n-1)/n of the payload)",
        labels=("op",)).inc(
            int(payload_elems * itemsize * 2 * (n - 1) / n), op=op)


def ring_allreduce(parts: Sequence[torch.Tensor]) -> list:
    """The ring all-reduce of per-shard partials: ``parts[i]``, all of one
    shape, on shard i's device. Returns the full sum on every shard's
    device (``[sum on device 0, sum on device 1, ...]``). The leading axis
    is split into n panels, padded with zero rows to a multiple of n."""
    n = len(parts)
    if n == 1:
        return [parts[0]]
    devs = [p.device for p in parts]
    shape = parts[0].shape
    lead = shape[0] if shape else 1
    flat = [p.reshape(lead, -1) for p in parts]
    cols = flat[0].shape[1]
    pad = (-lead) % n
    if pad:
        flat = [torch.cat([f, f.new_zeros((pad, cols))]) for f in flat]
    chunks = [f.reshape(n, -1, cols) for f in flat]
    # reduce-scatter: device d starts the panel d with its own part; each
    # hop it takes its predecessor's running panel and adds its own part
    running = [chunks[d][d] for d in range(n)]
    for k in range(n - 1):
        moved = [running[(d - 1) % n].to(devs[d], non_blocking=True)
                 for d in range(n)]
        running = [moved[d] + chunks[d][(d - k - 1) % n] for d in range(n)]
    # device d now owns the finished panel (d + 1) % n; all-gather
    out = [[None] * n for _ in range(n)]
    owner = [(d + 1) % n for d in range(n)]
    for d in range(n):
        out[d][owner[d]] = running[d]
    moving = running
    for _ in range(n - 1):
        moving = [moving[(d - 1) % n].to(devs[d], non_blocking=True)
                  for d in range(n)]
        owner = [owner[(d - 1) % n] for d in range(n)]
        for d in range(n):
            out[d][owner[d]] = moving[d]
    return [torch.cat(o)[:lead].reshape(shape) for o in out]


def _placed(A, mesh) -> EventShards:
    refuse_process_mesh(A, "the explicit ring")
    refuse_process_mesh(mesh, "the explicit ring")
    if isinstance(A, EventShards):
        return A
    if mesh is None:
        raise ValueError("a matrix that is not EventShards needs mesh=")
    t = torch.as_tensor(A)
    return place_event_shards(t, as_mesh(mesh), dtype=t.dtype)


def ring_gram(A, mesh=None) -> torch.Tensor:
    """``G = A A^T`` for an (R, E) matrix sharded over the events
    (:class:`~.mesh.EventShards`, or a matrix placed on ``mesh``): each
    shard's (R, R) partial, combined by :func:`ring_allreduce`. Returns G
    on the mesh's first device."""
    placed = _placed(A, mesh)
    R = placed.shape[0]
    _record_ring("gram", R * R, placed.shards[0].element_size(),
                 len(placed.mesh))
    return ring_allreduce([a @ a.T for a in placed.shards])[0]


def ring_matvec(A, v: torch.Tensor, mesh=None) -> torch.Tensor:
    """``t = A v`` for A (R, E) sharded over the events and v (E,): the
    local products and a ring all-reduce of the (R,) partials. Returns t
    on the mesh's first device."""
    placed = _placed(A, mesh)
    v = torch.as_tensor(v).to(device=placed.mesh[0], dtype=placed.dtype)
    _record_ring("matvec", placed.shape[0], placed.shards[0].element_size(),
                 len(placed.mesh))
    return ring_allreduce([a @ w for a, w in
                           zip(placed.shards, scatter(v, placed))])[0]


def ring_first_pc(reports_filled, reputation, mesh=None, n_iters: int = 128,
                  tol: float = 0.0):
    """First principal component of the reputation-weighted covariance
    with every cross-shard sum on the ring (the Gram trick of
    ``torch_kernels._first_pc_eigh_gram``): the columns centered on each
    shard, the (R, R) Gram by :func:`ring_gram`, its top eigenvector
    mapped back shard by shard, the loading's norm by one scalar ring
    all-reduce, the scores by :func:`ring_matvec`. ``n_iters`` and
    ``tol`` are taken for the reference's signature and unused (the Gram
    eigh is closed-form). Returns ``(loading (E,), scores (R,))`` on the
    mesh's first device, the sign arbitrary."""
    placed = _placed(reports_filled, mesh)
    dtype = placed.dtype
    rep = torch.as_tensor(reputation).to(device=placed.mesh[0], dtype=dtype)
    reps = [rep.to(x.device) for x in placed.shards]
    devs = [x - (r @ x)[None, :] for x, r in zip(placed.shards, reps)]
    denom = 1.0 - torch.sum(rep ** 2)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    As = [d * torch.sqrt(torch.clamp(r, min=0.0))[:, None]
          for d, r in zip(devs, reps)]
    G = ring_gram(placed._replace(shards=tuple(As))) / denom
    u = torch.linalg.eigh(G)[1][:, -1]
    vs = [a.T @ u.to(a.device) for a in As]
    sq = ring_allreduce([torch.sum(v ** 2)[None] for v in vs])
    vs = [v / torch.where(s == 0.0, torch.ones_like(s), torch.sqrt(s))
          for v, s in zip(vs, sq)]
    loading = gather(vs, placed)
    scores = ring_matvec(placed._replace(shards=tuple(devs)), loading)
    return loading, scores
