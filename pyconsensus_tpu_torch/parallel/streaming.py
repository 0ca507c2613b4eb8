"""Out-of-core consensus (``pyconsensus_tpu/parallel/streaming.py``):
resolve a reports matrix that never sits whole on the device.

The event axis streams from the host (a numpy array, an ``np.memmap``,
an ``.npy`` path loaded memory-mapped, or a ``.csv`` staged to ``.npy``)
in panels of ``panel_events`` columns, because everything the scoring
step needs collapses into R x R accumulators over the event axis (R =
reporters, the small axis). Per event panel ``F_p`` (filled), ``D_p``
(centered) and ``A_p = sqrt(rep) * D_p``:

    G += A_p A_p^T          # weighted Gram: the covariance's spectrum
    M += D_p A_p^T          # gives scores = M u / ||A^T u||
    S += F_p F_p^T          # gives the direction fix in closed form

- the top eigenvector ``u`` of ``G / (1 - sum(rep^2))`` is the Gram-trick
  principal component, and ``||A^T u|| = sqrt(u^T G u)``;
- ``scores = D @ loading = M u / ||A^T u||``;
- the direction fix needs only ``||w^T F - rep^T F||^2 =
  (w - rep)^T S (w - rep)``.

:func:`_pass1_panel` folds one panel into the accumulators,
:func:`_pass2_panel` resolves one panel's outcomes with the final
reputation, and :func:`assemble_light_result` finishes the bonus
accounting on the host (the serve tier's market sessions share all
three). :func:`streaming_consensus` is the driver: one accumulation pass
per executed iteration (G and M follow the iterating reputation; S and
the fill are pinned to the initial one and computed once), then one
resolve pass. By algorithm:

- ``sztorc``, ``fixed-variance`` and ``ica`` score off G, M and S (the
  streamed eigh-gram route; ica whitens and runs FastICA on the (R, k)
  score block);
- ``hierarchical``, ``dbscan`` and ``dbscan-jit`` take the R x R squared
  distances ``S_ii - 2 S_ij + S_jj`` from one S-only pass and cluster on
  the host (the native runtime) or, for dbscan-jit, once on the device;
- ``k-means`` is out-of-core Lloyd: (k, E) centroids on the host, two
  passes a Lloyd iteration, the (R, k) squared distances summed on the
  host panel by panel in panel order.

Device memory holds one panel (and the one prefetched behind it) plus the
three R x R accumulators; host memory holds the E-vectors. The products
are ``torch.matmul`` with TF32 off, as the reference leaves them to XLA
outside any Pallas kernel; no hand-written kernel is on this path.

Several hosts (``n_hosts > 1``): host ``h`` streams panels
``h::n_hosts``; the stacked R x R statistics cross hosts once an
iteration (k-means: its (R, k) accumulator once an assignment pass), and
the disjoint output slices sum in one (6, E) and one (2, R) reduction, so
every host returns the same result. The default reduction gathers over
``torch.distributed`` (:mod:`.distributed`) and sums in host order.

An event mesh (``mesh=``; a grid's first row): each panel, its width
rounded up to a multiple of the event axis as the reference rounds it,
is split into that many equal column blocks, each uploaded to its
device. The column-local work (the fill, the outcomes, the certainty,
the centroid sums, the panel's loading slice) stays on each shard, and
the (R, R) and (R, k) panel contributions and the per-row sums are
added in shard order on the mesh's first device, where the accumulators
live (the (R, R) ones into the accumulators shard by shard, so one
shard's temporaries are alive at a time; the rest through
``mesh.fold``). The round-up's extra columns are masked out like
a ragged tail's. Several hosts compose with it: each host's own devices
shard its panels, and every host rounds by the least common multiple of
the hosts' event axes (one small reduction at the start), so that hosts
with meshes of different widths still tile the events with the same
panels.
"""

from __future__ import annotations

import concurrent.futures
import math
import os
import pathlib
import tempfile
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..faults import plan as _faults
from ..models import clustering as cl
from ..models.ica import _EPS, _canon_signs, _conv_tol, _fastica_one_unit
from ..models.pipeline import ALGORITHMS, ConsensusParams
from ..models.sztorc import _component_weights
from ..ops import numpy_kernels as nk
from ..ops import torch_kernels as tk
from ..ops.constants import DIRFIX_TIE_ATOL
from ..ops.prng import orth_seed
from ..oracle import parse_event_bounds
from .mesh import as_mesh, effective_median_block, fold, refuse_process_mesh
from .sharded import resolve_device

__all__ = ["streaming_consensus", "gram_dirfix", "gram_top_components",
           "gram_warm_pc", "gram_pc_scores", "assemble_light_result",
           "STREAM_EIGH_MAX_R"]

#: R above which the spectrum comes from orthogonal iteration on the
#: explicit Gram accumulator instead of ``torch.linalg.eigh`` (the
#: reference's rule, ``GRAM_EIGH_MAX_R``)
STREAM_EIGH_MAX_R = 4096


def _sym_topk(Gd: torch.Tensor, k: int, n_iters: int = 96,
              tol: float = 1e-7):
    """Top-``k`` eigenpairs of an explicit symmetric PSD matrix by blocked
    orthogonal iteration and a final Rayleigh-Ritz rotation: the fixed-key
    start block (``prng.orth_seed``), the per-column alignment exit, the
    whole-block guard against a zero product's NaN columns, and NaN
    outputs for a non-finite accumulator. Returns ``(eigvals (k,)
    descending clipped, V (R, k))``."""
    R = Gd.shape[0]
    dtype, dev = Gd.dtype, Gd.device
    v0 = torch.from_numpy(np.array(orth_seed(R, k, str(dtype).removeprefix(
        "torch.")))).to(device=dev, dtype=dtype)
    V, _ = torch.linalg.qr(v0)
    for _ in range(n_iters):
        Q, _ = torch.linalg.qr(Gd @ V)
        Q = torch.where(torch.isfinite(Q).all(), Q, V)
        align = torch.abs(torch.sum(Q * V, dim=0))
        V = Q
        if bool(torch.all(align >= 1.0 - tol)):
            break
    H = V.T @ (Gd @ V)
    hvals, W = torch.linalg.eigh((H + H.T) * 0.5)
    order = torch.argsort(hvals, descending=True)
    lam = torch.clamp(hvals[order], min=0.0)
    V = V @ W[:, order]
    finite = torch.all(torch.isfinite(Gd))
    poison = torch.tensor(float("nan"), dtype=dtype, device=dev)
    return (torch.where(finite, lam, poison),
            torch.where(finite, V, poison))


def _pass1_panel(panel, fill_rep, weight_rep, scaled, mins, maxs, valid,
                 tolerance: float, with_s: bool, with_gm: bool = True):
    """One event panel -> its (G, M, S) contributions. ``fill_rep`` is
    the round's initial reputation (the fill, reference semantics),
    ``weight_rep`` the reputation the weighted means and the Gram follow;
    ``valid`` masks a zero-padded panel tail out of every accumulator;
    ``with_s`` False returns a zero S, ``with_gm`` False zero G and M."""
    acc = weight_rep.dtype
    R = panel.shape[0]
    rescaled = tk.rescale(panel, scaled, mins, maxs)
    filled, _ = tk.interpolate_masked(rescaled, fill_rep, scaled, tolerance)
    F = torch.where(valid[None, :], filled, 0.0)
    if with_gm:
        mu = weight_rep @ F
        D = torch.where(valid[None, :], F - mu[None, :], 0.0)
        A = D * torch.sqrt(torch.clamp(weight_rep, min=0.0))[:, None]
        G = A @ A.T
        M = D @ A.T
    else:
        G = M = torch.zeros((R, R), dtype=acc, device=panel.device)
    S = F @ F.T if with_s else torch.zeros_like(G)
    return G, M, S


def _pass2_panel(panel, fill_rep, score_rep, final_rep, u_over_nAu, scaled,
                 mins, maxs, tolerance: float, with_loading: bool = True,
                 median_block: int = tk.MEDIAN_BLOCK):
    """One panel's resolution with the final reputation: ``(raw,
    adjusted, final, certainty, pcol, prow, na_count, loading)`` —
    outcomes, certainty, the reputation mass on absent entries, the
    per-row ``na @ certainty`` partials, the absent counts per row and
    the panel's slice of the first loading (``A^T u / ||A^T u||`` under
    ``score_rep``). The fill is recomputed from ``fill_rep``."""
    acc = final_rep.dtype
    rescaled = tk.rescale(panel, scaled, mins, maxs)
    filled, present = tk.interpolate_masked(rescaled, fill_rep, scaled,
                                            tolerance)
    raw, adjusted = tk.resolve_outcomes(present, filled, final_rep, scaled,
                                        tolerance, median_block=median_block)
    final = tk.unscale_outcomes(adjusted, scaled, mins, maxs)
    agree = torch.where(scaled[None, :],
                        torch.abs(filled - adjusted[None, :]) <= tolerance,
                        filled == adjusted[None, :])
    certainty = torch.sum(agree * final_rep[:, None], dim=0)
    na = (~present).to(acc)
    pcol = final_rep @ na
    prow = na @ certainty
    na_count = torch.sum(na, dim=1)
    if with_loading:
        mu = score_rep @ filled
        A = (filled - mu[None, :]) * torch.sqrt(
            torch.clamp(score_rep, min=0.0))[:, None]
        loading = A.T @ u_over_nAu
    else:
        loading = torch.zeros(panel.shape[1], dtype=acc, device=panel.device)
    return raw, adjusted, final, certainty, pcol, prow, na_count, loading


def _filled_panel(panel, fill_rep, scaled, mins, maxs, tolerance):
    """The panel rescaled and filled from ``fill_rep`` (the scoring
    passes' fill), padding included."""
    rescaled = tk.rescale(panel, scaled, mins, maxs)
    return tk.interpolate_masked(rescaled, fill_rep, scaled, tolerance)[0]


def _kmeans_assign_panel(panel, fill_rep, cent_slice, valid, scaled, mins,
                         maxs, tolerance: float):
    """The (R, k) partial squared distances of every reporter to every
    centroid over one panel, ``sum_e (x_ie - c_je)^2`` by the expansion
    ``|x|^2 - 2 x.c + |c|^2``, the padding masked out."""
    filled = _filled_panel(panel, fill_rep, scaled, mins, maxs, tolerance)
    F = torch.where(valid[None, :], filled, 0.0)
    C = torch.where(valid[None, :], cent_slice, 0.0)
    x2 = torch.sum(F * F, dim=1)
    c2 = torch.sum(C * C, dim=1)
    return x2[:, None] - 2.0 * (F @ C.T) + c2[None, :]


def _kmeans_update_panel(panel, fill_rep, labels, weight_rep, valid, scaled,
                         mins, maxs, tolerance: float, k: int):
    """The numerators of the centroid update over one panel: the
    reputation-weighted and the plain per-cluster sums, each (k, P)."""
    filled = _filled_panel(panel, fill_rep, scaled, mins, maxs, tolerance)
    F = torch.where(valid[None, :], filled, 0.0)
    onehot = (labels[:, None] == torch.arange(k, device=F.device)[None, :]
              ).to(F.dtype)
    return (onehot * weight_rep[:, None]).T @ F, onehot.T @ F


def _fill_rows_panel(panel, fill_rep, rows, scaled, mins, maxs,
                     tolerance: float):
    """The filled values of ``rows`` only: a (k, P) gather on the device,
    so the seeding pass fetches k rows, not the panel."""
    return _filled_panel(panel, fill_rep, scaled, mins, maxs,
                         tolerance)[rows]


def _streaming_kmeans_seeds(panels, fill_rep, E, R, k: int, tol: float):
    """The seed centroids: the filled rows at the evenly spaced seed
    indices, gathered panel by panel into a (k, E) float64 host array.
    They depend only on the pinned fill reputation, so one pass serves
    every iteration. Under several hosts each fills only its own panels'
    slices; the others stay zero and are never read."""
    k = int(min(k, R))
    seeds = torch.as_tensor(cl._seed_indices(R, k), device=fill_rep.device)
    centroids = np.zeros((k, E))
    for start, stop, parts in panels():
        rows = np.concatenate([
            _fill_rows_panel(block, _on(fill_rep, block), _on(seeds, block),
                             sc, mn, mx, tol).cpu().numpy()
            for block, sc, mn, mx, _ in parts], axis=1)
        centroids[:, start:stop] = rows[:, :stop - start]
    return centroids


def _streaming_kmeans_conformity(panels, fill_rep, rep, seed_centroids, P,
                                 k: int, n_iters: int, tol: float,
                                 allreduce=None):
    """Out-of-core Lloyd under ``clustering.kmeans_conformity``'s rules:
    the evenly spaced seeds, first-argmin assignment, the reputation-
    weighted centroid update (an empty cluster keeps its centroid, a
    cluster without reputation mass takes the plain mean), and a final
    assignment against the final centroids. Two passes over the source a
    Lloyd iteration plus the final assignment; the (k, E) centroids stay
    on the host in float64, and the (R, k) squared distances sum there
    panel by panel in panel order.

    Several hosts (``allreduce`` given): a centroid slice derives only
    from the panels of the host that owns it, so the one cross-host state
    is the (R, k) distance accumulator, reduced once an assignment pass.
    Labels, cluster masses and the returned conformity are then the same
    on every host."""
    R = rep.shape[0]
    k = int(min(k, R))
    dtype, dev = rep.dtype, rep.device
    rep_host = rep.cpu().numpy()
    centroids = seed_centroids.copy()

    def assign(cents):
        d2 = np.zeros((R, k))
        for start, stop, parts in panels():
            cent = np.pad(cents[:, start:stop],
                          ((0, 0), (0, P - (stop - start))))
            Q = P // len(parts)
            d2 += fold([_kmeans_assign_panel(
                block, _on(fill_rep, block),
                torch.as_tensor(cent[:, i * Q:(i + 1) * Q], dtype=dtype,
                                device=block.device), valid, sc, mn, mx, tol)
                for i, (block, sc, mn, mx, valid) in enumerate(parts)],
                dev).cpu().numpy()
        if allreduce is not None:         # disjoint event partials
            d2 = _host_array(allreduce(d2))
        return np.argmin(d2, axis=1)

    for _ in range(n_iters):
        labels = assign(centroids)
        onehot = labels[:, None] == np.arange(k)[None, :]
        wsum = (onehot * rep_host[:, None]).sum(axis=0)
        counts = onehot.sum(axis=0)
        labels_dev = torch.as_tensor(labels, device=dev)
        new_centroids = centroids.copy()
        for start, stop, parts in panels():
            sums = [_kmeans_update_panel(
                block, _on(fill_rep, block), _on(labels_dev, block),
                _on(rep, block), valid, sc, mn, mx, tol, k)
                for block, sc, mn, mx, valid in parts]
            w, pl = (np.concatenate([t[i].cpu().numpy() for t in sums],
                                    axis=1)[:, :stop - start]
                     for i in (0, 1))
            new_centroids[:, start:stop] = np.where(
                wsum[:, None] > 0.0,
                w / np.where(wsum > 0.0, wsum, 1.0)[:, None],
                np.where(counts[:, None] > 0.0,
                         pl / np.clip(counts, 1.0, None)[:, None],
                         centroids[:, start:stop]))
        centroids = new_centroids

    labels = assign(centroids)
    onehot = labels[:, None] == np.arange(k)[None, :]
    mass = (onehot * rep_host[:, None]).sum(axis=0)
    return torch.as_tensor(mass[labels], dtype=dtype, device=dev)


def _on(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` on ``like``'s device (itself where it already is)."""
    return t.to(like.device, non_blocking=True)


def _host_array(x) -> np.ndarray:
    """A reduction's result as a float64 host array."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=float)


def gram_dirfix(scores, rep_ref, S):
    """The direction fix in closed form over ``S = F F^T``:
    ``||w^T F - rep^T F||^2 = (w - rep)^T S (w - rep)``, with the same
    normalize guard, banded tie and non-negative winning orientation as
    every other decision site."""
    scores = tk.canon_sign(scores)
    set1 = scores + torch.abs(torch.min(scores))
    set2 = scores - torch.max(scores)

    def sq_dist_to_old(w):
        d = w - rep_ref
        return d @ S @ d

    d1 = sq_dist_to_old(tk.normalize(set1))
    d2 = sq_dist_to_old(tk.normalize(set2))
    return torch.where(d1 - d2 <= DIRFIX_TIE_ATOL * (d1 + d2), set1, -set2)


def _gram_denom(rep_ref):
    denom = 1.0 - torch.sum(rep_ref ** 2)
    return torch.where(denom == 0.0, torch.ones_like(denom), denom)


def gram_warm_pc(G, rep_ref, warm_u, n_iters: int = 96, tol: float = 0.0):
    """Dominant eigenpair of ``Gd = G / (1 - sum(rep^2))`` by power
    iteration warm-started from ``warm_u`` (the previous round's
    principal component), through ``torch_kernels._power_loop``'s warm
    blend: a stale vector cannot pass the exit while it sits on a demoted
    eigenvector, because the cold seed is mixed back in. ``warm_u`` None
    or zero is the cold start bit for bit. Returns ``(u, sweeps)``."""
    Gd = G / _gram_denom(rep_ref)
    return tk._power_loop(lambda v: Gd @ v, G.shape[0], n_iters, tol,
                          G.device, v_init=warm_u, dtype=Gd.dtype)


def gram_pc_scores(G, M, u):
    """Scores and the first-loading operand from one principal component
    of the Gram accumulator: ``||A^T u|| = sqrt(u^T G u)``,
    ``scores = M (u / ||A^T u||)``. Returns ``(scores (R,), u_over_nAu
    (R,), nAu)``."""
    nAu = torch.sqrt(torch.clamp(u @ (G @ u), min=0.0))
    u_over_nAu = u / torch.where(nAu == 0.0, torch.ones_like(nAu), nAu)
    return M @ u_over_nAu, u_over_nAu, nAu


def gram_top_components(G, M, rep_ref, k: int, warm_u=None, delta=None,
                        warm_iters: int = 96, warm_tol: float = 0.0):
    """Top-k scores and explained fractions off the Gram accumulator.
    Returns ``(scores (R, k), explained (k,), U (R, k), nAu (k,))``.
    ``delta = (dG, dM)`` folds an appended block's contributions in
    first; ``warm_u`` (k = 1 only) takes the dominant component from
    :func:`gram_warm_pc` instead of the eigensolver. Above
    ``STREAM_EIGH_MAX_R`` reporters the subspace comes from
    :func:`_sym_topk` and the total variance from ``trace(Gd)``."""
    if delta is not None:
        dG, dM = delta
        G = G + dG
        M = M + dM
    R = G.shape[0]
    Gd = G / _gram_denom(rep_ref)
    if warm_u is not None:
        if k != 1:
            raise ValueError(
                f"gram_top_components: an eigenpair warm start serves "
                f"the dominant component only (k=1), got k={k}")
        u, _ = gram_warm_pc(G, rep_ref, warm_u, n_iters=warm_iters,
                            tol=warm_tol)
        U = u[:, None]
        lam = torch.clamp(u @ (Gd @ u), min=0.0)[None]
        total = torch.clamp(torch.trace(Gd), min=0.0)
        scores_1, _, nAu_1 = gram_pc_scores(G, M, u)
        scores, nAu = scores_1[:, None], nAu_1[None]
    else:
        if R <= STREAM_EIGH_MAX_R:
            # LAPACK refuses a non-finite matrix where XLA's eigh returns
            # NaN: solve a zero matrix instead and poison the outputs, so
            # a non-finite accumulator fails loudly as NaN, as _sym_topk's
            finite = torch.all(torch.isfinite(Gd))
            eigvals, eigvecs = torch.linalg.eigh(
                torch.where(finite, Gd, torch.zeros_like(Gd)))
            poison = torch.full((), float("nan"), dtype=Gd.dtype,
                                device=Gd.device)
            eigvals = torch.where(finite, eigvals, poison)
            eigvecs = torch.where(finite, eigvecs, poison)
            lam = torch.clamp(eigvals.flip(0)[:k], min=0.0)
            U = eigvecs.flip(1)[:, :k]
            total = torch.sum(torch.clamp(eigvals, min=0.0))
        else:
            obs.counter(
                "pyconsensus_streaming_topk_fallback_total",
                "streamed spectra taken via orthogonal iteration instead "
                "of eigh (R > STREAM_EIGH_MAX_R)").inc()
            lam, U = _sym_topk(Gd, k)
            total = torch.clamp(torch.trace(Gd), min=0.0)
        nAu = torch.sqrt(torch.clamp(torch.sum(U * (G @ U), dim=0),
                                     min=0.0))
        scores = M @ (U / torch.where(nAu == 0.0, torch.ones_like(nAu),
                                      nAu)[None, :])
    explained = torch.where(total > 0.0,
                            lam / torch.where(total > 0.0, total,
                                              torch.ones_like(total)),
                            torch.zeros_like(lam))
    return scores, explained, U, nAu


def _default_allreduce(x):
    """The cross-host sum over ``torch.distributed`` (the process group of
    :func:`.distributed.initialize`), in host order
    (:func:`.distributed.allreduce_sum`). ``allreduce=`` replaces it for
    tests and other transports."""
    from .distributed import allreduce_sum

    return allreduce_sum(x)


def _stage_csv(src_path: pathlib.Path, staging_dir) -> pathlib.Path:
    """A per-call staging file for a CSV source: a unique ``mkstemp``
    name (a fixed one would let two resolutions of one CSV truncate each
    other's staging under a memory map), in ``staging_dir`` or beside the
    source (the system temp directory is often a RAM-backed tmpfs, where a
    staging file larger than RAM defeats the out-of-core design), falling
    back to the temp directory only when the source's is not writable."""
    kw = dict(suffix=".npy", prefix=f"{src_path.stem}-stage-")
    try:
        fd, name = tempfile.mkstemp(
            dir=staging_dir if staging_dir is not None else src_path.parent,
            **kw)
    except OSError:
        if staging_dir is not None:
            raise
        fd, name = tempfile.mkstemp(**kw)
    os.close(fd)
    return pathlib.Path(name)


def streaming_consensus(reports_src, reputation=None, event_bounds=None,
                        panel_events: int = 8192,
                        params: Optional[ConsensusParams] = None,
                        mesh=None, host_id: Optional[int] = None,
                        n_hosts: Optional[int] = None, allreduce=None,
                        staging_dir=None, device=None) -> dict:
    """Resolve an oracle whose reports matrix never sits whole on the
    device, panel by panel (see the module docstring). Returns the light
    result dict as host numpy values.

    ``reports_src``: a numpy array, an ``np.memmap``, or the path of an
    ``.npy`` file (memory-mapped) or a ``.csv`` file (staged to a per-call
    ``.npy`` through :func:`..io.csv_to_npy` in ``staging_dir`` or beside
    the source, and removed afterwards, also when staging fails).
    ``device``: where the panels are resolved; None means the card and
    raises without one (``resolve_device``). The working dtype is
    ``torch.get_default_dtype()``.

    ``n_hosts > 1``: this host streams panels ``host_id::n_hosts``
    (``host_id`` defaults to the ``torch.distributed`` rank) and every
    host returns the same full result. ``allreduce`` sums a stacked array
    or tensor across hosts; it defaults to a ``torch.distributed`` gather
    summed in host order, which needs ``n_hosts`` equal to the process
    group's size.

    ``mesh`` (``parallel.mesh.make_mesh``, instead of ``device``): each
    panel event-sharded over the mesh's event axis (a grid's first row),
    its width rounded up to a multiple of that axis (module docstring).
    Under several hosts each host passes its own devices' mesh, and the
    width is rounded by the lcm of every host's axis."""
    if mesh is not None:
        if device is not None:
            raise ValueError("pass either device= or mesh=, not both")
        # each host shards its own panels over its own devices, as the
        # reference's hosts do (pyconsensus_tpu/cli.py:202-209)
        refuse_process_mesh(mesh, "streaming_consensus(mesh=)",
                            "; pass this host's local mesh (make_mesh) "
                            "and split the panels with n_hosts")
        # the prefetch thread uploads to these devices, whatever its own
        # current device is (make_mesh gives every card its index)
        devs = as_mesh(mesh)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs = (dev,)
    staged = None
    is_path = (isinstance(reports_src, (str, bytes))
               or hasattr(reports_src, "__fspath__"))
    if is_path:
        src_path = pathlib.Path(os.fsdecode(reports_src))
        if src_path.suffix == ".csv":
            staged = _stage_csv(src_path, staging_dir)
    try:
        from .. import io as _io

        if staged is not None:
            _io.csv_to_npy(src_path, staged)
            reports_src = _io.load_reports(staged, mmap=True)
        elif is_path:
            reports_src = _io.load_reports(src_path, mmap=True)
        p = params if params is not None else ConsensusParams()
        shape = tuple(getattr(reports_src, "shape", ()))
        with obs.span("streaming.consensus", algorithm=p.algorithm,
                      shape=str(shape), panel_events=int(panel_events),
                      multihost=bool(n_hosts and int(n_hosts) > 1)):
            return _streaming_consensus_impl(reports_src, reputation,
                                             event_bounds, panel_events, p,
                                             host_id, n_hosts, allreduce,
                                             devs)
    finally:
        if staged is not None:
            staged.unlink(missing_ok=True)


def _host_split(host_id, n_hosts, allreduce):
    """``(host_id, n_hosts, allreduce)`` after the reference's
    checks: a host id in range, the default reduction only over a process
    group of ``n_hosts`` processes (fewer would deadlock the surplus
    processes in the collective, more would drop the panels of hosts that
    do not exist), and no ``allreduce`` without a host split."""
    multi = n_hosts is not None and int(n_hosts) > 1
    if not multi:
        if allreduce is not None:
            raise ValueError("allreduce given without n_hosts > 1: the "
                             "multi-host split never engages; pass "
                             "n_hosts (and optionally host_id)")
        return 0, 1, None
    from . import distributed

    if host_id is None:
        host_id = distributed.rank()
    host_id, n_hosts = int(host_id), int(n_hosts)
    if not 0 <= host_id < n_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {n_hosts})")
    if allreduce is None:
        world = distributed.world_size()
        if n_hosts != world:
            raise ValueError(
                f"n_hosts={n_hosts} but the torch.distributed process "
                f"group has {world} process(es); call "
                "parallel.distributed.initialize on every host, or pass a "
                "custom allreduce to use a different host group")
        allreduce = _default_allreduce
    return host_id, n_hosts, allreduce


def _streaming_consensus_impl(reports_src, reputation, event_bounds,
                              panel_events, p: ConsensusParams, host_id,
                              n_hosts, allreduce, devs):
    if reports_src.ndim != 2:
        raise ValueError(f"reports must be 2-D, got {reports_src.shape}")
    R, E = reports_src.shape
    if p.algorithm not in ALGORITHMS:
        raise ValueError(
            f"streaming_consensus: unknown algorithm {p.algorithm!r} "
            f"(every algorithm streams; choose from {ALGORITHMS})")
    P = int(panel_events)
    if P < 1:
        raise ValueError("panel_events must be >= 1")
    dev = devs[0]
    mesh = devs if len(devs) > 1 else None
    host_id, n_hosts, allreduce = _host_split(host_id, n_hosts, allreduce)
    width = len(devs)
    if allreduce is not None:
        # every host rounds by the same width, the lcm of the hosts'
        # event axes, so that their panels tile the events as one
        axes = np.zeros(n_hosts)
        axes[host_id] = width
        width = math.lcm(*(int(a) for a in _host_array(allreduce(axes))))
    P = -(-P // width) * width                    # shardable on every host
    Q = P // len(devs)

    scaled_all, mins_all, maxs_all = parse_event_bounds(event_bounds, E)
    dtype = torch.get_default_dtype()
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    if reputation is None:
        reputation = np.full((R,), 1.0 / R)
    old_rep = nk.normalize(np.asarray(reputation, dtype=float))
    fill_rep = torch.as_tensor(old_rep, dtype=dtype, device=dev)
    tol = float(p.catch_tolerance)
    # the worker thread uploads on the caller's current stream of each
    # card, whichever it is when the call starts: the compute that reads
    # a panel, and the allocator's reuse of a freed panel's block, are
    # then ordered behind its copy
    upload_streams = [torch.cuda.current_stream(d) if d.type == "cuda"
                      else None for d in devs]

    def _prepare(start: int):
        stop = min(start + P, E)
        width = stop - start
        # one host copy: the (strided) column slice cast straight to the
        # working dtype into a contiguous array, never through float64
        block = np.array(reports_src[:, start:stop], dtype=np_dtype,
                         order="C")
        # the chaos hook, on the host before the upload: a poisoned panel
        # must surface as NaN outputs, never as a quiet spectrum
        block = _faults.corrupt("streaming.panel", block)
        if width < P:                            # zero-pad the ragged tail
            block = np.pad(block, ((0, 0), (0, P - width)))
        valid = torch.zeros(P, dtype=torch.bool)
        valid[:width] = True
        sc = np.pad(scaled_all[start:stop], (0, P - width))
        mn = np.pad(mins_all[start:stop], (0, P - width))
        mx = np.pad(maxs_all[start:stop], (0, P - width),
                    constant_values=1.0)
        parts = []
        for i, (d, stream) in enumerate(zip(devs, upload_streams)):
            cols = slice(i * Q, (i + 1) * Q)
            # pageable uploads on the caller's stream (None on the CPU)
            with torch.cuda.stream(stream):
                parts.append((
                    torch.from_numpy(np.ascontiguousarray(block[:, cols]))
                    .to(d), torch.from_numpy(sc[cols]).to(d),
                    torch.as_tensor(mn[cols], dtype=dtype).to(d),
                    torch.as_tensor(mx[cols], dtype=dtype).to(d),
                    valid[cols].to(d)))
        return start, stop, parts

    starts = list(range(0, E, P))[host_id::n_hosts]
    panel_count = obs.counter(
        "pyconsensus_streaming_panels_total",
        "event panels streamed from the source (all passes)")

    def panels():
        """This host's panels in order as ``(start, stop, parts)``, one
        ``(block, scaled, mins, maxs, valid)`` a shard, one panel
        prefetched ahead on a worker thread: the next panel's host read,
        cast and upload overlap the device work on this one. The worker
        is joined on every exit."""
        if not starts:                 # E == 0, or more hosts than panels
            return
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(_prepare, starts[0])
            for nxt in starts[1:]:
                ready = pending.result()
                pending = pool.submit(_prepare, nxt)
                panel_count.inc()
                yield ready
            ready = pending.result()
            panel_count.inc()
            yield ready

    def as_stats(x):
        return torch.as_tensor(x if isinstance(x, torch.Tensor)
                               else np.asarray(x), dtype=dtype, device=dev)

    S = None
    kmeans_seeds = None
    sq_dists = None
    dbscan_same = None
    ica_converged = None
    converged = False
    iterations = 0
    rep_k = this_rep = score_rep = fill_rep
    u_over_nAu = torch.zeros(R, dtype=dtype, device=dev)

    def accumulate_stats(weight_rep, with_s, with_gm=True):
        """One pass over the source: G, M (``with_gm``) and S
        (``with_s``) under ``weight_rep``, in panel order, then reduced
        across hosts in one stacked call; a statistic not asked for is
        None."""
        def zeros(wanted):
            return (torch.zeros((R, R), dtype=dtype, device=dev) if wanted
                    else None)

        G, M, S_acc = zeros(with_gm), zeros(with_gm), zeros(with_s)
        with obs.span("streaming.accumulate_pass", with_s=with_s,
                      with_gm=with_gm) as sp:
            # each shard's contributions added in shard order, one shard
            # at a time, so one shard's (R, R) temporaries are alive
            for _, _, parts in panels():
                for block, sc, mn, mx, valid in parts:
                    dG, dM, dS = _pass1_panel(
                        block, _on(fill_rep, block), _on(weight_rep, block),
                        sc, mn, mx, valid, tol, with_s, with_gm)
                    if with_gm:
                        G += _on(dG, G)
                        M += _on(dM, M)
                    if with_s:
                        S_acc += _on(dS, S_acc)
                    del dG, dM, dS
            sp.observe([x for x in (G, M, S_acc) if x is not None])
        if allreduce is not None:
            stats = ([G, M] if with_gm else []) + ([S_acc] if with_s
                                                  else [])
            reduced = as_stats(allreduce(torch.stack(stats)))
            if with_gm:
                G, M = reduced[0], reduced[1]
            if with_s:
                S_acc = reduced[-1]
        return G, M, S_acc

    for _ in range(max(p.max_iterations, 1)):
        if p.algorithm == "k-means":
            if kmeans_seeds is None:           # fill-pinned: once
                kmeans_seeds = _streaming_kmeans_seeds(
                    panels, fill_rep, E, R, p.num_clusters, tol)
            adj = _streaming_kmeans_conformity(
                panels, fill_rep, rep_k, kmeans_seeds, P, p.num_clusters,
                cl.KMEANS_ITERS, tol, allreduce=allreduce)
        elif p.algorithm in ("hierarchical", "dbscan", "dbscan-jit"):
            if sq_dists is None:
                # fill-pinned, so one S-only pass serves every iteration:
                # ||f_i - f_j||^2 = S_ii - 2 S_ij + S_jj
                _, _, S = accumulate_stats(fill_rep, True, with_gm=False)
                d = torch.diagonal(S)
                sq_dists = torch.clamp(d[:, None] - 2.0 * S + d[None, :],
                                       min=0.0)
                if p.algorithm != "dbscan-jit":  # the host's input
                    sq_dists = sq_dists.cpu().numpy().astype(np.float64)
            if p.algorithm == "dbscan-jit":
                # the propagation is reputation-independent: cluster once
                # on the device, then one matvec an iteration
                if dbscan_same is None:
                    dbscan_same = cl.dbscan_jit_same_matrix(
                        sq_dists, float(p.dbscan_eps),
                        int(p.dbscan_min_samples), dtype)
                adj = dbscan_same @ rep_k
            else:
                placeholder = np.empty((R, 0))
                rep_host = rep_k.cpu().numpy().astype(np.float64)
                if p.algorithm == "hierarchical":
                    adj = cl.hierarchical_conformity(
                        placeholder, rep_host, p.hierarchy_threshold,
                        sq_dists=sq_dists)
                else:
                    adj = cl.dbscan_conformity(
                        placeholder, rep_host, p.dbscan_eps,
                        p.dbscan_min_samples, sq_dists=sq_dists)
                adj = torch.as_tensor(adj, dtype=dtype, device=dev)
        else:
            G, M, S_acc = accumulate_stats(rep_k, S is None)
            if S is None:
                S = S_acc
            if p.algorithm == "sztorc":
                scores_k, _, U, nAu = gram_top_components(G, M, rep_k, 1)
                u_over_nAu = U[:, 0] / torch.where(
                    nAu[0] == 0.0, torch.ones_like(nAu[0]), nAu[0])
                adj = gram_dirfix(scores_k[:, 0], rep_k, S)
            elif p.algorithm == "fixed-variance":
                k = int(min(p.max_components, min(R, E)))
                scores, explained, U, nAu = gram_top_components(G, M,
                                                                rep_k, k)
                w = _component_weights(explained, p.variance_threshold)
                adj = torch.zeros(R, dtype=dtype, device=dev)
                for c in range(k):
                    adj = adj + w[c] * gram_dirfix(scores[:, c], rep_k, S)
                u_over_nAu = U[:, 0] / torch.where(
                    nAu[0] == 0.0, torch.ones_like(nAu[0]), nAu[0])
            else:                                       # ica
                k = max(1, int(min(p.max_components, min(R, E) - 1)))
                scores, _, _, _ = gram_top_components(G, M, rep_k, k)
                std = torch.sqrt(torch.clamp(
                    torch.var(scores, dim=0, correction=0), min=_EPS))
                Z = _canon_signs(scores / std[None, :])
                w_ica, conv = _fastica_one_unit(Z, _conv_tol(Z.dtype))
                ica_converged = bool(conv)
                adj = gram_dirfix(Z @ w_ica, rep_k, S)
            del G, M, S_acc
        this_rep = tk.row_reward_weighted(adj, rep_k)
        new_rep = tk.smooth(this_rep, rep_k, p.alpha)
        delta = float(torch.max(torch.abs(new_rep - rep_k)))
        obs.histogram(
            "pyconsensus_convergence_residual",
            "max-abs reputation change per redistribution iteration",
            labels=("backend",), buckets=obs.MAGNITUDE_BUCKETS).observe(
                delta, backend="streaming")
        score_rep = rep_k
        rep_k = new_rep
        iterations += 1
        if delta <= p.convergence_tolerance:
            converged = True
            break
    smooth_rep = rep_k
    obs.counter(
        "pyconsensus_consensus_total",
        "finished consensus() resolutions",
        labels=("algorithm", "backend", "converged")).inc(
            algorithm=p.algorithm, backend="streaming",
            converged=str(bool(converged)).lower())
    obs.histogram(
        "pyconsensus_consensus_iterations",
        "reputation-redistribution iterations per consensus() call",
        labels=("algorithm", "backend"),
        buckets=obs.ITERATION_BUCKETS).observe(
            iterations, algorithm=p.algorithm, backend="streaming")

    # pass 2, with the final reputation. Zeros, not empty: under several
    # hosts each fills only its own panels' slices, and the sum assembles
    e_out = np.zeros((6, E))     # raw, adjusted, final, certainty, pcols,
    r_out = np.zeros((2, R))     # first loading; prow, na_count
    with_loading = p.algorithm in ("sztorc", "fixed-variance")
    median_block = effective_median_block(p.median_block, mesh)
    with obs.span("streaming.resolve_pass", algorithm=p.algorithm):
        for start, stop, parts in panels():
            outs = list(zip(*(_pass2_panel(
                block, _on(fill_rep, block), _on(score_rep, block),
                _on(smooth_rep, block), _on(u_over_nAu, block), sc, mn, mx,
                tol, with_loading=with_loading, median_block=median_block)
                for block, sc, mn, mx, _ in parts)))
            # the columns joined in shard order; the row sums folded
            raw, adjd, fin, cert, pc, ld = (
                np.concatenate([t.cpu().numpy() for t in outs[i]])
                for i in (0, 1, 2, 3, 4, 7))
            pr, nc = (fold(outs[i], dev).cpu().numpy() for i in (5, 6))
            width = stop - start
            for row, v in enumerate((raw, adjd, fin, cert, 1.0 - pc, ld)):
                e_out[row, start:stop] = v[:width]
            r_out[0] += pr      # padded columns: certainty * na (0) = 0
            r_out[1] += nc
    if allreduce is not None:
        # disjoint slices and zeros elsewhere: the sum is the assembly
        e_out = _host_array(allreduce(e_out))
        r_out = _host_array(allreduce(r_out))
    (outcomes_raw, outcomes_adjusted, outcomes_final, certainty, pcols,
     first_loading) = e_out
    prow, na_count = r_out
    result_extra = ({"first_loading": nk.canon_sign(first_loading)}
                    if with_loading else {})
    if p.algorithm == "ica":
        result_extra["ica_converged"] = bool(ica_converged)
    return assemble_light_result(
        old_rep, this_rep, smooth_rep, na_count, outcomes_raw,
        outcomes_adjusted, outcomes_final, iterations, converged,
        certainty, pcols, prow, result_extra)


def assemble_light_result(old_rep, this_rep, smooth_rep, na_count,
                          outcomes_raw, outcomes_adjusted, outcomes_final,
                          iterations, converged, certainty, pcols, prow,
                          result_extra=None) -> dict:
    """The bonus accounting (numpy semantics) from the panel-accumulated
    host pieces, and the light result dict. ``pcols`` is
    ``participation_columns``; ``prow`` the per-row ``na @ certainty``
    partials. Tensors among the inputs are fetched to the host."""
    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else v

    total_cert = certainty.sum()
    consensus_reward = nk.normalize(certainty)
    participation_rows = 1.0 - (prow if total_cert == 0.0
                                else prow / total_cert)
    percent_na = 1.0 - pcols.mean()
    na_bonus_rows = nk.normalize(participation_rows)
    smooth_np = np.asarray(host(smooth_rep), dtype=float)
    reporter_bonus = (na_bonus_rows * percent_na
                      + smooth_np * (1.0 - percent_na))
    na_bonus_cols = nk.normalize(pcols)
    author_bonus = (na_bonus_cols * percent_na
                    + consensus_reward * (1.0 - percent_na))
    return {
        "old_rep": host(old_rep),
        "this_rep": np.asarray(host(this_rep), dtype=float),
        "smooth_rep": smooth_np,
        "na_row": na_count > 0,
        "outcomes_raw": outcomes_raw,
        "outcomes_adjusted": outcomes_adjusted,
        "outcomes_final": outcomes_final,
        "iterations": iterations,
        "convergence": converged,
        "certainty": certainty,
        "consensus_reward": consensus_reward,
        "avg_certainty": float(certainty.mean()),
        "participation_columns": pcols,
        "participation_rows": participation_rows,
        "percent_na": float(percent_na),
        "na_bonus_rows": na_bonus_rows,
        "reporter_bonus": reporter_bonus,
        "na_bonus_cols": na_bonus_cols,
        "author_bonus": author_bonus,
        **(result_extra or {}),
    }
