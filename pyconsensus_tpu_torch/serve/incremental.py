"""The ``bucket_incremental`` serve class
(``pyconsensus_tpu/serve/incremental.py``): O(update) marginal resolves
for warm market sessions.

An appended event block is a low-rank update to the reputation-weighted
Gram accumulator a session already keeps (``append`` folds each block's
``_pass1_panel`` contribution), and the previous round's principal
component is an excellent warm start for the next round's spectrum. So
the dominant eigenpair is maintained across rounds by warm-started power
iteration (:func:`..parallel.streaming.gram_warm_pc`, a few O(R^2)
matvecs) instead of an O(R^3) eigensolve per resolve.

This module is the class's executable: :func:`incremental_consensus` —
the warm power iteration, then the identical ``gram_dirfix`` /
row-reward / smooth arithmetic of the exact statistics path — keyed in
the executable cache by ``kernel_path="incremental"`` (rows = the
session's roster R, events = 0: it consumes R x R statistics, never a
panel). It is plain torch and launches none of the port's kernels.

**The staleness contract**: warm power iteration converges to the
dominant eigenvector, not to the eigensolver's bits, so continuous
outputs drift from the exact resolve of the same statistics by at most
:func:`incremental_drift_band`; snapped outcomes are generically
identical. An exact resolve every K rounds
(``ServeConfig.incremental_refresh_every``) re-anchors the warm state.
A warm resolve is a pure function of (G, M, S, reputation, warm_u,
params).
"""

from __future__ import annotations

import threading

import torch

from .. import obs
from ..models.pipeline import ConsensusParams
from ..ops import torch_kernels as tk
from ..parallel.streaming import gram_dirfix, gram_pc_scores, gram_warm_pc

__all__ = ["INCREMENTAL_KERNEL_PATH", "INCREMENTAL_REFRESH_DEFAULT",
           "INCREMENTAL_POWER_ITERS", "incremental_drift_band",
           "incremental_consensus", "make_incremental_executable",
           "incremental_executable", "incremental_params",
           "kernel_path_counter"]

#: BucketKey.kernel_path of the incremental executable family
INCREMENTAL_KERNEL_PATH = "incremental"

#: default exact-refresh cadence: one exact (eigh) resolve anchors every
#: K-round cycle; the K - 1 resolves between anchors ride the warm kernel
INCREMENTAL_REFRESH_DEFAULT = 4

#: warm power-iteration sweep cap: with a strong eigengap the alignment
#: exit fires in tens of sweeps; the cap bounds the weak-gap tail
INCREMENTAL_POWER_ITERS = 512


def incremental_drift_band(dtype) -> float:
    """The documented staleness band: the largest absolute drift of a
    warm resolve's continuous outputs (reputations, certainty, bonuses,
    loadings) from the exact resolve of the same statistics, by the
    accumulation dtype: 1e-6 in float64, 2e-3 in float32. Snapped
    outcomes are not covered by a band: the snap tolerances absorb
    eigenvector noise far above these levels."""
    eps = float(torch.finfo(dtype).eps)
    return 1e-6 if eps < 1e-9 else 2e-3


def incremental_params(alpha: float, catch_tolerance: float,
                       convergence_tolerance: float) -> ConsensusParams:
    """The resolved params of a ``bucket_incremental`` executable: the
    session statistics path's scope (sztorc, one scoring iteration) with
    the session's knobs threaded in."""
    return ConsensusParams(
        algorithm="sztorc", pca_method="power", max_iterations=1,
        alpha=float(alpha), catch_tolerance=float(catch_tolerance),
        convergence_tolerance=float(convergence_tolerance),
        power_iters=INCREMENTAL_POWER_ITERS, power_tol=0.0,
        has_na=True, any_scaled=False, n_scaled=0)


def incremental_consensus(G, M, S, reputation, warm_u,
                          p: ConsensusParams) -> dict:
    """One marginal scoring step off a session's statistics: the dominant
    eigenpair by warm-started power iteration, then the decision
    arithmetic of the exact statistics path (``gram_dirfix`` against S,
    the weighted row reward, the alpha-smooth). Returns ``this_rep``,
    ``smooth_rep``, ``u`` (the next round's warm start), ``u_over_nAu``
    (the first-loading operand of ``_pass2_panel``), ``sweeps``,
    ``delta`` (the largest reputation move) and ``warm_alignment``
    (``|<u, warm_u>|``)."""
    rep0 = reputation
    u, sweeps = gram_warm_pc(G, rep0, warm_u, n_iters=p.power_iters,
                             tol=p.power_tol)
    scores, u_over_nAu, _ = gram_pc_scores(G, M, u)
    adj = gram_dirfix(scores, rep0, S)
    this_rep = tk.row_reward_weighted(adj, rep0)
    smooth_rep = tk.smooth(this_rep, rep0, p.alpha)
    delta = torch.max(torch.abs(smooth_rep - rep0))
    warm = warm_u.to(u.dtype)
    wn = torch.linalg.vector_norm(warm)
    warm_alignment = torch.abs(torch.dot(
        u, warm / torch.where(wn == 0.0, torch.ones_like(wn), wn)))
    return {"this_rep": this_rep, "smooth_rep": smooth_rep, "u": u,
            "u_over_nAu": u_over_nAu, "sweeps": sweeps, "delta": delta,
            "warm_alignment": warm_alignment}


def make_incremental_executable(p: ConsensusParams):
    """A fresh executable for one ``bucket_incremental`` cache entry:
    ``fn(G, M, S, reputation, warm_u, p)``."""

    def fn(G, M, S, reputation, warm_u, p: ConsensusParams = p):
        return incremental_consensus(G, M, S, reputation, warm_u, p)

    return fn


#: process-wide default executables for sessions living outside a
#: ``ConsensusService``; the key space is the few (alpha, tolerance)
#: combinations a deployment configures
_DEFAULT_EXECUTABLES: dict = {}
_DEFAULT_LOCK = threading.Lock()


def incremental_executable(p: ConsensusParams):
    """The shared default executable for ``p``: sessions built without an
    ``executable_provider`` resolve through here; a ``ConsensusService``
    injects a provider routing through its LRU executable cache."""
    with _DEFAULT_LOCK:
        fn = _DEFAULT_EXECUTABLES.get(p)
        if fn is None:
            fn = _DEFAULT_EXECUTABLES[p] = make_incremental_executable(p)
        return fn


def kernel_path_counter():
    """The kernel-family counter's one registration site (the batcher and
    the session's warm path both count through here)."""
    return obs.counter(
        "pyconsensus_kernel_path_total",
        "resolutions dispatched by kernel family (which kernel family "
        "actually served traffic)", labels=("path",))
