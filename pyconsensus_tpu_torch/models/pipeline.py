"""The consensus pipelines in torch (``pyconsensus_tpu/models/pipeline.py``).

Data flow of one resolution:

    rescale -> fill -> [scoring -> row reward -> smooth] x iterations ->
    outcome resolution -> catch snap -> unscale -> certainty and bonuses

Four pipelines:

- :func:`consensus_np`, the numpy backend: the reference's numpy pipeline,
  bit for bit, for all seven algorithms;
- :func:`_consensus_core`, the plain core over the whole filled matrix
  (the reference's XLA core): the ``JIT_ALGORITHMS`` (sztorc,
  fixed-variance, ica, and the device clustering k-means and
  dbscan-jit), every PCA method, scaled events. :func:`consensus_torch`
  dispatches to it. Its sztorc ``"power-fused"`` arm runs the sweeps on
  ``apply_weighted_cov`` and ``scores_dirfix_pass`` over the dense filled
  matrix;
- :func:`_consensus_hybrid`, the ``HYBRID_ALGORITHMS`` (hierarchical and
  dbscan): rescale, fill and the (R, R) distances on the device, the
  clustering iterations on the host (the native runtime), outcomes and
  certainty on the device again;
- :func:`_consensus_core_fused`, the light fused pipeline on NaN-threaded
  storage (int8 sentinel, or float32 or bfloat16 with NaN), whose filled
  matrix never exists:

      rescale (scaled events) -> fill stats (plain torch, or
      fill_stats_pass under the gate) -> storage cast ->
      [scoring -> row reward -> smooth] x iterations ->
      resolve_certainty_fused -> gather-median tail (scaled events) ->
      bonuses (plain torch)

  Its scoring step is, by algorithm: ``sztorc``, power iteration over
  apply_weighted_cov, then scores_dirfix_pass and the direction fix;
  ``fixed-variance``, orthogonal iteration over apply_weighted_cov_block,
  then one storage_rows_matmat for all k direction fixes, blended by
  explained variance; ``ica``, the same subspace, FastICA on the whitened
  scores, and one storage_rows_matmat for the extracted component's
  direction fix. Every kernel reconstructs absent entries from the
  per-column fill vector. A small minority of scaled events (at most
  E // 8, the front door's gate) rides the binary kernels and is then
  re-resolved on a gather of its columns: the exact weighted median and
  the tolerance-agreement certainty.

The accumulation dtype is the reputation's dtype, as in the reference; the
kernels compute in float32.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..faults.errors import InputError
from ..ops import numpy_kernels as nk
from ..ops import torch_kernels as tk
from ..ops.cuda_kernels import (fill_stats_kernel_fits, fill_stats_pass,
                                resolve_certainty_fused)
from . import clustering as cl
from .ica import ica_k, ica_scores, ica_scores_np, ica_scores_storage
from .sztorc import (fixed_variance_k, fixed_variance_scores,
                     fixed_variance_scores_np, fixed_variance_scores_storage,
                     sztorc_scores, sztorc_scores_np)

__all__ = ["ConsensusParams", "consensus_np", "consensus_torch",
           "encode_reports", "encode_reports_host", "decode_reports",
           "lattice_exact", "looks_encoded", "resolve_encoded",
           "ALGORITHMS", "JIT_ALGORITHMS", "HYBRID_ALGORITHMS",
           "iterate_scores", "cluster_on_host"]

#: the algorithms the fused path scores
FUSED_ALGORITHMS = ("sztorc", "fixed-variance", "ica")
#: the algorithms the plain core scores on the device
JIT_ALGORITHMS = FUSED_ALGORITHMS + ("k-means", "dbscan-jit")
#: the algorithms with a host clustering step (the hybrid path)
HYBRID_ALGORITHMS = ("hierarchical", "dbscan")
#: every algorithm the reference knows
ALGORITHMS = JIT_ALGORITHMS + HYBRID_ALGORITHMS
#: the matvec narrowing casts ("" = none)
MATVEC_DTYPES = ("", "float32", "bfloat16")

#: thread the whitening subspace into iterated ica as the orthogonal
#: iteration's warm start. Off, as in the reference: the warm basis moves
#: ica's near-degenerate bulk columns and FastICA amplifies that, so
#: iterated ica starts cold every iteration. Read once at import.
_ICA_WARM_START = os.environ.get("PYCONSENSUS_ICA_WARM_START", "0") == "1"

#: take the int8 fill statistics from the fill_stats_pass kernel instead of
#: the plain reduction. Off by default, as in the reference; read once at
#: import (launchers set the environment before importing).
_FILL_STATS_KERNEL = os.environ.get(
    "PYCONSENSUS_FILL_STATS_KERNEL", "0") == "1"


class ConsensusParams(NamedTuple):
    """The consensus configuration, field for field the reference's
    ``ConsensusParams`` (same names, same defaults)."""
    algorithm: str = "sztorc"
    alpha: float = 0.1
    catch_tolerance: float = 0.1
    variance_threshold: float = 0.9
    max_components: int = 5
    max_iterations: int = 1
    convergence_tolerance: float = 1e-6
    num_clusters: int = 2
    hierarchy_threshold: float = 0.5
    dbscan_eps: float = 0.5
    dbscan_min_samples: int = 2
    pca_method: str = "auto"
    power_iters: int = 128
    #: power-iteration early-exit tolerance (0 = machine-precision floor,
    #: < 0 = no early exit)
    power_tol: float = 0.0
    matvec_dtype: str = ""
    #: "" keeps the input's float storage (NaN marks absence); "int8"
    #: stores ``round(2 * value)`` with -1 for absence (binary events);
    #: "bfloat16" halves float32's bytes (NaN marks absence)
    storage_dtype: str = ""
    any_scaled: bool = True
    has_na: bool = True
    allow_fused: bool = True
    #: set by the front door when the fused kernel path serves the call
    fused_resolution: bool = False
    n_scaled: int = 0
    median_block: int = 1024


def _le(a: torch.Tensor, bound: float) -> torch.Tensor:
    """``a <= bound`` with the bound rounded to ``a``'s dtype (a weak
    scalar in the reference)."""
    return a <= torch.tensor(bound, dtype=a.dtype, device=a.device)


def _fill_stats(reports: torch.Tensor, reputation: torch.Tensor,
                tolerance: float, storage_dtype: str, scaled=None):
    """Storage encode plus the per-column fill statistics: returns
    ``(x, fill, tw, numer)`` where ``tw`` is the present reputation mass,
    ``numer`` the present reputation-weighted sum and ``fill`` their
    catch-snapped ratio (0.5 for a column with no present mass; the
    ``scaled`` columns keep the raw weighted mean). With
    ``storage_dtype="int8"`` the statistics come from the decoded storage,
    so pre-encoded input and encode-per-resolution give the same bits.
    Float storage takes them from the float reports and casts after them
    (on bfloat16 the values round, the statistics do not)."""
    acc = reputation.dtype
    if storage_dtype == "int8":
        x = reports if reports.dtype == torch.int8 else encode_reports(reports)
        if _FILL_STATS_KERNEL and fill_stats_kernel_fits(x.shape[1], 1):
            tw, numer = fill_stats_pass(x, reputation)
            return (x, *_snap_fill(tw.to(acc), numer.to(acc), tolerance,
                                   scaled))
        # a present entry holds x * 0.5 and an absent one counts 0: clamp
        # the sentinel to 0 and fold the 0.5 into the weights (a power of
        # two, so every product rounds as it would on the decoded value)
        tw = reputation @ (x >= 0).to(acc)
        numer = (0.5 * reputation) @ torch.clamp(x, min=0).to(acc)
        return (x, *_snap_fill(tw, numer, tolerance, scaled))
    na = torch.isnan(reports)
    tw = reputation @ (~na).to(acc)
    zeroed = torch.where(na, torch.zeros((), dtype=reports.dtype,
                                         device=reports.device),
                         reports).to(acc)
    del na
    numer = reputation @ zeroed
    del zeroed
    x = reports.to(getattr(torch, storage_dtype)) if storage_dtype \
        else reports
    return (x, *_snap_fill(tw, numer, tolerance, scaled))


def _snap_fill(tw, numer, tolerance: float, scaled=None):
    """The catch-snapped fill vector from the present-weight stats; the
    ``scaled`` columns (None: none) keep the raw weighted mean. Returns
    ``(fill, tw, numer)``."""
    one = torch.ones_like(tw)
    fill = torch.where(tw > 0.0, numer / torch.where(tw > 0.0, tw, one),
                       torch.full_like(tw, 0.5))
    snapped = tk.catch(fill, tolerance)
    if scaled is not None:
        snapped = torch.where(scaled, fill, snapped)
    return snapped, tw, numer


def encode_reports(reports: torch.Tensor) -> torch.Tensor:
    """int8 sentinel storage of a float report matrix: ``round(2 * value)``
    after clipping to [0, 1] (half to even, as numpy and jax round), ``-1``
    for NaN."""
    na = torch.isnan(reports)
    enc = torch.round(torch.clamp(reports, 0.0, 1.0) * 2.0)
    return torch.where(na, torch.full_like(enc, -1.0), enc).to(torch.int8)


def encode_reports_host(reports) -> np.ndarray:
    """The numpy form of :func:`encode_reports`."""
    reports = np.asarray(reports)
    na = np.isnan(reports)
    return np.where(na, -1, np.round(np.clip(reports, 0.0, 1.0) * 2.0)
                    ).astype(np.int8)


def lattice_exact(reports) -> bool:
    """Whether every value of a float matrix is on the {0, 0.5, 1} lattice
    or NaN (``+0.0`` only), so that decode(encode(x)) gives x back bit for
    bit."""
    a = np.asarray(reports)
    ok = (np.isnan(a) | (a == 0.5) | (a == 1.0)
          | ((a == 0.0) & ~np.signbit(a)))
    return bool(ok.all())


def decode_reports(encoded):
    """Inverse of :func:`encode_reports`: float with NaN for the sentinel
    (float32 for a tensor, float64 for a numpy array)."""
    if isinstance(encoded, torch.Tensor):
        v = encoded.to(torch.float32)
        return torch.where(encoded < 0, torch.full_like(v, float("nan")),
                           v * 0.5)
    encoded = np.asarray(encoded)
    v = encoded.astype(np.float64)
    return np.where(encoded < 0, np.nan, v * 0.5)


def _masked_mu(x: torch.Tensor, fill: torch.Tensor,
               reputation: torch.Tensor) -> torch.Tensor:
    """Weighted column means of the implicitly filled matrix."""
    return reputation @ tk._decode_storage(x, fill, reputation.dtype)


def _subspace_carry_shape(p: ConsensusParams, R: int, E: int):
    """Shape of the warm-start carry between redistribution iterations:
    fixed-variance's (E, k) block, sztorc's (E,) loading, an (E,) vector
    for ica (which runs its whitening cold unless ``_ICA_WARM_START``,
    and then carries nothing), None for the clustering variants."""
    if p.algorithm == "fixed-variance":
        return (E, fixed_variance_k(R, E, p.max_components))
    if p.algorithm == "ica" and _ICA_WARM_START:
        return (E, ica_k(R, E, p.max_components))
    if p.algorithm in ("sztorc", "ica"):
        return (E,)
    return None


def _reported_loading(p: ConsensusParams, loading: torch.Tensor):
    """The (E,) loading the result reports: column 0 of fixed-variance's
    block, the carry itself otherwise."""
    if p.algorithm == "fixed-variance":
        return loading[:, 0]
    return loading


def _check_fused_params(reports_dtype, p: ConsensusParams) -> None:
    """The refusals of the fused path, shared by the single-device and
    the event-sharded pipelines."""
    if reports_dtype == torch.int8 and (p.storage_dtype != "int8"
                                        or p.any_scaled):
        raise ValueError(
            "pre-encoded int8 sentinel reports (encode_reports) require "
            "storage_dtype='int8' and an all-binary workload — got "
            f"storage_dtype={p.storage_dtype!r}, "
            f"any_scaled={p.any_scaled}")
    if p.storage_dtype == "int8" and p.any_scaled:
        raise ValueError(
            "storage_dtype='int8' supports binary/categorical events only: "
            "scaled columns rescale to continuous values in [0, 1] that "
            "the half-unit int8 lattice would corrupt; use "
            "storage_dtype='bfloat16' for scaled workloads")
    if p.algorithm not in FUSED_ALGORITHMS:
        raise ValueError(
            f"the fused path scores {'/'.join(FUSED_ALGORITHMS)} only, got "
            f"algorithm={p.algorithm!r}")


def _redistribute(scores_at, masked_mu, old_rep: torch.Tensor,
                  mu1: torch.Tensor, carry_shape, p: ConsensusParams):
    """The redistribution loop of the fused pipeline, on any layout:
    ``scores_at(rep, mu, v_init)`` returns ``(adj, warm-start carry or
    None, ica flag or None)`` and ``masked_mu(rep)`` the weighted column
    means of the filled matrix. One scoring at ``max_iterations <= 1``;
    otherwise the reference's scan with a freeze-once-converged mask,
    which stops at the first converged state (a frozen step changes
    nothing). Returns ``(rep, this_rep, loading, converged, iterations,
    ica_converged)``; ``loading`` is None when nothing was carried."""
    dev = old_rep.device
    ica_conv = True
    if p.max_iterations <= 1:
        adj, loading, ica_c = scores_at(old_rep, mu1)
        if ica_c is not None:
            ica_conv = ica_c
        this_rep = tk.row_reward_weighted(adj, old_rep)
        rep = tk.smooth(this_rep, old_rep, p.alpha)
        converged = _le(torch.max(torch.abs(rep - old_rep)),
                        p.convergence_tolerance)
        iters = 1
    else:
        rep, this_rep = old_rep, old_rep
        # zeros on iteration 1: the cold start of the power loop and of
        # the orthogonal iteration's blend
        loading = torch.zeros(carry_shape, dtype=old_rep.dtype, device=dev)
        conv, iters = False, 0
        for _ in range(p.max_iterations):
            if conv:
                break
            adj, carry, ica_c = scores_at(rep, masked_mu(rep),
                                          v_init=loading)
            if carry is not None:
                loading = carry
            if ica_c is not None:
                ica_conv = ica_c
            this_rep = tk.row_reward_weighted(adj, rep)
            new_rep = tk.smooth(this_rep, rep, p.alpha)
            delta = torch.max(torch.abs(new_rep - rep))
            rep = new_rep
            iters += 1
            conv = bool(_le(delta, p.convergence_tolerance).item())
        converged = torch.tensor(conv, device=dev)
    iters = torch.tensor(iters, dtype=torch.int32, device=dev)
    return rep, this_rep, loading, converged, iters, ica_conv


def _assemble(p: ConsensusParams, old_rep, this_rep, rep, loading,
              converged, iters, ica_conv, raw, adjusted, certainty, pcol,
              prow, narow, final=None) -> dict:
    """The O(R + E) back half after the resolve sweep (bonuses and the
    light result dict), in the reputation dtype. Every (E,) input covers
    the real events, so the means run over the real event count on any
    layout. ``final``: the unscaled outcomes (None: ``adjusted``, all
    events binary)."""
    acc = rep.dtype
    raw = raw.to(acc)
    adjusted = adjusted.to(acc)
    certainty = certainty.to(acc)
    prow = prow.to(acc)
    participation_columns = (1.0 - pcol).to(acc)
    consensus_reward = tk.normalize(certainty)
    total_cert = torch.sum(certainty)
    participation_rows = 1.0 - torch.where(
        total_cert == 0.0, prow,
        prow / torch.where(total_cert == 0.0, torch.ones_like(total_cert),
                           total_cert))
    percent_na = 1.0 - torch.mean(participation_columns)
    na_bonus_rows = tk.normalize(participation_rows)
    reporter_bonus = na_bonus_rows * percent_na + rep * (1.0 - percent_na)
    na_bonus_cols = tk.normalize(participation_columns)
    author_bonus = (na_bonus_cols * percent_na
                    + consensus_reward * (1.0 - percent_na))
    result = {
        "old_rep": old_rep,
        "this_rep": this_rep,
        "smooth_rep": rep,
        "na_row": narow > 0.0,
        "outcomes_raw": raw,
        "outcomes_adjusted": adjusted,
        "outcomes_final": adjusted if final is None else final.to(acc),
        "iterations": iters,
        "convergence": converged,
        "certainty": certainty,
        "consensus_reward": consensus_reward,
        "avg_certainty": torch.mean(certainty),
        "participation_columns": participation_columns,
        "participation_rows": participation_rows,
        "percent_na": percent_na,
        "na_bonus_rows": na_bonus_rows,
        "reporter_bonus": reporter_bonus,
        "na_bonus_cols": na_bonus_cols,
        "author_bonus": author_bonus,
    }
    if p.algorithm == "ica":                     # ica reports no loading
        result["ica_converged"] = torch.tensor(bool(ica_conv),
                                               device=rep.device)
    else:
        result["first_loading"] = tk.canon_sign(_reported_loading(p,
                                                                  loading))
    return result


def _scaled_tail(p: ConsensusParams, gathered, idx, rep, fill, mins,
                 maxs, raw, adjusted, certainty, prow):
    """The gather-median tail of the fused path
    (``pyconsensus_tpu/models/pipeline.py:858-907``): the kernels'
    catch-snapped means are wrong for the scaled columns, so their
    gathered, rescaled reports (``gathered`` (R, n_scaled), the float
    matrix's bits) are rounded to the storage dtype as the kernels saw
    them, filled, and re-resolved by the exact weighted median and the
    tolerance-agreement certainty; ``prow`` swaps the kernels' certainty
    of those columns for it. O(R * n_scaled). Returns ``(raw, adjusted,
    certainty, prow, final)`` in the reputation dtype, ``final`` unscaled."""
    acc = rep.dtype
    xs = gathered
    if p.storage_dtype:
        xs = xs.to(getattr(torch, p.storage_dtype))
    xs = xs.to(acc)
    pres = ~torch.isnan(xs)
    filled_s = torch.where(pres, xs, fill[idx].to(acc)[None, :])
    del xs
    med = tk.weighted_median_cols(filled_s, rep, pres)
    tw_s = rep @ pres.to(acc)
    out_s = torch.where(tw_s > 0.0, med, raw[idx])
    agree_s = torch.abs(filled_s - out_s[None, :]) <= p.catch_tolerance
    cert_s = rep @ agree_s.to(acc)
    prow = prow + (~pres).to(acc) @ (cert_s - certainty[idx])
    certainty = certainty.index_copy(0, idx, cert_s)
    raw = raw.index_copy(0, idx, out_s)
    adjusted = adjusted.index_copy(0, idx, out_s)           # no catch snap
    final = adjusted.index_copy(0, idx,
                                out_s * (maxs[idx] - mins[idx]) + mins[idx])
    return raw, adjusted, certainty, prow, final


def _consensus_core_fused(reports, reputation, scaled, mins, maxs,
                          p: ConsensusParams) -> dict:
    """The light pipeline on the fused kernel path
    (``pipeline._consensus_core_fused``) for sztorc, fixed-variance and
    ica. With scaled events the reports are rescaled into one new buffer,
    the ``p.n_scaled`` scaled columns gathered from it, and the buffer
    dropped once the storage cast is made; the gather-median tail then
    re-resolves those columns (:func:`_scaled_tail`)."""
    _check_fused_params(reports.dtype, p)
    old_rep = tk.normalize(reputation)
    acc = old_rep.dtype
    gathered = idx = None
    if p.any_scaled:
        reports = tk.rescale(reports, scaled, mins, maxs)    # NaN stays NaN
        if p.n_scaled:
            idx = tk._scaled_index(scaled, p.n_scaled)
            gathered = reports.index_select(1, idx)
    x, fill, tw0, numer0 = _fill_stats(reports, old_rep, p.catch_tolerance,
                                       p.storage_dtype,
                                       scaled if p.any_scaled else None)
    del reports
    full0 = torch.sum(old_rep)
    mu1 = numer0 + (full0 - tw0) * fill
    xs = tk.matvec_narrow(x, p.matvec_dtype)
    R, E = x.shape

    # scores_at returns (adj, warm-start carry or None, ica flag or None)
    if p.algorithm == "sztorc":
        def scores_at(rep_k, mu_k, v_init=None):
            return (*tk.sztorc_scores_power_fused(
                xs, rep_k, p.power_iters, p.power_tol, "", fill=fill,
                mu=mu_k, v_init=v_init), None)
    elif p.algorithm == "fixed-variance":
        def scores_at(rep_k, mu_k, v_init=None):
            return (*fixed_variance_scores_storage(
                xs, fill, mu_k, rep_k, p.variance_threshold,
                p.max_components, v_init=v_init), None)
    else:
        def scores_at(rep_k, mu_k, v_init=None):
            adj, conv, loadings = ica_scores_storage(
                xs, fill, mu_k, rep_k, p.max_components,
                v_init=v_init if _ICA_WARM_START else None)
            return adj, (loadings if _ICA_WARM_START else None), conv

    rep, this_rep, loading, converged, iters, ica_conv = _redistribute(
        scores_at, lambda r: _masked_mu(x, fill, r), old_rep, mu1,
        _subspace_carry_shape(p, R, E), p)
    raw, adjusted, certainty, pcol, prow, narow = resolve_certainty_fused(
        x, rep, fill, torch.sum(rep), float(p.catch_tolerance))
    final = None
    if gathered is not None:
        raw, adjusted, certainty, prow, final = _scaled_tail(
            p, gathered, idx, rep, fill, mins, maxs, raw.to(acc),
            adjusted.to(acc), certainty.to(acc), prow.to(acc))
    return _assemble(p, old_rep, this_rep, rep, loading, converged, iters,
                     ica_conv, raw, adjusted, certainty, pcol, prow, narow,
                     final)


def _consensus_core_light(reports, reputation, scaled, mins, maxs,
                          p: ConsensusParams) -> dict:
    """The light pipeline (no (R, E) outputs): the hybrid path for the
    ``HYBRID_ALGORITHMS``, the fused path where the front door opened it,
    the plain core otherwise."""
    if p.algorithm in HYBRID_ALGORITHMS:
        return _consensus_hybrid(reports, reputation, scaled, mins, maxs,
                                 p, light=True)
    if p.fused_resolution:
        return _consensus_core_fused(reports, reputation, scaled, mins, maxs,
                                     p)
    return _consensus_core(reports, reputation, scaled, mins, maxs, p,
                           light=True)


# -- the plain core and the numpy backend ------------------------------------

def looks_encoded(arr) -> bool:
    """Whether an int8 matrix is provably sentinel storage: it holds a
    ``-1`` (absent) or a ``2`` (an encoded 1.0 vote). A matrix of 0s and
    1s alone reads as raw binary votes or as encoded {0.0, 0.5}."""
    a = np.asarray(arr)
    return bool((a < 0).any() or (a > 1).any())


def resolve_encoded(arr, encoded=None) -> bool:
    """Whether an int8 ``arr`` is sentinel storage. ``encoded`` True or
    False states it (checked against the matrix); None keeps the
    :func:`looks_encoded` reading and warns on the ambiguous all-{0, 1}
    matrix, which it reads as raw votes."""
    a = np.asarray(arr)
    if encoded is not None:
        if encoded and (a > 2).any():
            raise ValueError(
                "encoded=True but the int8 matrix holds values > 2: not "
                "the round(2*value)/-1 sentinel lattice (encode_reports)")
        if not encoded and ((a < 0).any() or (a > 1).any()):
            raise ValueError(
                "encoded=False but the int8 matrix holds values outside "
                "{0, 1}: raw binary votes cannot contain "
                f"{sorted(set(a[(a < 0) | (a > 1)].tolist()))[:4]}; pass "
                "encoded=True (or fix the matrix)")
        return bool(encoded)
    if looks_encoded(a):
        return True
    import warnings

    warnings.warn(
        "int8 reports matrix with every value in {0, 1} is ambiguous: "
        "reading it as RAW binary votes. If it came from encode_reports "
        "(no NaN, no 1.0 vote: its 1 bytes mean 0.5), that reading is "
        "wrong; pass encoded=True/False to state the intent and silence "
        "this warning.", stacklevel=3)
    return False


def _scores_np(filled, rep, p: ConsensusParams):
    """``(adj_scores, loading or None, ica_converged or None)``."""
    algo = p.algorithm
    if algo == "sztorc":
        return (*sztorc_scores_np(filled, rep), None)
    if algo == "fixed-variance":
        return (*fixed_variance_scores_np(filled, rep, p.variance_threshold,
                                          p.max_components), None)
    if algo == "ica":
        adj, conv = ica_scores_np(filled, rep, p.max_components)
        return adj, None, conv
    if algo == "k-means":
        return cl.kmeans_conformity_np(filled, rep, p.num_clusters), None, None
    if algo == "dbscan-jit":
        return cl.dbscan_jit_conformity_np(filled, rep, p.dbscan_eps,
                                           p.dbscan_min_samples), None, None
    if algo == "hierarchical":
        return cl.hierarchical_conformity(filled, rep,
                                          p.hierarchy_threshold), None, None
    if algo == "dbscan":
        return cl.dbscan_conformity(filled, rep, p.dbscan_eps,
                                    p.dbscan_min_samples), None, None
    raise InputError(f"unknown algorithm: {algo!r}")


def consensus_np(reports, reputation, scaled, mins, maxs, p: ConsensusParams):
    """The numpy pipeline (``pipeline.consensus_np``, bit for bit). Returns
    the flat result dict of numpy arrays and Python scalars."""
    if (np.asarray(reports).dtype == np.int8
            and looks_encoded(reports)):
        reports = decode_reports(np.asarray(reports))
    reports = np.asarray(reports, dtype=np.float64)
    old_rep = nk.normalize(np.asarray(reputation, dtype=np.float64))
    scaled = np.asarray(scaled, dtype=bool)
    with obs.span("np.fill", algorithm=p.algorithm):
        n_na = int(np.isnan(reports).sum())
        if n_na:
            obs.counter(
                "pyconsensus_na_fills_total",
                "NaN report cells filled by interpolate, per backend",
                labels=("backend",)).inc(n_na, backend="numpy")
        rescaled = nk.rescale(reports, scaled, mins, maxs)
        filled = nk.interpolate(rescaled, old_rep, scaled, p.catch_tolerance)

    rep = old_rep
    this_rep = old_rep
    loading = None
    ica_converged = None
    converged = False
    iterations = 0
    residual = obs.histogram(
        "pyconsensus_convergence_residual",
        "max-abs reputation change per redistribution iteration",
        labels=("backend",), buckets=obs.MAGNITUDE_BUCKETS)
    with obs.span("np.iterate", algorithm=p.algorithm) as sp:
        for _ in range(max(p.max_iterations, 1)):
            adj, loading, ica_converged = _scores_np(filled, rep, p)
            this_rep = nk.row_reward_weighted(adj, rep)
            new_rep = nk.smooth(this_rep, rep, p.alpha)
            delta = float(np.max(np.abs(new_rep - rep)))
            residual.observe(delta, backend="numpy")
            rep = new_rep
            iterations += 1
            if delta <= p.convergence_tolerance:
                converged = True
                break
        sp.set_attr("iterations", iterations)
        sp.set_attr("converged", converged)

    with obs.span("np.resolve", algorithm=p.algorithm):
        outcomes_raw, outcomes_adjusted = nk.resolve_outcomes(
            rescaled, filled, rep, scaled, p.catch_tolerance)
        outcomes_final = nk.unscale_outcomes(outcomes_adjusted, scaled, mins,
                                             maxs)
        extras = nk.certainty_and_bonuses(rescaled, filled, rep,
                                          outcomes_adjusted, scaled,
                                          p.catch_tolerance)
    result = {
        "original": reports,
        "rescaled": rescaled,
        "filled": filled,
        "old_rep": old_rep,
        "this_rep": this_rep,
        "smooth_rep": rep,
        "na_row": np.isnan(reports).any(axis=1),
        "outcomes_raw": outcomes_raw,
        "outcomes_adjusted": outcomes_adjusted,
        "outcomes_final": outcomes_final,
        "iterations": iterations,
        "convergence": converged,
    }
    result.update(extras)
    if loading is not None:
        result["first_loading"] = nk.canon_sign(loading)
    if p.algorithm == "ica":
        result["ica_converged"] = bool(ica_converged)
    return result


def _scores(filled, rep, p: ConsensusParams, v_init=None, sq_dists=None):
    """``(adj_scores, warm-start carry or None, ica_converged or None)``
    over the dense filled matrix. ``v_init`` warm-starts sztorc's power
    family (its (E,) loading) and fixed-variance's orthogonal iteration
    (its (E, k) block); ica starts cold unless ``_ICA_WARM_START``.
    ``p.matvec_dtype`` narrows sztorc's power sweeps, as in the
    reference. ``sq_dists`` gives dbscan-jit the (R, R) squared distances
    of ``filled``, which do not change between iterations."""
    if p.algorithm == "k-means":
        return (cl.kmeans_conformity(filled, rep, p.num_clusters), None,
                None)
    if p.algorithm == "dbscan-jit":
        return (cl.dbscan_jit_conformity(filled, rep, p.dbscan_eps,
                                         p.dbscan_min_samples,
                                         sq_dists=sq_dists), None, None)
    if p.algorithm == "sztorc":
        return (*sztorc_scores(filled, rep, p.pca_method, p.power_iters,
                               p.power_tol, v_init=v_init,
                               matvec_dtype=p.matvec_dtype), None)
    if p.algorithm == "fixed-variance":
        return (*fixed_variance_scores(filled, rep, p.variance_threshold,
                                       p.max_components, p.pca_method,
                                       v_init=v_init), None)
    adj, conv, loadings = ica_scores(
        filled, rep, p.max_components, p.pca_method,
        v_init=v_init if _ICA_WARM_START else None)
    return adj, (loadings if _ICA_WARM_START else None), conv


def _iterate(filled, old_rep, p: ConsensusParams):
    """The redistribution loop (``pipeline._iterate_jax``) over the dense
    filled matrix: :func:`iterate_scores` with :func:`_scores`.
    dbscan-jit's distances are the same every iteration: one Gram."""
    R, E = filled.shape
    sq = (cl.pairwise_sq_dists(filled.to(old_rep.dtype))
          if p.algorithm == "dbscan-jit" else None)
    return iterate_scores(
        lambda rep, v_init: _scores(filled, rep, p, v_init=v_init,
                                    sq_dists=sq),
        _subspace_carry_shape(p, R, E), old_rep, p)


def iterate_scores(scores, carry_shape, old_rep, p: ConsensusParams):
    """The plain core's redistribution loop on any layout:
    ``scores(rep, v_init)`` returns ``(adj, warm-start carry or None, ica
    flag or None)``; ``carry_shape`` is :func:`_subspace_carry_shape`'s.
    The reference's scan freezes its state once converged; the loop stops
    there instead, which leaves the same state. Returns ``(rep, this_rep,
    loading or None, converged, iterations, ica_converged)``."""
    dev = old_rep.device
    rep, this_rep = old_rep, old_rep
    # zeros on iteration 1: the cold start of both iterations; the
    # clustering variants carry nothing
    loading = (None if carry_shape is None else
               torch.zeros(carry_shape, dtype=old_rep.dtype, device=dev))
    ica_conv, conv, iters = True, False, 0
    for _ in range(max(p.max_iterations, 1)):
        adj, carry, ica_c = scores(rep, loading)
        if carry is not None:
            loading = carry
        if ica_c is not None:
            ica_conv = ica_c
        this_rep = tk.row_reward_weighted(adj, rep)
        new_rep = tk.smooth(this_rep, rep, p.alpha)
        delta = torch.max(torch.abs(new_rep - rep))
        rep = new_rep
        iters += 1
        if bool(_le(delta, p.convergence_tolerance).item()):
            conv = True
            break
    loading = (_reported_loading(p, loading)
               if p.algorithm in ("sztorc", "fixed-variance") else None)
    return (rep, this_rep, loading, torch.tensor(conv, device=dev),
            torch.tensor(iters, dtype=torch.int32, device=dev), ica_conv)


def check_matvec_dtype(matvec_dtype: str) -> None:
    """Refuse a narrowing cast the kernels and the plain core do not
    take."""
    if matvec_dtype not in MATVEC_DTYPES:
        raise ValueError(f"matvec_dtype={matvec_dtype!r}: choose from "
                         f"{MATVEC_DTYPES}")


def _check_plain_params(reports, p: ConsensusParams) -> None:
    if reports.dtype == torch.int8:
        raise ValueError(
            "pre-encoded int8 sentinel reports require the fused path "
            "(storage_dtype='int8'); the plain core needs the float form: "
            "decode_reports(encoded) first")
    if p.storage_dtype == "int8":
        raise ValueError(
            "storage_dtype='int8' requires the fused path (sharded_"
            "consensus with a power-family pca_method and binary events): "
            "the plain core stores the interpolated matrix, whose "
            "continuous fills the half-unit int8 lattice would corrupt")
    check_matvec_dtype(p.matvec_dtype)
    if p.algorithm not in JIT_ALGORITHMS:
        raise InputError(f"algorithm {p.algorithm!r} is not scored by the "
                         f"plain core (hybrid algorithms: "
                         f"{HYBRID_ALGORITHMS})")


def _consensus_core(reports, reputation, scaled, mins, maxs,
                    p: ConsensusParams, light: bool = False) -> dict:
    """The plain core over the whole filled matrix (``pipeline
    ._consensus_core``) for the ``JIT_ALGORITHMS``. ``any_scaled``
    False skips rescale and the median, ``has_na`` False the fill and the
    absent accounting. ``light`` leaves out the (R, E) outputs and drops
    each (R, E) intermediate as soon as nothing reads it. A
    ``storage_dtype`` stores the filled matrix in that dtype (bfloat16:
    one 2-byte buffer): sztorc's ``power-fused`` sweeps it on the kernels
    as it is, every other product reads it in the reputation dtype
    (``torch_kernels._dot``). Returns the flat result dict of tensors."""
    _check_plain_params(reports, p)
    old_rep = tk.normalize(reputation)
    rescaled = (tk.rescale(reports, scaled, mins, maxs) if p.any_scaled
                else reports)
    if p.has_na:
        filled, present = tk.interpolate_masked(rescaled, old_rep, scaled,
                                                p.catch_tolerance)
    else:
        filled, present = rescaled, None
    if p.storage_dtype:
        filled = filled.to(getattr(torch, p.storage_dtype))
    result = ({} if light else
              {"original": reports, "rescaled": rescaled, "filled": filled})
    del rescaled
    rep, this_rep, loading, converged, iters, ica_conv = _iterate(
        filled, old_rep, p)
    outcomes_raw, outcomes_adjusted = tk.resolve_outcomes(
        present, filled, rep, scaled, p.catch_tolerance,
        any_scaled=p.any_scaled, has_na=p.has_na,
        median_block=p.median_block, n_scaled=p.n_scaled)
    result.update({
        "old_rep": old_rep,
        "this_rep": this_rep,
        "smooth_rep": rep,
        "na_row": ((~present).any(dim=1) if p.has_na else
                   torch.zeros(reports.shape[0], dtype=torch.bool,
                               device=reports.device)),
        "outcomes_raw": outcomes_raw,
        "outcomes_adjusted": outcomes_adjusted,
        "outcomes_final": (tk.unscale_outcomes(outcomes_adjusted, scaled,
                                               mins, maxs)
                           if p.any_scaled else outcomes_adjusted),
        "iterations": iters,
        "convergence": converged,
    })
    result.update(tk.certainty_and_bonuses(
        present, filled, rep, outcomes_adjusted, scaled, p.catch_tolerance,
        has_na=p.has_na, any_scaled=p.any_scaled))
    if loading is not None:
        result["first_loading"] = tk.canon_sign(loading)
    if p.algorithm == "ica":
        result["ica_converged"] = torch.tensor(bool(ica_conv),
                                               device=rep.device)
    return result


def _consensus_hybrid(reports, reputation, scaled, mins, maxs,
                      p: ConsensusParams, light: bool = False) -> dict:
    """The hybrid path for hierarchical and dbscan
    (``pipeline._consensus_hybrid``): rescale, fill and the (R, R)
    squared distances on the device (``hybrid.device_prep``, which waits
    for the distances); the clustering iterations on the host against
    those distances in float64 (``hybrid.cluster``), with the O(R)
    reputation updates; outcomes, certainty and bonuses on the device
    with the host's reputation. The filled matrix never leaves the
    device. ``light`` leaves out the (R, E) outputs. Returns the flat
    result dict of tensors."""
    if p.storage_dtype == "int8" or reports.dtype == torch.int8:
        raise ValueError(
            "storage_dtype='int8' is not supported by the hybrid "
            "clustering path: the interpolated fill values are continuous "
            "— use storage_dtype='bfloat16'")
    dev = reports.device
    with obs.span("hybrid.device_prep", algorithm=p.algorithm) as sp:
        old_rep = tk.normalize(reputation)
        rescaled = tk.rescale(reports, scaled, mins, maxs)
        filled, present = tk.interpolate_masked(rescaled, old_rep, scaled,
                                                p.catch_tolerance)
        sq_dev = sp.observe(cl.pairwise_sq_dists(filled))
        # the host clusters float64 distances whatever the storage; the
        # device phases after it read the compact filled matrix
        if p.storage_dtype:
            filled = filled.to(getattr(torch, p.storage_dtype))
    sq = sq_dev.to("cpu", torch.float64).numpy()
    del sq_dev
    rep, this_rep, iterations, converged = cluster_on_host(sq, old_rep, p)
    acc = old_rep.dtype
    rep_dev = torch.as_tensor(rep, dtype=acc, device=dev)
    outcomes_raw, outcomes_adjusted = tk.resolve_outcomes(
        present, filled, rep_dev, scaled, p.catch_tolerance,
        any_scaled=p.any_scaled, has_na=p.has_na,
        median_block=p.median_block, n_scaled=p.n_scaled)
    result = ({} if light else
              {"original": reports, "rescaled": rescaled, "filled": filled})
    result.update({
        "old_rep": old_rep,
        "this_rep": torch.as_tensor(this_rep, dtype=acc, device=dev),
        "smooth_rep": rep_dev,
        "na_row": (~present).any(dim=1),
        "outcomes_raw": outcomes_raw,
        "outcomes_adjusted": outcomes_adjusted,
        "outcomes_final": tk.unscale_outcomes(outcomes_adjusted, scaled,
                                              mins, maxs),
        "iterations": torch.tensor(iterations, dtype=torch.int32,
                                   device=dev),
        "convergence": torch.tensor(converged, device=dev),
    })
    result.update(tk.certainty_and_bonuses(
        present, filled, rep_dev, outcomes_adjusted, scaled,
        p.catch_tolerance, any_scaled=p.any_scaled))
    return result


def cluster_on_host(sq: np.ndarray, old_rep: torch.Tensor,
                    p: ConsensusParams):
    """The hybrid path's host phase (``hybrid.cluster``): the clustering
    iterations against the (R, R) float64 squared distances ``sq``, with
    the O(R) reputation updates in float64. Returns ``(rep, this_rep,
    iterations, converged)``, the reputations as numpy."""
    rep = old_rep.to("cpu", torch.float64).numpy()
    # a shape-only placeholder: with the distances supplied, the host
    # clustering never reads the matrix
    filled_host = np.empty((sq.shape[0], 0))
    this_rep = rep
    converged = False
    iterations = 0
    residual = obs.histogram(
        "pyconsensus_convergence_residual",
        "max-abs reputation change per redistribution iteration",
        labels=("backend",), buckets=obs.MAGNITUDE_BUCKETS)
    with obs.span("hybrid.cluster", algorithm=p.algorithm) as sp:
        for _ in range(max(p.max_iterations, 1)):
            if p.algorithm == "hierarchical":
                adj = cl.hierarchical_conformity(
                    filled_host, rep, p.hierarchy_threshold, sq_dists=sq)
            else:
                adj = cl.dbscan_conformity(filled_host, rep, p.dbscan_eps,
                                           p.dbscan_min_samples, sq_dists=sq)
            this_rep = nk.row_reward_weighted(adj, rep)
            new_rep = nk.smooth(this_rep, rep, p.alpha)
            delta = float(np.max(np.abs(new_rep - rep)))
            residual.observe(delta, backend="hybrid")
            rep = new_rep
            iterations += 1
            if delta <= p.convergence_tolerance:
                converged = True
                break
        sp.set_attr("iterations", iterations)
        sp.set_attr("converged", converged)
    return rep, this_rep, iterations, converged


def consensus_torch(reports, reputation, scaled, mins, maxs,
                    p: ConsensusParams, device=None,
                    light: bool = False) -> dict:
    """The plain core, or the hybrid path for the ``HYBRID_ALGORITHMS``,
    on ``device`` (None: the card, which must be sm_90) in the default
    float dtype (``torch.get_default_dtype()``), from host or device
    inputs; a pre-encoded int8 matrix is decoded first. Returns the flat
    result dict of tensors on the device (``light``: without the (R, E)
    ones). The plain core's ``pipeline.dispatch`` span measures the
    dispatch and observes nothing, so it adds no wait for the device; the
    hybrid path's waits for the distances it fetches."""
    from ..ops.cuda_kernels import require_hopper
    from ..parallel.sharded import resolve_device

    dev = resolve_device(device)
    require_hopper(dev)
    dtype = torch.get_default_dtype()
    if not isinstance(reports, torch.Tensor):
        reports = np.asarray(reports)
        if reports.dtype == np.int8 and looks_encoded(reports):
            reports = decode_reports(reports)
    elif reports.dtype == torch.int8 and looks_encoded(reports.cpu()):
        reports = decode_reports(reports)

    def put(a, dt):
        return torch.as_tensor(a).to(device=dev, dtype=dt)

    hybrid = p.algorithm in HYBRID_ALGORITHMS
    core = _consensus_hybrid if hybrid else _consensus_core
    with obs.span("pipeline.dispatch", algorithm=p.algorithm,
                  path="hybrid" if hybrid else "plain"):
        return core(put(reports, dtype), put(reputation, dtype),
                    put(scaled, torch.bool), put(mins, dtype),
                    put(maxs, dtype), p, light=light)
