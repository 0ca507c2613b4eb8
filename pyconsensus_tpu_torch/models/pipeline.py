"""The light fused consensus pipeline in torch
(``pyconsensus_tpu/models/pipeline.py``, fused sztorc branch).

Data flow of one resolution on NaN-threaded storage (int8 sentinel or
float with NaN):

    fill stats (plain torch) -> [power iteration over apply_weighted_cov
    -> scores_dirfix_pass -> direction fix -> row reward -> smooth]
    x iterations -> resolve_certainty_fused -> bonuses (plain torch)

The filled matrix never exists: every kernel reconstructs absent entries
from the per-column fill vector. The accumulation dtype is the
reputation's dtype, as in the reference; the kernels compute in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import torch_kernels as tk
from ..ops.cuda_kernels import resolve_certainty_fused

__all__ = ["ConsensusParams", "encode_reports", "encode_reports_host",
           "decode_reports", "lattice_exact", "ROADMAP_SCALED",
           "ROADMAP_PLAIN"]

#: where the parts this slice refuses are queued (ROADMAP.md section A)
ROADMAP_PLAIN = ("ROADMAP.md §A.2 (plain Oracle/_consensus_core: eigh PCA, "
                 "the XLA-path pipeline and every other algorithm)")
ROADMAP_SCALED = ("ROADMAP.md §A.2 (scaled events: rescale and the "
                  "weighted-median tail)")


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
    #: stores ``round(2 * value)`` with -1 for absence (binary events)
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
                tolerance: float, storage_dtype: str):
    """Storage encode plus the per-column fill statistics: returns
    ``(x, fill, tw, numer)`` where ``tw`` is the present reputation mass,
    ``numer`` the present reputation-weighted sum and ``fill`` their
    catch-snapped ratio (0.5 for a column with no present mass). With
    ``storage_dtype="int8"`` the statistics come from the decoded storage,
    so pre-encoded input and encode-per-resolution give the same bits."""
    acc = reputation.dtype
    if storage_dtype == "int8":
        x = reports if reports.dtype == torch.int8 else encode_reports(reports)
        # a present entry holds x * 0.5 and an absent one counts 0: clamp
        # the sentinel to 0 and fold the 0.5 into the weights (a power of
        # two, so every product rounds as it would on the decoded value)
        tw = reputation @ (x >= 0).to(acc)
        numer = (0.5 * reputation) @ torch.clamp(x, min=0).to(acc)
        return (x, *_snap_fill(tw, numer, tolerance))
    na = torch.isnan(reports)
    x = reports.to(getattr(torch, storage_dtype)) if storage_dtype \
        else reports
    zeroed = torch.where(na, torch.zeros((), dtype=reports.dtype,
                                         device=reports.device),
                         reports).to(acc)
    tw = reputation @ (~na).to(acc)
    numer = reputation @ zeroed
    return (x, *_snap_fill(tw, numer, tolerance))


def _snap_fill(tw, numer, tolerance: float):
    """The catch-snapped fill vector from the present-weight stats.
    Returns ``(fill, tw, numer)``."""
    one = torch.ones_like(tw)
    fill = torch.where(tw > 0.0, numer / torch.where(tw > 0.0, tw, one),
                       torch.full_like(tw, 0.5))
    return tk.catch(fill, tolerance), tw, numer


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


def _consensus_core_fused(reports, reputation, scaled, mins, maxs,
                          p: ConsensusParams) -> dict:
    """The light pipeline on the fused kernel path, sztorc branch
    (``pipeline._consensus_core_fused``). ``scaled``/``mins``/``maxs`` are
    accepted for the reference's signature; scaled events raise."""
    if reports.dtype == torch.int8 and (p.storage_dtype != "int8"
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
            "the half-unit int8 lattice would corrupt")
    if p.any_scaled or p.n_scaled:
        raise NotImplementedError(f"scaled events are not ported yet: "
                                  f"{ROADMAP_SCALED}")
    if p.algorithm != "sztorc":
        raise NotImplementedError(
            f"the fused path of this port scores sztorc only, got "
            f"algorithm={p.algorithm!r}: {ROADMAP_PLAIN}")
    old_rep = tk.normalize(reputation)
    acc = old_rep.dtype
    x, fill, tw0, numer0 = _fill_stats(reports, old_rep, p.catch_tolerance,
                                       p.storage_dtype)
    full0 = torch.sum(old_rep)
    mu1 = numer0 + (full0 - tw0) * fill
    xs = tk.matvec_narrow(x, p.matvec_dtype)
    E = x.shape[1]

    def scores_at(rep_k, mu_k, v_init=None):
        return tk.sztorc_scores_power_fused(
            xs, rep_k, p.power_iters, p.power_tol, "", fill=fill, mu=mu_k,
            v_init=v_init)

    if p.max_iterations <= 1:
        adj, loading = scores_at(old_rep, mu1)
        this_rep = tk.row_reward_weighted(adj, old_rep)
        rep = tk.smooth(this_rep, old_rep, p.alpha)
        converged = _le(torch.max(torch.abs(rep - old_rep)),
                        p.convergence_tolerance)
        iters = 1
    else:
        # the reference's scan with a freeze-once-converged mask: a frozen
        # step changes nothing, so the loop stops at the first converged
        # state
        rep, this_rep = old_rep, old_rep
        loading = torch.zeros(E, dtype=acc, device=x.device)
        conv, iters = False, 0
        for _ in range(p.max_iterations):
            if conv:
                break
            adj, loading = scores_at(rep, _masked_mu(x, fill, rep),
                                     v_init=loading)
            this_rep = tk.row_reward_weighted(adj, rep)
            new_rep = tk.smooth(this_rep, rep, p.alpha)
            delta = torch.max(torch.abs(new_rep - rep))
            rep = new_rep
            iters += 1
            conv = bool(_le(delta, p.convergence_tolerance).item())
        converged = torch.tensor(conv, device=x.device)
    iters = torch.tensor(iters, dtype=torch.int32, device=x.device)

    raw, adjusted, certainty, pcol, prow, narow = resolve_certainty_fused(
        x, rep, fill, torch.sum(rep), float(p.catch_tolerance))
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
    return {
        "old_rep": old_rep,
        "this_rep": this_rep,
        "smooth_rep": rep,
        "na_row": narow > 0.0,
        "outcomes_raw": raw,
        "outcomes_adjusted": adjusted,
        "outcomes_final": adjusted,
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
        "first_loading": tk.canon_sign(loading),
    }


def _consensus_core_light(reports, reputation, scaled, mins, maxs,
                          p: ConsensusParams) -> dict:
    """The light pipeline (no (R, E) outputs). Only the fused branch is
    ported."""
    if p.fused_resolution:
        return _consensus_core_fused(reports, reputation, scaled, mins, maxs,
                                     p)
    raise NotImplementedError(f"the non-fused pipeline is not ported yet: "
                              f"{ROADMAP_PLAIN}")
