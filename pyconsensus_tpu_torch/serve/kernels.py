"""The padded bucket path (``pyconsensus_tpu/serve/kernels.py``): one
executable per shape bucket, bit-identical to direct resolution in its
discrete answers.

A serving workload presents (R, E) report matrices whose shapes vary
request to request. The batcher pads every request up to a configured
shape bucket (powers of two on both axes) and dispatches through THIS
path — one executable per (bucket, params), built before traffic. The
reference computes it in XLA and reaches no Pallas kernel; here it is
plain torch and launches none of the port's kernels.

The guarantee (pinned by tests against the reference and the port's
direct ``Oracle``):

- **discrete answers are exact**: catch-snapped outcomes
  (``outcomes_adjusted`` / ``outcomes_final``) and iteration counts equal
  those of a direct ``Oracle(pca_method="power")`` resolution of the
  unpadded matrix for every configured bucket — the catch, median and
  direction-fix tie bands make every snap decision reduction-order
  stable;
- **serving determinism**: a request's full result is the same bit for
  bit on every dispatch, alone or in any coalesced batch. The lanes of a
  dispatch run together (:func:`padded_consensus_lanes`, the reference's
  ``jax.vmap``) in ``sim/_batched.py``'s lane arithmetic
  (``ops/lanes.py``): every contraction is an elementwise product and a
  fixed-order pairwise sum over one lane's axis, never a batched product
  or a reduction whose algorithm could follow the lane count. A lane
  that exits its power loop or converges keeps its state and leaves the
  working set while the others sweep on. The prior's normalization, the
  NA fill and a scaled column's median run lane by lane at the bucket
  shape, through ``torch_kernels`` as the direct resolution runs them.
  An unoccupied lane is not computed at all (its outputs would be
  dropped); a capacity-1 dispatch is the one-lane case. On the card a
  lane is within the float32 band of the CPU's, not bit for bit (plain
  division and square root);
- **continuous tails** (reputations, certainty, bonuses) match direct
  resolution to <= 1e-9 in float64: a padded reduction sees the direct
  reduction's operands plus exact zeros, in another order. The first
  loading is the power iterate where the loop exits at the 8 eps
  alignment floor; where two implementations exit a sweep apart it
  moves by up to a few 1e-9.

Padding makes every padded contribution EXACTLY zero (or an exact
reduction identity):

- **pad rows**: reputation 0, reports NaN in real columns on the NA path
  (absent, 0-weight, sorted last in the weighted median), present zeros
  on the dense path; their scores are zeroed before the direction-fix
  statistics;
- **pad events**: present constant 0.0 — the filled column and its mean
  are exactly zero, so the centered deviation column is exactly zero
  (NaN padding would fill with 0.5 and leave a rounding-sized deviation);
- **power seed**: the TRUE-width ``power_seed(E)`` is computed on the
  host and passed in zero-extended (``torch_kernels._power_loop(base=
  ...)``). A bucket-width draw would carry nonzero pad entries, whose
  norm enters the seed's unit vector — the warm-start blend of every
  iteration past the first, and the zero-covariance fallback — so only
  the zero-extended true seed starts the direct trajectory;
- **cross-column aggregates** (the reward's mean reputation, NA bonuses,
  ``percent_na``, ``avg_certainty``) are taken against the validity
  masks over the true counts.

Scope: ``algorithm="sztorc"`` with ``pca_method="power"``; every other
algorithm or method takes the direct path (``Oracle`` itself).

Buffers. :class:`BucketTemplates` keeps one set of host pad buffers per
key (pinned when the service runs on the card) and rewrites only the
extent a lane dirtied. :func:`place_bucket_operands` uploads them with
``non_blocking`` copies and records a CUDA event after the copies; the
template waits on that event before any lane is rewritten, so request
k + 1's padding can never overwrite request k's input mid-copy (the
reference donates the buffers to XLA and pins the transfer instead). On
the CPU the placement is a copy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.pipeline import ConsensusParams, _le
from ..ops import torch_kernels as tk
from ..ops.constants import DIRFIX_TIE_ATOL
from ..ops.lanes import fsum, guard
from ..ops.prng import power_seed
from ..parallel.sharded import resolve_device

__all__ = ["padded_consensus", "padded_consensus_lanes",
           "make_bucket_executable", "bucket_inputs",
           "slice_result", "bucket_path_eligible", "SERVE_ALGORITHMS",
           "BucketTemplates", "place_bucket_operands"]

#: algorithms the padded bucket path scores (see the module docstring);
#: everything else takes the direct per-shape dispatch path
SERVE_ALGORITHMS = ("sztorc",)


def bucket_path_eligible(algorithm: str, pca_method: str, any_scaled: bool,
                         has_na: bool, storage_dtype: str) -> bool:
    """Whether a request may ride the padded bucket path (the one copy of
    the routing rule, shared by the service and the tests): sztorc with
    a power-family scorer (the one scorer whose arithmetic is
    shape-stable under padding — an eigh factors a different-size matrix
    per bucket), and not int8 sentinel storage (that encoding needs the
    fused NaN-threaded path)."""
    return (algorithm in SERVE_ALGORITHMS
            and pca_method in ("auto", "power")
            and storage_dtype != "int8")


def _lane_dot_rows(x, v, acc):
    """``x @ v`` in every lane, (n, R, E) by (n, E) to (n, R) in ``acc``,
    under ``torch_kernels._dot``'s dtype rule: both operands take the
    storage dtype, whose products and sum are exact in ``acc`` on
    bfloat16 storage and run in the storage dtype otherwise."""
    v = v.to(x.dtype)
    if x.dtype == torch.bfloat16:
        return fsum(x.to(acc) * v.to(acc)[:, None, :], 2)
    return fsum(x * v[:, None, :], 2).to(acc)


def _lane_dot_cols(w, x, acc):
    """``w @ x`` in every lane, (n, R) or (n, k, R) by (n, R, E) to (n, E)
    or (n, k, E) in ``acc`` (the rule of :func:`_lane_dot_rows`)."""
    w = w.to(x.dtype)
    if w.dim() == 3:
        x = x[:, None]
    if x.dtype == torch.bfloat16:
        return fsum(w.to(acc)[..., None] * x.to(acc), -2)
    return fsum(w[..., None] * x, -2).to(acc)


def _lane_norm(v):
    return torch.sqrt(fsum(v * v, 1))


def _lane_normalize(v):
    """``torch_kernels.normalize`` of every lane's last axis."""
    total = fsum(v, -1)[..., None]
    return torch.where(total == 0.0, v, v / guard(total))


def _lane_canon_sign(v):
    """``torch_kernels.canon_sign`` in every lane (first argmax on
    ties, a zero entry as +1)."""
    top = torch.gather(v, 1, torch.argmax(torch.abs(v), dim=1,
                                          keepdim=True))
    s = torch.sign(top)
    return v * torch.where(s == 0.0, torch.ones_like(s), s)


def _cov_operands(mm, mu, rep, denom):
    """What one outer iteration's sweeps read: the explicitly centered
    matrix ``(X - mu, rep, denom)`` when the sweeps' storage is the
    reputation dtype (one contraction each way), else ``(X, mu, rep,
    denom)`` for the implicit centering of narrowed storage, where the
    products follow ``torch_kernels._dot``'s dtype rule."""
    if mm.dtype == rep.dtype:
        return (mm - mu[:, None, :], rep, denom)
    return (mm, mu, rep, denom)


def _apply_cov(operands, v):
    """One application of each lane's weighted covariance,
    ``(X - mu)^T (rep * ((X - mu) v)) / denom``, on
    :func:`_cov_operands`. Pad rows carry zero reputation, so their
    centered rows add exact zeros."""
    if len(operands) == 3:
        xc, rep, denom = operands
        rt = rep * fsum(xc * v[:, None, :], 2)
        return fsum(rt[:, :, None] * xc, 1) / denom[:, None]
    mm, mu, rep, denom = operands
    acc = rep.dtype
    t = _lane_dot_rows(mm, v, acc) - fsum(mu * v, 1)[:, None]
    rt = rep * t
    y = _lane_dot_cols(rt, mm, acc) - mu * fsum(rt, 1)[:, None]
    return y / denom[:, None]


def _lane_power(operands, base, v_init, n_iters: int, tol: float):
    """``torch_kernels._power_loop`` in every lane: the seed ``base``
    (n, E) blended with a non-zero warm start ``v_init``, then sweeps
    until a lane's successive unit iterates meet ``|<w, v>| >= 1 -
    max(tol, 8 eps)`` (``tol < 0``: exactly ``n_iters``). A lane that
    exits keeps its loading and leaves the working set while the others
    sweep on; the exit test reads one flag back per sweep for the whole
    batch. Returns the (n, E) unit loadings and each lane's in-loop
    sweeps (a list)."""
    dtype = base.dtype
    no_exit = tol < 0
    tol = max(float(tol), 8.0 * float(torch.finfo(dtype).eps))
    base_unit = base / _lane_norm(base)[:, None]
    n_i = _lane_norm(v_init)
    blended = v_init / guard(n_i)[:, None] + 0.25 * base_unit
    seed = torch.where((n_i > 0.0)[:, None], blended, base)
    v = _apply_cov(operands, seed)
    n0 = _lane_norm(v)[:, None]
    v = torch.where(n0 == 0.0, base_unit, v / guard(n0))
    # the exit threshold as the iterate dtype rounds it
    thresh = torch.tensor(1.0 - tol, dtype=v.dtype).item()
    sweeps = [0] * v.shape[0]
    live = list(range(v.shape[0]))          # the working set's lanes
    vs = v
    for _ in range(int(n_iters)):
        for i in live:
            sweeps[i] += 1
        w = _apply_cov(operands, vs)
        # |w|^2 and <w, v> in one sum: the alignment of the unit iterate
        # is <w, v> / |w|; a zero w keeps v, aligned with itself
        ww, wv = fsum(w[:, None] * torch.stack([w, vs], 1), -1).unbind(1)
        n = torch.sqrt(ww)
        zero = n == 0.0
        done = zero | (torch.abs(wv) / guard(n) >= thresh)
        vs = torch.where(zero[:, None], vs, w / guard(n)[:, None])
        if no_exit or not bool(done.any()):
            continue
        flags = done.tolist()
        v[[i for i, f in zip(live, flags) if f]] = vs[done]
        keep = ~done
        live = [i for i, f in zip(live, flags) if not f]
        if not live:
            return v, sweeps
        vs = vs[keep]
        operands = tuple(a[keep] for a in operands)
    v[live] = vs
    return v, sweeps


def _masked_power_scores(filled, rep_k, row_valid, seed, v_init,
                         p: ConsensusParams):
    """The scoring step of every lane (``torch_kernels._first_pc_power``
    and the masked direction fix) with warm starts ``v_init`` (zeros:
    cold) and the injected true-width ``seed``. Pad-row scores are
    zeroed before the direction-fix statistics. Returns ``(adj_scores,
    loading, sweeps)``: (n, R), (n, E) and each lane's power sweeps."""
    acc = rep_k.dtype
    mu = fsum(rep_k[:, :, None] * filled.to(acc), 1)
    denom = guard(1.0 - fsum(rep_k * rep_k, 1))
    mm = tk.matvec_narrow(filled, p.matvec_dtype)
    loading, sweeps = _lane_power(_cov_operands(mm, mu, rep_k, denom),
                                  seed.to(acc), v_init, p.power_iters,
                                  p.power_tol)
    scores = (_lane_dot_rows(filled, loading, acc)
              - fsum(mu * loading, 1)[:, None])
    scores = torch.where(row_valid, scores, 0.0)
    return (_masked_dirfix(scores, filled, rep_k, row_valid), loading,
            sweeps)


def _masked_dirfix(scores, filled, rep_k, row_valid):
    """``torch_kernels.direction_fixed_scores`` in every lane with pad
    rows excluded: min and max over ±inf identities, the candidate sets
    zeroed on pad rows so the normalize sums and the projections see
    exact zeros."""
    acc = scores.dtype
    scores = _lane_canon_sign(scores)           # pads are 0: argmax safe
    inf = torch.tensor(float("inf"), dtype=acc, device=scores.device)
    a1 = torch.abs(torch.amin(torch.where(row_valid, scores, inf), dim=1,
                              keepdim=True))
    a2 = torch.amax(torch.where(row_valid, scores, -inf), dim=1,
                    keepdim=True)
    set1 = torch.where(row_valid, scores + a1, 0.0)
    set2 = torch.where(row_valid, scores - a2, 0.0)
    # old, new1 and new2 in one contraction of the stacked weights
    W = torch.cat([rep_k.to(acc)[:, None],
                   _lane_normalize(torch.stack([set1, set2], 1))], 1)
    M = _lane_dot_cols(W, filled, acc)
    d = fsum((M[:, 1:] - M[:, :1]) ** 2, -1)    # pad cols: exact zeros
    d1, d2 = d[:, 0], d[:, 1]
    return torch.where((d1 - d2 <= DIRFIX_TIE_ATOL * (d1 + d2))[:, None],
                       set1, -set2)


def _masked_row_reward(adj, rep_k, n_rows_f):
    """``torch_kernels.row_reward_weighted`` in every lane with the mean
    reputation over the TRUE reporter count (a mean would divide by the
    bucket height)."""
    degenerate = torch.amax(torch.abs(adj), dim=1, keepdim=True) == 0.0
    mean_rep = (fsum(rep_k, 1) / n_rows_f)[:, None]
    candidate = _lane_normalize(adj * (rep_k / mean_rep))
    return torch.where(degenerate, rep_k, candidate)


def _iterate_lanes(filled, old_rep, row_valid, seed, p: ConsensusParams):
    """The redistribution loop of every lane (the plain core's
    ``_consensus_core`` loop under the reference's vmap). A lane that
    converges applies no further update: it leaves the working set and
    its ``iterations`` stops. Returns ``(this_rep, smooth_rep, loading,
    iterations, converged, sweeps)``; ``sweeps`` (n lists of
    max_iterations) holds each outer iteration's power sweeps."""
    n = filled.shape[0]
    dev = filled.device
    dt = old_rep.dtype
    n_iter = max(p.max_iterations, 1)
    n_rows_f = torch.sum(row_valid.to(dt), dim=1)
    rep, this_rep = old_rep.clone(), old_rep.clone()
    loading = torch.zeros(seed.shape, dtype=dt, device=dev)
    iters = torch.zeros(n, dtype=torch.int32, device=dev)
    converged = torch.zeros(n, dtype=torch.bool, device=dev)
    sweeps = [[0] * n_iter for _ in range(n)]
    live = list(range(n))                   # the lanes still iterating
    for it in range(n_iter):
        # every lane live: no gather of the (n, R, E) operand
        whole = len(live) == n
        pick = (lambda a: a) if whole else (lambda a: a[live])
        rep_l = pick(rep)
        adj, load, swept = _masked_power_scores(
            pick(filled), rep_l, pick(row_valid), pick(seed),
            pick(loading), p)
        tr = _masked_row_reward(adj, rep_l, pick(n_rows_f))
        new_rep = tk.smooth(tr, rep_l, p.alpha)
        delta = torch.amax(torch.abs(new_rep - rep_l), dim=1)
        if whole:
            this_rep, rep, loading = tr, new_rep, load
            iters += 1
        else:
            this_rep[live], rep[live], loading[live] = tr, new_rep, load
            iters[live] += 1
        for lane, k in zip(live, swept):
            sweeps[lane][it] = k
        # a converged scan step freezes its state: stopping leaves it
        done = _le(delta, p.convergence_tolerance)
        if it == n_iter - 1:
            converged[live] = done
            break
        flags = done.tolist()
        converged[live] = done
        live = [lane for lane, f in zip(live, flags) if not f]
        if not live:
            break
    return this_rep, rep, loading, iters, converged, sweeps


def _lane_outcomes(present, filled, rep, scaled, p: ConsensusParams):
    """``torch_kernels.resolve_outcomes`` in every lane: the reputation
    restricted to the present reporters, the weighted mean of each column
    (catch-snapped on binary ones) and, on scaled columns, the weighted
    median, which each lane takes through ``torch_kernels`` on its own
    columns. Returns ``(outcomes_raw, outcomes_adjusted)``, (n, E)."""
    acc = rep.dtype
    full_total = fsum(rep, 1)[:, None]
    full_mean = (_lane_dot_cols(rep, filled, acc)
                 / torch.where(full_total == 0.0, 1.0, full_total))
    if p.has_na:
        pw = present.to(acc)
        tw = fsum(rep[:, :, None] * pw, 1)
        mean_present = (fsum(rep[:, :, None] * (pw * filled.to(acc)), 1)
                        / torch.where(tw > 0.0, tw, 1.0))
        del pw
        means = torch.where(tw > 0.0, mean_present, full_mean)
    else:
        tw = full_total.expand(full_mean.shape)
        means = full_mean
    if not p.any_scaled:
        outcomes_raw = means
    else:
        medians = []
        for i in range(filled.shape[0]):
            pres = (present[i] if p.has_na else
                    torch.ones(filled.shape[1:], dtype=torch.bool,
                               device=filled.device))
            if tk.gather_median_pays(p.n_scaled, filled.shape[2]) \
                    and p.median_block > 0:
                idx = tk._scaled_index(scaled[i], p.n_scaled)
                med_s = tk.weighted_median_cols(
                    filled[i].index_select(1, idx), rep[i],
                    pres.index_select(1, idx), p.median_block)
                # the binary positions are never read
                medians.append(torch.zeros_like(means[i]).index_copy_(
                    0, idx, med_s.to(means.dtype)))
            else:
                medians.append(tk.weighted_median_cols(
                    filled[i], rep[i], pres, p.median_block))
        outcomes_raw = torch.where(
            tw > 0.0, torch.where(scaled, torch.stack(medians), means),
            means)
    return outcomes_raw, torch.where(
        scaled, outcomes_raw, tk.catch(outcomes_raw, p.catch_tolerance))


def _masked_bonuses(present, filled, rep_f, outcomes_adjusted, scaled,
                    row_valid, col_valid, n_rows_f, n_cols_f,
                    p: ConsensusParams):
    """``torch_kernels.certainty_and_bonuses`` in every lane with every
    cross-column and cross-row aggregate taken against the validity
    masks. Per-element outputs keep the bucket width (the caller slices);
    pad columns agree fully (zero fill against a zero outcome), so
    certainty is zeroed there before the sums."""
    dtype = rep_f.dtype
    dev = filled.device
    oa = outcomes_adjusted[:, None, :]
    agree = filled == oa
    if p.any_scaled:
        agree = torch.where(scaled[:, None, :],
                            torch.abs(filled.to(dtype) - oa)
                            <= p.catch_tolerance, agree)
    certainty = fsum(rep_f[:, :, None] * agree.to(dtype), 1)
    del agree
    certainty = torch.where(col_valid, certainty, 0.0)
    consensus_reward = _lane_normalize(certainty)
    avg_certainty = fsum(certainty, 1) / n_cols_f
    if p.has_na:
        na = (~present).to(dtype)
        participation_columns = 1.0 - fsum(rep_f[:, :, None] * na, 1)
        # pad rows are all-NaN in real columns: their na row would drag a
        # finite but meaningless entry into the normalize
        participation_rows = torch.where(
            row_valid, 1.0 - fsum(na * consensus_reward[:, None, :], 2),
            0.0)
        pc_masked = torch.where(col_valid, participation_columns, 0.0)
        percent_na = 1.0 - fsum(pc_masked, 1) / n_cols_f
        pn = percent_na[:, None]
        na_bonus_rows = _lane_normalize(participation_rows)
        reporter_bonus = na_bonus_rows * pn + rep_f * (1.0 - pn)
        na_bonus_cols = _lane_normalize(pc_masked)
        author_bonus = na_bonus_cols * pn + consensus_reward * (1.0 - pn)
        na_row = (~present).any(dim=2)
    else:
        # a dense request fits its rows exactly (the service sets has_na
        # whenever rows pad): the closed forms, masked over the events
        n, R_b, E_b = filled.shape
        participation_columns = torch.ones((n, E_b), dtype=dtype, device=dev)
        participation_rows = torch.ones((n, R_b), dtype=dtype, device=dev)
        percent_na = torch.zeros(n, dtype=dtype, device=dev)
        na_bonus_rows = participation_rows / n_rows_f[:, None]
        reporter_bonus = rep_f
        na_bonus_cols = participation_columns / n_cols_f[:, None]
        author_bonus = consensus_reward
        na_row = torch.zeros((n, R_b), dtype=torch.bool, device=dev)
    return {
        "certainty": certainty,
        "consensus_reward": consensus_reward,
        "avg_certainty": avg_certainty,
        "participation_columns": participation_columns,
        "participation_rows": participation_rows,
        "percent_na": percent_na,
        "na_bonus_rows": na_bonus_rows,
        "reporter_bonus": reporter_bonus,
        "na_bonus_cols": na_bonus_cols,
        "author_bonus": author_bonus,
        "na_row": na_row,
    }


def _check_bucket_params(p: ConsensusParams) -> None:
    if p.algorithm not in SERVE_ALGORITHMS:
        raise ValueError(
            f"the padded bucket path scores {SERVE_ALGORITHMS} only "
            f"(shape-stable power iteration); algorithm={p.algorithm!r} "
            f"must take the direct dispatch path")
    if p.pca_method != "power":
        raise ValueError(
            f"the padded bucket path requires pca_method='power' (eigh "
            f"factors a different-size matrix per bucket and cannot be "
            f"bit-identical across them), got {p.pca_method!r}")
    if p.storage_dtype == "int8":
        raise ValueError(
            "storage_dtype='int8' requires the fused NaN-threaded path; "
            "the bucket path stores the interpolated matrix "
            "(use '' or 'bfloat16')")


def padded_consensus_lanes(reports, reputation, scaled, mins, maxs,
                           row_valid, col_valid, seed, p: ConsensusParams,
                           stats=None) -> dict:
    """The bucket-shaped light pipeline of ``n`` independent requests:
    the plain core's data flow (``models.pipeline._consensus_core``) with
    validity masking at the decision points. Every tensor input carries a
    leading lane axis over the bucket shape, on one device (see
    :func:`bucket_inputs`); the computation runs in the reputation's
    dtype. The lanes run together (the module docstring's lane
    arithmetic), except the prior's normalization, the NA fill and a
    scaled column's median, which each lane takes through
    ``torch_kernels`` as the direct resolution does. Returns the flat
    result dict, each entry with the leading lane axis over the bucket
    shape — :func:`slice_result` trims a lane. ``p.has_na`` must be True
    whenever rows pad (pad rows are NaN). ``stats`` (a dict) gains
    ``"sweeps"``, the power sweeps of every lane's outer iterations (n
    lists of ``max_iterations``)."""
    _check_bucket_params(p)
    dt = reputation.dtype
    old_rep = torch.stack([tk.normalize(r) for r in reputation])
    rescaled = (tk.rescale(reports, scaled[:, None], mins[:, None],
                           maxs[:, None]) if p.any_scaled else reports)
    if p.has_na:
        lanes = [tk.interpolate_masked(rescaled[i], old_rep[i], scaled[i],
                                       p.catch_tolerance)
                 for i in range(reports.shape[0])]
        filled = torch.stack([f for f, _ in lanes])
        present = torch.stack([pr for _, pr in lanes])
        del lanes
    else:
        filled, present = rescaled, None
    del rescaled
    if p.storage_dtype:
        filled = filled.to(getattr(torch, p.storage_dtype))
    this_rep, rep, loading, iters, converged, sweeps = _iterate_lanes(
        filled, old_rep, row_valid, seed, p)
    if stats is not None:
        stats["sweeps"] = sweeps
    outcomes_raw, outcomes_adjusted = _lane_outcomes(present, filled, rep,
                                                     scaled, p)
    outcomes_final = (tk.unscale_outcomes(outcomes_adjusted, scaled, mins,
                                          maxs)
                      if p.any_scaled else outcomes_adjusted)
    result = {
        "old_rep": old_rep,
        "this_rep": this_rep,
        "smooth_rep": rep,
        "outcomes_raw": outcomes_raw,
        "outcomes_adjusted": outcomes_adjusted,
        "outcomes_final": outcomes_final,
        "iterations": iters,
        "convergence": converged,
        "first_loading": _lane_canon_sign(loading),
    }
    result.update(_masked_bonuses(
        present, filled, rep, outcomes_adjusted, scaled, row_valid,
        col_valid, torch.sum(row_valid.to(dt), dim=1),
        torch.sum(col_valid.to(dt), dim=1), p))
    return result


def padded_consensus(reports, reputation, scaled, mins, maxs, row_valid,
                     col_valid, seed, p: ConsensusParams,
                     stats=None) -> dict:
    """One request's bucket-shaped light pipeline: the one-lane
    :func:`padded_consensus_lanes`, so a request gives the same bits
    alone and inside any coalesced dispatch. All tensor inputs are
    bucket-shaped; returns the bucket-shaped flat result dict."""
    out = padded_consensus_lanes(
        *(a[None] for a in (reports, reputation, scaled, mins, maxs,
                            row_valid, col_valid, seed)), p, stats)
    return {k: v[0] for k, v in out.items()}


def make_bucket_executable(p: ConsensusParams, batched: bool = False):
    """A fresh executable for one (params[, batch]) cache entry:
    ``fn(reports, reputation, scaled, mins, maxs, row_valid, col_valid,
    seed, p)``. Unbatched it returns :func:`padded_consensus`'s dict;
    batched, the operands carry a leading lane axis (the occupied lanes
    only) and it returns :func:`padded_consensus_lanes`' dict, every
    entry with that axis. Building one compiles nothing: the service
    counts it as the key's build."""
    _check_bucket_params(p)
    return padded_consensus_lanes if batched else padded_consensus


@functools.lru_cache(maxsize=1024)
def _seed_host(E: int, dtype_name: str) -> np.ndarray:
    """The TRUE-width power seed (``ops/prng.py power_seed``) as a cached
    read-only host array; callers copy out of it."""
    seed = np.array(power_seed(E, dtype_name), dtype=np.dtype(dtype_name))
    seed.setflags(write=False)
    return seed


def _fill_bucket_views(views, reports, reputation, scaled, mins, maxs,
                       has_na: bool):
    """The one copy of the pad construction, writing a request into
    pre-defaulted bucket-shaped numpy views ``(padded, rep, sc, mn, mx,
    row_valid, col_valid, seed)``, which must arrive in the pad-default
    state (zeros; ``mx`` ones). Returns the request's ``(R, E)``."""
    padded, rep, sc, mn, mx, row_valid, col_valid, seed = views
    reports = np.asarray(reports, dtype=np.float64)
    R, E = reports.shape
    bucket_rows, bucket_events = padded.shape
    if not (R <= bucket_rows and E <= bucket_events):
        raise ValueError(f"shape {(R, E)} exceeds bucket "
                         f"{(bucket_rows, bucket_events)}")
    # pad rows: NaN in real columns (absent, 0-weight) on the NA path,
    # present zeros on the dense path; pad columns: present zeros
    padded[:R, :E] = reports
    if bucket_rows > R and has_na:
        padded[R:, :E] = np.nan
    rep[:R] = np.asarray(reputation, dtype=np.float64)
    sc[:E] = np.asarray(scaled, dtype=bool)
    mn[:E] = np.asarray(mins, dtype=np.float64)
    mx[:E] = np.asarray(maxs, dtype=np.float64)
    row_valid[:R] = True
    col_valid[:E] = True
    # the TRUE-width power seed, zero-extended
    seed[:E] = _seed_host(E, seed.dtype.name)
    return R, E


def _pad_buffers(lead: tuple, rows: int, events: int, dtype: torch.dtype,
                 pin: bool) -> tuple:
    """Pad-default host tensors ``(reports, reputation, scaled, mins,
    maxs, row_valid, col_valid, seed)`` with leading shape ``lead``."""
    def make(shape, dt, ones=False):
        t = torch.empty(lead + shape, dtype=dt, pin_memory=pin)
        return t.fill_(1 if ones else 0)

    return (make((rows, events), dtype), make((rows,), dtype),
            make((events,), torch.bool), make((events,), dtype),
            make((events,), dtype, ones=True), make((rows,), torch.bool),
            make((events,), torch.bool), make((events,), dtype))


def bucket_inputs(reports, reputation, scaled, mins, maxs,
                  bucket_rows: int, bucket_events: int,
                  has_na: bool = None, dtype: torch.dtype = None):
    """Pad a request to the bucket shape per the module contract: fresh
    CPU tensors ``(reports', reputation', scaled', mins', maxs',
    row_valid, col_valid, seed)`` in ``dtype`` (None: the default dtype),
    ready for :func:`padded_consensus`. ``reports`` is float (R, E) with
    NaN for non-reports; ``reputation`` the unnormalized prior.
    ``has_na`` (default: from the data) picks the pad-row encoding — NaN
    rows when the pipeline runs the NA fill anyway, present zero rows for
    a dense request, so the bucket keeps ``p.has_na=False`` and the
    direct path's elided fill (zero reputation takes those rows out of
    every contraction)."""
    reports = np.asarray(reports, dtype=np.float64)
    if has_na is None:
        has_na = bool(np.isnan(reports).any())
    dtype = dtype or torch.get_default_dtype()
    bufs = _pad_buffers((), bucket_rows, bucket_events, dtype, pin=False)
    _fill_bucket_views(tuple(t.numpy() for t in bufs), reports, reputation,
                       scaled, mins, maxs, has_na)
    return bufs


class BucketTemplates:
    """Reusable host pad buffers for one bucket key: one set of
    bucket-shaped buffers per key, batched to the key's capacity when it
    coalesces, pinned when ``device`` is a card (None: the card, raising
    without one). Per dispatch a lane
    (a) restores the pad defaults over its previously dirtied extent and
    (b) takes the new request. Rewriting waits on the CUDA event that
    :func:`place_bucket_operands` recorded after its ``non_blocking``
    uploads, so an upload in flight is never overwritten. Single-threaded
    by contract (the batcher thread owns dispatch)."""

    def __init__(self, rows: int, events: int, capacity: int,
                 dtype: torch.dtype = None, device=None) -> None:
        self.rows, self.events = int(rows), int(events)
        self.capacity = int(capacity)
        self.dtype = dtype or torch.get_default_dtype()
        self.device = resolve_device(device)
        lead = (self.capacity,) if self.capacity > 1 else ()
        pin = self.device.type == "cuda"
        self._fields = _pad_buffers(lead, self.rows, self.events,
                                    self.dtype, pin)
        self._views = tuple(t.numpy() for t in self._fields)
        #: per-lane (R, E) extent of the last fill (None = pad-default)
        self._dirty = [None] * max(self.capacity, 1)
        #: the CUDA event recorded after the last upload (None: none)
        self._pending = None

    def _lane_views(self, i: int):
        if self.capacity > 1:
            return tuple(v[i] for v in self._views)
        return self._views

    def _wait_upload(self) -> None:
        """Block until the last upload out of these buffers has landed."""
        if self._pending is not None:
            self._pending.synchronize()
            self._pending = None

    def reset_lane(self, i: int) -> None:
        """Restore lane ``i`` to the pad-default state, only over the
        extent the previous fill dirtied."""
        dirty = self._dirty[i]
        if dirty is None:
            return
        self._wait_upload()
        R_d, E_d = dirty
        padded, rep, sc, mn, mx, rv, cv, seed = self._lane_views(i)
        padded[:, :E_d] = 0.0          # covers the NaN pad-row band too
        rep[:R_d] = 0.0
        sc[:E_d] = False
        mn[:E_d] = 0.0
        mx[:E_d] = 1.0
        rv[:R_d] = False
        cv[:E_d] = False
        seed[:E_d] = 0.0
        self._dirty[i] = None

    def fill_lane(self, i: int, reports, reputation, scaled, mins, maxs,
                  has_na: bool) -> None:
        """Write one request into lane ``i`` (the :func:`bucket_inputs`
        fill core)."""
        self.reset_lane(i)
        self._wait_upload()
        self._dirty[i] = _fill_bucket_views(
            self._lane_views(i), reports, reputation, scaled, mins, maxs,
            has_na)

    def arrays(self) -> tuple:
        """The template's host tensors, in the executable's argument
        order."""
        return self._fields


def place_bucket_operands(tmpl: BucketTemplates, lanes: int = None) -> list:
    """Device operands for one dispatch of ``tmpl``, detached from its
    host buffers: on a card ``non_blocking`` copies out of the pinned
    buffers, followed by a CUDA event the template waits on before its
    next rewrite; on the CPU a copy (``torch.as_tensor`` would alias).
    ``lanes`` uploads only the first lanes of a batched template."""
    arrays = tmpl.arrays()
    if lanes is not None and tmpl.capacity > 1:
        arrays = tuple(a[:lanes] for a in arrays)
    dev = tmpl.device
    if dev.type != "cuda":
        return [a.clone() for a in arrays]
    out = [a.to(dev, non_blocking=True) for a in arrays]
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    tmpl._pending = event
    return out


#: result keys sliced on the row axis / event axis when trimming a
#: bucket-shaped result back to the request's true shape
_ROW_KEYS = ("old_rep", "this_rep", "smooth_rep", "na_row",
             "participation_rows", "na_bonus_rows", "reporter_bonus")
_COL_KEYS = ("outcomes_raw", "outcomes_adjusted", "outcomes_final",
             "certainty", "consensus_reward", "participation_columns",
             "na_bonus_cols", "author_bonus", "first_loading")


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def slice_result(raw: dict, n_rows: int, n_cols: int) -> dict:
    """Trim a bucket-shaped flat result to the request's true (R, E) on
    the host (tensors are fetched)."""
    out = {}
    for k, v in raw.items():
        v = _host(v)
        if k in _ROW_KEYS:
            v = v[..., :n_rows]
        elif k in _COL_KEYS:
            v = v[..., :n_cols]
        out[k] = v
    return out
