"""The batched resolution core of the simulator: many independent oracle
resolutions, one lane each, as one torch computation.

This is the counterpart of ``jax.vmap(_trial_metrics)`` over the JAX
package's ``_iterate_jax`` and ``resolve_outcomes``
(``pyconsensus_tpu/sim/collusion.py``, ``models/pipeline.py``). Its input
is ``(N, R, E)`` dense binary reports with no NA (rescale and the fill
are identities there) and ``(N, R)`` reputations; each lane runs sztorc's
redistribution loop with the reference's per-lane rules:

- a lane that has converged applies no update, and its ``iterations``
  stops (the scan's freeze);
- the power iteration exits per lane (``lax.while_loop`` under vmap keeps
  each lane's own sweep count): a lane whose successive unit iterates
  meet ``|<w, v>| >= 1 - max(tol, 8 eps)`` keeps its ``v`` while the
  others sweep on, up to ``power_iters``.

**A lane does not depend on the batch.** Every contraction is an
elementwise product and a sum over a fixed axis in a fixed pairwise order
(``ops/lanes.py``: :func:`fsum`), never a library product or reduction
whose algorithm may change with the number of lanes (a batched GEMM or a
reduction's launch configuration can). Products and sums are correctly
rounded on the CPU and on the card alike, and so are divisions and
square roots as ``_div`` and ``_sqrt`` take them, so a lane gives the
same bits alone, inside any batch and on either device in the same
dtype, on the power path; on the eigh paths up to the eigensolver (on
the card one solver call a matrix). Live lanes are gathered into a
smaller working set as they finish, which changes nothing for the same
reason.
"""

from __future__ import annotations

import torch

from ..models.pipeline import ConsensusParams
from ..ops import torch_kernels as tk
from ..ops.constants import DIRFIX_TIE_ATOL
from ..ops.lanes import div as _div
from ..ops.lanes import fsum
from ..ops.lanes import guard as _guard
from ..ops.lanes import sqrt as _sqrt
from ..ops.prng import power_seed

__all__ = ["fsum", "pca_method_for", "iterate", "resolve_binary",
           "ROADMAP_SIM_ALGORITHMS"]

#: what the simulator's other algorithms wait for
ROADMAP_SIM_ALGORITHMS = ("ROADMAP.md §A.7b (the simulator's other "
                          "algorithms: fixed-variance, ica, k-means and "
                          "dbscan-jit batched)")

#: reporter and event counts up to which "auto" takes the exact eigh
#: (``ops/torch_kernels.py`` GRAM_EIGH_MAX_R, COV_EIGH_MAX_E)
_GRAM_EIGH_MAX_R = 4096
_COV_EIGH_MAX_E = 1024
#: elements of the (lanes, R, E, E) or (lanes, R, R, E) product an eigh
#: path forms at once
_EIGH_CHUNK_ELEMS = 1 << 26


def _norm(v: torch.Tensor) -> torch.Tensor:
    return _sqrt(fsum(v * v, -1))


def pca_method_for(R: int, E: int, method: str) -> str:
    """The PCA method a lane of (R, E) runs: ``"auto"`` by shape (E <=
    1024 the covariance eigh, else R <= 4096 the Gram eigh, else power),
    ``"power-fused"`` as ``"power"`` (the same loading: the fused sweep is
    a one-matrix kernel)."""
    if method == "auto":
        if E <= _COV_EIGH_MAX_E:
            return "eigh-cov"
        if R <= _GRAM_EIGH_MAX_R:
            return "eigh-gram"
        return "power"
    if method == "power-fused":
        return "power"
    if method not in ("power", "eigh-cov", "eigh-gram"):
        raise ValueError(f"unknown PCA method: {method!r}")
    return method


def _weighted_means(x: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """``rep @ X`` per lane: (N, E)."""
    return fsum(rep[:, :, None] * x, 1)


def _denom(rep: torch.Tensor) -> torch.Tensor:
    return _guard(1.0 - fsum(rep * rep, 1))


def _power(x, mu, denom, rep, n_iters: int, tol: float, v_init,
           stats=None):
    """Per-lane power iteration on the implicitly centered covariance
    (``jax_kernels._power_loop`` / ``_first_pc_power`` under vmap).
    Returns the (N, E) unit loadings. ``stats`` (a dict) gains the sweeps
    of the loop (``"sweeps"``) and their sum over the lanes
    (``"lane_sweeps"``)."""
    N, _, E = x.shape
    dtype = x.dtype
    tol = max(float(tol), 8.0 * float(torch.finfo(dtype).eps))
    base = torch.from_numpy(power_seed(E, str(dtype).removeprefix(
        "torch.")).copy()).to(x.device)
    base_unit = _div(base, _norm(base))

    def apply_cov(xs, mus, dens, reps, v):
        t = fsum(xs * v[:, None, :], 2) - fsum(mus * v, 1)[:, None]
        rt = reps * t
        y = fsum(xs * rt[:, :, None], 1) - mus * fsum(rt, 1)[:, None]
        return _div(y, dens[:, None])

    n_i = _norm(v_init)
    blended = _div(v_init, _guard(n_i)[:, None]) + 0.25 * base_unit
    seed = torch.where((n_i > 0.0)[:, None], blended,
                       base.expand(N, E))
    v = apply_cov(x, mu, denom, rep, seed)
    n0 = _norm(v)[:, None]
    v = torch.where(n0 == 0.0, base_unit.expand(N, E), _div(v, _guard(n0)))
    # the exit threshold as the iterate dtype rounds it
    thresh = torch.tensor(1.0 - tol, dtype=dtype).item()
    # the working set: the lanes still sweeping, and their operands. A
    # lane that exits writes its loading back and leaves the set
    idx = torch.arange(N, device=x.device)
    xs, mus, dens, reps, vs = x, mu, denom, rep, v
    for _ in range(int(n_iters)):
        if stats is not None:
            stats["sweeps"] = stats.get("sweeps", 0) + 1
            stats["lane_sweeps"] = stats.get("lane_sweeps", 0) + len(idx)
        w = apply_cov(xs, mus, dens, reps, vs)
        n = _norm(w)[:, None]
        w = torch.where(n == 0.0, vs, _div(w, _guard(n)))
        done = torch.abs(fsum(w * vs, 1)) >= thresh
        vs = w
        if not bool(done.any()):
            continue
        v[idx[done]] = vs[done]
        keep = ~done
        idx, xs, mus, dens, reps, vs = (a[keep] for a in
                                        (idx, xs, mus, dens, reps, vs))
        if idx.numel() == 0:
            return v
    v[idx] = vs
    return v


def _eigh_top(m: torch.Tensor) -> torch.Tensor:
    """The eigenvector of the largest eigenvalue of each symmetric matrix
    of ``m`` (..., n, n), solved in float64 and returned in ``m``'s dtype.
    On the card each matrix is its own solver call: cuSOLVER's batched
    Jacobi route (which ``torch.linalg.eigh`` takes for a batch of
    matrices up to 32 wide) is not the single-matrix route, and it failed
    to converge on a sweep's rank-deficient covariances on an H100, as its
    float32 single-matrix route did too."""
    m64 = m.double()
    if m.device.type != "cuda":
        return torch.linalg.eigh(m64)[1][..., -1].to(m.dtype)
    lead, n = m.shape[:-2], m.shape[-1]
    flat = m64.reshape(-1, n, n)
    out = torch.empty(flat.shape[:2], dtype=torch.float64, device=m.device)
    for i in range(flat.shape[0]):
        out[i] = torch.linalg.eigh(flat[i])[1][:, -1]
    return out.reshape(*lead, n).to(m.dtype)


def _lane_chunks(N: int, per_lane: int):
    step = max(1, _EIGH_CHUNK_ELEMS // max(per_lane, 1))
    return [(s, min(N, s + step)) for s in range(0, N, step)]


def _eigh_cov(x, mu, denom, rep):
    """Per-lane ``eigh`` of the (E, E) weighted covariance
    (``jax_kernels._first_pc_eigh_cov``): loadings (N, E)."""
    N, R, E = x.shape
    out = []
    for s, t in _lane_chunks(N, R * E * E):
        dev = x[s:t] - mu[s:t, None, :]
        cov = _div(fsum((dev * rep[s:t, :, None])[:, :, :, None]
                        * dev[:, :, None, :], 1), denom[s:t, None, None])
        out.append(_eigh_top(cov))
    return torch.cat(out)


def _eigh_gram(x, mu, denom, rep):
    """Per-lane Gram trick (``jax_kernels._first_pc_eigh_gram``): the top
    eigenvector ``u`` of ``A A^T / denom`` (R x R) maps back to the unit
    loading ``A^T u / ||A^T u||``."""
    N, R, E = x.shape
    out = []
    for s, t in _lane_chunks(N, R * R * E):
        dev = x[s:t] - mu[s:t, None, :]
        A = dev * _sqrt(torch.clamp(rep[s:t], min=0.0))[:, :, None]
        G = _div(fsum(A[:, :, None, :] * A[:, None, :, :], 3),
                 denom[s:t, None, None])
        u = _eigh_top(G)
        v = fsum(A * u[:, :, None], 1)
        out.append(_div(v, _guard(_norm(v))[:, None]))
    return torch.cat(out)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    total = fsum(v, 1)[:, None]
    return torch.where(total == 0.0, v, _div(v, _guard(total)))


def _canon_sign(v: torch.Tensor) -> torch.Tensor:
    """Per lane, the sign that makes the entry of largest magnitude
    positive (first argmax on ties, zero as +1)."""
    top = torch.gather(v, 1, torch.argmax(torch.abs(v), dim=1,
                                          keepdim=True))
    s = torch.sign(top)
    return v * torch.where(s == 0.0, torch.ones_like(s), s)


def _sztorc_adj(x, rep, p: ConsensusParams, method: str, v_init,
                stats=None):
    """Direction-fixed first-component scores and the loading
    (``sztorc_scores_jax``, then ``direction_fixed_scores``)."""
    mu = _weighted_means(x, rep)
    denom = _denom(rep)
    if method == "power":
        loading = _power(x, mu, denom, rep, p.power_iters, p.power_tol,
                         v_init, stats)
    elif method == "eigh-cov":
        loading = _eigh_cov(x, mu, denom, rep)
    else:
        loading = _eigh_gram(x, mu, denom, rep)
    scores = fsum(x * loading[:, None, :], 2) \
        - fsum(mu * loading, 1)[:, None]
    scores = _canon_sign(scores)
    set1 = scores + torch.abs(torch.amin(scores, dim=1, keepdim=True))
    set2 = scores - torch.amax(scores, dim=1, keepdim=True)
    # old = rep^T X is the weighted means, the same sum in the same order
    new1 = _weighted_means(x, _normalize(set1))
    new2 = _weighted_means(x, _normalize(set2))
    d1 = fsum((new1 - mu) ** 2, 1)
    d2 = fsum((new2 - mu) ** 2, 1)
    adj = torch.where((d1 - d2 <= DIRFIX_TIE_ATOL * (d1 + d2))[:, None],
                      set1, -set2)
    return adj, loading


def _row_reward(adj: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """``normalize(adj * rep / mean(rep))``, the reputation unchanged
    where the adjusted scores vanish."""
    degenerate = torch.amax(torch.abs(adj), dim=1, keepdim=True) == 0.0
    # jnp.mean as XLA compiles it: the sum times 1 / R
    mean = fsum(rep, 1)[:, None] * (1.0 / rep.shape[1])
    return torch.where(degenerate, rep, _normalize(adj * _div(rep, mean)))


def iterate(x: torch.Tensor, rep0: torch.Tensor, p: ConsensusParams,
            stats=None):
    """The redistribution loop of every lane (``_iterate_jax`` under
    vmap) on (N, R, E) dense reports from (N, R) reputations. Returns
    ``(rep (N, R), converged (N,) bool, iterations (N,) int32)``;
    ``stats`` (a dict) gains the power loop's sweep counts."""
    N, R, E = x.shape
    method = pca_method_for(R, E, p.pca_method)
    rep = rep0.clone()
    loading = torch.zeros((N, E), dtype=rep0.dtype, device=x.device)
    conv = torch.zeros(N, dtype=torch.bool, device=x.device)
    iters = torch.zeros(N, dtype=torch.int32, device=x.device)
    live = torch.arange(N, device=x.device)
    for _ in range(max(int(p.max_iterations), 1)):
        # a converged lane applies no update: only live lanes compute
        xs, reps = x[live], rep[live]
        adj, load = _sztorc_adj(xs, reps, p, method, loading[live], stats)
        this_rep = _row_reward(adj, reps)
        new_rep = p.alpha * this_rep + (1.0 - p.alpha) * reps
        delta = torch.amax(torch.abs(new_rep - reps), dim=1)
        rep[live] = new_rep
        loading[live] = load
        iters[live] += 1
        done = delta <= p.convergence_tolerance
        conv[live[done]] = True
        live = live[~done]
        if live.numel() == 0:
            break
    return rep, conv, iters


def resolve_binary(x: torch.Tensor, rep: torch.Tensor,
                   tolerance: float) -> torch.Tensor:
    """Catch-snapped outcomes of binary events with no NA
    (``resolve_outcomes`` with ``any_scaled=False, has_na=False``):
    (N, E)."""
    total = fsum(rep, 1)[:, None]
    return tk.catch(_div(_weighted_means(x, rep), _guard(total)), tolerance)
