"""Wrappers of the port's three Hopper kernels, their plain versions, their
launch counts and their fit gates.

Each wrapper stands for one Pallas kernel of
``pyconsensus_tpu/ops/pallas_kernels.py`` and keeps its signature and
return order:

- :func:`apply_weighted_cov` — ``(X - mu)^T (rep * ((X - mu) v))``
  (``csrc/storage_sweeps.cu``);
- :func:`scores_dirfix_pass` — ``(t, q, c, o)``
  (``csrc/storage_sweeps.cu``);
- :func:`resolve_certainty_fused` — outcomes, certainty and
  participation in one call (``csrc/resolve.cu``).

A wrapper takes its plain version (``*_plain``, plain torch with the same
arithmetic) only for a matrix that lies on the CPU. For a CUDA matrix it
launches the kernel or raises; nothing falls back. Storage is int8
sentinel storage (``round(2 * value)``, ``-1`` absent) or float32 with
NaN marking absence. The kernels accumulate in float32 and reduce across
blocks in a fixed order (per-block partials, then a second pass), never
with float atomics.
"""

from __future__ import annotations

from typing import Optional

import torch

from .torch_kernels import _power_loop, catch_tie_atol

__all__ = ["apply_weighted_cov", "apply_weighted_cov_plain",
           "power_iteration_fused", "scores_dirfix_pass",
           "scores_dirfix_pass_plain", "resolve_certainty_fused",
           "resolve_certainty_fused_plain", "fused_pca_fits",
           "resolve_kernel_fits", "resolve_block_cols", "resolve_smem_bytes",
           "launch_counts", "reset_launch_counts", "SMEM_PER_BLOCK"]

#: dynamic shared memory one block may use on sm_90 (227 KB)
SMEM_PER_BLOCK = 232448
#: column-block widths the resolve kernel takes, widest first
#: (csrc/resolve.cu instantiates each)
_RES_COLS = (32, 16, 8, 4, 2, 1)
#: floats of the resolve column kernel's shared memory after the panel:
#: two rows of per-warp partials per column (16 warps) and the block's
#: outcome and fill columns (csrc/resolve.cu kAuxFloats)
_RES_AUX_FLOATS = 2 * 16 * max(_RES_COLS) + 2 * max(_RES_COLS)
#: rows per chunk of the column-sum pass: bounds the partials buffer to
#: ``ceil(R / rows) * k * E`` floats while keeping enough blocks in flight
_COL_CHUNK_MAX = 64

_COUNTS = {"apply_weighted_cov": 0, "scores_dirfix_pass": 0,
           "resolve_certainty_fused": 0}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset (plain-version
    calls on CPU tensors are not launches)."""
    return dict(_COUNTS)


def reset_launch_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


# -- fit gates ---------------------------------------------------------------

def fused_pca_fits(n_events: int, itemsize: int) -> bool:
    """Whether the storage sweeps (``apply_weighted_cov``,
    ``scores_dirfix_pass``) take an E-wide matrix of ``itemsize`` bytes.
    Unlike the TPU kernels, which hold E-wide panels in VMEM, they keep
    nothing E-wide on chip: a block streams its rows or columns, so any
    width the 32-bit grid can index fits."""
    return itemsize in (1, 4) and 1 <= n_events < 2 ** 31


def resolve_smem_bytes(n_reporters: int, block_cols: int,
                       itemsize: int) -> int:
    """Dynamic shared memory of one resolve column block: the resident
    ``R x C`` panel (16-byte aligned), the per-warp partials and the
    block's outcome and fill columns."""
    panel = -(-n_reporters * block_cols * itemsize // 16) * 16
    return panel + _RES_AUX_FLOATS * 4


def resolve_block_cols(n_reporters: int, itemsize: int) -> Optional[int]:
    """The widest column block whose panel fits one block's shared
    memory at this R; None when even one column does not."""
    for c in _RES_COLS:
        if resolve_smem_bytes(n_reporters, c, itemsize) <= SMEM_PER_BLOCK:
            return c
    return None


def resolve_kernel_fits(n_reporters: int, itemsize: int) -> bool:
    """Whether the resolve kernel can hold an ``R x 1`` panel or wider:
    ``R * C * itemsize`` within the per-block shared memory, C >= 1."""
    return itemsize in (1, 4) and resolve_block_cols(n_reporters,
                                                     itemsize) is not None


# -- shared checks -----------------------------------------------------------

def _check_matrix(x: torch.Tensor):
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("storage matrix must be a 2-D tensor")
    if x.device.type == "cuda":
        if x.dtype not in (torch.int8, torch.float32):
            raise TypeError("the CUDA kernels take int8 sentinel or float32 "
                            f"storage, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("storage matrix must be contiguous")
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return x.shape


def _vec(v, n: int, like: torch.Tensor, name: str) -> torch.Tensor:
    """An (n,) f32 contiguous vector on ``like``'s device (the Pallas
    wrappers cast their vector operands to f32 the same way)."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v)
    v = v.reshape(-1)
    if v.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got "
                         f"{tuple(v.shape)}")
    if v.device != like.device:
        raise ValueError(f"{name} is on {v.device}, the matrix on "
                         f"{like.device}")
    return v.to(torch.float32).contiguous()


def _decode(x: torch.Tensor):
    """``(values f32, absent)`` of a storage matrix (the plain form of
    ``pallas_kernels._decode_block``)."""
    xp = x.to(torch.float32)
    if x.dtype == torch.int8:
        return xp * 0.5, xp < 0.0
    return xp, torch.isnan(xp)


def _launch_args(x: torch.Tensor):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return int(x.dtype == torch.int8), stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _row_pass(lib, x, m, a, v):
    R, E = x.shape
    t = torch.empty(R, dtype=torch.float32, device=x.device)
    is_int8, stream = _launch_args(x)
    _raise_on(lib.pyc_row_pass(
        x.data_ptr(), is_int8, R, E, m.data_ptr(),
        a.data_ptr() if a is not None else None, v.data_ptr(), t.data_ptr(),
        stream), "pyc_row_pass")
    return t


def _col_pass(lib, x, m, a, w):
    """``out[k, e] = sum_i w[k, i] * xc[i, e]`` through per-chunk partials
    reduced in a fixed order."""
    R, E = x.shape
    k = w.shape[0]
    rows = max(1, -(-R // _COL_CHUNK_MAX))
    n_chunks = -(-R // rows)
    partial = torch.empty((n_chunks, k, E), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((k, E), dtype=torch.float32, device=x.device)
    is_int8, stream = _launch_args(x)
    _raise_on(lib.pyc_col_pass(
        x.data_ptr(), is_int8, R, E, m.data_ptr(),
        a.data_ptr() if a is not None else None, w.data_ptr(), k, n_chunks,
        partial.data_ptr(), out.data_ptr(), stream), "pyc_col_pass")
    return out


def _storage_lib():
    from .build import load

    return load("storage_sweeps.cu")


# -- apply_weighted_cov ------------------------------------------------------

def apply_weighted_cov_plain(x, mu, rep, v, fill=None):
    """Plain torch ``(X - mu)^T (rep * ((X - mu) v))``; absent entries
    take ``fill - mu`` when ``fill`` is given. All f32."""
    val, absent = _decode(x)
    mu = mu.to(torch.float32)
    if fill is not None:
        xc = torch.where(absent, fill.to(torch.float32) - mu, val - mu)
    else:
        xc = val - mu
    t = xc @ v.to(torch.float32)
    return (rep.to(torch.float32) * t) @ xc


def apply_weighted_cov(x, mu, rep, v, fill=None):
    """``(X - mu)^T (rep * ((X - mu) v))`` over storage ``x`` (R, E),
    centered in-register; with ``fill`` the absent entries take
    ``fill - mu``. Returns (E,) f32; the caller divides by the
    unbiased-weight denominator. Replaces
    ``pallas_kernels.apply_weighted_cov``."""
    R, E = _check_matrix(x)
    mu, rep, v = (_vec(mu, E, x, "mu"), _vec(rep, R, x, "rep"),
                  _vec(v, E, x, "v"))
    fill = _vec(fill, E, x, "fill") if fill is not None else None
    if x.device.type == "cpu":
        return apply_weighted_cov_plain(x, mu, rep, v, fill)
    lib = _storage_lib()
    with torch.cuda.device(x.device):
        a = (fill - mu).contiguous() if fill is not None else None
        t = _row_pass(lib, x, mu, a, v)
        w = (rep * t).reshape(1, R).contiguous()
        y = _col_pass(lib, x, mu, a, w)[0]
    _COUNTS["apply_weighted_cov"] += 1
    return y


def power_iteration_fused(x, mu, denom, rep, n_iters: int, tol: float,
                          fill=None, v_init=None):
    """First principal component by power iteration over
    :func:`apply_weighted_cov` (``pallas_kernels.power_iteration_fused``).
    The iterate runs in the promoted dtype of the f32 kernel output and
    ``denom`` (f64 when the reputation is f64), as in the reference.
    Returns the unit-norm loading (sign arbitrary)."""
    it_dtype = torch.promote_types(torch.float32, denom.dtype)

    def apply_cov(v):
        return apply_weighted_cov(x, mu, rep, v, fill=fill).to(it_dtype) \
            / denom

    return _power_loop(apply_cov, x.shape[1], n_iters, tol, x.device,
                       v_init=v_init)[0]


# -- scores_dirfix_pass ------------------------------------------------------

def scores_dirfix_pass_plain(x, rep, loading, fill=None):
    """Plain torch ``(t, q, c, o)``: ``t = filled @ loading``,
    ``q = t^T filled``, ``c = 1^T filled``, ``o = rep^T filled``."""
    val, absent = _decode(x)
    xp = (torch.where(absent, fill.to(torch.float32), val)
          if fill is not None else val)
    t = xp @ loading.to(torch.float32)
    w3 = torch.stack([t, rep.to(torch.float32), torch.ones_like(t)])
    acc = w3 @ xp                                          # q, o, c
    return t, acc[0], acc[2], acc[1]


def scores_dirfix_pass(x, rep, loading, fill=None):
    """The scores and direction-fix contractions over storage ``x``:
    returns ``(t (R,), q (E,), c (E,), o (E,))`` f32, in the Pallas
    wrapper's order (its accumulator rows are q, o, c). Replaces
    ``pallas_kernels.scores_dirfix_pass``."""
    R, E = _check_matrix(x)
    rep, loading = _vec(rep, R, x, "rep"), _vec(loading, E, x, "loading")
    fill = _vec(fill, E, x, "fill") if fill is not None else None
    if x.device.type == "cpu":
        return scores_dirfix_pass_plain(x, rep, loading, fill)
    lib = _storage_lib()
    with torch.cuda.device(x.device):
        zeros = torch.zeros(E, dtype=torch.float32, device=x.device)
        t = _row_pass(lib, x, zeros, fill, loading)
        w3 = torch.stack([t, rep, torch.ones_like(t)]).contiguous()
        acc = _col_pass(lib, x, zeros, fill, w3)               # q, o, c
    _COUNTS["scores_dirfix_pass"] += 1
    return t, acc[0], acc[2], acc[1]


# -- resolve_certainty_fused -------------------------------------------------

def _catch_bounds(tolerance: float):
    atol = catch_tie_atol(torch.float32)
    return (float(torch.tensor(0.5 - tolerance - atol, dtype=torch.float32)),
            float(torch.tensor(0.5 + tolerance + atol, dtype=torch.float32)))


def resolve_certainty_fused_plain(x, rep, fill, full_total, tolerance):
    """Plain torch form of the fused back half; same returns as
    :func:`resolve_certainty_fused`."""
    f32 = torch.float32
    val, na = _decode(x)
    rep = rep.to(f32)
    fill = fill.to(f32)
    xz = torch.where(na, torch.zeros_like(val), val)
    numer = rep @ xz
    tw = rep @ (~na).to(f32)
    rep_total = rep.sum()
    pcol = torch.minimum(torch.clamp(rep_total - tw, min=0.0), rep_total)
    fmn = numer + fill * pcol
    ft = torch.as_tensor(full_total, device=x.device).to(f32)
    full_mean = fmn / torch.where(ft == 0.0, torch.ones_like(ft), ft)
    means = torch.where(tw > 0.0,
                        numer / torch.where(tw > 0.0, tw,
                                            torch.ones_like(tw)),
                        full_mean)
    lo, hi = _catch_bounds(tolerance)
    out = torch.where(means < lo, torch.zeros_like(means),
                      torch.where(means > hi, torch.ones_like(means),
                                  torch.full_like(means, 0.5)))
    xf = torch.where(na, fill, val)
    cert = rep @ (xf == out).to(f32)
    naf = na.to(f32)
    return means, out, cert, pcol, naf @ cert, naf.sum(dim=1)


def resolve_certainty_fused(x, rep, fill, full_total, tolerance: float):
    """Outcome resolution, certainty and participation over storage ``x``
    (binary events): returns ``(outcomes_raw, outcomes_adjusted,
    certainty, pcol, prow, na_count_rows)`` f32, where
    ``pcol = rep^T [absent]`` clamped to ``[0, sum(rep)]`` and
    ``prow = [absent] @ certainty``. Means fall back to the
    full-reputation filled mean where no reputation is present; outcomes
    are catch-snapped with ``catch_tie_atol(float32)``. Replaces
    ``pallas_kernels.resolve_certainty_fused``."""
    R, E = _check_matrix(x)
    rep, fill = _vec(rep, R, x, "rep"), _vec(fill, E, x, "fill")
    if x.device.type == "cpu":
        return resolve_certainty_fused_plain(x, rep, fill, full_total,
                                             tolerance)
    itemsize = x.element_size()
    C = resolve_block_cols(R, itemsize)
    if C is None:
        raise ValueError(f"R={R} at {itemsize}-byte storage does not fit the "
                         "resolve kernel's shared memory "
                         f"({SMEM_PER_BLOCK} bytes per block)")
    from .build import load

    lib = load("resolve.cu")
    lo, hi = _catch_bounds(tolerance)
    f32 = torch.float32
    with torch.cuda.device(x.device):
        ft = torch.as_tensor(full_total, device=x.device).to(f32).reshape(())
        scal = torch.stack([rep.sum(), ft]).contiguous()
        outs = [torch.empty(E, dtype=f32, device=x.device) for _ in range(4)]
        prow = torch.empty(R, dtype=f32, device=x.device)
        narow = torch.empty(R, dtype=f32, device=x.device)
        is_int8, stream = _launch_args(x)
        _raise_on(lib.pyc_resolve_certainty(
            x.data_ptr(), is_int8, R, E, C,
            resolve_smem_bytes(R, C, itemsize), rep.data_ptr(),
            fill.data_ptr(), scal.data_ptr(), lo, hi,
            *[o.data_ptr() for o in outs], prow.data_ptr(), narow.data_ptr(),
            stream), "pyc_resolve_certainty")
    _COUNTS["resolve_certainty_fused"] += 1
    return (*outs, prow, narow)
