"""Wrappers of the port's Hopper kernels, their plain versions, their
launch counts and their fit gates.

Each wrapper stands for one Pallas kernel of
``pyconsensus_tpu/ops/pallas_kernels.py`` and keeps its signature and
return order:

- :func:`apply_weighted_cov` — ``(X - mu)^T (rep * ((X - mu) v))``
  (``csrc/storage_sweeps.cu``);
- :func:`scores_dirfix_pass` — ``(t, q, c, o)``
  (``csrc/storage_sweeps.cu``);
- :func:`apply_weighted_cov_block` — the same covariance application for
  an (E, k) block, with the centered ``(X - mu) V`` on request
  (``csrc/storage_sweeps.cu``);
- :func:`storage_matvec` — the uncentered ``filled(X) v``
  (``csrc/storage_sweeps.cu``, the row-tile pass at k = 1, uncentered);
- :func:`storage_matmat` — the uncentered ``filled(X) V`` for an (E, k)
  block (``csrc/storage_sweeps.cu``, the row-tile pass, uncentered);
- :func:`storage_rows_matmat` — ``W filled(X)`` for a (k, R) stack
  (``csrc/storage_sweeps.cu``, the column-tile pass, uncentered, one
  launch per group of at most 16 rows);
- :func:`fill_stats_pass` — the per-column present mass and
  reputation-weighted sum (``csrc/storage_sweeps.cu``);
- :func:`resolve_certainty_fused` — outcomes, certainty and
  participation in one call: the column-panel kernel of
  ``csrc/resolve.cu``, then the row-tile pass at k = 2 with the
  absent-indicator op (``csrc/storage_sweeps.cu``).

A wrapper takes its plain version (``*_plain``, plain torch with the same
arithmetic) only for a matrix that lies on the CPU. For a CUDA matrix it
launches the kernel or raises; nothing falls back. Storage is int8
sentinel storage (``round(2 * value)``, ``-1`` absent), or float32 or
bfloat16 with NaN marking absence (``fill_stats_pass`` takes int8 and
float32 only, as in the reference). The kernels decode every entry to its
exact float32 value, accumulate in float32 and reduce across blocks in a
fixed order (per-block partials, then a second pass), never with float
atomics.

Two fill forms, as in the reference. ``apply_weighted_cov``,
``scores_dirfix_pass`` and ``resolve_certainty_fused`` give an absent
entry the float32 fill (``pallas_kernels._decode_block``).
``storage_matvec``, ``storage_matmat``, ``storage_rows_matmat`` and
``apply_weighted_cov_block`` on bfloat16 storage give it the fill rounded
to bfloat16 (``pallas_kernels._decode_filled_bf16``): binary fills are on
the bfloat16 lattice, so only the continuous fills of scaled columns
round. The plain versions and the launches round the fill
(``_lattice_fill``); the kernels stay exact float32 inside. The
reference's bfloat16 MXU products with a compensated vector (``_vector_aux``,
``_matrix_aux``) are not carried over: a float32 FMA of the decoded entry
and the float32 vector is at least as exact.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import torch

from .torch_kernels import _power_loop, catch_tie_atol

__all__ = ["apply_weighted_cov", "apply_weighted_cov_plain",
           "power_iteration_fused", "storage_matvec", "storage_matvec_plain",
           "storage_matmat", "storage_matmat_plain", "scores_dirfix_pass",
           "scores_dirfix_pass_plain", "apply_weighted_cov_block",
           "apply_weighted_cov_block_plain", "storage_rows_matmat",
           "storage_rows_matmat_plain", "fill_stats_pass",
           "fill_stats_pass_plain", "resolve_certainty_fused",
           "resolve_certainty_fused_plain", "fused_pca_fits",
           "cov_block_kernel_fits", "matmat_kernels_fit",
           "resolve_kernel_fits", "resolve_block_cols", "resolve_smem_bytes",
           "wave_splits", "row_tile_splits", "col_tile_splits",
           "split_candidates", "split_fits", "resolve_block_fits",
           "resolve_block_candidates", "fill_stats_chunk_rows",
           "fill_stats_kernel_fits", "set_tune_provider", "tuned_shapes",
           "row_splits", "col_splits", "resolve_cols", "NOMINAL_SMS",
           "launch_counts", "reset_launch_counts", "hopper", "require_hopper",
           "SMEM_PER_BLOCK",
           "MAX_BLOCK_K", "MAX_TILE_K", "MAX_ROWS_K"]

#: dynamic shared memory one block may use on sm_90 (227 KB)
SMEM_PER_BLOCK = 232448
#: column-block widths the resolve kernel takes, widest first
#: (csrc/resolve.cu instantiates each)
_RES_COLS = (32, 16, 8, 4, 2, 1)
#: threads of a resolve column block, its most ring slots (one mbarrier
#: each) and the fewest rows a thread takes into one slot
#: (csrc/resolve.cu kResThreads, kMaxSlots, kMinChunkRows)
_RES_THREADS = 512
_RES_MAX_SLOTS = 32
_RES_MIN_CHUNK_ROWS = 4
#: the resolve gate: an R whose one-column panel takes at most this many
#: bytes. It is the rule the front door has routed by since the first
#: resolve kernel (a resident panel beside 4,352 bytes of partials); the
#: chunk ring takes one column at every such R (tests/test_torch_kernels.py
#: test_resolve_ring_takes_every_gated_r)
_RES_MAX_PANEL_BYTES = 228096
#: row chunks of fill_stats_pass, its only user: at most this many
#: chunks, so the partials buffer holds at most ``64 * 2 * E`` floats
#: while enough blocks stay in flight (10,000 rows: 64 chunks of 157)
_COL_CHUNK_MAX = 64
#: the widest (E, k) block of apply_weighted_cov_block: its centered
#: row-tile and column-tile passes are instantiated for k = 1..8
#: (csrc/storage_sweeps.cu)
MAX_BLOCK_K = 8
#: the widest (E, k) block of one uncentered row-tile launch (k = 1..16);
#: storage_matmat splits a wider block into groups of this many columns
MAX_TILE_K = 16
#: the widest (k, R) stack of one uncentered column-tile launch
#: (k = 1..16); storage_rows_matmat splits a wider stack into groups of
#: this many rows
MAX_ROWS_K = 16

_COUNTS = {"apply_weighted_cov": 0, "storage_matvec": 0,
           "scores_dirfix_pass": 0, "storage_matmat": 0,
           "apply_weighted_cov_block": 0, "storage_rows_matmat": 0,
           "fill_stats_pass": 0, "resolve_certainty_fused": 0}


#: the counts are bumped from every thread that launches (a fleet's
#: batcher threads among them): a read-modify-write under a lock
_COUNTS_LOCK = threading.Lock()


def _count(name: str) -> None:
    with _COUNTS_LOCK:
        _COUNTS[name] += 1


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset (plain-version
    calls on CPU tensors are not launches)."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_launch_counts() -> None:
    with _COUNTS_LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


# -- fit gates ---------------------------------------------------------------

def hopper(device: torch.device) -> bool:
    """Whether ``device`` is an sm_90 card, the only one the kernels are
    built for."""
    return (device.type == "cuda"
            and torch.cuda.get_device_capability(device) == (9, 0))


def require_hopper(device: torch.device) -> None:
    """Refuse a card that is not sm_90: the port runs nothing on a card
    without its kernels."""
    if device.type == "cuda" and not hopper(device):
        raise NotImplementedError(
            f"device {device} is not sm_90: the port's kernels are built "
            "for Hopper (sm_90a) only")


#: element sizes of the storage the kernels take: int8, bfloat16, float32
_ITEMSIZES = (1, 2, 4)


def fused_pca_fits(n_events: int, itemsize: int) -> bool:
    """Whether the storage sweeps (``apply_weighted_cov``,
    ``scores_dirfix_pass``) take an E-wide matrix of ``itemsize`` bytes
    (int8, bfloat16 or float32). Unlike the TPU kernels, which hold E-wide
    panels in VMEM, they keep nothing E-wide on chip: a block streams its
    rows or columns, so any width the 32-bit grid can index fits."""
    return itemsize in _ITEMSIZES and 1 <= n_events < 2 ** 31


def cov_block_kernel_fits(n_events: int, n_components: int,
                          itemsize: int) -> bool:
    """Whether :func:`apply_weighted_cov_block` takes an E-wide matrix of
    ``itemsize`` bytes and an (E, k) block. Its passes stage E in chunks
    and keep nothing E-wide on chip; the limit is the centered row-tile
    and column-tile passes, each instantiated for ``1 <= k <= 8`` (they
    keep 8k and 4k sums a thread, the part the TPU kernel's VMEM plays).
    A wider block takes the separable arm of the orthogonal iteration
    (:func:`storage_matmat`, then :func:`storage_rows_matmat`)."""
    return (fused_pca_fits(n_events, itemsize)
            and 1 <= n_components <= MAX_BLOCK_K)


def matmat_kernels_fit(n_events: int, n_components: int,
                       itemsize: int) -> bool:
    """Whether :func:`storage_matmat` and :func:`storage_rows_matmat` take
    k columns or rows against an E-wide matrix of ``itemsize`` bytes: any
    ``k >= 1``, in groups of at most ``MAX_TILE_K`` columns or
    ``MAX_ROWS_K`` rows per launch."""
    return fused_pca_fits(n_events, itemsize) and n_components >= 1


def _resolve_ring(block_cols: int, itemsize: int):
    """The chunk ring of a resolve column block of C columns
    (csrc/resolve.cu): ``(granule bytes, rows one pass of the block's
    threads covers, rows a chunk takes per thread, ring slots, bytes
    before the ring)``. A thread owns one granule of a panel row (the row
    up to 16 bytes); the slots fill the shared memory beside the
    mbarriers, the three rows of per-warp partials and the outcome and
    fill columns, at most ``_RES_MAX_SLOTS`` of them. A 16-byte granule
    holds 16 int8, 8 bfloat16 or 4 float32 columns."""
    gb = min(block_cols * itemsize, 16)
    rows = _RES_THREADS // (block_cols * itemsize // gb)
    aux = -(-(_RES_MAX_SLOTS * 8 + 4 * (3 * (_RES_THREADS // 32) * block_cols
                                        + 2 * block_cols)) // 16) * 16
    granules = (SMEM_PER_BLOCK - aux) // (_RES_THREADS * gb)
    per_chunk = max(_RES_MIN_CHUNK_ROWS, -(-granules // _RES_MAX_SLOTS))
    return gb, rows, per_chunk, granules // per_chunk, aux


def resolve_smem_bytes(n_reporters: int, block_cols: int,
                       itemsize: int) -> int:
    """Dynamic shared memory of one resolve column block: the mbarriers,
    partials and outcome and fill columns, then the chunk ring, which
    holds exactly the ``R x C`` panel's chunks (the rest of the SM's
    shared memory serves as L1). Above ``SMEM_PER_BLOCK`` the panel does
    not fit."""
    gb, rows, per_chunk, _, aux = _resolve_ring(block_cols, itemsize)
    chunks = -(-(-(-n_reporters // rows)) // per_chunk)
    return aux + chunks * per_chunk * _RES_THREADS * gb


@functools.lru_cache(maxsize=None)
def resolve_block_cols(n_reporters: int, itemsize: int) -> Optional[int]:
    """The widest column panel whose ``R x C`` chunks fit one block's
    ring at this R; None when even one column does not."""
    for c in _RES_COLS:
        if resolve_smem_bytes(n_reporters, c, itemsize) <= SMEM_PER_BLOCK:
            return c
    return None


def resolve_kernel_fits(n_reporters: int, itemsize: int) -> bool:
    """Whether resolve takes R reporters at ``itemsize``-byte storage:
    the one-column panel ``R * itemsize`` within
    ``_RES_MAX_PANEL_BYTES``, the gate the front door routes by, at
    which :func:`resolve_block_cols` always finds a width."""
    return itemsize in _ITEMSIZES and n_reporters * itemsize <= \
        _RES_MAX_PANEL_BYTES


# -- launch-shape models -------------------------------------------------------
#
# The Hopper counterparts of the Pallas kernels' shape models
# (``pallas_kernels._panel_rows``, ``cov_tile_fits``, ``cov_tile_candidates``,
# ``resolve_block_fits``, ``resolve_block_candidates``, ``matmat_tile_rows``).
# The tile of both tile passes is a compile-time constant (64 rows x 512
# bytes, csrc/storage_sweeps.cu); what a launch chooses is how many ranges
# of its reduction axis it splits into partials (``n_splits``), and
# resolve's column-panel width. The built-in choices are copies of the
# library's own (``wave_splits``, ``row_tile_splits``, ``col_tile_splits``;
# tests/test_torch_cuda.py holds them to ``pyc_row_tile_splits`` and
# ``pyc_col_tile_splits``), so the CPU and the deterministic sweep know
# them without ``nvcc``. Each is a function of R, E, the storage type and
# the card, never of k, and so is every value a provider may install: a
# column of a k = 12 launch is summed in the same order as at k = 1.

#: rows of a tile and bytes of a row a tile takes (kTileRows, kTileBytes)
_TILE_ROWS = 64
_TILE_BYTES = 512
#: most partials of one tile-pass launch (kMaxSplits)
_MAX_SPLITS = 16
#: resident column-tile blocks an SM (kColTileBlocksPerSm); the row-tile
#: pass counts one
_COL_TILE_BLOCKS_PER_SM = 2
#: the SMs of an H100 SXM: the card the deterministic CPU sweep ranks for
NOMINAL_SMS = 132


def wave_splits(tiles: int, chunks: int, slots: int) -> int:
    """Of 1 .. ``_MAX_SPLITS`` ranges (at most one a chunk), the fewest
    whose ``tiles x ranges`` blocks fill the last wave of ``slots``
    resident blocks best (``csrc/storage_sweeps.cu wave_splits``)."""
    best, best_fill = 1, 0.0
    for s in range(1, min(_MAX_SPLITS, chunks) + 1):
        blocks = tiles * s
        waves = (blocks + slots - 1) // slots
        fill = blocks / (waves * slots)
        if fill > best_fill + 1e-3:
            best, best_fill = s, fill
    return best


def _row_chunks(n_events: int, itemsize: int) -> int:
    """The 512-byte chunks of a row: the row-tile pass's reduction axis."""
    cols = _TILE_BYTES // itemsize
    return -(-n_events // cols)


def _col_chunks(n_reporters: int) -> int:
    """The 64-row chunks of a column: the column-tile pass's reduction
    axis."""
    return -(-n_reporters // _TILE_ROWS)


@functools.lru_cache(maxsize=4096)
def row_tile_splits(n_reporters: int, n_events: int, itemsize: int,
                    n_sm: int) -> int:
    """The built-in E ranges of the row-tile pass, one block an SM
    (``pyc_row_tile_splits``; 10,000 x 100,000 int8 on 132 SMs: 157
    tiles x 5 ranges)."""
    return wave_splits(_col_chunks(n_reporters),
                       _row_chunks(n_events, itemsize), max(1, n_sm))


@functools.lru_cache(maxsize=4096)
def col_tile_splits(n_reporters: int, n_events: int, itemsize: int,
                    n_sm: int) -> int:
    """The built-in row ranges of the column-tile pass, two blocks an SM
    (``pyc_col_tile_splits``; 10,000 x 100,000 int8 on 132 SMs: 196
    tiles x 4 ranges)."""
    return wave_splits(_row_chunks(n_events, itemsize),
                       _col_chunks(n_reporters),
                       _COL_TILE_BLOCKS_PER_SM * max(1, n_sm))


def split_candidates(kind: str, n_reporters: int, n_events: int,
                     itemsize: int) -> list:
    """The legal split counts of a tile pass (``kind`` ``"row_tile_splits"``
    or ``"col_tile_splits"``), ascending: ``1 .. min(_MAX_SPLITS, chunks)``
    over the pass's reduction axis, where the built-in always lies."""
    chunks = (_row_chunks(n_events, itemsize) if kind == "row_tile_splits"
              else _col_chunks(n_reporters))
    return list(range(1, min(_MAX_SPLITS, chunks) + 1))


def split_fits(kind: str, n_splits: int, n_reporters: int, n_events: int,
               itemsize: int) -> bool:
    """Whether ``n_splits`` is a legal split count of that pass."""
    legal = split_candidates(kind, n_reporters, n_events, itemsize)
    return bool(legal) and 1 <= n_splits <= legal[-1]


def resolve_block_fits(n_reporters: int, block_cols: int,
                       itemsize: int) -> bool:
    """Whether resolve's column kernel takes ``block_cols``-wide panels at
    this R: an R the gate admits (:func:`resolve_kernel_fits`) and one of
    the instantiated widths (``_RES_COLS``) whose ``R x C`` chunks fit one
    block's shared memory."""
    return (block_cols in _RES_COLS
            and resolve_kernel_fits(n_reporters, itemsize)
            and resolve_smem_bytes(n_reporters, block_cols, itemsize)
            <= SMEM_PER_BLOCK)


def resolve_block_candidates(n_reporters: int, itemsize: int) -> list:
    """The legal column-panel widths of resolve at this R, ascending (the
    built-in :func:`resolve_block_cols` is the widest); empty when even
    one column does not fit."""
    return sorted(c for c in _RES_COLS
                  if resolve_block_fits(n_reporters, c, itemsize))


def fill_stats_chunk_rows(n_reporters: int) -> int:
    """The rows of one chunk of :func:`fill_stats_pass`: at most
    ``_COL_CHUNK_MAX`` chunks, so the partials hold at most ``64 * 2 * E``
    floats while enough blocks stay in flight (10,000 rows: 64 chunks of
    157). The counterpart of ``pallas_kernels._fill_stats_tile_rows``;
    untuned, as the reference's."""
    return max(1, -(-n_reporters // _COL_CHUNK_MAX))


def fill_stats_kernel_fits(n_events: int, itemsize: int) -> bool:
    """Whether :func:`fill_stats_pass` takes an E-wide matrix of
    ``itemsize`` bytes: int8 or float32 storage, as the reference runs it
    (``pallas_kernels.fill_stats_kernel_fits``). A block keeps a strip of
    columns and streams its rows, so nothing E-wide sits on chip."""
    return itemsize in (1, 4) and 1 <= n_events < 2 ** 31


# -- tuned launch shapes (pyconsensus_tpu_torch.tune) --------------------------
#
# ``tune`` may install a PROVIDER that overrides the built-in choices per
# (card generation, storage type, shape class). It is asked at each
# launch, through :func:`_tuned`, which remembers its answer per shape for
# the provider it asked; every value is re-validated against the legal
# sets above, so a stale or hand-edited cache entry can cost speed but
# can never launch an illegal shape.

_TUNE_PROVIDER = None
_TUNE_AUTOLOAD = True
#: ``(provider, {(kind, ctx): value})``: the answers of the provider that
#: gave them, dropped when another provider is installed
_TUNE_MEMO = (None, {})


def set_tune_provider(provider):
    """Install (or clear, with None) the launch-shape provider —
    ``provider(kind, **ctx) -> int | None`` with kinds
    ``"row_tile_splits"`` and ``"col_tile_splits"`` (ctx: n_reporters,
    n_events, itemsize) and ``"resolve_block_cols"`` (ctx: n_reporters,
    itemsize). Returns the previous provider. Installing one explicitly
    (even None) disables the lazy default-cache autoload."""
    global _TUNE_PROVIDER, _TUNE_AUTOLOAD
    prev = _TUNE_PROVIDER
    _TUNE_PROVIDER = provider
    _TUNE_AUTOLOAD = False
    return prev


@contextlib.contextmanager
def tuned_shapes(provider):
    """Run the block with ``provider`` installed, then put the provider
    and the autoload back as they were."""
    global _TUNE_PROVIDER, _TUNE_AUTOLOAD
    prev = (_TUNE_PROVIDER, _TUNE_AUTOLOAD)
    set_tune_provider(provider)
    try:
        yield provider
    finally:
        _TUNE_PROVIDER, _TUNE_AUTOLOAD = prev


def _tuned(kind: str, device=None, **ctx):
    """The provider's override for ``kind`` at ``ctx`` (None: the
    built-in). The first call on a card lazily installs the tune
    runtime's default provider for ``device`` (a persisted-cache lookup)
    unless one was installed explicitly.

    Hardened as the reference's: a provider that raises, or returns
    anything but a positive integral number (a hand-edited cache file can
    put ANY JSON value behind ``"value"``), yields None — tuning is never
    load-bearing."""
    global _TUNE_PROVIDER, _TUNE_AUTOLOAD, _TUNE_MEMO
    if _TUNE_PROVIDER is None and _TUNE_AUTOLOAD and device is not None:
        _TUNE_AUTOLOAD = False
        try:
            from ..tune.autotune import default_provider

            _TUNE_PROVIDER = default_provider(device=device)
        except Exception:      # noqa: BLE001 — tuning is never load-bearing
            _TUNE_PROVIDER = None
    provider = _TUNE_PROVIDER
    if provider is None:
        return None
    owner, memo = _TUNE_MEMO
    if owner is not provider:
        memo = {}
        _TUNE_MEMO = (provider, memo)
    key = (kind, tuple(sorted(ctx.items())))
    if key in memo:
        return memo[key]
    try:
        v = provider(kind, **ctx)
    except Exception:          # noqa: BLE001 — same rule as the autoload
        v = None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        v = None
    elif isinstance(v, float) and not v.is_integer():
        v = None
    else:
        v = int(v) if v > 0 else None
    memo[key] = v
    return v


def row_splits(n_reporters: int, n_events: int, itemsize: int, n_sm: int,
               device=None) -> int:
    """The E ranges a row-tile launch takes: the provider's legal value,
    else the built-in :func:`row_tile_splits`."""
    t = _tuned("row_tile_splits", device, n_reporters=n_reporters,
               n_events=n_events, itemsize=itemsize)
    if t and split_fits("row_tile_splits", t, n_reporters, n_events,
                        itemsize):
        return t
    return row_tile_splits(n_reporters, n_events, itemsize, n_sm)


def col_splits(n_reporters: int, n_events: int, itemsize: int, n_sm: int,
               device=None) -> int:
    """The row ranges a column-tile launch takes: the provider's legal
    value, else the built-in :func:`col_tile_splits`."""
    t = _tuned("col_tile_splits", device, n_reporters=n_reporters,
               n_events=n_events, itemsize=itemsize)
    if t and split_fits("col_tile_splits", t, n_reporters, n_events,
                        itemsize):
        return t
    return col_tile_splits(n_reporters, n_events, itemsize, n_sm)


def resolve_cols(n_reporters: int, itemsize: int,
                 device=None) -> Optional[int]:
    """The panel width a resolve launch takes: the provider's legal
    value, else the built-in :func:`resolve_block_cols`."""
    t = _tuned("resolve_block_cols", device, n_reporters=n_reporters,
               itemsize=itemsize)
    if t and resolve_block_fits(n_reporters, t, itemsize):
        return t
    return resolve_block_cols(n_reporters, itemsize)


def _check_override(kind: str, value, n_reporters: int, n_events: int,
                    itemsize: int) -> None:
    """Refuse an explicit launch-shape override outside its legal set."""
    if value is None:
        return
    legal = (resolve_block_candidates(n_reporters, itemsize)
             if kind == "resolve_block_cols"
             else split_candidates(kind, n_reporters, n_events, itemsize))
    if value not in legal:
        raise ValueError(f"{kind}={value!r} is not legal at {n_reporters} x "
                         f"{n_events}, {itemsize}-byte storage: {legal}")


def _check_splits(x: torch.Tensor, row, col) -> None:
    """Refuse an illegal ``row_splits`` / ``col_splits`` override for
    storage ``x``."""
    R, E = x.shape
    _check_override("row_tile_splits", row, R, E, x.element_size())
    _check_override("col_tile_splits", col, R, E, x.element_size())


# -- shared checks -----------------------------------------------------------

#: the storage codes of the C entry points (csrc/*.cu)
_STORAGE_CODES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}


def _check_matrix(x: torch.Tensor):
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("storage matrix must be a 2-D tensor")
    if x.device.type == "cuda":
        if x.dtype not in _STORAGE_CODES:
            raise TypeError("the CUDA kernels take int8 sentinel, bfloat16 "
                            f"or float32 storage, got {x.dtype}")
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


def _block(V, n: int, like: torch.Tensor, name: str) -> torch.Tensor:
    """An (n, k) f32 contiguous block on ``like``'s device."""
    if not isinstance(V, torch.Tensor):
        V = torch.as_tensor(V)
    if V.dim() != 2 or V.shape[0] != n or V.shape[1] < 1:
        raise ValueError(f"{name} must have shape ({n}, k), got "
                         f"{tuple(V.shape)}")
    if V.device != like.device:
        raise ValueError(f"{name} is on {V.device}, the matrix on "
                         f"{like.device}")
    return V.to(torch.float32).contiguous()


def _aligned(v: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``v`` itself when its data starts on a 16-byte boundary (the
    row-tile pass copies it 16 bytes at a time), else a copy; None stays
    None."""
    if v is None or v.data_ptr() % 16 == 0:
        return v
    return v.clone()


def _decode(x: torch.Tensor):
    """``(values f32, absent)`` of a storage matrix (the plain form of
    ``pallas_kernels._decode_block``): bfloat16 and float32 values upcast
    exactly, NaN absent."""
    xp = x.to(torch.float32)
    if x.dtype == torch.int8:
        return xp * 0.5, xp < 0.0
    return xp, torch.isnan(xp)


def _lattice_fill(x: torch.Tensor, fill):
    """The fill of the uncentered products and the block covariance
    (``pallas_kernels._decode_filled_bf16``): rounded to bfloat16 on
    bfloat16 storage, as it is; None stays None."""
    if fill is None or x.dtype != torch.bfloat16:
        return fill
    return fill.to(torch.bfloat16).to(fill.dtype)


def _launch_args(x: torch.Tensor):
    """``(storage code, stream)`` of a launch over ``x``."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return _STORAGE_CODES[x.dtype], stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, queried once per device: the
    tile passes' split counts depend on R, E, the storage type and this,
    never on k."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _col_pass(lib, x, m, a, w, splits=None):
    """``out = w xc`` (k, E) for a (k, R) stack ``w`` through one
    column-tile launch: centered on ``m`` for k <= 8, uncentered (``m``
    None) for k <= 16. The launch sums ``n_splits`` ranges of rows into
    partials (``splits``, else :func:`col_splits`: fixed by R, E, the
    storage type and the card, never by k) and reduces them in a fixed
    order."""
    R, E = x.shape
    k = w.shape[0]
    storage, stream = _launch_args(x)
    n_splits = splits or col_splits(R, E, x.element_size(),
                                    _sm_count(x.device.index), x.device)
    out = torch.empty((k, E), dtype=torch.float32, device=x.device)
    partial = (torch.empty((n_splits, k, E), dtype=torch.float32,
                           device=x.device) if n_splits > 1 else out)
    _raise_on(lib.pyc_col_pass(
        x.data_ptr(), storage, R, E,
        m.data_ptr() if m is not None else None,
        a.data_ptr() if a is not None else None, w.data_ptr(), k, n_splits,
        partial.data_ptr(), out.data_ptr(), stream), "pyc_col_pass")
    return out


def _grouped(x: torch.Tensor, k: int, width: int, part,
             dim: int) -> torch.Tensor:
    """The group loop of the uncentered products, the same on both
    devices: ``part(slice)`` computes at most ``width`` of the k columns
    or rows (its plain version on the CPU, one launch on the card), and
    the pieces join along ``dim`` (one piece is returned as it is). Each
    output column or row is a sum of its own, which the kernels take in
    the same order at any k, so on the card the split changes no bit."""
    pieces = []
    with torch.cuda.device(x.device) if x.device.type == "cuda" \
            else contextlib.nullcontext():
        for c in range(0, k, width):
            pieces.append(part(slice(c, min(c + width, k))))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)


def _filled(x, fill):
    """The plain filled view of storage ``x`` in f32, ``fill`` as it is
    given."""
    val, absent = _decode(x)
    return (torch.where(absent, fill.to(torch.float32), val)
            if fill is not None else val)


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


def apply_weighted_cov(x, mu, rep, v, fill=None, *, row_splits=None,
                       col_splits=None):
    """``(X - mu)^T (rep * ((X - mu) v))`` over storage ``x`` (R, E),
    centered in-register; with ``fill`` the absent entries take
    ``fill - mu``. Returns (E,) f32; the caller divides by the
    unbiased-weight denominator. ``row_splits`` / ``col_splits`` override
    the passes' split counts (the autotuner's sweep; a legal value or
    ValueError). Replaces ``pallas_kernels.apply_weighted_cov``."""
    R, E = _check_matrix(x)
    _check_splits(x, row_splits, col_splits)
    mu, rep, v = (_vec(mu, E, x, "mu"), _vec(rep, R, x, "rep"),
                  _vec(v, E, x, "v"))
    fill = _vec(fill, E, x, "fill") if fill is not None else None
    if x.device.type == "cpu":
        return apply_weighted_cov_plain(x, mu, rep, v, fill)
    lib = _storage_lib()
    with torch.cuda.device(x.device):
        a = (fill - mu).contiguous() if fill is not None else None
        t = _row_tile(lib, x, mu, a, v[:, None], splits=row_splits)[0]
        w = (rep * t).reshape(1, R).contiguous()
        y = _col_pass(lib, x, mu, a, w, splits=col_splits)[0]
    _count("apply_weighted_cov")
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


# -- storage_matvec ----------------------------------------------------------

def storage_matvec_plain(x, v, fill=None):
    """Plain torch ``filled(x) @ v`` (f32)."""
    return _filled(x, _lattice_fill(x, fill)) @ v.to(torch.float32)


def storage_matvec(x, v, fill=None):
    """The uncentered ``filled(x) @ v`` over storage ``x`` (R, E); absent
    entries take ``fill`` (rounded to bfloat16 on bfloat16 storage).
    Returns (R,) f32: the event-sharded path sums
    it across shards before it centers. Replaces
    ``pallas_kernels.storage_matvec``."""
    R, E = _check_matrix(x)
    v = _vec(v, E, x, "v")
    fill = _vec(fill, E, x, "fill") if fill is not None else None
    if x.device.type == "cpu":
        return storage_matvec_plain(x, v, fill)
    fill = _lattice_fill(x, fill)
    lib = _storage_lib()
    with torch.cuda.device(x.device):
        t = _row_tile(lib, x, None, fill, v[:, None])[0]
    _count("storage_matvec")
    return t


# -- scores_dirfix_pass ------------------------------------------------------

def scores_dirfix_pass_plain(x, rep, loading, fill=None):
    """Plain torch ``(t, q, c, o)``: ``t = filled @ loading``,
    ``q = t^T filled``, ``c = 1^T filled``, ``o = rep^T filled``."""
    xp = _filled(x, fill)
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
        t = _row_tile(lib, x, None, fill, loading[:, None])[0]
        w3 = torch.stack([t, rep, torch.ones_like(t)]).contiguous()
        acc = _col_pass(lib, x, None, fill, w3)                # q, o, c
    _count("scores_dirfix_pass")
    return t, acc[0], acc[2], acc[1]


# -- apply_weighted_cov_block ------------------------------------------------

def apply_weighted_cov_block_plain(x, mu, rep, V, fill=None, emit_t=False):
    """Plain torch ``(X - 1 mu^T)^T (rep * T)`` with ``T = (X - 1 mu^T) V``;
    absent entries take ``fill - mu`` when ``fill`` is given (the fill
    rounded to bfloat16 on bfloat16 storage). Returns ``(y (E, k), T (R,
    k) or None)``, all f32."""
    val, absent = _decode(x)
    fill = _lattice_fill(x, fill)
    mu = mu.to(torch.float32)
    if fill is not None:
        xc = torch.where(absent, fill.to(torch.float32) - mu, val - mu)
    else:
        xc = val - mu
    t = xc @ V.to(torch.float32)
    y = xc.T @ (rep.to(torch.float32)[:, None] * t)
    return y, (t if emit_t else None)


def apply_weighted_cov_block(x, mu, rep, V, fill=None, emit_t=False):
    """``(X - 1 mu^T)^T (rep * ((X - 1 mu^T) V))`` for an (E, k) block over
    storage ``x`` (R, E), centered in-register; with ``fill`` the absent
    entries take ``fill - mu`` (the fill rounded to bfloat16 on bfloat16
    storage). Returns ``(y (E, k), t)`` f32, where ``t``
    is the centered ``(X - 1 mu^T) V`` (R, k) under ``emit_t`` and None
    otherwise; the caller divides ``y`` by the unbiased-weight
    denominator. Replaces ``pallas_kernels.apply_weighted_cov_block``."""
    R, E = _check_matrix(x)
    mu, rep = _vec(mu, E, x, "mu"), _vec(rep, R, x, "rep")
    V = _block(V, E, x, "V")
    fill = _vec(fill, E, x, "fill") if fill is not None else None
    if x.device.type == "cpu":
        return apply_weighted_cov_block_plain(x, mu, rep, V, fill, emit_t)
    fill = _lattice_fill(x, fill)
    k = V.shape[1]
    if not cov_block_kernel_fits(E, k, x.element_size()):
        raise ValueError(f"apply_weighted_cov_block takes 1 <= k <= "
                         f"{MAX_BLOCK_K} columns, got {k}")
    lib = _storage_lib()
    with torch.cuda.device(x.device):
        a = (fill - mu).contiguous() if fill is not None else None
        t = _row_tile(lib, x, mu, a, V)                         # (k, R)
        y = _col_pass(lib, x, mu, a, (rep[None, :] * t).contiguous())
    _count("apply_weighted_cov_block")
    return y.T, (t.T if emit_t else None)


# -- storage_matmat ----------------------------------------------------------

def storage_matmat_plain(x, V, fill=None):
    """Plain torch ``filled(x) @ V`` (f32)."""
    return _filled(x, _lattice_fill(x, fill)) @ V.to(torch.float32)


def _row_tile(lib, x, m, a, V, absent: bool = False, splits=None):
    """``T = (xc V)^T`` (k, R) through one row-tile launch: centered on
    ``m`` for k <= 8, uncentered (``m`` None) for k <= 16; every row
    contraction of the port, k = 1 included. ``absent``: xc is the
    absent indicator, uncentered with no fill, at k = 2 (resolve's row
    half). The launch sums
    ``n_splits`` ranges of E into partials (``splits``, else
    :func:`row_splits`: fixed by R, E, the storage type and the card,
    never by k) and reduces them in a fixed order.
    ``vt``, ``a`` and ``m`` are staged 16 bytes at a time only when all
    three start on a 16-byte boundary, so an unaligned view (a k = 1
    column ``V`` is ``v`` itself) is copied first."""
    R, E = x.shape
    k = V.shape[1]
    vt = _aligned(V.T.contiguous())                             # (k, E)
    m, a = _aligned(m), _aligned(a)
    storage, stream = _launch_args(x)
    n_splits = splits or row_splits(R, E, x.element_size(),
                                    _sm_count(x.device.index), x.device)
    t = torch.empty((k, R), dtype=torch.float32, device=x.device)
    partial = (torch.empty((n_splits, k, R), dtype=torch.float32,
                           device=x.device) if n_splits > 1 else t)
    if absent:
        _raise_on(lib.pyc_row_tile_absent(
            x.data_ptr(), storage, R, E, vt.data_ptr(), k, n_splits,
            partial.data_ptr(), t.data_ptr(), stream), "pyc_row_tile_absent")
        return t
    _raise_on(lib.pyc_row_tile_pass(
        x.data_ptr(), storage, R, E,
        m.data_ptr() if m is not None else None,
        a.data_ptr() if a is not None else None, vt.data_ptr(), k, n_splits,
        partial.data_ptr(), t.data_ptr(), stream), "pyc_row_tile_pass")
    return t


def storage_matmat(x, V, fill=None):
    """The uncentered ``filled(x) @ V`` for an (E, k) block over storage
    ``x`` (R, E), any ``k >= 1``; absent entries take ``fill``. Returns
    (R, k) f32; centering is the caller's (``T - 1 (mu @ V)``). The fill
    rounds to bfloat16 on bfloat16 storage. Replaces
    ``pallas_kernels.storage_matmat``."""
    R, E = _check_matrix(x)
    V = _block(V, E, x, "V")
    fill = _vec(fill, E, x, "fill") if fill is not None else None
    k = V.shape[1]
    if x.device.type == "cpu":
        return _grouped(x, k, MAX_TILE_K,
                        lambda g: storage_matmat_plain(x, V[:, g], fill), 1)
    lib = _storage_lib()
    fill = _lattice_fill(x, fill)
    out = _grouped(x, k, MAX_TILE_K,
                   lambda g: _row_tile(lib, x, None, fill, V[:, g]).T, 1)
    _count("storage_matmat")
    return out


# -- storage_rows_matmat -----------------------------------------------------

def _pad_weights(W, R: int, x: torch.Tensor) -> torch.Tensor:
    """A (k, R') f32 stack zero-padded to (k, R): the Pallas wrapper pads a
    W narrower than the (row-padded) matrix the same way."""
    if not isinstance(W, torch.Tensor):
        W = torch.as_tensor(W)
    if W.dim() != 2 or W.shape[0] < 1 or W.shape[1] > R:
        raise ValueError(f"W must have shape (k, R' <= {R}), got "
                         f"{tuple(W.shape)}")
    if W.device != x.device:
        raise ValueError(f"W is on {W.device}, the matrix on {x.device}")
    W = W.to(torch.float32)
    if W.shape[1] < R:
        W = torch.nn.functional.pad(W, (0, R - W.shape[1]))
    return W.contiguous()


def storage_rows_matmat_plain(x, W, fill=None):
    """Plain torch ``W @ filled(x)`` (f32)."""
    return W.to(torch.float32) @ _filled(x, _lattice_fill(x, fill))


def storage_rows_matmat(x, W, fill=None):
    """``W @ filled(x)`` for a (k, R') stack of row vectors over storage
    ``x`` (R, E), uncentered, any ``k >= 1`` in groups of at most
    ``MAX_ROWS_K`` (16) rows, one column-tile launch each; a W narrower
    than R is zero-padded; the fill rounds to bfloat16 on bfloat16
    storage. Returns (k, E) f32. Replaces
    ``pallas_kernels.storage_rows_matmat``."""
    R, E = _check_matrix(x)
    W = _pad_weights(W, R, x)
    fill = _vec(fill, E, x, "fill") if fill is not None else None
    k = W.shape[0]
    if x.device.type == "cpu":
        return _grouped(x, k, MAX_ROWS_K,
                        lambda g: storage_rows_matmat_plain(x, W[g], fill),
                        0)
    lib = _storage_lib()
    fill = _lattice_fill(x, fill)
    out = _grouped(x, k, MAX_ROWS_K,
                   lambda g: _col_pass(lib, x, None, fill, W[g]), 0)
    _count("storage_rows_matmat")
    return out


# -- fill_stats_pass ---------------------------------------------------------

def fill_stats_pass_plain(x, rep):
    """Plain torch ``(tw, numer)`` f32: ``tw = rep^T [present]`` and
    ``numer = rep^T value`` with absent entries counting 0."""
    rep = rep.to(torch.float32)
    if x.dtype == torch.int8:
        # the sentinel clamps to 0; the exact 0.5 folds into the weights
        return (rep @ (x >= 0).to(torch.float32),
                (0.5 * rep) @ torch.clamp(x, min=0).to(torch.float32))
    xf = x.to(torch.float32)
    na = torch.isnan(xf)
    return (rep @ (~na).to(torch.float32),
            rep @ torch.where(na, torch.zeros_like(xf), xf))


def fill_stats_pass(x, rep):
    """The per-column fill statistics over storage ``x`` (R, E) in one
    sweep: ``(tw, numer)``, both (E,) f32, where ``tw`` is the present
    reputation mass and ``numer`` the present reputation-weighted value
    sum. int8 and float32 storage, as the reference runs it at int8
    alone. Replaces ``pallas_kernels.fill_stats_pass``."""
    R, E = _check_matrix(x)
    if x.dtype not in (torch.int8, torch.float32):
        raise TypeError(f"fill_stats_pass takes int8 sentinel or float32 "
                        f"storage, got {x.dtype}")
    rep = _vec(rep, R, x, "rep")
    if x.device.type == "cpu":
        return fill_stats_pass_plain(x, rep)
    lib = _storage_lib()
    with torch.cuda.device(x.device):
        n_chunks = -(-R // fill_stats_chunk_rows(R))
        partial = torch.empty((n_chunks, 2, E), dtype=torch.float32,
                              device=x.device)
        out = torch.empty((2, E), dtype=torch.float32, device=x.device)
        storage, stream = _launch_args(x)
        _raise_on(lib.pyc_fill_stats(
            x.data_ptr(), storage, R, E, rep.data_ptr(), n_chunks,
            partial.data_ptr(), out.data_ptr(), stream), "pyc_fill_stats")
    _count("fill_stats_pass")
    return out[0], out[1]


# -- resolve_certainty_fused -------------------------------------------------

@functools.lru_cache(maxsize=None)
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


def resolve_certainty_fused(x, rep, fill, full_total, tolerance: float, *,
                            block_cols=None, row_splits=None):
    """Outcome resolution, certainty and participation over storage ``x``
    (binary events): returns ``(outcomes_raw, outcomes_adjusted,
    certainty, pcol, prow, na_count_rows)`` f32, where
    ``pcol = rep^T [absent]`` clamped to ``[0, sum(rep)]`` and
    ``prow = [absent] @ certainty``. Means fall back to the
    full-reputation filled mean where no reputation is present; outcomes
    are catch-snapped with ``catch_tie_atol(float32)``. ``block_cols``
    overrides the column kernel's panel width and ``row_splits`` the row
    half's split count (the autotuner's sweep; a legal value or
    ValueError), as the reference's ``block_cols=``. Replaces
    ``pallas_kernels.resolve_certainty_fused``."""
    R, E = _check_matrix(x)
    _check_override("resolve_block_cols", block_cols, R, E,
                    x.element_size())
    _check_splits(x, row_splits, None)
    rep, fill = _vec(rep, R, x, "rep"), _vec(fill, E, x, "fill")
    if x.device.type == "cpu":
        return resolve_certainty_fused_plain(x, rep, fill, full_total,
                                             tolerance)
    if not resolve_kernel_fits(R, x.element_size()):
        raise ValueError(f"R={R} at {x.element_size()}-byte storage exceeds "
                         "the resolve kernel's panel "
                         f"({_RES_MAX_PANEL_BYTES} bytes a column)")
    with torch.cuda.device(x.device):
        # the certainty goes straight into row 0 of the row half's V^T
        vt = torch.empty((2, E), dtype=torch.float32, device=x.device)
        raw, out, cert, pcol = _resolve_columns(x, rep, fill, full_total,
                                                tolerance, vt[0], block_cols)
        vt[1].fill_(1.0)
        prow, narow = _absent_rows(x, vt, row_splits)
    _count("resolve_certainty_fused")
    return raw, out, cert, pcol, prow, narow


def _resolve_columns(x, rep, fill, full_total, tolerance: float, cert=None,
                     block_cols=None):
    """The column half of :func:`resolve_certainty_fused` on the card:
    ``(raw, out, cert, pcol)`` from one launch of the column-panel kernel
    (``pyc_resolve_cols``, a persistent grid of one block an SM) at
    ``block_cols`` (else :func:`resolve_cols`), the certainty into
    ``cert`` when it is given."""
    from .build import load

    R, E = x.shape
    lib = load("resolve.cu")
    C = block_cols or resolve_cols(R, x.element_size(), x.device)
    lo, hi = _catch_bounds(tolerance)
    f32 = torch.float32
    ft = (full_total.to(device=x.device, dtype=f32)
          if isinstance(full_total, torch.Tensor)
          else torch.full((), float(full_total), dtype=f32, device=x.device))
    rep_sum = rep.sum()
    outs = [torch.empty(E, dtype=f32, device=x.device) if o is None else o
            for o in (None, None, cert, None)]
    storage, stream = _launch_args(x)
    _raise_on(lib.pyc_resolve_cols(
        x.data_ptr(), storage, R, E, C, _sm_count(x.device.index),
        rep.data_ptr(), fill.data_ptr(), rep_sum.data_ptr(), ft.data_ptr(),
        lo, hi, *[o.data_ptr() for o in outs], stream), "pyc_resolve_cols")
    return tuple(outs)


def _absent_rows(x, vt, splits=None):
    """The row half of :func:`resolve_certainty_fused` on the card:
    ``(prow, narow) = [absent] vt^T`` for ``vt = [cert; 1]`` (2, E), one
    row-tile launch at k = 2 with the absent-indicator op, its E ranges
    summed in a fixed order."""
    t = _row_tile(_storage_lib(), x, None, None, vt.T, absent=True,
                  splits=splits)
    return t[0], t[1]
