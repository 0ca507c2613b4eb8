"""The ``bucket_cuda`` low-latency bucket class, the counterpart of
``pyconsensus_tpu/serve/pallas.py`` (``bucket_pallas``).

Small interactive markets want the fewest passes over their reports per
resolution, not the padded buckets' coalescing window and pad lanes.
That is the fused NaN-threaded pipeline
(``models.pipeline._consensus_core_fused``): one storage pass per power
sweep (``apply_weighted_cov``, B.1), one for the scores and the
direction-fix sums (``scores_dirfix_pass``, B.2) per iteration, and one
for the whole outcome, certainty and participation back half
(``resolve_certainty_fused``, B.3: the column-panel kernel, then the
row-tile pass at k = 2). This module gives the serve tier a cached
executable class for it:

- **exact-shape keys, no padding**: a ``bucket_cuda`` executable is keyed
  by the request's true (R, E) with ``batch=1``. It runs the very
  function ``ShardedOracle`` runs on one device when its fused gate
  opens, on the same placement (float32 reports, or int8 sentinel
  storage with ``storage_dtype="int8"``; the reputation in the service's
  dtype; float32 bounds), so its result equals a direct fused
  resolution bit for bit by construction;
- **never colliding with the padded buckets**: ``BucketKey`` carries
  ``kernel_path`` — ``"plain"`` for the padded path (the reference's
  ``"xla"``), ``"cuda"`` for this class (its ``"pallas"``);
- **gated by the kernels' fits**: :func:`cuda_bucket_eligible` is the
  reference's rule over the port's front-door gate
  (``parallel/sharded.py _use_fused_resolution``: ``fused_pca_fits`` at
  the event width, ``resolve_kernel_fits`` at the reporter count) plus
  the low-latency class bound (``ServeConfig.pallas_max_events``).
  ``"auto"`` engages on an sm_90
  card, where the reference engages on a TPU; ``True`` engages on any
  device the service runs on (the CPU runs the kernels' plain versions);
  ``False`` disables the class.

No fallback: a kernel that fails to build or launch raises into the
request's future; a request admitted to this class is never re-routed to
the padded or direct path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.pipeline import ConsensusParams, _consensus_core_light
from ..ops.cuda_kernels import hopper
from ..parallel.sharded import _place_reports, _use_fused_resolution

__all__ = ["CUDA_KERNEL_PATH", "PLAIN_KERNEL_PATH", "cuda_bucket_eligible",
           "cuda_bucket_params", "make_cuda_bucket_executable",
           "cuda_bucket_inputs"]

#: BucketKey.kernel_path values: the padded bucket family (the
#: reference's "xla") and this class (its "pallas")
PLAIN_KERNEL_PATH = "plain"
CUDA_KERNEL_PATH = "cuda"


def cuda_bucket_eligible(n_reporters: int, n_events: int, algorithm: str,
                         pca_method: str, any_scaled: bool,
                         storage_dtype: str, mode, max_events: int,
                         device) -> bool:
    """Whether a request may ride the ``bucket_cuda`` class on ``device``
    — the one copy of the routing rule. ``mode`` is
    ``ServeConfig.pallas_buckets``. sztorc scored by power iteration on an
    all-binary panel, an event width inside the class bound, and the
    front door's fused gate at this shape and storage
    (``parallel/sharded.py _use_fused_resolution``), so a direct fused
    resolution of the request takes the same path."""
    if mode is False:
        return False
    if mode == "auto":
        if not hopper(torch.device(device)):
            return False
    elif mode is not True:
        raise ValueError(f"pallas_buckets must be 'auto', True or False, "
                         f"got {mode!r}")
    if algorithm != "sztorc" or pca_method not in ("auto", "power"):
        return False
    if any_scaled:
        return False
    if n_events > int(max_events):
        return False
    return _use_fused_resolution(
        ConsensusParams(algorithm="sztorc", pca_method="power",
                        storage_dtype=storage_dtype, any_scaled=False),
        n_reporters, n_events)


def cuda_bucket_params(has_na: bool, oracle_kwargs: dict,
                       bucket_kwargs) -> ConsensusParams:
    """The resolved params of a ``bucket_cuda`` executable: the fused
    single-device pipeline on sztorc power iteration, binary only.
    ``bucket_kwargs`` is the service's ``_BUCKET_KWARGS`` allowlist."""
    return ConsensusParams(
        algorithm="sztorc", pca_method="power", fused_resolution=True,
        has_na=has_na, any_scaled=False, n_scaled=0,
        **{k: v for k, v in oracle_kwargs.items() if k in bucket_kwargs})


def make_cuda_bucket_executable(p: ConsensusParams):
    """A fresh executable for one ``bucket_cuda`` cache entry:
    ``fn(reports, reputation, scaled, mins, maxs, p)`` at the request's
    true shape, running ``models.pipeline._consensus_core_light`` with
    the fused params (the kernels' wrappers launch B.1, B.2 and B.3 on a
    card, their plain versions on the CPU)."""
    if not p.fused_resolution:
        raise ValueError("a bucket_cuda executable requires "
                         "fused_resolution=True params "
                         "(cuda_bucket_params builds them)")

    def fn(reports, reputation, scaled, mins, maxs,
           p: ConsensusParams = p):
        return _consensus_core_light(reports, reputation, scaled, mins,
                                     maxs, p)

    return fn


def cuda_bucket_inputs(req, device, dtype: torch.dtype) -> tuple:
    """The operands of a ``bucket_cuda`` dispatch from a derived request,
    placed as ``ShardedOracle`` places them: the float reports as
    float32 (``parallel/sharded.py _place_reports``; ``pipeline.
    _fill_stats`` encodes int8 storage from them), the reputation in
    ``dtype``, the bounds as float32."""
    dev = torch.device(device)
    f32 = torch.float32
    return (_place_reports(np.asarray(req.reports), dev),
            torch.as_tensor(np.asarray(req.reputation)).to(
                device=dev, dtype=dtype),
            torch.as_tensor(np.asarray(req.scaled, dtype=bool), device=dev),
            torch.as_tensor(np.asarray(req.mins), dtype=f32, device=dev),
            torch.as_tensor(np.asarray(req.maxs), dtype=f32, device=dev))
