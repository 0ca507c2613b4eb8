"""The single-device front door (``pyconsensus_tpu/parallel/sharded.py``
``sharded_consensus``): quarantine, parameter resolution, the fused-path
gate, placement, and the light fused pipeline.

The gate opens on the CPU (where every kernel wrapper runs its plain
version) and on an sm_90 CUDA device whose shapes fit the Hopper kernels.
What this slice does not cover raises ``NotImplementedError`` naming the
``ROADMAP.md`` slice that brings it: scaled events, algorithms other
than sztorc, exact eigh PCA (which ``pca_method="auto"`` picks at
R <= 4096), the non-fused pipeline and meshes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..faults.degrade import quarantine_nonfinite
from ..faults.errors import InputError
from ..models.pipeline import (ROADMAP_PLAIN, ROADMAP_SCALED,
                               ConsensusParams, _consensus_core_light)
from ..ops.cuda_kernels import fused_pca_fits, resolve_kernel_fits
from ..oracle import parse_event_bounds

__all__ = ["sharded_consensus", "resolve_device", "resolve_params"]

_SHARDABLE_PCA = ("eigh-gram", "power", "power-fused")
_KNOWN_PCA = ("auto", "eigh-cov") + _SHARDABLE_PCA
#: the reference's R ceiling for the exact Gram eigh under "auto"
_GRAM_EIGH_MAX_R = 4096
#: storage dtypes the kernels take ("" = the input's float storage)
_STORAGE = ("", "float32", "int8")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises ``RuntimeError`` when the card is
    asked for and there is none: only an explicit ``device="cpu"`` runs
    the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain torch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _hopper(device: torch.device) -> bool:
    return (device.type == "cuda"
            and torch.cuda.get_device_capability(device) == (9, 0))


def _kernels_serve(device: torch.device) -> bool:
    """Whether the kernel wrappers serve this device: the CPU through
    their plain versions, an sm_90 card through the kernels."""
    return device.type == "cpu" or _hopper(device)


def _pick_pca_method(params: ConsensusParams, n_reporters: int,
                     device: torch.device) -> str:
    """The single-device sztorc rows of the reference's pick: explicit
    methods as requested, "auto"/"eigh-cov" to the Gram eigh at
    R <= 4096 and to fused power iteration beyond it."""
    if params.pca_method not in _KNOWN_PCA:
        raise ValueError(f"unknown PCA method: {params.pca_method!r}; "
                         f"choose from {_KNOWN_PCA}")
    if not params.allow_fused and params.pca_method == "power-fused":
        return "power"
    if params.pca_method in _SHARDABLE_PCA:
        return params.pca_method
    if n_reporters <= _GRAM_EIGH_MAX_R:
        return "eigh-gram"
    if params.allow_fused and _kernels_serve(device):
        return "power-fused"
    return "power"


def _use_fused_resolution(p: ConsensusParams, n_reporters: int,
                          n_events: int, device: torch.device) -> bool:
    itemsize = 1 if p.storage_dtype == "int8" else 4
    return (p.allow_fused
            and _kernels_serve(device)
            and p.algorithm == "sztorc"
            and p.pca_method in ("power", "power-fused")
            and not p.any_scaled
            and fused_pca_fits(n_events, itemsize)
            and resolve_kernel_fits(n_reporters, itemsize))


def resolve_params(p: ConsensusParams, R: int, E: int,
                   device: torch.device) -> ConsensusParams:
    """The parameters ``sharded_consensus`` runs with (``any_scaled`` and
    ``has_na`` already set): the PCA method, the fused gate, and the
    refusals of what this slice does not cover."""
    if p.storage_dtype == "int8" and p.any_scaled:
        raise ValueError(
            "storage_dtype='int8' supports binary/categorical events "
            "only: scaled columns rescale to continuous values in [0, 1] "
            "that the half-unit int8 lattice would corrupt")
    if p.storage_dtype not in _STORAGE or p.matvec_dtype:
        raise NotImplementedError(
            f"storage_dtype={p.storage_dtype!r}, "
            f"matvec_dtype={p.matvec_dtype!r}: this slice's kernels take "
            "int8 sentinel or float32 storage; bfloat16 storage is queued "
            "in ROADMAP.md §A.3")
    if p.any_scaled:
        raise NotImplementedError(f"scaled events: {ROADMAP_SCALED}")
    if p.algorithm != "sztorc":
        raise NotImplementedError(f"algorithm={p.algorithm!r}: "
                                  f"{ROADMAP_PLAIN}")
    p = p._replace(pca_method=_pick_pca_method(p, R, device))
    p = p._replace(fused_resolution=_use_fused_resolution(p, R, E, device))
    if p.fused_resolution:
        return p
    if p.storage_dtype == "int8":
        raise ValueError(
            "storage_dtype='int8' requires the fused kernel path (power-"
            "family pca_method, an sm_90 card or the CPU, a shape the "
            f"kernels fit); resolved pca_method={p.pca_method!r}, "
            f"device={device}, R={R}, E={E}")
    if _kernels_serve(device):
        raise NotImplementedError(
            f"pca_method={p.pca_method!r} (R={R}) resolves to the non-fused "
            f"pipeline: {ROADMAP_PLAIN}")
    raise NotImplementedError(
        f"device {device} is not sm_90: the port's kernels are built for "
        "Hopper (sm_90a) only")


def _place_reports(reports, device: torch.device) -> torch.Tensor:
    """int8 sentinel storage keeps its dtype; float reports compute in
    float32 (the kernels' storage type)."""
    t = torch.as_tensor(reports)
    dtype = torch.int8 if t.dtype == torch.int8 else torch.float32
    return t.to(device=device, dtype=dtype).contiguous()


def _place_reputation(reputation, R: int, device: torch.device):
    """A uniform float32 reputation by default; a given one keeps a
    float64 dtype (the reference's accumulation dtype follows it)."""
    if reputation is None:
        return torch.full((R,), 1.0 / R, dtype=torch.float32, device=device)
    t = torch.as_tensor(reputation)
    dtype = t.dtype if t.dtype in (torch.float32, torch.float64) \
        else torch.float32
    t = t.to(device=device, dtype=dtype).reshape(-1)
    if t.shape != (R,):
        raise InputError(f"reputation has {t.shape[0]} entries for {R} "
                         "reporters", got=t.shape[0], expected=R)
    return t


def sharded_consensus(reports, reputation=None, event_bounds=None,
                      params: Optional[ConsensusParams] = None, device=None,
                      *, mesh=None) -> dict:
    """Resolve one oracle on one device: the light result dict (no
    (R, E) matrices), tensors left on ``device``, plus
    ``quarantined_rows`` (numpy). ``reports`` is a numpy array or a
    tensor: float with NaN for absence, or int8 sentinel storage
    (``encode_reports``) with ``storage_dtype="int8"``. ``device=None``
    means the card."""
    if mesh is not None:
        raise NotImplementedError(
            "meshes are not ported yet: ROADMAP.md §A.10 (multi-GPU)")
    dev = resolve_device(device)
    if reports.ndim != 2:
        raise InputError(f"reports must be 2-D, got shape "
                         f"{tuple(reports.shape)}")
    R, E = reports.shape
    p = params if params is not None else ConsensusParams()
    is_host = isinstance(reports, np.ndarray)
    quarantined = None
    host_has_na = False
    scaled, mins, maxs = parse_event_bounds(event_bounds, E)
    p = p._replace(n_scaled=int(scaled.sum()))
    if is_host and reports.dtype != np.int8:
        reports, quarantined, host_has_na = quarantine_nonfinite(reports)
    if is_host and reports.dtype == np.int8:
        has_na = bool((reports < 0).any())
    elif is_host:
        has_na = host_has_na
    else:
        has_na = p.has_na
    p = p._replace(any_scaled=bool(scaled.any()), has_na=has_na)
    p = resolve_params(p, R, E, dev)
    x = _place_reports(reports, dev)
    rep = _place_reputation(reputation, R, dev)
    result = _consensus_core_light(
        x, rep, torch.as_tensor(scaled, device=dev),
        torch.as_tensor(mins, device=dev), torch.as_tensor(maxs, device=dev),
        p)
    result["quarantined_rows"] = (np.array([], dtype=np.int64)
                                  if quarantined is None
                                  else np.asarray(quarantined))
    return result
