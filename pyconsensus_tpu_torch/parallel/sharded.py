"""The front door (``pyconsensus_tpu/parallel/sharded.py``
``sharded_consensus``): quarantine, parameter resolution, the fused-path
gate, placement, and the light pipeline on one device or on an event
mesh.

The gate opens on the CPU (where every kernel wrapper runs its plain
version) and on an sm_90 CUDA device whose shapes fit the Hopper kernels
(on a mesh, at its widest padded shard): on one device for sztorc and for
the multi-component variants fixed-variance and ica, on an event mesh of
more than one shard for sztorc (``parallel/fused_sharded.py``); scaled
events may not exceed E // 8 of the events, and take the gather-median
tail. Where it closes (exact eigh PCA, which ``pca_method="auto"`` picks
at R <= 4096, and for the multi-component variants also at E <= 1024;
scaled events beyond E // 8; float storage off the kernels' fit; on a
mesh every algorithm but sztorc), the plain core over the whole filled
matrix serves (``models/pipeline.py _consensus_core``, on a mesh
``parallel/plain_sharded.py``), as it does for k-means and dbscan-jit;
hierarchical and dbscan take the hybrid path (``_consensus_hybrid``:
distances on the device, clustering on the host; on a mesh the distances
fold over the shards). A closed gate on a mesh turns ``"power-fused"``
into ``"power"``, as the reference's does. Storage is the float reports
as float32, int8 sentinel storage or bfloat16 (:func:`resolve_auto_storage`
is the reference's rule between the last two). On a batch x event grid
(``make_mesh(batch > 1)``) one matrix resolves on the grid's first row,
as the reference's replicated placement computes it on every row.

:class:`ShardedOracle` is the ``Oracle`` over the same dispatch: the
class API with ``mesh=``, ``place()`` to keep the reports on the card
between resolutions, and the ``Oracle``'s fallback chain as its recovery
route. Every dispatch counts its path in
``pyconsensus_sharded_resolutions_total`` and
``pyconsensus_kernel_path_total`` (host-static labels: nothing is read
back from the device).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import obs
from ..faults import degrade as _degrade
from ..faults import plan as _faults
from ..faults.errors import InputError
from ..models.pipeline import (ALGORITHMS, FUSED_ALGORITHMS,
                               HYBRID_ALGORITHMS, ConsensusParams,
                               _consensus_core_light, check_matvec_dtype,
                               encode_reports, lattice_exact)
from ..ops.cuda_kernels import (fused_pca_fits, matmat_kernels_fit,
                                require_hopper, resolve_kernel_fits)
from ..ops.torch_kernels import (COV_EIGH_MAX_E, GRAM_EIGH_MAX_R,
                                 gather_median_pays)
from ..oracle import Oracle, parse_event_bounds
from .fused_sharded import fused_sharded_consensus
from .mesh import (EventShards, as_mesh, effective_median_block,
                   home_device, local_devices, make_mesh, padded_width,
                   place_event_shards)
from .plain_sharded import hybrid_sharded_consensus, plain_sharded_consensus

__all__ = ["sharded_consensus", "ShardedOracle", "resolve_device",
           "resolve_params", "resolve_auto_storage"]

_SHARDABLE_PCA = ("eigh-gram", "power", "power-fused")
_KNOWN_PCA = ("auto", "eigh-cov") + _SHARDABLE_PCA
_MULTI_COMPONENT = ("fixed-variance", "ica")
#: storage dtypes the kernels take ("" = the input's float storage)
_STORAGE = ("", "float32", "int8", "bfloat16")
_ITEMSIZE = {"int8": 1, "bfloat16": 2}


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


def _pick_pca_method(params: ConsensusParams, n_reporters: int,
                     n_events: int) -> str:
    """The single-device rows of the reference's pick. sztorc: explicit
    methods as requested, "auto"/"eigh-cov" to the Gram eigh at
    R <= 4096 and to fused power iteration beyond it. fixed-variance and
    ica: an explicit power-family request to "power" (orthogonal
    iteration), an explicit eigh as requested, "auto" to the covariance
    eigh at E <= 1024, the Gram eigh at R <= 4096 and "power" beyond."""
    if params.pca_method not in _KNOWN_PCA:
        raise ValueError(f"unknown PCA method: {params.pca_method!r}; "
                         f"choose from {_KNOWN_PCA}")
    if not params.allow_fused and params.pca_method == "power-fused":
        return "power"
    if params.algorithm in _MULTI_COMPONENT:
        if params.pca_method in ("power", "power-fused"):
            return "power"
        if params.pca_method in ("eigh-cov", "eigh-gram"):
            return params.pca_method
        if n_events <= COV_EIGH_MAX_E:
            return "eigh-cov"
        return ("eigh-gram" if n_reporters <= GRAM_EIGH_MAX_R
                else "power")
    if params.pca_method in _SHARDABLE_PCA:
        return params.pca_method
    if n_reporters <= GRAM_EIGH_MAX_R:
        return "eigh-gram"
    return "power-fused" if params.allow_fused else "power"


def _itemsize(p: ConsensusParams) -> int:
    return _ITEMSIZE.get(p.storage_dtype, 4)


def _multi_fits(p: ConsensusParams, n_reporters: int, n_events: int) -> bool:
    """The Hopper gate of the multi-component arm (the reference's
    ``sharded.py:275-278``): the direction fix's (k + 1)-row stack, with
    k the upper bound ``min(max_components, R)`` of both algorithms'
    sizing rules. Where the one-pass block kernel does not fit, the
    separable arm serves at any width: the reference's
    ``_MULTI_FUSED_MAX_E`` ceiling is a speed threshold measured on a TPU
    against its XLA path, which the port does not have yet."""
    k = min(p.max_components, n_reporters)
    return matmat_kernels_fit(n_events, k + 1, _itemsize(p))


def _use_fused_resolution(p: ConsensusParams, n_reporters: int,
                          n_events: int, n_event: int = 1) -> bool:
    """The fused-path gate at the widest shard of ``n_event``, padded to
    16 columns on a mesh; a mesh scores sztorc alone. Scaled events take
    it only as a small minority (``0 < n_scaled <= E // 8``, the
    reference's ``scaled_ok``)."""
    itemsize = _itemsize(p)
    e_local = -(-n_events // n_event)
    if n_event > 1:
        e_local = padded_width(e_local)
        algo_ok = p.algorithm == "sztorc"
    else:
        algo_ok = p.algorithm in FUSED_ALGORITHMS
    multi_fit = (p.algorithm not in _MULTI_COMPONENT
                 or _multi_fits(p, n_reporters, e_local))
    scaled_ok = not p.any_scaled or 0 < p.n_scaled <= n_events // 8
    return (p.allow_fused
            and algo_ok
            and p.pca_method in ("power", "power-fused")
            and scaled_ok
            and multi_fit
            and fused_pca_fits(e_local, itemsize)
            and resolve_kernel_fits(n_reporters, itemsize))


def resolve_params(p: ConsensusParams, R: int, E: int,
                   device: torch.device, n_event: int = 1) -> ConsensusParams:
    """The parameters ``sharded_consensus`` runs with (``any_scaled``,
    ``n_scaled`` and ``has_na`` already set) on ``device``, or on an event
    mesh of ``n_event`` shards whose first device is ``device``: the PCA
    method, the median's blocking, the fused gate and the plain core's
    scaled count, in the reference's order (``_resolve_sharded_params``),
    and its refusals."""
    if p.storage_dtype == "int8" and p.any_scaled:
        raise ValueError(
            "storage_dtype='int8' supports binary/categorical events "
            "only: scaled columns rescale to continuous values in [0, 1] "
            "that the half-unit int8 lattice would corrupt")
    if p.storage_dtype not in _STORAGE:
        raise ValueError(f"storage_dtype={p.storage_dtype!r}: choose from "
                         f"{_STORAGE}")
    check_matvec_dtype(p.matvec_dtype)
    if p.algorithm not in ALGORITHMS:
        raise InputError(f"unknown algorithm: {p.algorithm!r}")
    # the kernel wrappers serve the CPU through their plain versions and
    # an sm_90 card through the kernels; any other card is refused
    require_hopper(device)
    p = p._replace(pca_method=_pick_pca_method(p, R, E),
                   median_block=effective_median_block(
                       p.median_block, [device] * n_event))
    p = p._replace(fused_resolution=_use_fused_resolution(p, R, E, n_event))
    if p.fused_resolution:
        return p
    if p.pca_method == "power-fused" and n_event > 1:
        # a closed gate on a mesh: the plain mesh core's power iteration
        p = p._replace(pca_method="power")
    if p.storage_dtype == "int8":
        raise ValueError(
            "storage_dtype='int8' requires the fused kernel path (power-"
            "family pca_method, an sm_90 card or the CPU, a shape the "
            "kernels fit, sztorc on a mesh); resolved pca_method="
            f"{p.pca_method!r}, algorithm={p.algorithm!r}, device={device}, "
            f"event shards={n_event}, R={R}, E={E}; use "
            "storage_dtype='bfloat16'")
    # the plain core medians a gather of the scaled columns where that
    # pays, on one device (a mesh's median is shard-local and unblocked)
    return p._replace(n_scaled=p.n_scaled if n_event == 1
                      and p.median_block > 0
                      and gather_median_pays(p.n_scaled, E) else 0)


def _place_reports(reports, device: torch.device) -> torch.Tensor:
    """int8 sentinel storage keeps its dtype; float reports are placed as
    float32 (a bfloat16 ``storage_dtype`` casts them after the fill
    statistics and the rescale, in ``pipeline._fill_stats``)."""
    t = torch.as_tensor(reports)
    dtype = torch.int8 if t.dtype == torch.int8 else torch.float32
    return t.to(device=device, dtype=dtype).contiguous()


def resolve_auto_storage(p: ConsensusParams, R: int, E: int, device=None,
                         n_event: int = 1) -> tuple:
    """The reference's storage rule (``pyconsensus_tpu/parallel/
    sharded.py resolve_auto_storage``) on ``device`` (None: the card) or
    an event mesh of ``n_event`` shards: int8 sentinel storage exactly
    when the workload is all-binary and the int8 parameters resolve onto
    the fused kernel path (int8's half-unit lattice is exact there and
    reads a quarter of float32's bytes); bfloat16 otherwise (half the
    bytes; snapped binary outcomes stay exact, and the scaled medians
    read bfloat16 values). ``p.any_scaled`` must be set as
    ``sharded_consensus`` sets it. The fused path opens on an sm_90 card
    and on the CPU (the kernels' plain versions), where the reference's
    opens on a TPU only. Returns ``(storage_dtype, reason)``."""
    dev = resolve_device(device)
    if p.any_scaled:
        return "bfloat16", ("scaled events present: int8's half-unit "
                            "lattice cannot carry continuous rescaled "
                            "values")
    require_hopper(dev)
    trial = p._replace(storage_dtype="int8")
    trial = trial._replace(pca_method=_pick_pca_method(trial, R, E))
    if _use_fused_resolution(trial, R, E, n_event):
        return "int8", (f"all-binary workload on the fused path "
                        f"(pca_method={trial.pca_method!r}, "
                        f"n_event={n_event}, device={dev})")
    return "bfloat16", (f"fused gate closed (algorithm={p.algorithm!r}, "
                        f"resolved pca_method={trial.pca_method!r}, "
                        f"n_event={n_event}, device={dev}, "
                        f"allow_fused={p.allow_fused}, R={R}, E={E})")


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


def _record_sharded_dispatch(p: ConsensusParams, n_event: int) -> str:
    """Count one dispatch by its resolved path, and return the path
    (host-static labels; the result stays on the device, so nothing here
    can add a sync). The
    label values name the port's implementations: the path ``hybrid``,
    ``fused``, ``fused_sharded`` or ``plain`` (the reference's ``xla``),
    the kernel family ``cuda`` (the reference's ``pallas``), ``hybrid``
    or ``plain``."""
    if p.algorithm in HYBRID_ALGORITHMS:
        path = "hybrid"
    elif p.fused_resolution:
        path = "fused_sharded" if n_event > 1 else "fused"
    else:
        path = "plain"
    obs.counter(
        "pyconsensus_sharded_resolutions_total",
        "sharded_consensus dispatches by resolved execution path",
        labels=("path", "algorithm", "storage")).inc(
            path=path, algorithm=p.algorithm,
            storage=p.storage_dtype or "full")
    obs.counter(
        "pyconsensus_kernel_path_total",
        "resolutions dispatched by kernel family (which kernel family "
        "actually served traffic)", labels=("path",)).inc(
            path=path if path in ("hybrid", "plain") else "cuda")
    obs.gauge(
        "pyconsensus_mesh_event_shards",
        "event-axis width of the mesh used by the latest sharded "
        "resolution").set(n_event)
    return path


def _dispatch(reports, rep: torch.Tensor, scaled, mins, maxs,
              p: ConsensusParams, dev: torch.device, mesh) -> dict:
    """Count, place and run one resolution with resolved ``p``
    (``pyconsensus_tpu/parallel/sharded.py:600-643``): on an event mesh of
    more than one shard the hybrid path, the fused path or the plain core
    over the shards; else the light pipeline on ``dev`` (the fused path,
    the plain core or the hybrid path)."""
    n_event = len(mesh) if mesh is not None else 1
    path = _record_sharded_dispatch(p, n_event)
    if n_event > 1:
        if not isinstance(reports, EventShards):
            reports = place_event_shards(reports, mesh)
        if p.algorithm in HYBRID_ALGORITHMS:
            return hybrid_sharded_consensus(reports, rep, scaled, mins,
                                            maxs, p)
        if p.fused_resolution:
            return fused_sharded_consensus(reports, rep, p, scaled, mins,
                                           maxs)
        return plain_sharded_consensus(reports, rep, scaled, mins, maxs, p)
    x = (reports.shards[0] if isinstance(reports, EventShards)
         else _place_reports(reports, dev))
    # the bounds in the storage's float type, as the reference takes them
    # in its default dtype
    fdt = torch.float32
    args = (torch.as_tensor(scaled, device=dev),
            torch.as_tensor(mins, dtype=fdt, device=dev),
            torch.as_tensor(maxs, dtype=fdt, device=dev))
    # dispatch only (the hybrid path waits for its distances): the result
    # stays on the device
    with obs.span("pipeline.dispatch", algorithm=p.algorithm, path=path):
        return _consensus_core_light(x, rep, *args, p)


def sharded_consensus(reports, reputation=None, event_bounds=None,
                      params: Optional[ConsensusParams] = None, device=None,
                      *, mesh=None) -> dict:
    """Resolve one oracle: the light result dict (no (R, E) matrices),
    tensors left on ``device`` (or the mesh's first device), plus
    ``quarantined_rows`` (numpy). ``reports`` is a numpy array or a
    tensor: float with NaN for absence, or int8 sentinel storage
    (``encode_reports``) with ``storage_dtype="int8"``; on a mesh it may
    also be :class:`~pyconsensus_tpu_torch.parallel.mesh.EventShards`
    placed once by ``place_event_shards`` (a plain matrix is placed on
    every call). ``device=None`` means the card. ``mesh``
    (``make_mesh``) shards the events over its devices; a one-device mesh
    takes the single-device path, as in the reference. On a mesh that
    spans processes (``distributed.make_process_mesh`` or
    ``make_hybrid_mesh``) every rank calls with the same matrix, and each
    gets the whole result on its first device, the same bits on every
    rank."""
    if isinstance(reports, EventShards) and mesh is None:
        mesh = reports.mesh
    if mesh is not None:
        if device is not None:
            raise ValueError("pass either device= or mesh=, not both")
        mesh = as_mesh(mesh)
        if isinstance(reports, EventShards) and reports.mesh != mesh:
            raise ValueError(f"reports are placed on {reports.mesh}, not on "
                             f"the mesh {mesh}")
        dev = home_device(mesh)
    else:
        dev = resolve_device(device)
    n_event = len(mesh) if mesh is not None else 1
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
        # the chaos hook and the ±Inf quarantine on host float matrices
        # (int8 sentinel storage carries no Inf); the isfinite scan gives
        # has_na as well
        reports = _faults.corrupt("sharded.reports", reports)
        reports, quarantined, host_has_na = \
            _degrade.quarantine_nonfinite(reports)
    if is_host and reports.dtype == np.int8:
        has_na = bool((reports < 0).any())
    elif is_host:
        has_na = host_has_na
    else:
        has_na = p.has_na
    p = p._replace(any_scaled=bool(scaled.any()), has_na=has_na)
    for d in local_devices(mesh) if mesh is not None else ():
        require_hopper(d)
    p = resolve_params(p, R, E, dev, n_event)
    rep = _place_reputation(reputation, R, dev)
    result = _dispatch(reports, rep, scaled, mins, maxs, p, dev, mesh)
    result["quarantined_rows"] = (np.array([], dtype=np.int64)
                                  if quarantined is None
                                  else np.asarray(quarantined))
    return result


class ShardedOracle(Oracle):
    """The :class:`~pyconsensus_tpu_torch.oracle.Oracle` resolved through
    the front door's dispatch (``pyconsensus_tpu/parallel/sharded.py
    ShardedOracle``): every algorithm and storage, on one device or over
    an event mesh (the fused path where the gate opens, the plain core
    where it closes, the hybrid path for hierarchical and dbscan). The
    constructor adds ``mesh=`` (``make_mesh`` or a mesh that spans
    processes, every rank constructing it alike; default one shard on
    ``device``, which defaults to the card).
    ``consensus()`` returns the reference-shaped dict without the (R, E)
    matrices. A non-finite result walks the inherited fallback chain on
    the mesh's first device: the re-resolve trades the fused path for the
    plain core on purpose, and drops the (R, E) outputs too.

    Only ``backend="torch"``."""

    _LIGHT_RECOVERY = True
    _SPAN_ATTRS = {"sharded": True}

    def __init__(self, *args, mesh=None, device=None, **kwargs):
        if mesh is not None:
            if device is not None:
                raise ValueError("pass either device= or mesh=, not both")
            mesh = as_mesh(mesh)
            device = home_device(mesh)
        super().__init__(*args, device=device, **kwargs)
        if self.backend != "torch":
            raise ValueError("ShardedOracle requires backend='torch'")
        self.mesh = mesh if mesh is not None else make_mesh(
            devices=[self.device])
        for d in local_devices(self.mesh):
            require_hopper(d)
        R, E = self.reports.shape
        self.params = resolve_params(
            self.params._replace(n_scaled=int(self.scaled.sum())), R, E,
            self.device, len(self.mesh))
        self._placed = None

    def place(self) -> "ShardedOracle":
        """Place the reports on the mesh (and the reputation on its first
        device) once, so that each later ``consensus()`` uploads nothing.
        On a mesh that spans processes each rank places and encodes its
        own shards.
        With ``storage_dtype="int8"`` the placed storage is the int8
        encoding, made once on each device: the fused path would encode
        the float reports on every call, to the same bits. With
        ``"bfloat16"`` and no scaled event, the shards are cast once on
        each device when every value is on the {0, 0.5, 1} lattice (or
        absent), where the fill statistics read the same values either
        way; scaled events keep the raw float32 shards, which each call
        rescales before its cast. ``reports`` stays the host matrix the
        recovery rungs read: change it and call ``place()`` again."""
        placed = place_event_shards(self.reports, self.mesh)
        storage = self.params.storage_dtype
        if storage == "int8":
            placed = placed._replace(shards=tuple(
                encode_reports(x) for x in placed.shards))
        elif (storage == "bfloat16" and not self.params.any_scaled
              and lattice_exact(self.reports)):
            placed = placed._replace(shards=tuple(
                x.to(torch.bfloat16) for x in placed.shards))
        self._placed = (placed, self._device_reputation())
        return self

    def _device_reputation(self) -> torch.Tensor:
        # in the default dtype, as the Oracle's plain core takes it
        return torch.as_tensor(self.reputation,
                               dtype=torch.get_default_dtype(),
                               device=self.device)

    def resolve_raw(self) -> dict:
        """The flat light result dict, tensors left on the mesh's first
        device."""
        reports, rep = (self._placed if self._placed is not None
                        else (self.reports, self._device_reputation()))
        mesh = self.mesh if len(self.mesh) > 1 else None
        return _dispatch(reports, rep, self.scaled, self.mins, self.maxs,
                         self.params, self.device, mesh)
