"""The front door (``pyconsensus_tpu/parallel/sharded.py``
``sharded_consensus``): quarantine, parameter resolution, the fused-path
gate, placement, and the light pipeline on one device or on an event
mesh.

The gate opens on the CPU (where every kernel wrapper runs its plain
version) and on an sm_90 CUDA device whose shapes fit the Hopper kernels:
on one device for sztorc and for the multi-component variants
fixed-variance and ica, on an event mesh of more than one shard for
sztorc (``parallel/fused_sharded.py``); scaled events may not exceed
E // 8 of the events, and on one device they take the gather-median
tail. Where it closes on one device (exact eigh PCA, which
``pca_method="auto"`` picks at R <= 4096, and for the multi-component
variants also at E <= 1024; scaled events beyond E // 8; float storage
off the kernels' fit), the plain core over the whole filled matrix
serves (``models/pipeline.py _consensus_core``), as it does for k-means
and dbscan-jit; hierarchical and dbscan take the hybrid path
(``_consensus_hybrid``: distances on the device, clustering on the host).
Storage is the float reports as float32, int8 sentinel storage or
bfloat16 (:func:`resolve_auto_storage` is the reference's rule between
the last two). What the port does not cover yet raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings it: on
an event mesh scaled events, bfloat16, the plain core, the clustering
variants and batch meshes.

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
                               HYBRID_ALGORITHMS, ROADMAP_BF16,
                               ROADMAP_MESH_PLAIN, ROADMAP_SCALED_FUSED,
                               ConsensusParams, _consensus_core_light,
                               check_matvec_dtype, encode_reports)
from ..ops.cuda_kernels import (fused_pca_fits, matmat_kernels_fit,
                                require_hopper, resolve_kernel_fits)
from ..ops.torch_kernels import (COV_EIGH_MAX_E, GRAM_EIGH_MAX_R,
                                 gather_median_pays)
from ..oracle import Oracle, parse_event_bounds
from .fused_sharded import fused_sharded_consensus
from .mesh import EventShards, as_mesh, make_mesh, place_event_shards

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
    """The fused-path gate at the widest shard of ``n_event``. Scaled
    events take it only as a small minority (``0 < n_scaled <= E // 8``,
    the reference's ``scaled_ok``)."""
    itemsize = _itemsize(p)
    e_local = -(-n_events // n_event)
    multi_fit = (p.algorithm not in _MULTI_COMPONENT
                 or _multi_fits(p, n_reporters, e_local))
    scaled_ok = not p.any_scaled or 0 < p.n_scaled <= n_events // 8
    return (p.allow_fused
            and p.algorithm in FUSED_ALGORITHMS
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
    method, the fused gate, the plain core's scaled count, and the
    refusals of what the port does not cover."""
    if p.storage_dtype == "int8" and p.any_scaled:
        raise ValueError(
            "storage_dtype='int8' supports binary/categorical events "
            "only: scaled columns rescale to continuous values in [0, 1] "
            "that the half-unit int8 lattice would corrupt")
    if p.storage_dtype not in _STORAGE:
        raise ValueError(f"storage_dtype={p.storage_dtype!r}: choose from "
                         f"{_STORAGE}")
    check_matvec_dtype(p.matvec_dtype)
    if n_event > 1 and (p.storage_dtype == "bfloat16"
                        or p.matvec_dtype == "bfloat16"):
        raise NotImplementedError(
            f"storage_dtype={p.storage_dtype!r}, matvec_dtype="
            f"{p.matvec_dtype!r} on an event mesh of {n_event} shards: "
            f"{ROADMAP_BF16}")
    if p.algorithm not in ALGORITHMS:
        raise InputError(f"unknown algorithm: {p.algorithm!r}")
    if n_event > 1 and p.algorithm != "sztorc":
        raise NotImplementedError(
            f"algorithm={p.algorithm!r} on an event mesh of {n_event} "
            f"shards takes the reference's XLA or hybrid path: "
            f"{ROADMAP_MESH_PLAIN}")
    # the kernel wrappers serve the CPU through their plain versions and
    # an sm_90 card through the kernels; any other card is refused
    require_hopper(device)
    p = p._replace(pca_method=_pick_pca_method(p, R, E))
    p = p._replace(fused_resolution=_use_fused_resolution(p, R, E, n_event))
    if p.fused_resolution:
        if p.any_scaled and n_event > 1:
            raise NotImplementedError(
                f"{p.n_scaled} scaled of {E} events (at most E // 8) on an "
                f"event mesh of {n_event} shards: {ROADMAP_SCALED_FUSED}")
        return p
    if p.storage_dtype == "int8":
        raise ValueError(
            "storage_dtype='int8' requires the fused kernel path (power-"
            "family pca_method, an sm_90 card or the CPU, a shape the "
            f"kernels fit); resolved pca_method={p.pca_method!r}, "
            f"device={device}, R={R}, E={E}")
    if n_event > 1:
        raise NotImplementedError(
            f"pca_method={p.pca_method!r}, {p.n_scaled} scaled events: the "
            f"fused gate closes on the mesh: {ROADMAP_MESH_PLAIN}")
    # the plain core medians a gather of the scaled columns where that pays
    return p._replace(n_scaled=p.n_scaled if p.median_block > 0
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
    # the event mesh's fused path scores sztorc alone
    if ((n_event == 1 or trial.algorithm == "sztorc")
            and _use_fused_resolution(trial, R, E, n_event)):
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
    """Count, place and run one resolution with resolved ``p``: the fused
    path over an event mesh of more than one shard, else the light
    pipeline on ``dev`` (the fused path, the plain core or the hybrid
    path)."""
    n_event = len(mesh) if mesh is not None else 1
    path = _record_sharded_dispatch(p, n_event)
    if n_event > 1:
        if not isinstance(reports, EventShards):
            reports = place_event_shards(reports, mesh)
        return fused_sharded_consensus(reports, rep, p)
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
    takes the single-device path, as in the reference."""
    if isinstance(reports, EventShards) and mesh is None:
        mesh = reports.mesh
    if mesh is not None:
        if device is not None:
            raise ValueError("pass either device= or mesh=, not both")
        mesh = as_mesh(mesh)
        if isinstance(reports, EventShards) and reports.mesh != mesh:
            raise ValueError(f"reports are placed on {reports.mesh}, not on "
                             f"the mesh {mesh}")
        dev = mesh[0]
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
    for d in mesh or ():
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
    ShardedOracle``): the fused path where the gate opens (on one device
    or, for sztorc, over an event mesh), the plain core where it closes
    on one device. The constructor adds ``mesh=`` (``make_mesh``; default
    one shard on ``device``, which defaults to the card).
    ``consensus()`` returns the reference-shaped dict without the (R, E)
    matrices. A non-finite result walks the inherited fallback chain on
    the mesh's first device: the re-resolve trades the fused path for the
    plain core on purpose, and drops the (R, E) outputs too.

    Only ``backend="torch"``. What the port's mesh does not cover raises
    naming ``ROADMAP.md`` §A.10, as ``sharded_consensus`` does."""

    _LIGHT_RECOVERY = True
    _SPAN_ATTRS = {"sharded": True}

    def __init__(self, *args, mesh=None, device=None, **kwargs):
        if mesh is not None:
            if device is not None:
                raise ValueError("pass either device= or mesh=, not both")
            mesh = as_mesh(mesh)
            device = mesh[0]
        super().__init__(*args, device=device, **kwargs)
        if self.backend != "torch":
            raise ValueError("ShardedOracle requires backend='torch'")
        self.mesh = mesh if mesh is not None else make_mesh(
            devices=[self.device])
        for d in self.mesh:
            require_hopper(d)
        R, E = self.reports.shape
        self.params = resolve_params(
            self.params._replace(n_scaled=int(self.scaled.sum())), R, E,
            self.device, len(self.mesh))
        self._placed = None

    def place(self) -> "ShardedOracle":
        """Place the reports on the mesh (and the reputation on its first
        device) once, so that each later ``consensus()`` uploads nothing.
        With ``storage_dtype="int8"`` the placed storage is the int8
        encoding, made once on the device: the fused path would encode
        the float reports on every call, to the same bits. ``reports``
        stays the host matrix the recovery rungs read: change it and call
        ``place()`` again."""
        placed = place_event_shards(self.reports, self.mesh)
        if self.params.storage_dtype == "int8":
            placed = placed._replace(shards=tuple(
                encode_reports(x) for x in placed.shards))
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
