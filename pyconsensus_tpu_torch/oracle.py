"""The public ``Oracle`` API (``pyconsensus_tpu/oracle.py``), event bounds
parsing and the reference-shaped result dict.

Usage::

    from pyconsensus_tpu_torch import Oracle
    result = Oracle(reports=my_matrix, algorithm="sztorc").consensus()

``reports`` is a (reporters x events) float matrix; ``NaN`` marks a
non-report; binary events take values in {0, 0.5, 1}; scaled events carry
raw values plus an ``event_bounds`` entry ``{"scaled": True, "min": m,
"max": M}``. ``backend="torch"`` (the default) runs the plain core on
``device`` (None: the card; ``"cpu"`` on request), or for hierarchical
and dbscan the hybrid path (distances on the device, clustering on the
host), ``backend="numpy"`` the numpy pipeline on the host. ``consensus()`` returns the reference's
nested result dict of host numpy values. A torch result with non-finite
decision outputs walks the reference's fallback chain (power-fused ->
eigh-gram -> numpy, ``faults.degrade``) and raises the classified
error when every rung stays non-finite.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import obs
from .faults import degrade as _degrade
from .faults import plan as _faults
from .faults.errors import InputError
from .models.pipeline import (ALGORITHMS, HYBRID_ALGORITHMS,
                              ConsensusParams, consensus_np, consensus_torch,
                              decode_reports, resolve_encoded)
from .ops.torch_kernels import gather_median_pays, resolve_pca_method

__all__ = ["Oracle", "ALGORITHMS", "BACKENDS", "STORAGE_DTYPES",
           "parse_event_bounds", "assemble_result",
           "record_consensus_result"]

BACKENDS = ("numpy", "torch")
#: legal storage_dtype values ("" = the default float dtype)
STORAGE_DTYPES = ("", "float32", "bfloat16", "int8")
#: accepted lowercase spellings -> canonical algorithm name
_ALGORITHM_ALIASES = {
    "pca": "sztorc",
    "first-component": "sztorc",
    "kmeans": "k-means",
    "agglomerative": "hierarchical",
}


def parse_event_bounds(event_bounds, n_events: int):
    """Parse a per-event list of ``{"scaled": bool, "min": float,
    "max": float}`` dicts (``None`` = binary) into ``(scaled, mins,
    maxs)`` numpy arrays."""
    scaled = np.zeros(n_events, dtype=bool)
    mins = np.zeros(n_events, dtype=np.float64)
    maxs = np.ones(n_events, dtype=np.float64)
    if event_bounds is None:
        return scaled, mins, maxs
    if len(event_bounds) != n_events:
        raise InputError(f"event_bounds has {len(event_bounds)} "
                         f"entries for {n_events} events",
                         got=len(event_bounds), expected=n_events)
    for j, b in enumerate(event_bounds):
        if b is None:
            continue
        scaled[j] = bool(b.get("scaled", False))
        mins[j] = float(b.get("min", 0.0))
        maxs[j] = float(b.get("max", 1.0))
        if scaled[j] and maxs[j] <= mins[j]:
            raise InputError(f"event {j}: max must exceed min "
                             f"for a scaled event", event=j)
    return scaled, mins, maxs


def assemble_result(raw: dict) -> dict:
    """The nested result dict (agents / events / scalars) from a flat
    pipeline result; (R, E)-sized keys only when present."""
    result = {
        "agents": {
            "old_rep": raw["old_rep"],
            "this_rep": raw["this_rep"],
            "smooth_rep": raw["smooth_rep"],
            "na_row": raw["na_row"],
            "participation_rows": raw["participation_rows"],
            "relative_part": raw["na_bonus_rows"],
            "reporter_bonus": raw["reporter_bonus"],
        },
        "events": {
            "outcomes_raw": raw["outcomes_raw"],
            "consensus_reward": raw["consensus_reward"],
            "certainty": raw["certainty"],
            "participation_columns": raw["participation_columns"],
            "author_bonus": raw["author_bonus"],
            "outcomes_adjusted": raw["outcomes_adjusted"],
            "outcomes_final": raw["outcomes_final"],
        },
        "participation": float(1.0 - raw["percent_na"]),
        "certainty": float(raw["avg_certainty"]),
        "convergence": bool(raw["convergence"]),
        "iterations": int(raw["iterations"]),
    }
    for key in ("original", "filled"):
        if key in raw:
            result[key] = raw[key]
    if "first_loading" in raw:
        result["events"]["adj_first_loadings"] = raw["first_loading"]
    if "ica_converged" in raw:
        result["ica_converged"] = bool(raw["ica_converged"])
    return result


def record_consensus_result(result: dict, algorithm: str,
                            backend: str) -> None:
    """Emit the per-``consensus()`` convergence metrics from an assembled
    HOST result dict: everything read here is an O(R) vector or scalar
    already on the host, so this adds no device sync. Shared by
    :class:`Oracle` and ``parallel.ShardedOracle``."""
    obs.counter(
        "pyconsensus_consensus_total",
        "finished consensus() resolutions",
        labels=("algorithm", "backend", "converged")).inc(
            algorithm=algorithm, backend=backend,
            converged=str(bool(result["convergence"])).lower())
    obs.histogram(
        "pyconsensus_consensus_iterations",
        "reputation-redistribution iterations per consensus() call",
        labels=("algorithm", "backend"),
        buckets=obs.ITERATION_BUCKETS).observe(
            int(result["iterations"]), algorithm=algorithm, backend=backend)
    agents = result["agents"]
    old = np.asarray(agents["old_rep"], dtype=np.float64)
    mass = obs.histogram(
        "pyconsensus_redistribution_mass",
        "reputation mass moved per resolution: raw (catch) redistribution "
        "|this_rep - old_rep|/2 and smoothed |smooth_rep - old_rep|/2",
        labels=("kind",), buckets=obs.MAGNITUDE_BUCKETS)
    mass.observe(0.5 * float(np.abs(
        np.asarray(agents["this_rep"], dtype=np.float64) - old).sum()),
        kind="raw")
    mass.observe(0.5 * float(np.abs(
        np.asarray(agents["smooth_rep"], dtype=np.float64) - old).sum()),
        kind="smooth")


def _host(v):
    """A result value on the host: one copy per tensor (a bfloat16 one, the
    compact filled matrix, as its exact float32 values: numpy has no
    bfloat16)."""
    if not hasattr(v, "cpu"):
        return v
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.cpu().numpy()


class Oracle:
    """The consensus oracle with a selectable backend, constructor for
    constructor the reference's ``Oracle``.

    reports : (R, E) array-like; NaN = no report. An int8 matrix is
        sentinel storage (``encode_reports``) or raw {0, 1} votes, as
        ``encoded`` says (None: by :func:`resolve_encoded`).
    event_bounds : per-event ``{"scaled": bool, "min": m, "max": M}`` or
        None (binary/categorical).
    reputation : (R,) non-negative prior, uniform by default.
    catch_tolerance, alpha, variance_threshold, max_components,
    max_iterations, convergence_tolerance : the consensus knobs.
    num_clusters, hierarchy_threshold, dbscan_eps, dbscan_min_samples :
        the clustering knobs.
    algorithm : ``sztorc`` (aliases ``pca``, ``first-component``),
        ``fixed-variance``, ``ica``, ``k-means`` (alias ``kmeans``),
        ``dbscan-jit``, ``hierarchical`` (alias ``agglomerative``) or
        ``dbscan``.
    backend : ``"torch"`` (on ``device``: the plain core, or the hybrid
        path for hierarchical and dbscan) or ``"numpy"``.
    pca_method : ``auto`` | ``eigh-cov`` | ``eigh-gram`` | ``power`` |
        ``power-fused`` (the sweeps on the Hopper kernels).
    power_iters, power_tol : the power-iteration cap and early-exit
        tolerance (0 = machine-precision floor, < 0 = none).
    matvec_dtype, storage_dtype : ``storage_dtype="float32"`` or
        ``"bfloat16"`` stores the filled matrix in that dtype (int8 needs
        the fused path, ``sharded_consensus``); ``matvec_dtype=
        "bfloat16"`` narrows sztorc's power sweeps alone.
    verbose : print a summary after ``consensus()``.
    device : the torch backend's device; None means the card.
    """

    def __init__(self,
                 reports=None,
                 event_bounds: Optional[Sequence] = None,
                 reputation=None,
                 catch_tolerance: float = 0.1,
                 alpha: float = 0.1,
                 variance_threshold: float = 0.9,
                 max_components: int = 5,
                 max_iterations: int = 1,
                 convergence_tolerance: float = 1e-6,
                 num_clusters: int = 2,
                 hierarchy_threshold: float = 0.5,
                 dbscan_eps: float = 0.5,
                 dbscan_min_samples: int = 2,
                 algorithm: str = "sztorc",
                 backend: str = "torch",
                 pca_method: str = "auto",
                 power_iters: int = 128,
                 power_tol: float = 0.0,
                 matvec_dtype: str = "",
                 storage_dtype: str = "",
                 encoded: Optional[bool] = None,
                 verbose: bool = False,
                 device=None):
        if reports is None:
            raise InputError("reports matrix is required")
        if np.asarray(reports).dtype == np.int8:
            if resolve_encoded(reports, encoded):
                reports = decode_reports(np.asarray(reports))
        elif encoded:
            raise ValueError(
                "encoded=True requires an int8 sentinel matrix "
                f"(encode_reports), got dtype {np.asarray(reports).dtype}")
        self.reports = np.asarray(reports, dtype=np.float64)
        if self.reports.ndim != 2:
            raise InputError(f"reports must be 2-D (reporters x events), "
                             f"got shape {self.reports.shape}",
                             shape=tuple(self.reports.shape))
        if self.reports.size == 0:
            raise InputError(
                f"reports matrix is empty (shape {self.reports.shape}): a "
                "resolution needs at least one reporter and one event",
                shape=tuple(self.reports.shape))
        n_reporters, n_events = self.reports.shape

        algorithm = algorithm.lower()
        algorithm = _ALGORITHM_ALIASES.get(algorithm, algorithm)
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}; "
                             f"choose from {ALGORITHMS}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"choose from {BACKENDS}")

        self.event_bounds = event_bounds
        self.scaled, self.mins, self.maxs = parse_event_bounds(event_bounds,
                                                               n_events)
        if reputation is None:
            rep = np.full(n_reporters, 1.0 / n_reporters, dtype=np.float64)
        else:
            rep = np.asarray(reputation, dtype=np.float64)
            if rep.shape != (n_reporters,):
                raise InputError(f"reputation shape {rep.shape} does not "
                                 f"match {n_reporters} reporters",
                                 shape=tuple(rep.shape),
                                 expected=n_reporters)
            if np.isnan(rep).any():
                raise InputError("reputation must not contain NaN")
            if not np.isfinite(rep).all():
                raise InputError("reputation must be finite (found ±Inf)")
            if (rep < 0).any():
                raise InputError("reputation must be non-negative")
            if rep.sum() <= 0:
                raise InputError("reputation must have positive total mass")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must lie in [0, 1]")
        if catch_tolerance < 0.0:
            raise ValueError("catch_tolerance must be non-negative")
        for name, value in (("max_components", max_components),
                            ("max_iterations", max_iterations),
                            ("num_clusters", num_clusters),
                            ("dbscan_min_samples", dbscan_min_samples),
                            ("power_iters", power_iters)):
            if int(value) < 1:
                raise ValueError(f"{name} must be >= 1")
        if dbscan_eps <= 0.0:
            raise ValueError("dbscan_eps must be positive")
        if storage_dtype not in STORAGE_DTYPES:
            raise ValueError(f"unknown storage_dtype {storage_dtype!r}; "
                             f"choose from {STORAGE_DTYPES}")
        if storage_dtype == "int8" and algorithm in HYBRID_ALGORITHMS:
            raise ValueError(
                "storage_dtype='int8' is not supported by the hybrid "
                f"clustering algorithms ({algorithm!r}): the interpolated "
                "fill values are continuous")

        if backend == "torch":
            from .parallel.sharded import resolve_device

            self.device = resolve_device(device)
        else:
            self.device = None
        # the chaos hook, then quarantine, after every validation: a
        # refused construction counts no quarantined row. Rows holding
        # ±Inf are not heard; the isfinite scan gives has_na as well
        self.reports = _faults.corrupt("oracle.reports", self.reports)
        self.reports, self.quarantined_rows, has_na = \
            _degrade.quarantine_nonfinite(self.reports)
        self.reputation = rep
        self.backend = backend
        self.verbose = verbose
        n_sc = int(self.scaled.sum())
        self.params = ConsensusParams(
            # the exact count where the median gathers the scaled columns
            n_scaled=n_sc if gather_median_pays(n_sc, n_events) else 0,
            any_scaled=bool(self.scaled.any()),
            has_na=has_na,
            algorithm=algorithm,
            alpha=float(alpha),
            catch_tolerance=float(catch_tolerance),
            variance_threshold=float(variance_threshold),
            max_components=int(max_components),
            max_iterations=int(max_iterations),
            convergence_tolerance=float(convergence_tolerance),
            num_clusters=int(num_clusters),
            hierarchy_threshold=float(hierarchy_threshold),
            dbscan_eps=float(dbscan_eps),
            dbscan_min_samples=int(dbscan_min_samples),
            pca_method=pca_method,
            power_iters=int(power_iters),
            power_tol=float(power_tol),
            matvec_dtype=str(matvec_dtype),
            storage_dtype=str(storage_dtype),
        )

    #: the fallback rungs drop the (R, E) outputs (``ShardedOracle``'s
    #: result never carries them)
    _LIGHT_RECOVERY = False
    #: extra attributes of the ``oracle.consensus`` span
    _SPAN_ATTRS: dict = {}

    def resolve_raw(self) -> dict:
        """Run the pipeline: the flat result dict, tensors left on the
        device on the torch backend."""
        if self.backend == "numpy":
            return consensus_np(self.reports, self.reputation, self.scaled,
                                self.mins, self.maxs, self.params)
        return consensus_torch(self.reports, self.reputation, self.scaled,
                               self.mins, self.maxs, self.params,
                               device=self.device)

    # -- graceful degradation (faults.degrade's fallback chain) -----------

    def _resolve_once(self, update: dict) -> dict:
        """One rung of the fallback chain: the resolution again with
        ConsensusParams overrides on the torch backend (on the Oracle's
        device), or the numpy pipeline on the host when ``update ==
        {"backend": "numpy"}``. ``ShardedOracle`` inherits this as its
        recovery route: the rare re-resolve trades the fused path for the
        plain core on purpose."""
        if update.get("backend") == "numpy":
            return consensus_np(self.reports, self.reputation, self.scaled,
                                self.mins, self.maxs, self.params)
        p2 = self.params._replace(**update)
        if p2.storage_dtype == "int8":
            # int8 sentinel storage serves only the fused path the chain
            # falls back FROM; the rung runs the plain core on the floats
            p2 = p2._replace(storage_dtype="")
        return consensus_torch(self.reports, self.reputation, self.scaled,
                               self.mins, self.maxs, p2, device=self.device,
                               light=self._LIGHT_RECOVERY)

    def _effective_pca_method(self) -> str:
        """The pca_method the torch path actually RAN: ``"auto"`` resolves
        by shape (``torch_kernels.resolve_pca_method``), so the chain keys
        on the resolved method; an unresolved ``"auto"`` would skip the
        eigh-gram rung where auto picks power iteration."""
        R, E = self.reports.shape
        return resolve_pca_method(R, E, self.params.pca_method,
                                  self.device or torch.device("cpu"))

    def _degraded_raw(self) -> dict:
        """Walk the fallback chain after a non-finite result, emitting
        ``pyconsensus_fallbacks_total{from,to,reason}`` per hop; raises the
        classified taxonomy error when every rung stays non-finite."""
        effective = self._effective_pca_method()
        for frm, to, update in _degrade.fallback_steps(effective,
                                                       self.backend):
            _degrade.record_fallback(frm, to, "nonfinite_result")
            raw = {k: _host(v) for k, v in self._resolve_once(update).items()}
            if not _degrade.result_nonfinite(raw):
                return raw
        _degrade.raise_exhausted(effective, self.params.algorithm)

    def _fetch_raw(self) -> dict:
        """Fetch the flat result to the host (the completion barrier) and
        run the degradation checks: the ``oracle.raw_result`` chaos site
        simulates an internal NaN storm, and a non-finite torch result
        walks the fallback chain instead of being returned. A launch or
        build error raised while resolving propagates: it starts no
        rung."""
        raw = {k: _host(v) for k, v in self.resolve_raw().items()}
        raw = _faults.corrupt("oracle.raw_result", raw)
        if self.backend == "torch" and _degrade.result_nonfinite(raw):
            raw = self._degraded_raw()
        return raw

    def consensus(self) -> dict:
        """Resolve outcomes and reputation: the reference-shaped nested
        result dict of host numpy values, plus ``quarantined_rows`` (the
        reporter rows not heard for carrying ±Inf, empty on clean
        inputs)."""
        with obs.span("oracle.consensus",
                      algorithm=self.params.algorithm, backend=self.backend,
                      reporters=self.reports.shape[0],
                      events=self.reports.shape[1], **self._SPAN_ATTRS):
            # the host fetch is the span's completion barrier
            result = assemble_result(self._fetch_raw())
        result["quarantined_rows"] = (
            np.array([], dtype=np.int64) if self.quarantined_rows is None
            else np.asarray(self.quarantined_rows))
        record_consensus_result(result, self.params.algorithm, self.backend)
        if self.verbose:
            with np.printoptions(precision=6, suppress=True):
                self._print_summary(result)
        return result

    def _print_summary(self, result: dict) -> None:
        where = (f"backend={self.backend}" if self.device is None
                 else f"backend={self.backend} device={self.device}")
        print(f"pyconsensus_tpu_torch Oracle: algorithm="
              f"{self.params.algorithm} {where}")
        print(f"  reporters x events: {self.reports.shape[0]} x "
              f"{self.reports.shape[1]}")
        print(f"  outcomes_final:     {result['events']['outcomes_final']}")
        print(f"  smooth_rep:         {result['agents']['smooth_rep']}")
        print(f"  certainty:          {result['certainty']:.6f}")
        print(f"  participation:      {result['participation']:.6f}")
        print(f"  convergence:        {result['convergence']} "
              f"({result['iterations']} iteration(s))")
