"""``ConsensusService`` — the in-process micro-batching consensus server
(``pyconsensus_tpu/serve/service.py``).

Wires the tier together: admission control -> bounded queue ->
micro-batcher -> shape-bucketed executable cache, with named market
sessions on the side. Concurrent callers ``submit`` resolutions and get
``concurrent.futures.Future``\\ s back; the batcher thread coalesces
compatible requests into padded bucket dispatches, serves small binary
requests on the ``bucket_cuda`` class (the Hopper kernels), and resolves
the rest directly through the ``Oracle``. Counters and histograms: queue
depth, batch occupancy, request latency by path, cache hits, misses,
evictions and builds.

Quick use::

    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig

    with ConsensusService(ServeConfig(warmup=((16, 64),))) as svc:
        fut = svc.submit(reports=matrix)          # returns a Future
        result = fut.result(timeout=30)           # Oracle-shaped dict

``device=None`` means the card and raises where there is none; only an
explicit ``device="cpu"`` serves on the CPU (the kernels' plain
versions). The service computes in the default dtype at construction.
"""

from __future__ import annotations

import json
import pathlib
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..faults import InputError, ServiceOverloadError
from ..faults import degrade as _degrade
from ..faults import plan as _faults
from ..models.pipeline import ConsensusParams
from ..ops.torch_kernels import gather_median_pays
from ..oracle import ALGORITHMS, BACKENDS, parse_event_bounds
from ..parallel.sharded import resolve_device
from .admission import AdmissionController
from .batcher import Microbatcher
from .cache import (ROADMAP_AOT, ROADMAP_SHARDED_SERVE, SINGLE_TOPOLOGY,
                    BucketKey, ExecutableCache)
from .cuda import CUDA_KERNEL_PATH, cuda_bucket_eligible, cuda_bucket_params
from .incremental import (INCREMENTAL_KERNEL_PATH,
                          INCREMENTAL_REFRESH_DEFAULT)
from .kernels import bucket_path_eligible
from .queue import RequestQueue, ResolveRequest
from .session import SessionStore

__all__ = ["ServeConfig", "ConsensusService"]

#: oracle_kwargs that enter the static ConsensusParams of a bucketed
#: dispatch (anything else forces the direct path)
_BUCKET_KWARGS = ("alpha", "catch_tolerance", "max_iterations",
                  "convergence_tolerance", "power_iters", "power_tol",
                  "matvec_dtype", "storage_dtype")
#: the reference's backend names read in the port's terms
_BACKEND_ALIASES = {"jax": "torch"}


@dataclass(frozen=True)
class ServeConfig:
    """Service policy, JSON-loadable (``ServeConfig.load``). The keys are
    the reference's, so one config file serves both packages; the ones
    naming parts the port does not have yet are refused at
    ``ConsensusService`` construction when set (``ROADMAP.md`` §A.10,
    §A.11)."""

    #: shape-bucket ladders; a request maps to the smallest (rows,
    #: events) bucket that fits, or to the direct path beyond both
    row_buckets: tuple = (8, 16, 32, 64, 128, 256, 512, 1024)
    event_buckets: tuple = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
    #: bounded queue depth — the overload backstop
    max_queue: int = 256
    #: coalescing window (ms) the batcher holds a fresh batch open
    batch_window_ms: float = 2.0
    #: lanes of every padded dispatch (fixed; 1 disables batching)
    max_batch: int = 8
    #: padded dispatches kept in flight before a result fetch blocks:
    #: 1 = synchronous, 0 (default) = 2
    pipeline_depth: int = 0
    #: default per-request shed deadline (ms; None = no deadline)
    default_deadline_ms: Optional[float] = 30_000.0
    #: per-tenant token-bucket rate (req/s; 0 disables rate limiting)
    rate_limit_rps: float = 0.0
    rate_burst: float = 0.0
    #: LRU capacity of the executable cache
    cache_capacity: int = 32
    #: (rows, events) bucket shapes built before traffic (default
    #: serving params, has_na=True)
    warmup: tuple = ()
    #: compute backend of requests that name none ("jax" reads "torch")
    backend: str = "torch"
    #: mesh-sharded buckets: "auto" and False serve on one device; True
    #: with more than one card is ROADMAP.md §A.10
    sharded_buckets: object = "auto"
    mesh_batch: int = 0
    #: the low-latency ``bucket_cuda`` class (the reference's Pallas
    #: class, under its key names): "auto" engages on an sm_90 card, True
    #: on the service's device whatever it is, False never
    pallas_buckets: object = "auto"
    #: event-width bound of the low-latency class
    pallas_max_events: int = 4096
    #: exact (rows, events) request shapes built on the low-latency class
    #: before traffic
    pallas_warmup: tuple = ()
    #: sessions created through the service ride the incremental tier
    incremental_sessions: bool = False
    #: the incremental tier's exact-refresh cadence K (>= 1)
    incremental_refresh_every: int = INCREMENTAL_REFRESH_DEFAULT
    #: the AOT executable store: ROADMAP.md §A.11
    aot_cache_dir: Optional[str] = None
    #: windowed SLO targets (validated; their monitor is the
    #: reference's fleet tooling)
    slo_window_s: float = 10.0
    slo_p50_ms: float = 0.0
    slo_p99_ms: float = 0.0
    slo_shed_ratio: float = 0.0
    slo_queue_depth: float = 0.0
    flightrec_dir: Optional[str] = None
    #: tiered session residency and journal compaction: ROADMAP.md §A.11
    hot_sessions: int = 0
    compact_rounds: int = 0
    compact_journal_bytes: int = 0
    compact_interval_s: float = 5.0

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        known = {f for f in cls.__dataclass_fields__}
        unknown = set(d) - known
        if unknown:
            raise InputError(f"unknown serve config keys "
                             f"{sorted(unknown)}")
        d = dict(d)
        for key in ("row_buckets", "event_buckets"):
            if key in d:
                d[key] = tuple(int(x) for x in d[key])
        for key in ("warmup", "pallas_warmup"):
            if key in d:
                d[key] = tuple((int(r), int(e)) for r, e in d[key])
        for key in ("slo_window_s", "slo_p50_ms", "slo_p99_ms",
                    "slo_shed_ratio", "slo_queue_depth",
                    "compact_interval_s"):
            if key in d:
                d[key] = float(d[key])
        for key in ("hot_sessions", "compact_rounds",
                    "compact_journal_bytes"):
            if key in d:
                d[key] = int(d[key])
        return cls(**d)

    @classmethod
    def load(cls, path) -> "ServeConfig":
        return cls.from_dict(json.loads(pathlib.Path(path).read_text()))


def _validate(cfg: ServeConfig) -> None:
    """The reference's construction checks (``InputError``, PYC101), and
    the refusals of what the port does not have."""
    if (sorted(cfg.row_buckets) != list(cfg.row_buckets)
            or sorted(cfg.event_buckets) != list(cfg.event_buckets)):
        raise InputError("bucket ladders must be ascending")
    if cfg.max_batch < 1:
        raise InputError("max_batch must be >= 1")
    if int(cfg.pipeline_depth) < 0:
        raise InputError(
            f"pipeline_depth must be >= 0 (0 = the default of 2, 1 = "
            f"synchronous dispatch, N = N in-flight dispatches), got "
            f"{cfg.pipeline_depth}", pipeline_depth=cfg.pipeline_depth)
    if int(cfg.incremental_refresh_every) < 1:
        raise InputError(
            f"incremental_refresh_every must be >= 1 (the exact resolve "
            f"every K rounds is the incremental tier's staleness-bound "
            f"contract), got {cfg.incremental_refresh_every}",
            incremental_refresh_every=cfg.incremental_refresh_every)
    if float(cfg.slo_window_s) <= 0:
        raise InputError(f"slo_window_s must be > 0, got "
                         f"{cfg.slo_window_s}",
                         slo_window_s=cfg.slo_window_s)
    for key in ("slo_p50_ms", "slo_p99_ms", "slo_shed_ratio",
                "slo_queue_depth"):
        if float(getattr(cfg, key)) < 0:
            raise InputError(
                f"{key} must be >= 0 (0 disables the target), got "
                f"{getattr(cfg, key)}", **{key: getattr(cfg, key)})
    for key in ("hot_sessions", "compact_rounds", "compact_journal_bytes"):
        value = int(getattr(cfg, key))
        if value < 0:
            raise InputError(f"{key} must be >= 0 (0 disables it), got "
                             f"{value}", **{key: value})
        if value > 0:
            raise NotImplementedError(f"{key}={value}: {ROADMAP_AOT}")
    if float(cfg.compact_interval_s) <= 0:
        raise InputError(f"compact_interval_s must be > 0, got "
                         f"{cfg.compact_interval_s}",
                         compact_interval_s=cfg.compact_interval_s)
    if cfg.aot_cache_dir:
        raise NotImplementedError(
            f"aot_cache_dir={cfg.aot_cache_dir!r}: {ROADMAP_AOT}")
    if cfg.sharded_buckets not in ("auto", True, False):
        raise InputError(f"sharded_buckets must be 'auto', True or False, "
                         f"got {cfg.sharded_buckets!r}")
    if cfg.pallas_buckets not in ("auto", True, False):
        raise InputError(f"pallas_buckets must be 'auto', True or False, "
                         f"got {cfg.pallas_buckets!r}")


class ConsensusService:
    """See the module docstring. A thread-safe front door; one batcher
    thread owns device dispatch on ``device`` (None: the card)."""

    def __init__(self, config: Optional[ServeConfig] = None,
                 device=None) -> None:
        self.config = config or ServeConfig()
        _validate(self.config)
        self.device = resolve_device(device)
        if (self.config.sharded_buckets is True
                and self.device.type == "cuda"
                and torch.cuda.device_count() > 1):
            raise NotImplementedError(
                f"sharded_buckets=True over "
                f"{torch.cuda.device_count()} cards: "
                f"{ROADMAP_SHARDED_SERVE}")
        self.dtype = torch.get_default_dtype()
        self.queue = RequestQueue(self.config.max_queue)
        self.cache = ExecutableCache(self.config.cache_capacity,
                                     device=self.device, dtype=self.dtype)
        self.admission = AdmissionController(self.config.rate_limit_rps,
                                             self.config.rate_burst)
        self.sessions = SessionStore()
        self.batcher = Microbatcher(self.queue, self.cache, self.config,
                                    self.sessions, self.admission,
                                    device=self.device, dtype=self.dtype)
        self._started = False
        self._start_lock = threading.Lock()

    @property
    def pipeline_depth(self) -> int:
        """The resolved dispatch pipeline depth the batcher runs with."""
        return self.batcher._depth

    # -- lifecycle ------------------------------------------------------

    def start(self, warmup: bool = True) -> "ConsensusService":
        # check-then-act under a lock: two concurrent first submits must
        # not each start a batcher thread
        with self._start_lock:
            if not self._started:
                if warmup:
                    self.warm_buckets()
                self.batcher.start()
                self._started = True
        return self

    def __enter__(self) -> "ConsensusService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    def warm_buckets(self, shapes=None, **oracle_kwargs) -> int:
        """Build the configured (or given) bucket shapes and run each once
        before traffic; with no shapes given, the low-latency class's
        ``pallas_warmup`` shapes too (their kernels' libraries load here,
        so the batcher thread never builds). Returns the number of
        executables warmed."""
        n = 0
        for rows, events in (shapes or self.config.warmup):
            key = self._bucket_key((rows, events), has_na=True,
                                   any_scaled=False, n_scaled=0,
                                   oracle_kwargs=oracle_kwargs)
            with obs.span("serve.warmup", bucket=f"{rows}x{events}"):
                self.cache.warm(key)
            n += 1
        if shapes is None:
            for rows, events in self.config.pallas_warmup:
                key = self._cuda_key(rows, events, has_na=True,
                                     oracle_kwargs=oracle_kwargs)
                with obs.span("serve.warmup", bucket=f"{rows}x{events}",
                              kernel_path=CUDA_KERNEL_PATH):
                    self.cache.warm(key)
                n += 1
        return n

    def drain(self, timeout: Optional[float] = 60.0) -> None:
        """Graceful shutdown: refuse new work, finish everything queued,
        stop the batcher."""
        self.admission.start_drain()
        self.queue.close()
        self.batcher.join(timeout)

    def close(self, drain: bool = True,
              timeout: Optional[float] = 60.0) -> None:
        if drain:
            self.drain(timeout)
            return
        self.admission.start_drain()
        self.queue.close()
        for req in self.queue.drain_pending():
            self.admission.record_shed("draining")
            req.shed("draining")
        self.batcher.join(timeout)

    # -- request derivation --------------------------------------------

    def _pick_bucket(self, R: int, E: int):
        rb = next((b for b in self.config.row_buckets if b >= R), None)
        eb = next((b for b in self.config.event_buckets if b >= E), None)
        return None if rb is None or eb is None else (rb, eb)

    def buckets_for(self, shapes) -> list:
        """The distinct ladder buckets a set of (R, E) request shapes map
        to, sorted (the warm-up list for that traffic; shapes beyond the
        ladders dispatch direct)."""
        return sorted({b for b in (self._pick_bucket(*s) for s in shapes)
                       if b is not None})

    def _cuda_key(self, rows: int, events: int, has_na,
                  oracle_kwargs) -> BucketKey:
        """The low-latency class key: the TRUE shape, batch capacity 1,
        ``kernel_path="cuda"`` (never a padded executable's key)."""
        p = cuda_bucket_params(has_na, oracle_kwargs, _BUCKET_KWARGS)
        return BucketKey.make(rows, events, 1, p, SINGLE_TOPOLOGY,
                              kernel_path=CUDA_KERNEL_PATH)

    def _bucket_key(self, bucket, has_na, any_scaled, n_scaled,
                    oracle_kwargs) -> BucketKey:
        p = ConsensusParams(
            algorithm="sztorc", pca_method="power", has_na=has_na,
            any_scaled=any_scaled, n_scaled=n_scaled,
            **{k: v for k, v in oracle_kwargs.items()
               if k in _BUCKET_KWARGS})
        return BucketKey.make(bucket[0], bucket[1], self.config.max_batch,
                              p, SINGLE_TOPOLOGY)

    def _derive(self, req: ResolveRequest, oracle_kwargs: dict) -> None:
        """Classify and prepare a matrix request: validate, quarantine
        ±Inf rows (the ``Oracle`` front-door contract), parse the bounds,
        pick the dispatch path and the batch key."""
        reports = np.asarray(req.reports, dtype=np.float64)
        if reports.ndim != 2 or reports.size == 0:
            raise InputError(
                f"reports must be a non-empty 2-D matrix, got shape "
                f"{reports.shape}", shape=tuple(reports.shape))
        R, E = reports.shape
        scaled, mins, maxs = parse_event_bounds(req.event_bounds, E)
        reports, quarantined, has_na = _degrade.quarantine_nonfinite(
            reports)
        req.quarantined_rows = (np.array([], dtype=np.int64)
                                if quarantined is None
                                else np.asarray(quarantined))
        if req.reputation is None:
            req.reputation = np.full(R, 1.0 / R)
        else:
            rep = np.asarray(req.reputation, dtype=np.float64)
            if rep.shape != (R,):
                raise InputError(f"reputation shape {rep.shape} does "
                                 f"not match {R} reporters")
            req.reputation = rep
        req.reports = reports
        req.shape = (R, E)
        req.scaled, req.mins, req.maxs = scaled, mins, maxs

        algorithm = oracle_kwargs.get("algorithm", "sztorc")
        pca_method = oracle_kwargs.get("pca_method", "auto")
        if algorithm not in ALGORITHMS:
            raise InputError(f"unknown algorithm {algorithm!r}")
        kwargs_ok = not (set(oracle_kwargs) - set(_BUCKET_KWARGS)
                         - {"algorithm", "pca_method"})
        storage = oracle_kwargs.get("storage_dtype", "")
        # the low-latency class first: a small all-binary market wants the
        # fused pipeline's fewest passes, not a coalescing window
        if (req.backend == "torch" and req.session is None and kwargs_ok
                and not bool(scaled.any())
                and cuda_bucket_eligible(
                    R, E, algorithm, pca_method, False, storage,
                    self.config.pallas_buckets,
                    self.config.pallas_max_events, self.device)):
            key = self._cuda_key(R, E, has_na=has_na,
                                 oracle_kwargs=oracle_kwargs)
            req.dispatch_path = "bucket"
            req.bucket = (R, E)
            req.params = key.params
            req.batch_key = key
            return
        bucket = self._pick_bucket(R, E)
        eligible = (req.backend == "torch" and bucket is not None
                    and req.session is None
                    and bucket_path_eligible(algorithm, pca_method,
                                             bool(scaled.any()), has_na,
                                             storage)
                    and kwargs_ok)
        if not eligible:
            req.dispatch_path = "direct"
            return
        n_sc = int(scaled.sum())
        key = self._bucket_key(
            bucket, has_na=has_na or bucket[0] > R,
            any_scaled=bool(scaled.any()),
            n_scaled=n_sc if gather_median_pays(n_sc, E) else 0,
            oracle_kwargs=oracle_kwargs)
        req.dispatch_path = "bucket"
        req.bucket = bucket
        req.params = key.params
        req.batch_key = key

    # -- the front door -------------------------------------------------

    def submit(self, reports=None, event_bounds=None, reputation=None,
               session: Optional[str] = None, tenant: str = "default",
               deadline_ms: Optional[float] = None, backend=None,
               **oracle_kwargs):
        """Enqueue one resolution; returns a ``concurrent.futures.Future``
        resolving to the ``Oracle``-shaped nested result dict. Raises
        :class:`ServiceOverloadError` (PYC401) when admission refuses the
        request, and input errors, synchronously."""
        if (reports is None) == (session is None):
            raise InputError(
                "exactly one of reports= / session= is required")
        self.admission.admit(tenant)
        _faults.fire("serve.enqueue")
        backend = backend or self.config.backend
        req = ResolveRequest(
            reports=reports, event_bounds=event_bounds,
            reputation=reputation, session=session,
            oracle_kwargs=dict(oracle_kwargs),
            backend=_BACKEND_ALIASES.get(backend, backend), tenant=tenant)
        if req.backend not in BACKENDS:
            raise InputError(f"unknown backend {req.backend!r}")
        ms = (self.config.default_deadline_ms if deadline_ms is None
              else deadline_ms)
        if ms is not None:
            req.deadline = req.submitted_at + float(ms) / 1e3
        if session is not None:
            self.sessions.get(session)       # fail fast on an unknown name
            req.dispatch_path = "session"
        else:
            self._derive(req, oracle_kwargs)
        if self.batcher.fatal is not None:
            raise RuntimeError("the serve batcher thread has stopped") \
                from self.batcher.fatal
        try:
            self.queue.put(req)
        except ServiceOverloadError:
            self.admission.record_shed("queue_full")
            raise
        if not self._started:
            self.start(warmup=False)
        return req.future

    def resolve(self, timeout: Optional[float] = None, **kwargs) -> dict:
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(**kwargs).result(timeout)

    # -- sessions -------------------------------------------------------

    def incremental_executable_for(self, n_reporters: int, params):
        """The ``bucket_incremental`` executable of sessions created
        through this service: a per-roster key (rows = R, events = 0) in
        the executable cache."""
        key = BucketKey.make(n_reporters, 0, 1, params, SINGLE_TOPOLOGY,
                             kernel_path=INCREMENTAL_KERNEL_PATH)
        return self.cache.get(key)

    def session_defaults(self, kwargs: dict) -> dict:
        """Session-construction kwargs with this service's device, dtype,
        incremental policy and executable provider threaded in."""
        kwargs = dict(kwargs)
        if self.config.incremental_sessions:
            kwargs.setdefault("incremental", True)
        if kwargs.get("incremental"):
            kwargs.setdefault("refresh_every",
                              int(self.config.incremental_refresh_every))
        kwargs.setdefault("executable_provider",
                          self.incremental_executable_for)
        kwargs.setdefault("device", self.device)
        kwargs.setdefault("dtype", self.dtype)
        return kwargs

    def create_session(self, name: str, n_reporters: int, **kwargs):
        """Create a named market session (see ``serve.session``)."""
        return self.sessions.create(name, n_reporters,
                                    **self.session_defaults(kwargs))

    def append(self, session: str, reports_block,
               event_bounds=None) -> int:
        """Append an event block to a named session."""
        return self.sessions.get(session).append(reports_block,
                                                 event_bounds)
