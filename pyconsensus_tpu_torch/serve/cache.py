"""Shape-bucketed executable cache (``pyconsensus_tpu/serve/cache.py``).

One executable per (bucket shape, batch capacity, static params,
topology, kernel path) key, in an LRU with hit, miss, eviction and size
counters. The reference compiles a private ``jax.jit`` per entry and pins
its retraces; the port compiles nothing per key, so the invariant it
keeps is on builds: ``pyconsensus_serve_builds_total{entry}`` counts the
executables built, which equals the keys cached until the LRU evicts,
and no build happens under steady traffic after the warm-up
(``warm_buckets``). A ``cuda`` key's build loads the CUDA kernels
(``ops/build.py``, under its lock: one ``nvcc`` per source the first
time), so the batcher thread launches kernels but never builds them once
the service is warm.

The cache serves one device and the single-device topology; the mesh
topologies of the reference's sharded buckets are ``ROADMAP.md`` §A.10,
and its AOT store (``aot=``) §A.11.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import obs
from ..faults import plan as _faults
from ..parallel.sharded import resolve_device
from . import kernels as sk
from .cuda import (CUDA_KERNEL_PATH, PLAIN_KERNEL_PATH,
                   make_cuda_bucket_executable)
from .incremental import (INCREMENTAL_KERNEL_PATH,
                          make_incremental_executable)

__all__ = ["ExecutableCache", "BucketKey", "warm_inputs",
           "SINGLE_TOPOLOGY", "ROADMAP_AOT", "ROADMAP_SHARDED_SERVE"]

#: the single-device topology fingerprint (the reference's value)
SINGLE_TOPOLOGY = "single"
#: where the parts the port's serve tier refuses are queued
ROADMAP_AOT = ("ROADMAP.md §A.11 (the serve tier's AOT executable store, "
               "tiered session state and the fleet)")
ROADMAP_SHARDED_SERVE = ("ROADMAP.md §A.10 (mesh-sharded serve buckets, "
                         "serve/sharded.py)")

#: the build counter's entry label of each kernel path (the reference's
#: retrace entries)
_BUILD_ENTRY = {PLAIN_KERNEL_PATH: "serve_bucket",
                CUDA_KERNEL_PATH: "serve_bucket_cuda",
                INCREMENTAL_KERNEL_PATH: "serve_bucket_incremental"}


def warm_inputs(key, device=None, dtype: torch.dtype = None) -> list:
    """The zero inputs that warm ``key``'s executable on ``device`` in
    ``dtype`` (None: the card, raising without one; the default dtype).
    A zero matrix resolves
    degenerately fast (the power loop's zero-covariance guard exits on
    the first sweep) while still running every phase; ``has_na`` params
    get one NaN so the fill runs too."""
    rows, events, batch = key.rows, key.events, key.batch
    dev = resolve_device(device)
    dt = dtype or torch.get_default_dtype()
    p = key.params

    def put(a, d=None):
        return torch.as_tensor(a).to(device=dev, dtype=d or dt)

    if key.kernel_path == INCREMENTAL_KERNEL_PATH:
        Z = np.zeros((rows, rows))
        return [put(a) for a in (Z, Z, Z, np.full((rows,), 1.0 / rows),
                                 np.zeros((rows,)))]
    reports = np.zeros((rows, events))
    if p.has_na:
        reports[-1, 0] = np.nan
    rep = np.full((rows,), 1.0 / rows)
    if key.kernel_path == CUDA_KERNEL_PATH:
        f32 = torch.float32
        return [put(reports, f32), put(rep),
                put(np.zeros(events, bool), torch.bool),
                put(np.zeros(events), f32), put(np.ones(events), f32)]
    # the true-width seed: with a zero covariance the power loop then
    # exits after one sweep
    seed = np.array(sk._seed_host(events, str(dt).removeprefix("torch.")))
    args = [put(reports), put(rep), put(np.zeros(events, bool), torch.bool),
            put(np.zeros(events)), put(np.ones(events)),
            put(np.ones(rows, bool), torch.bool),
            put(np.ones(events, bool), torch.bool), put(seed)]
    if batch > 1:
        # one lane: an unoccupied lane is never computed
        args = [a[None] for a in args]
    return args


class BucketKey(tuple):
    """(rows, events, batch_capacity, params, topology, kernel_path) — a
    hashable cache key. ``params`` is the resolved ``ConsensusParams``
    (a NamedTuple): two tenants with different alphas are two
    executables. ``kernel_path`` keys the executable family:
    ``"plain"`` the padded bucket path, ``"cuda"`` the fused low-latency
    class at exact shape, ``"incremental"`` the warm-started session
    kernel over R x R statistics (rows = roster, events = 0)."""

    __slots__ = ()

    @classmethod
    def make(cls, rows: int, events: int, batch: int, params,
             topology: str = SINGLE_TOPOLOGY,
             kernel_path: str = PLAIN_KERNEL_PATH):
        return cls((int(rows), int(events), int(batch), params,
                    str(topology), str(kernel_path)))

    @property
    def rows(self):
        return self[0]

    @property
    def events(self):
        return self[1]

    @property
    def batch(self):
        return self[2]

    @property
    def params(self):
        return self[3]

    @property
    def topology(self):
        return self[4]

    @property
    def kernel_path(self):
        return self[5]


class ExecutableCache:
    """Bucket-keyed LRU of built executables with hit, miss, eviction and
    build metrics, for one ``device`` (None: the card, raising without
    one; only ``device="cpu"`` runs the plain versions) and ``dtype``.
    Thread-safe; builds run under the cache's lock (the batcher is the
    only caller after warm-up, and serialized builds keep the build
    accounting exact)."""

    def __init__(self, capacity: int = 64, device=None,
                 dtype: torch.dtype = None, aot=None) -> None:
        if int(capacity) < 1:
            raise ValueError("capacity must be >= 1")
        if aot is not None:
            raise NotImplementedError(
                f"an AOT executable store: {ROADMAP_AOT}")
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self.dtype = dtype or torch.get_default_dtype()
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self._hits = obs.counter(
            "pyconsensus_serve_cache_hits_total",
            "bucket-executable cache hits")
        self._misses = obs.counter(
            "pyconsensus_serve_cache_misses_total",
            "bucket-executable cache misses (each one builds)")
        self._evictions = obs.counter(
            "pyconsensus_serve_cache_evictions_total",
            "bucket executables evicted by LRU pressure")
        self._size = obs.gauge(
            "pyconsensus_serve_cache_size",
            "bucket executables currently cached")
        self._builds = obs.counter(
            "pyconsensus_serve_builds_total",
            "serve executables built, by entry (the port's counterpart of "
            "the reference's serve retraces)", labels=("entry",))
        #: this cache's builds, hits and misses (the metrics are
        #: process-wide)
        self.builds = self.hits = self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self):
        with self._lock:
            return list(self._entries.keys())

    def hit_ratio(self):
        """This cache's lifetime hit ratio (None before any lookup)."""
        total = self.hits + self.misses
        return None if total == 0 else self.hits / total

    def get(self, key: BucketKey):
        """The executable for ``key`` — built (and stored) on a miss,
        LRU-refreshed on a hit."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self._hits.inc()
                self.hits += 1
                return entry
            self._misses.inc()
            self.misses += 1
            _faults.fire("serve.cache_store")
            entry = self._build(key)
            self._store(key, entry)
            return entry

    def _store(self, key: BucketKey, entry) -> None:
        """Install ``entry`` under the held lock with LRU pressure."""
        self._entries[key] = entry
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self._evictions.inc()
        self._size.set(len(self._entries))

    def _build(self, key: BucketKey):
        """Build the executable class of ``key``; a key of another
        topology is refused (the port's serve tier is single-device)."""
        if key.topology != SINGLE_TOPOLOGY:
            raise ValueError(
                f"bucket key of topology {key.topology!r}: this cache "
                f"serves {SINGLE_TOPOLOGY!r} only "
                f"({ROADMAP_SHARDED_SERVE})")
        if key.kernel_path == CUDA_KERNEL_PATH:
            if self.device.type == "cuda":
                from ..ops import build

                for src in build.SOURCES:
                    build.load(src)
            entry = make_cuda_bucket_executable(key.params)
        elif key.kernel_path == INCREMENTAL_KERNEL_PATH:
            entry = make_incremental_executable(key.params)
        elif key.kernel_path == PLAIN_KERNEL_PATH:
            entry = sk.make_bucket_executable(key.params,
                                              batched=key.batch > 1)
        else:
            raise ValueError(f"unknown bucket kernel path "
                             f"{key.kernel_path!r} (expected "
                             f"{PLAIN_KERNEL_PATH!r}, "
                             f"{CUDA_KERNEL_PATH!r} or "
                             f"{INCREMENTAL_KERNEL_PATH!r})")
        self._builds.inc(entry=_BUILD_ENTRY[key.kernel_path])
        self.builds += 1
        return entry

    def warm(self, key: BucketKey) -> None:
        """Build ``key``'s executable and run it once on
        :func:`warm_inputs`, so the first real request builds nothing
        (on a card: the kernels' libraries loaded, the library
        handles made)."""
        entry = self.get(key)
        out = entry(*warm_inputs(key, self.device, self.dtype), key.params)
        out["smooth_rep"].cpu()
