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

A cache is bound to at most one mesh (``mesh=``): keys of the
single-device topology build the single-device classes, keys carrying
that mesh's fingerprint (``serve/sharded.py mesh_fingerprint``) build the
mesh-sharded padded executable, and a key of any other topology is
refused, never built for the wrong layout.

With a kernel store attached (``aot=``, ``serve/aotcache.py``), ``get``
consults it before it builds: a key whose verified entry is on disk is
adopted (its kernel libraries come from the store, with no ``nvcc``) and
counted under ``entry="serve_bucket_aot"``, so after a restart with a
full store a warmed key's own ``serve_bucket*`` count stays at 0. The
topology gate runs first. ``warm`` persists a key it built. A refused
entry is deleted and the key is built as without a store.
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
from .aotcache import AOT_ENTRY
from .cuda import (CUDA_KERNEL_PATH, PLAIN_KERNEL_PATH,
                   make_cuda_bucket_executable)
from .incremental import (INCREMENTAL_KERNEL_PATH,
                          make_incremental_executable)
from .sharded import (SINGLE_TOPOLOGY, make_sharded_bucket_executable,
                      mesh_fingerprint)

__all__ = ["ExecutableCache", "BucketKey", "warm_inputs",
           "SINGLE_TOPOLOGY"]

#: the build counter's entry label of each kernel path (the reference's
#: retrace entries); a mesh key of the padded path is ``_SHARDED_ENTRY``
_BUILD_ENTRY = {PLAIN_KERNEL_PATH: "serve_bucket",
                CUDA_KERNEL_PATH: "serve_bucket_cuda",
                INCREMENTAL_KERNEL_PATH: "serve_bucket_incremental"}
_SHARDED_ENTRY = "serve_bucket_sharded"


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
    one; only ``device="cpu"`` runs the plain versions), ``dtype``, at
    most one ``mesh`` (``serve/sharded.py serve_mesh``) and an optional
    kernel store ``aot`` (an ``aotcache.AotCache``; on the card it is
    also attached to ``ops/build`` when none is, so a missing kernel
    library is adopted from it before any ``nvcc``). Thread-safe; builds
    run under the cache's lock (the batcher is the only caller after
    warm-up, and serialized builds keep the build accounting exact)."""

    def __init__(self, capacity: int = 64, device=None,
                 dtype: torch.dtype = None, aot=None, mesh=None) -> None:
        if int(capacity) < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        #: the kernel store behind ``get`` and ``warm`` (None: none)
        self.aot = aot
        if aot is not None and self.device.type == "cuda":
            from ..ops import build

            if build.attached_store() is None:
                build.attach_store(aot)
        #: keys adopted from the store (``warm`` never persists them)
        self._adopted: set = set()
        self.dtype = dtype or torch.get_default_dtype()
        self.mesh = mesh
        #: the mesh keys' topology (None without a mesh)
        self.mesh_topology = (mesh_fingerprint(mesh) if mesh is not None
                              else None)
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
        #: this cache's builds, adoptions, hits and misses (the metrics
        #: are process-wide)
        self.builds = self.adopted = self.hits = self.misses = 0

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
            entry = self._build(key, adopt=self._adoptable(key))
            self._store(key, entry)
            return entry

    def _store(self, key: BucketKey, entry) -> None:
        """Install ``entry`` under the held lock with LRU pressure."""
        self._entries[key] = entry
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self._evictions.inc()
        self._size.set(len(self._entries))

    def _adoptable(self, key: BucketKey) -> bool:
        """Whether ``key``'s verified entry is in the store (a miss or a
        refused entry: False, and the key is built). The topology gate
        runs first: a wrong-topology key gets ``_build``'s refusal, never
        a quiet miss."""
        if self.aot is None:
            return False
        if key.topology not in (SINGLE_TOPOLOGY, self.mesh_topology):
            return False
        return self.aot.adopt(key) is not None

    def _build(self, key: BucketKey, adopt: bool = False):
        """Build the executable class of ``key``, or refuse a key of a
        topology this cache does not serve: only the padded path runs on
        a mesh, and only on this cache's. A key adopted from the store
        (``adopt``) is counted under ``serve_bucket_aot``, not under its
        own entry."""
        if key.topology not in (SINGLE_TOPOLOGY, self.mesh_topology):
            served = [t for t in (SINGLE_TOPOLOGY, self.mesh_topology) if t]
            raise ValueError(
                f"wrong-topology bucket key {key.topology!r}: this cache "
                f"serves {served}; a key minted for another mesh or "
                f"device kind is never built here")
        if key.topology != SINGLE_TOPOLOGY:
            if key.kernel_path != PLAIN_KERNEL_PATH:
                raise ValueError(
                    f"{key.kernel_path!r} keys are single-topology by "
                    f"definition, got {key.topology!r}")
            entry = make_sharded_bucket_executable(
                key.params, self.mesh, batched=key.batch > 1,
                capacity=key.batch)
            self._count(key, _SHARDED_ENTRY, adopt)
            return entry
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
        self._count(key, _BUILD_ENTRY[key.kernel_path], adopt)
        return entry

    def _count(self, key: BucketKey, entry: str, adopt: bool) -> None:
        if adopt:
            self._adopted.add(key)
            self._builds.inc(entry=AOT_ENTRY)
            self.adopted += 1
        else:
            self._builds.inc(entry=entry)
            self.builds += 1

    def warm(self, key: BucketKey) -> None:
        """Build (or adopt) ``key``'s executable and run it once on
        :func:`warm_inputs`, so the first real request builds nothing
        (on a card: the kernels' libraries loaded, the library
        handles made); with a store, persist a key this cache built."""
        entry = self.get(key)
        out = entry(*warm_inputs(key, self.device, self.dtype), key.params)
        out["smooth_rep"].cpu()
        if self.aot is not None and key not in self._adopted:
            self.aot.persist(key)
