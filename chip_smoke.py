#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pyconsensus_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py                      # 10000 x 100000, one card
    python3 chip_smoke.py --mesh-devices 4     # the mesh over four cards

Phases, each printing its seconds:

1. the device: ``torch.cuda.get_device_name`` and the raw line of
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
2. build the CUDA kernels from ``pyconsensus_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel; the compiler's ``-Xptxas -v`` report
   goes to ``chiprun_out/chip_smoke_build.log``), then the native
   clustering library from ``native/cluster.cpp`` (g++);
3. hold each kernel against its plain torch version on the card at full
   size, on int8 sentinel storage, on float32+NaN storage and on
   bfloat16+NaN storage (its last eighth of the events continuous, as
   rescaled scaled events are, with continuous fills there), and time
   all three with CUDA events: the sztorc sweeps, resolve, the block
   covariance at k = 5 with and without its centered projections, the
   uncentered products (``storage_matvec``, ``storage_matmat`` at k = 12
   in one launch, the rows product at k = 6) and the fill statistics;
   ``storage_matmat`` is also timed on int8 at k = 4 and k = 16, the rows
   product at k = 1, 12 and 16 (one launch each), and the uncentered
   products against one PyTorch call (``torch.mv``, ``@``) on a dense
   float32 matrix. The row halves of the sztorc sweeps and
   ``storage_matvec`` are the row-tile pass at k = 1: on int8 and on
   bfloat16 each must equal the k = 1 call of ``storage_matmat`` or
   ``apply_weighted_cov_block`` bit for bit. Resolve's snapped outcomes
   and absent counts must equal the plain version's, and its two halves
   (the column-panel kernel, the row-tile pass at k = 2 with the absent
   op) are timed apart on both storages;
4. drive the main paths, ``sharded_consensus`` on pre-encoded int8
   storage with the default device and ``pca_method="auto"``, at
   ``max_iterations`` 1 and 3: sztorc, then fixed-variance and ica (which
   must resolve to the fused path), each with the launch counts set to 0
   just before and read just after; every kernel of a path must have
   launched, and a kernel of another arm must not. Then sztorc on an
   event mesh (four shards on card 0, or ``--mesh-devices`` cards),
   placed once, against the single-device outcomes; fixed-variance and
   ica at 12 components (the separable arm); and sztorc with the
   fill-statistics kernel gated on, as an A/B against the plain fill
   statistics. ``--profile`` then prints the device time by kernel name
   of one resolution of each path (the tile passes under
   ``row_tile_kernel<storage, centered, k>`` and
   ``col_tile_kernel<...>``). Then the plain core over the dense filled
   matrix (float32, TF32 off): sztorc through ``sharded_consensus`` on
   the float reports with the last ``PLAIN_SCALED`` (16,000) events
   scaled on [-5, 15], more than E // 8, so the fused gate closes and the sweeps run
   ``apply_weighted_cov`` and ``scores_dirfix_pass`` on the dense matrix
   (``pca_method="auto"`` resolves to ``power-fused``, at
   ``max_iterations`` 1 and 3); and sztorc, fixed-variance and ica at
   4096 reporters, where ``"auto"`` takes the Gram eigh and no storage
   kernel runs; and sztorc at ``PLAIN_SCALED`` scaled events with the
   filled matrix stored in bfloat16. Each prints its rate and its peak
   device memory, and must recover the truth. Then the fused path with
   scaled events on bfloat16 storage (the reference's ``bench.py --scaled
   1000`` and ``--scaled 4000``): the float reports with the last
   ``SCALED_FUSED`` events scaled, sztorc at ``max_iterations`` 1 and 3
   and, at the first count, fixed-variance and ica; each prints its rate,
   peak memory and launches of B.1, B.2 and resolve, and its binary
   outcomes must recover the truth and its scaled ones ``20 truth - 5``
   exactly;
5. ``ShardedOracle`` at full size on the generator's matrix (host int8
   storage, ``storage_dtype="int8"``): its rate as passed and after
   ``place()``, beside ``sharded_consensus``'s in the same phase, with
   B.1, B.2 and B.3 launched and the outcomes recovering the truth; then
   a ``FaultPlan`` NaN storm at ``oracle.raw_result`` that must walk
   exactly one hop, ``power-fused -> eigh-gram``, on the card (counted
   in ``pyconsensus_fallbacks_total``), with the recovered outcomes
   equal to a clean eigh-gram resolution's, the seconds of both and the
   recovery's peak memory; then the span tree and counters of one traced
   resolution;
6. the clustering variants, which launch none of the kernels (the
   reference's clustering reaches no Pallas kernel): ``sharded_consensus``
   on the generator's float32 reports at full size with the storage
   ``resolve_auto_storage`` picks (bfloat16), k-means at
   ``max_iterations`` 1 and 3 and dbscan-jit at the defaults and at the
   radius that follows the geometry (``eps = sqrt(0.15 E)``), each with
   its rate, peak memory and every launch count 0; then hierarchical and
   dbscan at ``HYBRID_R`` x ``HYBRID_E`` (4096 x 32768) through
   ``ShardedOracle`` (defaults and geometry) and ``Oracle`` (geometry),
   each with its seconds split by the spans into ``hybrid.device_prep``,
   ``hybrid.cluster`` and the finish, ``native=True`` on every
   clustering span and the cluster count. Every outcome must recover the
   truth;
7. the simulator and the persistence layer, which launch none of the
   kernels (the reference's simulator reaches no Pallas kernel): the
   recorded Monte-Carlo sweep (``SIM_R`` x ``SIM_E``, 10,000 trials,
   ``CollusionSimulator.run``) at ``max_iterations`` 1 and 5, one warm-up
   and 3 timed runs each, with trials/s, peak memory, the draw's seconds,
   the power sweeps a lane takes and every launch count 0; 64 of its
   lanes replayed through the ``Oracle`` (exact metrics equal); a
   1,000-trial sub-grid on the card against the CPU (float32 bit for
   bit, and the band to float64); ``RoundsSimulator(n_rounds=10)`` over
   1,000 trials; ``CheckpointedSweep`` in 1,024-trial chunks equal to the
   monolithic run bit for bit; then the generator's full-size matrix
   written as int8 ``.npy`` (``io.save_reports``), read onto the card by
   ``io.load_reports_encoded`` and resolved (outcomes equal to the
   in-memory run's; seconds and GB/s), a CSV at the middle size through
   the native loader (``native/loader.cpp``, built with g++), and a
   ``ReputationLedger`` of 3 rounds saved, verified and loaded, whose 4th
   round equals an uninterrupted ledger's;
8. the serve tier (``pyconsensus_tpu_torch.serve``, about 10 s): the
   reference's recorded serve block (``SERVE_SHAPES``, 48 requests from 8
   closed-loop threads through the padded buckets: throughput, p50 / p99,
   mean occupancy, the cache hit ratio, no build after the warm-up,
   every launch count 0); the ``bucket_cuda`` class at
   ``LATENCY_SHAPES`` (50 x 500, 200 x 2000 and the class bound 1024 x
   4096), 15 blocking requests each, p50 / p99 and B.1, B.2 and B.3
   launches a request, each result bit for bit the direct fused
   ``ShardedOracle``; the top padded bucket (1024 x 4096) under 8
   concurrent 1000 x 4000 requests with 8 scaled events (launches 0);
   and a 1024-reporter market session of 8 blocks of 512 events, exact
   and incremental (the seconds of an append and a resolve, outcomes
   equal to the direct ``Oracle``, the warm drift within its band);
9. run the same paths at a middle size on the card and on the CPU
   (``device="cpu"``, or a mesh of as many CPU shards) and compare the
   two; then the ``Oracle`` (``backend="torch"``) on the card against
   its CPU run, with and without scaled events, under ``"auto"`` (the
   Gram eigh) and ``"power-fused"`` at a fixed sweep count, and its
   ``backend="numpy"`` against ``backend="torch"`` on the CPU on a
   corner of that matrix (the numpy backend's covariance eigh is E x E);
   and the fused path on bfloat16 storage with E // 8 scaled events, card
   against CPU, for sztorc, fixed-variance and ica; and the four
   clustering algorithms through the ``Oracle`` (exact keys, clusters and
   reputation order equal), then ``compare_algorithms`` over all seven,
   whose disagreement matrix must equal the CPU run's;
10. print the ``kernels`` JSON line (each kernel with the storage types it
   takes and its bfloat16 time, plain time and bound beside the int8
   ones), then the result line.

It exits non-zero, and prints no result line, when there is no CUDA
device, when the package is not beside it, or when any phase fails. It
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 FLOP/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: full-size kernel check: each output is held to this fraction of its
#: largest magnitude floored at 1, the reputation's total (float32 sums in
#: two orders; ``pcol = sum(rep) - tw`` cancels to a few percent of that
#: total), and resolve's snapped outcomes and absent counts exactly
FULL_RTOL = 3e-5
#: card-vs-CPU pipeline check at the middle size (the CPU tests' atol)
MID_ATOL = 1e-5
#: card-vs-CPU band of the multi-component paths: their orthogonal
#: iteration's exit is not pinned to a sweep count (the CPU tests hold the
#: port to the reference within the same band)
MULTI_ATOL = 2e-3
#: component counts of the block-kernel checks: fixed-variance's default
#: five components, and the direction fix's k + 1 rows
BLOCK_K = 5
#: components of the separable arm (the orthogonal iteration beyond the
#: one-pass block kernel's eight), and the storage_matmat check's width
SEPARABLE_K = 12
#: shards of the event mesh on card 0 when --mesh-devices is not given
MESH_SHARDS = 4
#: scaled events of the plain sztorc path, the last ones on [-5, 15]: the
#: project's recorded scaled run at 10k x 100k (``bench.py --scaled
#: 16000``, metric ``..._scaled16000`` in docs/MEASUREMENTS_r05.json),
#: above E // 8, so the fused gate closes
PLAIN_SCALED = 16_000
#: scaled events of the fused path's cells on bfloat16 storage, the last
#: ones on [-5, 15]: the project's recorded ``bench.py --scaled 1000`` and
#: ``--scaled 4000`` runs at 10k x 100k (``scaled_1k``, ``scaled_4k`` in
#: docs/MEASUREMENTS_r03.json, where the reference resolved bfloat16
#: storage and the fused path), at most E // 8
SCALED_FUSED = (1000, 4000)
#: timed resolutions of ShardedOracle as passed: each uploads the float
#: reports (8 GB of float64 at 10k x 100k) again
SHARDED_ORACLE_PASSED = 3
#: the hybrid clustering cells (hierarchical, dbscan): the project's
#: recorded hybrid shape (``hybrid_hierarchical_4096x32768`` and
#: ``hybrid_dbscan_4096x32768`` in docs/MEASUREMENTS_r05.json)
HYBRID_R, HYBRID_E = 4096, 32768
#: the squared radii that follow the generator's geometry, in units of E:
#: honest pairs sit near d^2 = 0.095 E, honest-liar pairs near 0.9 E
#: (dbscan's eps^2 and hierarchy's threshold^2)
DBSCAN_EPS2_PER_E, HIER_T2_PER_E = 0.15, 0.3
#: the Monte-Carlo collusion sweep (BASELINE.json config 5), at the shape
#: the project recorded it (``mc_sweep_10k_trials`` in
#: docs/MEASUREMENTS_r05.json): 50 reporters x 25 binary events, liar
#: fractions x variances x 1000 trials = 10,000 trials, the simulator's
#: defaults (``power_iters=64``) at ``max_iterations`` 1 and 5
SIM_R, SIM_E = 50, 25
SIM_LF = (0.0, 0.1, 0.2, 0.3, 0.4)
SIM_VAR = (0.05, 0.1)
SIM_T = 1000
SIM_ITERS = (1, 5)
#: sweep lanes replayed through the Oracle, and the checkpointed chunk
SIM_REPLAY = 64
SIM_CHUNK = 1024
#: the serve phase. The reference's recorded serve block
#: (``bench.py:1053-1110``): two shapes at na_frac 0.05, 48 requests at
#: concurrency 8 through ``ServeConfig(batch_window_ms=2.0, max_batch=8,
#: pallas_buckets=False)``; its latency shapes (``bench.py:181``) plus the
#: low-latency class bound, 15 blocking requests each; the top default
#: bucket (1024 x 4096) filled by 8 concurrent 1000 x 4000 requests with
#: 8 scaled events; a 1024-reporter market session of 8 blocks of 512
#: events, exact and incremental
SERVE_SHAPES = ((24, 96), (48, 192))
SERVE_REQUESTS, SERVE_CONCURRENCY = 48, 8
SERVE_NA = 0.05
LATENCY_SHAPES = ((50, 500), (200, 2000), (1024, 4096))
LATENCY_SAMPLES = 15
TOP_REQUEST, TOP_SCALED, TOP_CONCURRENT = (1000, 4000), 8, 8
SESSION_R, SESSION_BLOCKS, SESSION_BLOCK_E = 1024, 8, 512
SESSION_ROUNDS = 4
#: continuous keys of a served result against the direct resolution
SERVE_ATOL = 1e-5
#: the storage kernels of the bucket_cuda class
CUDA_TIER_KERNELS = ("apply_weighted_cov", "scores_dirfix_pass",
                     "resolve_certainty_fused")
OUT_DIR = "chiprun_out"

KERNELS = {
    "apply_weighted_cov": (
        "pyconsensus_tpu_torch/csrc/storage_sweeps.cu",
        "pyconsensus_tpu/ops/pallas_kernels.py:468"),
    "storage_matvec": (
        "pyconsensus_tpu_torch/csrc/storage_sweeps.cu",
        "pyconsensus_tpu/ops/pallas_kernels.py:538"),
    "storage_matmat": (
        "pyconsensus_tpu_torch/csrc/storage_sweeps.cu",
        "pyconsensus_tpu/ops/pallas_kernels.py:720"),
    "scores_dirfix_pass": (
        "pyconsensus_tpu_torch/csrc/storage_sweeps.cu",
        "pyconsensus_tpu/ops/pallas_kernels.py:1056"),
    # the column half, then the row half (the row-tile pass at k = 2)
    "resolve_certainty_fused": (
        "pyconsensus_tpu_torch/csrc/resolve.cu",
        "pyconsensus_tpu/ops/pallas_kernels.py:1275",
        "pyconsensus_tpu_torch/csrc/storage_sweeps.cu"),
    "apply_weighted_cov_block": (
        "pyconsensus_tpu_torch/csrc/storage_sweeps.cu",
        "pyconsensus_tpu/ops/pallas_kernels.py:853"),
    "storage_rows_matmat": (
        "pyconsensus_tpu_torch/csrc/storage_sweeps.cu",
        "pyconsensus_tpu/ops/pallas_kernels.py:978"),
    "fill_stats_pass": (
        "pyconsensus_tpu_torch/csrc/storage_sweeps.cu",
        "pyconsensus_tpu/ops/pallas_kernels.py:627"),
}
#: the kernels each main path must launch, and those of another arm that
#: it must not
PATH_KERNELS = {
    "sztorc": ("apply_weighted_cov", "scores_dirfix_pass",
               "resolve_certainty_fused"),
    "fixed-variance": ("apply_weighted_cov_block", "storage_rows_matmat",
                       "resolve_certainty_fused"),
    "ica": ("apply_weighted_cov_block", "storage_rows_matmat",
            "resolve_certainty_fused"),
    "sztorc mesh": ("storage_matvec", "storage_rows_matmat",
                    "resolve_certainty_fused"),
    "fixed-variance separable": ("storage_matmat", "storage_rows_matmat",
                                 "resolve_certainty_fused"),
    "ica separable": ("storage_matmat", "storage_rows_matmat",
                      "resolve_certainty_fused"),
    # the plain core: sztorc's sweeps on the dense filled matrix; the
    # Gram eigh runs no storage kernel
    "sztorc plain": ("apply_weighted_cov", "scores_dirfix_pass"),
    "gram plain": (),
    # k-means and dbscan-jit: the plain core's clustering, no PCA
    "clustering": (),
}
#: the storage types each kernel takes (fill_stats_pass: int8 and float32,
#: as the reference runs it on int8 alone)
STORAGES = {k: ("int8", "float32", "bfloat16") for k in KERNELS}
STORAGES["fill_stats_pass"] = ("int8", "float32")
PATH_FORBIDS = {
    "sztorc": ("storage_matvec",),
    "fixed-variance": ("storage_matmat",),
    "ica": ("storage_matmat",),
    "sztorc mesh": ("apply_weighted_cov", "scores_dirfix_pass"),
    "fixed-variance separable": ("apply_weighted_cov_block",),
    "ica separable": ("apply_weighted_cov_block",),
    "sztorc plain": tuple(k for k in KERNELS if k not in (
        "apply_weighted_cov", "scores_dirfix_pass")),
    "gram plain": tuple(KERNELS),
    "clustering": tuple(KERNELS),
}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    log(f"== phase {name}: {time.perf_counter() - t0:.3f} s")


def gen_reports(torch, R, E, seed, device, na_frac=0.02, liar_frac=0.1,
                noise=0.05, rows=1000):
    """The collusion threat model of the JAX package's simulator (honest
    reporters flip the truth at ``noise``, a ``liar_frac`` share reports
    the shared anti-truth, ``na_frac`` of entries absent), drawn with an
    explicit ``torch.Generator`` straight into int8 sentinel storage.
    Returns ``(x int8 (R, E), truth (E,) float32)``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    truth = torch.rand(E, generator=g, device=device) < 0.5
    liar = torch.rand(R, generator=g, device=device) < liar_frac
    x = torch.empty((R, E), dtype=torch.int8, device=device)
    for r0 in range(0, R, rows):
        r1 = min(R, r0 + rows)
        flip = torch.rand((r1 - r0, E), generator=g, device=device) < noise
        vote = torch.where(liar[r0:r1, None], ~truth[None, :],
                           truth[None, :] ^ flip)
        na = torch.rand((r1 - r0, E), generator=g, device=device) < na_frac
        x[r0:r1] = torch.where(na, torch.full_like(vote, -1, dtype=torch.int8),
                               vote.to(torch.int8) * 2)
    return x, truth.to(torch.float32)


def time_ms(torch, fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` calls, each between
    two CUDA events (after one warm-up call)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn, reps):
    """Milliseconds of device time per call of ``fn``: ``reps`` calls
    back to back between two CUDA events (after one warm-up call), so the
    card's queue never waits on the host."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(n_bytes, n_flops):
    """The least time for the work: bytes over the memory rate or float32
    operations over the float32 rate, whichever is larger."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = n_flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_rel_err(torch, got, ref):
    """max |got - ref| and that over max(max |ref|, 1)."""
    d = (got.double() - ref.double()).abs().max().item()
    scale = max(ref.double().abs().max().item(), 1.0)
    return d, d / scale


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from pyconsensus_tpu_torch import (ConsensusParams, _native,
                                           sharded_consensus)
        from pyconsensus_tpu_torch.models import pipeline
        from pyconsensus_tpu_torch.models.pipeline import _fill_stats
        from pyconsensus_tpu_torch.ops import build
        from pyconsensus_tpu_torch.ops import cuda_kernels as ck
        from pyconsensus_tpu_torch.parallel.mesh import (make_mesh,
                                                         place_event_shards)
        from pyconsensus_tpu_torch.parallel.sharded import resolve_params
    except ImportError as exc:
        print(f"chip_smoke: the pyconsensus_tpu_torch package is not beside "
              f"this script ({exc})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    R, E = args.reporters, args.events
    t_start = time.perf_counter()

    with phase("device"):
        name = torch.cuda.get_device_name(0)
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
            f"{name}, capability {torch.cuda.get_device_capability(0)}, "
            f"count {torch.cuda.device_count()}")
        smi = shutil.which("nvidia-smi")
        if smi is None:
            raise RuntimeError("nvidia-smi not found")
        card = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True
        ).stdout.strip().splitlines()[0]
        log(card)

    with phase("build"):
        libs = build.build_all()
        for src, path in libs.items():
            secs = build.build_seconds().get(src)
            took = f" in {secs:.1f} s" if secs is not None else " (cached)"
            log(f"built {src}{took} -> {os.path.relpath(path, here)}")
        os.makedirs(os.path.join(here, OUT_DIR), exist_ok=True)
        if build.build_log():       # empty when every library was built
            with open(os.path.join(here, OUT_DIR, "chip_smoke_build.log"),
                      "w") as f:
                for src, text in build.build_log().items():
                    f.write(f"--- {src}\n{text}\n")
        spills = [ln.strip() for text in build.build_log().values()
                  for ln in text.splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores, "
                      "0 bytes spill loads")]
        log(f"ptxas lines reporting spills or stack: {len(spills)}")
        for ln in spills[:8]:
            log(f"  {ln}")
        # the hybrid clustering's host runtime (g++, native/cluster.cpp):
        # the card's machine has no sklearn to fall back on
        t0 = time.perf_counter()
        if _native.load() is None:
            raise RuntimeError("the native clustering library did not build "
                               "from native/cluster.cpp")
        log(f"built native/cluster.cpp in {time.perf_counter() - t0:.1f} s "
            f"-> {os.path.relpath(_native.library_path(), here)}")

    if args.mesh_devices > torch.cuda.device_count():
        raise RuntimeError(f"--mesh-devices {args.mesh_devices}: only "
                           f"{torch.cuda.device_count()} cards")
    stats = kernel_phase(torch, args, ck, _fill_stats, dev, card)
    launches = {k: 0 for k in KERNELS}

    def drive(x, p, label, path=None, **kw):
        """One main path: a warm-up, then ``args.resolutions`` timed
        resolutions with the launch counts set to 0 just before and read
        just after; the kernels of ``path`` (default: the algorithm) must
        have launched and those of another arm must not. ``kw`` goes to
        ``sharded_consensus``. Returns ``(out, resolutions/s, counts)``."""
        path = path or p.algorithm
        out = sharded_consensus(x, params=p, **kw)           # warm-up
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(args.resolutions):
            out = sharded_consensus(x, params=p, **kw)
        torch.cuda.synchronize()
        rate = args.resolutions / (time.perf_counter() - t0)
        counts = ck.launch_counts()
        for k in KERNELS:
            launches[k] += counts[k]
        missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
        if missing:
            raise RuntimeError(f"{label}: kernels of the path never "
                               f"launched: {missing} ({counts})")
        stray = [k for k in PATH_FORBIDS.get(path, ()) if counts[k] != 0]
        if stray:
            raise RuntimeError(f"{label}: kernels of another arm launched: "
                               f"{stray} ({counts})")
        return out, rate, counts

    if args.mesh_devices:
        mesh = make_mesh(event=args.mesh_devices)
        where = f"{args.mesh_devices} cards"
    else:
        mesh = make_mesh(devices=[dev] * MESH_SHARDS)
        where = f"{MESH_SHARDS} shards on one card"
    with phase(f"main paths {R}x{E} int8"):
        x8, truth = gen_reports(torch, R, E, args.seed + 2, dev)
        torch.cuda.synchronize()
        single = {}
        for algo in ("sztorc", "fixed-variance", "ica"):
            for mi in (1, 3):
                # "auto" picks fused power or orthogonal iteration above
                # 4096 reporters (the exact eigh below it is not ported);
                # a smaller rehearsal names the iteration
                small = "power-fused" if algo == "sztorc" else "power"
                p = ConsensusParams(algorithm=algo, storage_dtype="int8",
                                    max_iterations=mi, power_tol=1e-5,
                                    pca_method="auto" if R > 4096 else small)
                resolved = resolve_params(p._replace(any_scaled=False), R,
                                          E, dev)
                if not resolved.fused_resolution:
                    raise RuntimeError(f"{algo}: pca_method={p.pca_method} "
                                       "did not open the fused path")
                label = f"{algo} max_iterations={mi}"
                out, rate, counts = drive(x8, p, label)
                single[algo, mi] = out
                check_result(torch, out, R, E, algo)
                correct = float((out["outcomes_adjusted"] == truth)
                                .float().mean())
                iters = int(out["iterations"])
                extra = ""
                if algo != "sztorc":
                    sweeps = (counts["apply_weighted_cov_block"]
                              / (args.resolutions * iters) - 1)
                    extra = f", orth-iter sweeps per scoring {sweeps:.2f}"
                if algo == "ica":
                    extra += f", ica_converged {bool(out['ica_converged'])}"
                log(f"{label} (pca_method {resolved.pca_method}): "
                    f"{rate:.4f} resolutions/s ({1e3 / rate:.3f} ms each) "
                    f"on {card}; iterations {iters}, converged "
                    f"{bool(out['convergence'])}, outcomes == truth "
                    f"{correct:.6f}{extra}; launches {counts}")
                if correct < 0.99:
                    raise RuntimeError(f"{label}: the outcomes do not "
                                       "recover the truth")
        placed = mesh_paths(torch, args, drive, x8, truth, mesh, where,
                            single, card, resolve_params, place_event_shards)
        separable_paths(torch, args, drive, x8, truth, card, resolve_params)
        fill_stats_ab(torch, pipeline, drive, x8, card)
        scaled_fused_paths(torch, args, drive, x8, truth, card, dev,
                           resolve_params)
        if args.profile:
            for tag, x, algo, k in (
                    ("sztorc_mesh", placed, "sztorc", 5),
                    ("sztorc", x8, "sztorc", 5),
                    ("fixed-variance", x8, "fixed-variance", 5),
                    ("ica", x8, "ica", 5),
                    ("fixed-variance_separable", x8, "fixed-variance",
                     SEPARABLE_K)):
                profile_resolution(torch, sharded_consensus, x,
                                   ConsensusParams(algorithm=algo,
                                                   storage_dtype="int8",
                                                   max_components=k,
                                                   power_tol=1e-5,
                                                   pca_method="auto"),
                                   card, tag)
        del placed
        del x8
        torch.cuda.empty_cache()

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the plain core's products "
                           "must be faithful to float32")
    with phase(f"plain paths {R}x{E} float32"):
        plain_paths(torch, args, drive, card, dev, sharded_consensus,
                    resolve_params)

    with phase(f"ShardedOracle and the fallback chain {R}x{E} int8"):
        sharded_oracle_phase(torch, args, card, dev, launches)

    with phase("clustering"):
        clustering_paths(torch, args, drive, card, dev)
        hybrid_paths(torch, args, card, dev)

    with phase("simulator and persistence"):
        sim_phase(torch, args, ck, card, dev)
        persistence_phase(torch, args, ck, card, dev)

    with phase("serve"):
        serve_phase(torch, ck, card, dev, launches, args.seed)

    with phase(f"card vs cpu {args.mid_r}x{args.mid_e}"):
        xm, _ = gen_reports(torch, args.mid_r, args.mid_e, args.seed + 3, dev)
        xm_cpu = xm.cpu()
        for algo, atol in (("sztorc", MID_ATOL),
                           ("fixed-variance", MULTI_ATOL),
                           ("ica", MULTI_ATOL)):
            for mi in (1, 3):
                p = ConsensusParams(algorithm=algo, storage_dtype="int8",
                                    max_iterations=mi, pca_method="power",
                                    power_tol=1e-5)
                a = sharded_consensus(xm, params=p)
                b = sharded_consensus(xm_cpu, params=p, device="cpu")
                worst = compare_outputs(torch, a, b, atol,
                                        f"card vs cpu {algo} "
                                        f"max_iterations={mi}")
                log(f"{algo} max_iterations={mi}: card and cpu agree (exact "
                    f"keys equal, continuous max |diff| {worst:.3e} <= "
                    f"{atol}); iterations {int(a['iterations'])}")
        cpu_mesh = make_mesh(devices=["cpu"] * len(mesh))
        for mi in (1, 3):
            p = ConsensusParams(storage_dtype="int8", max_iterations=mi,
                                pca_method="power", power_tol=1e-5)
            a = sharded_consensus(xm, params=p, mesh=mesh)
            b = sharded_consensus(xm_cpu, params=p, mesh=cpu_mesh)
            worst = compare_outputs(torch, a, b, MID_ATOL,
                                    f"card vs cpu sztorc mesh "
                                    f"max_iterations={mi}")
            log(f"sztorc mesh ({where} vs {len(mesh)} cpu shards) "
                f"max_iterations={mi}: exact keys equal, continuous max "
                f"|diff| {worst:.3e} <= {MID_ATOL}; iterations "
                f"{int(a['iterations'])}")
        for algo in ("fixed-variance", "ica"):
            p = ConsensusParams(algorithm=algo, storage_dtype="int8",
                                max_components=SEPARABLE_K,
                                pca_method="power", power_tol=1e-5)
            a = sharded_consensus(xm, params=p)
            b = sharded_consensus(xm_cpu, params=p, device="cpu")
            worst = compare_outputs(torch, a, b, MULTI_ATOL,
                                    f"card vs cpu {algo} separable")
            log(f"{algo} max_components={SEPARABLE_K} (separable arm): card "
                f"and cpu agree (exact keys equal, continuous max |diff| "
                f"{worst:.3e} <= {MULTI_ATOL})")
        oracle_card_vs_cpu(torch, ck, xm_cpu, PLAIN_SCALED)
        bf16_card_vs_cpu(torch, sharded_consensus, xm_cpu, dev)
        clustering_card_vs_cpu(torch, ck, xm_cpu)

    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "sources": [KERNELS[k][0], *KERNELS[k][2:]],
         "replaces": KERNELS[k][1], "launches": launches[k],
         "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
         "plain_ms": stats[k]["plain_ms"],
         "bound_ms": stats[k]["bound_ms"],
         "bound_by": stats[k]["bound_by"],
         "library_ms": stats[k]["library_ms"],
         "float32_ms": stats[k].get("float32_ms"),
         "dense_float32_ms": stats[k].get("dense_float32_ms"),
         "storages": list(STORAGES[k]),
         "bfloat16_ms": stats[k].get("bfloat16_ms"),
         "bfloat16_plain_ms": stats[k].get("bfloat16_plain_ms"),
         "bfloat16_bound_ms": stats[k].get("bfloat16_bound_ms")}
        for k in KERNELS]}))
    log(f"chip_smoke total {time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_phase(torch, args, ck, _fill_stats, dev, card) -> dict:
    """Phase 3: every kernel against its plain version at full size on
    int8, float32+NaN and bfloat16+NaN storage, timed beside its bound,
    and the uncentered products beside one PyTorch call on dense float32.
    Returns the per-kernel numbers of the ``kernels`` line."""
    R, E = args.reporters, args.events
    stats = {k: {"max_abs_err": 0.0, "library_ms": None} for k in KERNELS}
    with phase(f"kernels {R}x{E}"):
        x8, _ = gen_reports(torch, R, E, args.seed, dev)
        g = torch.Generator(device=dev)
        g.manual_seed(args.seed + 1)
        rep = torch.rand(R, generator=g, device=dev) + 0.5
        rep = rep / rep.sum()
        _, fill, tw, numer = _fill_stats(x8, rep, 0.1, "int8")
        mu = numer + (rep.sum() - tw) * fill
        v = torch.randn(E, generator=g, device=dev)
        V = torch.randn((E, BLOCK_K), generator=g, device=dev)
        V12 = torch.randn((E, SEPARABLE_K), generator=g, device=dev)
        W = torch.randn((BLOCK_K + 1, R), generator=g, device=dev)
        xf = torch.where(x8 < 0, torch.full((), float("nan"), device=dev),
                         x8.to(torch.float32) * 0.5)
        # bfloat16: the last eighth of the events continuous in [0, 1] (as
        # rescaled scaled events are) with continuous fills there, so that
        # the uncentered products' bfloat16 fill and the sweeps' float32
        # fill differ
        n_sc = E // 8
        xb = xf.clone()
        xb[:, E - n_sc:] = torch.where(
            torch.isnan(xb[:, E - n_sc:]), xb[:, E - n_sc:],
            torch.rand((R, n_sc), generator=g, device=dev))
        xb = xb.to(torch.bfloat16)
        fill_b = fill.clone()
        fill_b[E - n_sc:] = torch.rand(n_sc, generator=g, device=dev)
        for storage, x, fl in (("int8", x8, fill), ("float32", xf, fill),
                               ("bfloat16", xb, fill_b)):
            nb = x.numel() * x.element_size()
            checks = {
                "apply_weighted_cov": (
                    lambda: ck.apply_weighted_cov(x, mu, rep, v, fl),
                    lambda: ck.apply_weighted_cov_plain(x, mu, rep, v, fl),
                    nb + 4 * (3 * E + R) + 4 * E, 4 * R * E),
                "scores_dirfix_pass": (
                    lambda: ck.scores_dirfix_pass(x, rep, v, fl),
                    lambda: ck.scores_dirfix_pass_plain(x, rep, v, fl),
                    nb + 4 * (2 * E + R) + 4 * (3 * E + R), 8 * R * E),
                "storage_matvec": (
                    lambda: ck.storage_matvec(x, v, fl),
                    lambda: ck.storage_matvec_plain(x, v, fl),
                    nb + 4 * 2 * E + 4 * R, 2 * R * E),
                # k = 12 in one row-tile launch (up to 16 columns a launch)
                "storage_matmat": (
                    lambda: ck.storage_matmat(x, V12, fl),
                    lambda: ck.storage_matmat_plain(x, V12, fl),
                    nb + 4 * (E + SEPARABLE_K * E) + 4 * SEPARABLE_K * R,
                    2 * SEPARABLE_K * R * E),
                "resolve_certainty_fused": (
                    lambda: ck.resolve_certainty_fused(x, rep, fl, 1.0,
                                                       0.1),
                    lambda: ck.resolve_certainty_fused_plain(x, rep, fl,
                                                             1.0, 0.1),
                    nb + 4 * (E + R) + 4 * (4 * E + 2 * R), 10 * R * E),
                # the loop's sweeps (no projections out); the final
                # Rayleigh-Ritz form is checked and timed below
                "apply_weighted_cov_block": (
                    lambda: ck.apply_weighted_cov_block(x, mu, rep, V, fl),
                    lambda: ck.apply_weighted_cov_block_plain(x, mu, rep, V,
                                                              fl),
                    nb + 4 * (2 * E + R + BLOCK_K * E) + 4 * BLOCK_K * E,
                    4 * BLOCK_K * R * E),
                "apply_weighted_cov_block emit_t": (
                    lambda: ck.apply_weighted_cov_block(x, mu, rep, V, fl,
                                                        emit_t=True),
                    lambda: ck.apply_weighted_cov_block_plain(
                        x, mu, rep, V, fl, emit_t=True),
                    nb + 4 * (2 * E + R + BLOCK_K * E)
                    + 4 * BLOCK_K * (E + R), 4 * BLOCK_K * R * E),
                "storage_rows_matmat": (
                    lambda: ck.storage_rows_matmat(x, W, fl),
                    lambda: ck.storage_rows_matmat_plain(x, W, fl),
                    nb + 4 * ((BLOCK_K + 1) * R + E)
                    + 4 * (BLOCK_K + 1) * E, 2 * (BLOCK_K + 1) * R * E),
                "fill_stats_pass": (
                    lambda: ck.fill_stats_pass(x, rep),
                    lambda: ck.fill_stats_pass_plain(x, rep),
                    nb + 4 * R + 4 * 2 * E, 5 * R * E),
            }
            checks = {c: v for c, v in checks.items()
                      if storage in STORAGES[c.split()[0]]}
            for check, (kern, plain, n_bytes, n_flops) in checks.items():
                kname = check.split()[0]
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                got = tuple(a for a in got if a is not None)
                ref = tuple(b for b in ref if b is not None)
                worst_abs, worst_rel = 0.0, 0.0
                for a, b in zip(got, ref):
                    if not bool(torch.isfinite(a).all()):
                        raise RuntimeError(f"{kname} [{storage}]: non-finite "
                                           "output")
                    d, r = max_rel_err(torch, a, b)
                    worst_abs, worst_rel = max(worst_abs, d), max(worst_rel,
                                                                  r)
                if kname == "resolve_certainty_fused":
                    for i, what in ((1, "snapped outcomes"),
                                    (5, "absent counts")):
                        if not torch.equal(got[i], ref[i]):
                            n = int((got[i] != ref[i]).sum())
                            raise RuntimeError(
                                f"{kname} [{storage}]: {n} {what} differ "
                                "from the plain version")
                ok = worst_rel <= FULL_RTOL
                log(f"{check} [{storage}]: max_abs_err {worst_abs:.3e}, "
                    f"max err / max(max|ref|, 1) {worst_rel:.3e} (limit "
                    f"{FULL_RTOL:.0e}) {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise RuntimeError(f"{check} [{storage}] disagrees with "
                                       "its plain version")
                k_ms = time_ms(torch, kern, args.reps)
                p_ms = time_ms(torch, plain, max(3, args.reps // 3))
                b_ms, b_by = bound_ms(n_bytes, n_flops)
                log(f"{check} [{storage}]: kernel {k_ms:.4f} ms, plain "
                    f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) on {card}")
                if storage == "int8" and check == kname:
                    stats[kname].update(ms=k_ms, plain_ms=p_ms,
                                        bound_ms=b_ms, bound_by=b_by)
                if storage == "float32" and check == kname:
                    stats[kname]["float32_ms"] = k_ms
                if storage == "bfloat16" and check == kname:
                    stats[kname].update(bfloat16_ms=k_ms,
                                        bfloat16_plain_ms=p_ms,
                                        bfloat16_bound_ms=b_ms)
                stats[kname]["max_abs_err"] = max(
                    stats[kname]["max_abs_err"], worst_abs)
            # resolve's halves: the column-panel kernel (one read of X,
            # rep and fill; four E-vectors out), then the row-tile pass at
            # k = 2 over [cert; 1] (one read of X and 2E; 2R out)
            cert = ck._resolve_columns(x, rep, fl, 1.0, 0.1)[2]
            vt = torch.stack([cert, torch.ones_like(cert)])
            halves = (("column half", lambda: ck._resolve_columns(
                x, rep, fl, 1.0, 0.1), nb + 4 * (R + E) + 4 * 4 * E),
                      ("row half", lambda: ck._absent_rows(x, vt),
                       nb + 4 * 2 * E + 4 * 2 * R))
            for half, fn, n_bytes in halves:
                d_ms = device_ms(torch, fn, args.reps)
                log(f"resolve_certainty_fused [{storage}] {half}: "
                    f"{d_ms:.4f} ms of device time, bound "
                    f"{bound_ms(n_bytes, 0)[0]:.4f} ms (bytes) on {card}")
        log(f"resolve_certainty_fused around the call: int8 "
            f"{stats['resolve_certainty_fused']['ms']:.4f} ms, float32+NaN "
            f"{stats['resolve_certainty_fused']['float32_ms']:.4f} ms, "
            f"bfloat16+NaN "
            f"{stats['resolve_certainty_fused']['bfloat16_ms']:.4f} ms on "
            f"{card}")
        del xf
        # the matvecs are the row-tile pass at k = 1, whose tiling does
        # not depend on k: each equals the k = 1 block call (on bfloat16
        # both products take the fill rounded to bfloat16, the sweeps'
        # scores pass the float32 fill: a dense matrix compares them)
        xbd = torch.nan_to_num(xb, nan=0.5)
        for storage, x, fl in (("int8", x8, fill), ("bfloat16", xb, fill_b),
                               ("bfloat16 dense", xbd, None)):
            same = {
                "storage_matvec": (ck.storage_matvec(x, v, fl),
                                   ck.storage_matmat(x, v[:, None],
                                                     fl)[:, 0]),
                "apply_weighted_cov_block": (
                    ck.apply_weighted_cov_block(x, mu, rep, V, fl)[0][:, :2],
                    ck.apply_weighted_cov_block(x, mu, rep, V[:, :2],
                                                fl)[0]),
            }
            if storage != "bfloat16":
                same["scores_dirfix_pass"] = (
                    ck.scores_dirfix_pass(x, rep, v, fl)[0],
                    ck.storage_matvec(x, v, fl))
                same["apply_weighted_cov"] = (
                    ck.apply_weighted_cov(x, mu, rep, v, fl),
                    ck.apply_weighted_cov_block(x, mu, rep, v[:, None],
                                                fl)[0][:, 0])
            for kname, (a, b) in same.items():
                if not torch.equal(a, b):
                    raise RuntimeError(f"{kname} [{storage}]: not the bits "
                                       "of the k = 1 (or k = 2) call")
            log(f"{', '.join(same)} [{storage}]: equal bit for bit to the "
                "smaller-k block calls")
        del xb, xbd
        # how the two uncentered block products' time grows with k, on
        # int8: one launch each
        grows = [("storage_matmat", k, torch.randn((E, k), generator=g,
                                                   device=dev))
                 for k in (4, 16)]
        grows += [("storage_rows_matmat", k,
                   torch.randn((k, R), generator=g, device=dev))
                  for k in (1, 12, 16)]
        for kname, k, B in grows:
            kern = getattr(ck, kname)
            got = kern(x8, B, fill)
            ref = getattr(ck, kname + "_plain")(x8, B, fill)
            d, r = max_rel_err(torch, got, ref)
            if r > FULL_RTOL:
                raise RuntimeError(f"{kname} k={k} [int8] disagrees with its "
                                   f"plain version: {r:.3e}")
            k_ms = time_ms(torch, lambda: kern(x8, B, fill), args.reps)
            n_out = k * (R if kname == "storage_matmat" else E)
            b_ms, b_by = bound_ms(R * E + 4 * (E + B.numel() + n_out),
                                  2 * k * R * E)
            stats[kname]["max_abs_err"] = max(stats[kname]["max_abs_err"], d)
            log(f"{kname} k={k} [int8]: kernel {k_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}) on {card}; max_abs_err {d:.3e}")
        # one PyTorch call computes each uncentered product where no entry
        # is absent: time it on the filled matrix in float32, beside the
        # kernel on the same dense storage
        xd = torch.where(x8 < 0, fill.to(torch.float32)[None, :],
                         x8.to(torch.float32) * 0.5)
        library = {
            "storage_matvec": ("torch.mv", lambda: ck.storage_matvec(xd, v),
                               lambda: torch.mv(xd, v)),
            "storage_matmat": ("x @ V", lambda: ck.storage_matmat(xd, V12),
                               lambda: xd @ V12),
            "storage_rows_matmat": ("W @ x",
                                    lambda: ck.storage_rows_matmat(xd, W),
                                    lambda: W @ xd),
        }
        # the plain core's sweeps: B.1 and B.2 on the dense filled matrix
        # (fill=None), each against its plain version
        dense = {
            "apply_weighted_cov": (
                lambda: ck.apply_weighted_cov(xd, mu, rep, v),
                lambda: ck.apply_weighted_cov_plain(xd, mu, rep, v),
                4 * R * E + 4 * (2 * E + R) + 4 * E, 4 * R * E),
            "scores_dirfix_pass": (
                lambda: ck.scores_dirfix_pass(xd, rep, v),
                lambda: ck.scores_dirfix_pass_plain(xd, rep, v),
                4 * R * E + 4 * (E + R) + 4 * (3 * E + R), 8 * R * E),
        }
        for kname, (kern, plain, n_bytes, n_flops) in dense.items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            worst_abs, worst_rel = 0.0, 0.0
            for a, b in zip(got, ref):
                d, r = max_rel_err(torch, a, b)
                worst_abs, worst_rel = max(worst_abs, d), max(worst_rel, r)
            if worst_rel > FULL_RTOL:
                raise RuntimeError(f"{kname} [dense float32] disagrees with "
                                   f"its plain version: {worst_rel:.3e}")
            k_ms = time_ms(torch, kern, args.reps)
            p_ms = time_ms(torch, plain, max(3, args.reps // 3))
            b_ms, b_by = bound_ms(n_bytes, n_flops)
            stats[kname]["dense_float32_ms"] = k_ms
            stats[kname]["max_abs_err"] = max(stats[kname]["max_abs_err"],
                                              worst_abs)
            log(f"{kname} [dense float32, fill=None]: kernel {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) on "
                f"{card}; max err / max(max|ref|, 1) {worst_rel:.3e}")
        for kname, (call, kern, lib) in library.items():
            got, ref = kern(), lib()
            torch.cuda.synchronize()
            d, r = max_rel_err(torch, got, ref)
            if r > FULL_RTOL:
                raise RuntimeError(f"{kname} [dense float32] disagrees with "
                                   f"{call}: {r:.3e}")
            k_ms = time_ms(torch, kern, args.reps)
            l_ms = time_ms(torch, lib, args.reps)
            stats[kname]["library_ms"] = l_ms
            log(f"{kname} [dense float32]: kernel {k_ms:.4f} ms, library "
                f"{call} {l_ms:.4f} ms on {card}; agree to {r:.3e}")
        del xd
        torch.cuda.empty_cache()

    return stats


def mesh_paths(torch, args, drive, x8, truth, mesh, where, single, card,
               resolve_params, place_event_shards):
    """sztorc on the event mesh at ``max_iterations`` 1 and 3, the storage
    placed once (its time printed apart from the timed loop): the mesh
    launches the uncentered products and resolve, not the one-device
    sweeps; its outcomes must recover the truth, and its outcomes,
    ``na_row`` and iterations must equal the single-device run's on the
    same matrix. Then the same matrix as float reports, encoded to int8
    per call: 16-column shards, and the pre-encoded run's answer."""
    from pyconsensus_tpu_torch import ConsensusParams

    R, E = x8.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = place_event_shards(x8, mesh)
    torch.cuda.synchronize()
    log(f"mesh placement ({where}): {time.perf_counter() - t0:.4f} s; shard "
        f"widths {list(placed.widths)} padded to "
        f"{[s.shape[1] for s in placed.shards]}")
    mesh_out = {}
    for mi in (1, 3):
        p = ConsensusParams(storage_dtype="int8", max_iterations=mi,
                            power_tol=1e-5,
                            pca_method="auto" if R > 4096 else "power-fused")
        resolved = resolve_params(p._replace(any_scaled=False), R, E,
                                  mesh[0], len(mesh))
        if not resolved.fused_resolution:
            raise RuntimeError("sztorc mesh: the fused path did not open")
        label = f"sztorc mesh ({where}) max_iterations={mi}"
        out, rate, counts = drive(placed, p, label, "sztorc mesh")
        check_result(torch, out, R, E)
        correct = float((out["outcomes_adjusted"] == truth).float().mean())
        ref = single["sztorc", mi]
        for key in ("outcomes_adjusted", "na_row", "iterations"):
            if not torch.equal(out[key], ref[key]):
                raise RuntimeError(f"{label}: {key} differs from the "
                                   "single-device run")
        worst = 0.0
        for key, v in out.items():
            if not isinstance(v, torch.Tensor) or key in (
                    "outcomes_adjusted", "outcomes_final", "na_row",
                    "iterations", "convergence"):
                continue
            w = ref[key]
            if key == "first_loading" and float(v @ w) < 0:
                w = -w
            worst = max(worst, (v.double() - w.double()).abs().max().item())
        log(f"{label} (pca_method {resolved.pca_method}): {rate:.4f} "
            f"resolutions/s ({1e3 / rate:.3f} ms each) on {card}; "
            f"iterations {int(out['iterations'])}, outcomes == truth "
            f"{correct:.6f}; outcomes, na_row and iterations equal to one "
            f"device, continuous max |diff| {worst:.3e}; launches {counts}")
        if correct < 0.99:
            raise RuntimeError(f"{label}: the outcomes do not recover the "
                               "truth")
        mesh_out[mi] = out
    # float reports that storage_dtype="int8" encodes per call: each shard
    # keeps a 16-column multiple, so its int8 rows load 16 bytes at a time
    xf = torch.where(x8 < 0, torch.full((), float("nan"), device=x8.device),
                     x8.to(torch.float32) * 0.5)
    t0 = time.perf_counter()
    placed_f = place_event_shards(xf, mesh)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    del xf
    padded = [s.shape[1] for s in placed_f.shards]
    if any(w % 16 for w in padded):
        raise RuntimeError(f"float shards padded to {padded}: not 16-column "
                           "multiples")
    p = ConsensusParams(storage_dtype="int8", max_iterations=1,
                        power_tol=1e-5,
                        pca_method="auto" if R > 4096 else "power-fused")
    label = f"sztorc mesh ({where}) on float reports encoded per call"
    out, rate, counts = drive(placed_f, p, label, "sztorc mesh")
    del placed_f
    torch.cuda.empty_cache()
    worst = compare_outputs(torch, out, mesh_out[1], MID_ATOL,
                            f"{label} vs pre-encoded int8")
    log(f"{label} (placed in {place_s:.4f} s, shards padded to {padded}): "
        f"{rate:.4f} resolutions/s ({1e3 / rate:.3f} ms each) on {card}; "
        f"equal to the pre-encoded mesh run, continuous max |diff| "
        f"{worst:.3e}; launches {counts}")
    return placed


def separable_paths(torch, args, drive, x8, truth, card, resolve_params):
    """fixed-variance and ica at ``SEPARABLE_K`` components: the
    orthogonal iteration takes the separable arm (``storage_matmat``,
    never the block kernel)."""
    from pyconsensus_tpu_torch import ConsensusParams

    R, E = x8.shape
    dev = x8.device
    for algo in ("fixed-variance", "ica"):
        p = ConsensusParams(algorithm=algo, storage_dtype="int8",
                            max_components=SEPARABLE_K, power_tol=1e-5,
                            pca_method="auto" if R > 4096 else "power")
        if not resolve_params(p._replace(any_scaled=False), R, E,
                              dev).fused_resolution:
            raise RuntimeError(f"{algo} separable: the fused path did not "
                               "open")
        label = f"{algo} max_components={SEPARABLE_K}"
        out, rate, counts = drive(x8, p, label, f"{algo} separable")
        check_result(torch, out, R, E, algo)
        correct = float((out["outcomes_adjusted"] == truth).float().mean())
        # per scoring: one storage_matmat call per sweep, the Rayleigh-Ritz
        # application and the scores sweep
        sweeps = counts["storage_matmat"] / args.resolutions - 2
        log(f"{label} (separable arm): {rate:.4f} resolutions/s "
            f"({1e3 / rate:.3f} ms each) on {card}; orth-iter sweeps "
            f"{sweeps:.2f}, outcomes == truth {correct:.6f}; launches "
            f"{counts}")
        if correct < 0.99:
            raise RuntimeError(f"{label}: the outcomes do not recover the "
                               "truth")


def profile_resolution(torch, sharded_consensus, x, p, card, tag, **kw):
    """One resolution under ``torch.profiler``: wall time, the device's
    kernel time and busy share, and device time by kernel name (the full
    table goes to ``profile_<tag>.txt`` under ``OUT_DIR``). ``kw`` goes to
    ``sharded_consensus``."""
    from torch.profiler import ProfilerActivity, profile

    sharded_consensus(x, params=p, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sharded_consensus(x, params=p, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel entries only: an operator's entry repeats its kernels' time
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"profile {tag} max_iterations={p.max_iterations}: wall "
        f"{wall_ms:.3f} ms, "
        f"device kernels {busy_ms:.3f} ms, busy share "
        f"{busy_ms / wall_ms:.4f} on {card}")
    for ms, n, key in rows[:14]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {key[:110]}")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, OUT_DIR, f"profile_{tag}.txt"),
              "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))


def fill_stats_ab(torch, pipeline, drive, x, card):
    """sztorc at ``max_iterations=1`` with the plain fill statistics and
    with ``fill_stats_pass`` (the pipeline's import-time gate set in
    place), timed in turns plain, kernel, kernel, plain. Outcomes must be
    equal and the continuous keys within ``MID_ATOL``."""
    from pyconsensus_tpu_torch import ConsensusParams

    p = ConsensusParams(storage_dtype="int8", power_tol=1e-5,
                        pca_method="auto" if x.shape[0] > 4096
                        else "power-fused")
    rates = {False: [], True: []}
    outs = {}
    try:
        for gate in (False, True, True, False):
            pipeline._FILL_STATS_KERNEL = gate
            label = f"sztorc fill statistics {'kernel' if gate else 'plain'}"
            outs[gate], rate, counts = drive(x, p, label)
            rates[gate].append(rate)
            if gate and counts["fill_stats_pass"] == 0:
                raise RuntimeError("fill_stats_pass never launched with the "
                                   "gate on")
            if not gate and counts["fill_stats_pass"] != 0:
                raise RuntimeError("fill_stats_pass launched with the gate "
                                   "off")
    finally:
        pipeline._FILL_STATS_KERNEL = False
    worst = compare_outputs(torch, outs[True], outs[False], MID_ATOL,
                            "fill statistics kernel vs plain")
    log("fill statistics A/B, sztorc max_iterations=1 (plain, kernel, "
        "kernel, plain): plain " + ", ".join(f"{r:.4f}" for r in rates[False])
        + " resolutions/s; kernel " + ", ".join(f"{r:.4f}"
                                                for r in rates[True])
        + f" resolutions/s on {card}; outcomes equal, continuous max |diff| "
        f"{worst:.3e} <= {MID_ATOL}")


def scaled_fused_paths(torch, args, drive, x8, truth, card, dev,
                       resolve_params):
    """The fused path on bfloat16 storage with scaled events: the float
    reports of ``x8`` with the last ``SCALED_FUSED`` events mapped by
    ``20 x - 5`` (the reference's ``bench.py --scaled``), sztorc at
    ``max_iterations`` 1 and 3 and, at the first count, fixed-variance and
    ica. The gate must open; B.2 must launch once a scoring and resolve
    once a resolution; binary outcomes must recover the truth and scaled
    ones equal ``20 truth - 5`` (0 and 1 are on the bfloat16 lattice, so
    exactly)."""
    from pyconsensus_tpu_torch import ConsensusParams, sharded_consensus

    R, E = x8.shape
    for i, n_sc in enumerate(SCALED_FUSED):
        n_sc = min(n_sc, E // 8)
        xf = float_reports(torch, x8, n_sc)
        bounds = scaled_bounds(E, n_sc)
        binary = slice(0, E - n_sc)
        cells = [("sztorc", 1), ("sztorc", 3)]
        if i == 0:
            cells += [("fixed-variance", 1), ("ica", 1)]
        for algo, mi in cells:
            small = "power-fused" if algo == "sztorc" else "power"
            p = ConsensusParams(algorithm=algo, storage_dtype="bfloat16",
                                max_iterations=mi, power_tol=1e-5,
                                pca_method="auto" if R > 4096 else small)
            resolved = resolve_params(p._replace(any_scaled=True,
                                                 n_scaled=n_sc), R, E, dev)
            if not resolved.fused_resolution:
                raise RuntimeError(f"{algo}, {n_sc} scaled, bfloat16: the "
                                   "fused path did not open")
            label = (f"{algo}, {n_sc} scaled, bfloat16 fused, "
                     f"max_iterations={mi}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out, rate, counts = drive(xf, p, label, event_bounds=bounds)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check_result(torch, out, R, E, algo, lattice=binary)
            final = out["outcomes_final"]
            ok_bin = float((final[binary] == truth[binary]).float().mean())
            ok_sc = float((final[E - n_sc:] == 20.0 * truth[E - n_sc:] - 5.0)
                          .float().mean())
            iters = int(out["iterations"])
            n = args.resolutions
            if counts["resolve_certainty_fused"] != n:
                raise RuntimeError(f"{label}: resolve launched "
                                   f"{counts['resolve_certainty_fused']} "
                                   f"times in {n} resolutions")
            if algo == "sztorc" and counts["scores_dirfix_pass"] != n * iters:
                raise RuntimeError(f"{label}: scores_dirfix_pass launched "
                                   f"{counts['scores_dirfix_pass']} times")
            log(f"{label} (pca_method {resolved.pca_method}): {rate:.4f} "
                f"resolutions/s ({1e3 / rate:.3f} ms each) on {card}; peak "
                f"{peak:.3f} GiB; iterations {iters}, binary outcomes == "
                f"truth {ok_bin:.6f}, scaled outcomes == 20 truth - 5 "
                f"{ok_sc:.6f}; launches a resolution: B.1 "
                f"{counts['apply_weighted_cov'] / n:g}, B.2 "
                f"{counts['scores_dirfix_pass'] / n:g}, resolve "
                f"{counts['resolve_certainty_fused'] / n:g}; launches "
                f"{counts}")
            if ok_bin < 0.99 or ok_sc < 0.99:
                raise RuntimeError(f"{label}: the outcomes do not recover the "
                                   "truth")
        if args.profile and i == 0:
            profile_resolution(torch, sharded_consensus, xf,
                               ConsensusParams(storage_dtype="bfloat16",
                                               power_tol=1e-5,
                                               pca_method="auto"),
                               card, "sztorc_scaled_bf16_fused",
                               event_bounds=bounds)
        del xf
        torch.cuda.empty_cache()


def bf16_card_vs_cpu(torch, sharded_consensus, xm_cpu, dev):
    """Phase 5's bfloat16 fused path: the middle-size float reports with
    their last E // 8 events scaled, sztorc, fixed-variance and ica at
    ``max_iterations`` 1 and 3, on the card against the CPU (sztorc within
    ``MID_ATOL``, the others within ``MULTI_ATOL``; binary outcomes
    exact)."""
    from pyconsensus_tpu_torch import ConsensusParams

    R, E = xm_cpu.shape
    n_sc = E // 8
    xs = float_reports(torch, xm_cpu, n_sc)
    xs_dev = xs.to(dev)
    bounds = scaled_bounds(E, n_sc)
    for algo, atol in (("sztorc", MID_ATOL), ("fixed-variance", MULTI_ATOL),
                       ("ica", MULTI_ATOL)):
        for mi in (1, 3):
            p = ConsensusParams(algorithm=algo, storage_dtype="bfloat16",
                                max_iterations=mi, pca_method="power",
                                power_tol=1e-5)
            a = sharded_consensus(xs_dev, event_bounds=bounds, params=p)
            b = sharded_consensus(xs, event_bounds=bounds, params=p,
                                  device="cpu")
            what = (f"card vs cpu {algo} bfloat16, {n_sc} scaled, "
                    f"max_iterations={mi}")
            worst = compare_outputs(torch, a, b, atol, what,
                                    scaled_from=E - n_sc)
            log(f"{what}: exact keys equal on the binary events, continuous "
                f"max |diff| {worst:.3e} <= {atol}; iterations "
                f"{int(a['iterations'])}")


def scaled_bounds(E, n_scaled):
    """The last ``n_scaled`` of E events scaled on [-5, 15]
    (``bench.py --scaled``)."""
    return ([None] * (E - n_scaled)
            + [{"scaled": True, "min": -5.0, "max": 15.0}] * n_scaled)


def float_reports(torch, x8, n_scaled):
    """The float form of int8 storage (NaN absent), its last ``n_scaled``
    columns mapped by ``20 x - 5``."""
    xf = torch.where(x8 < 0, torch.full((), float("nan"), device=x8.device),
                     x8.to(torch.float32) * 0.5)
    if n_scaled:
        xf[:, -n_scaled:].mul_(20.0).sub_(5.0)
    return xf


def plain_paths(torch, args, drive, card, dev, sharded_consensus,
                resolve_params):
    """Phase 4's plain core. sztorc with scaled events beyond E // 8:
    ``"auto"`` resolves to ``power-fused`` with the fused gate closed,
    the sweeps launch on the dense filled matrix and resolve's kernel does
    not; binary outcomes must recover the truth and scaled ones
    ``20 truth - 5`` on 0.99 of their events. Then sztorc,
    fixed-variance and ica at ``min(R, 4096)`` reporters: ``"auto"``
    takes the Gram eigh and no storage kernel launches."""
    from pyconsensus_tpu_torch import ConsensusParams

    R, E = args.reporters, args.events
    n_sc = min(PLAIN_SCALED, E)
    if n_sc <= E // 8:
        raise RuntimeError(f"{n_sc} scaled events must exceed E // 8 = "
                           f"{E // 8}")
    x8, truth = gen_reports(torch, R, E, args.seed + 4, dev)
    xf = float_reports(torch, x8, n_sc)
    del x8
    bounds = scaled_bounds(E, n_sc)
    binary = slice(0, E - n_sc)
    for mi in (1, 3):
        p = ConsensusParams(max_iterations=mi, power_tol=1e-5,
                            pca_method="auto")
        resolved = resolve_params(p._replace(any_scaled=True, n_scaled=n_sc),
                                  R, E, dev)
        if resolved.fused_resolution or resolved.pca_method != "power-fused":
            raise RuntimeError(f"sztorc scaled: resolved to "
                               f"{resolved.pca_method}, fused "
                               f"{resolved.fused_resolution}")
        label = f"sztorc, {n_sc} scaled, plain core, max_iterations={mi}"
        torch.cuda.reset_peak_memory_stats()
        out, rate, counts = drive(xf, p, label, "sztorc plain",
                                  event_bounds=bounds)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_result(torch, out, R, E, lattice=binary)
        final = out["outcomes_final"]
        ok_bin = float((final[binary] == truth[binary]).float().mean())
        ok_sc = float(((final[E - n_sc:] - (20.0 * truth[E - n_sc:] - 5.0))
                       .abs() <= 1e-3).float().mean())
        log(f"{label} (pca_method {resolved.pca_method}): {rate:.4f} "
            f"resolutions/s ({1e3 / rate:.3f} ms each) on {card}; peak "
            f"{peak:.3f} GiB; iterations {int(out['iterations'])}, binary "
            f"outcomes == truth {ok_bin:.6f}, scaled outcomes == 20 truth - 5 "
            f"{ok_sc:.6f}; launches {counts}")
        if ok_bin < 0.99 or ok_sc < 0.99:
            raise RuntimeError(f"{label}: the outcomes do not recover the "
                               "truth")
    # the filled matrix stored in bfloat16, as the reference's auto
    # storage picks where the fused gate closes
    p = ConsensusParams(power_tol=1e-5, pca_method="auto",
                        storage_dtype="bfloat16")
    label = f"sztorc, {n_sc} scaled, plain core, bfloat16, max_iterations=1"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, rate, counts = drive(xf, p, label, "sztorc plain",
                              event_bounds=bounds)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_result(torch, out, R, E, lattice=binary)
    final = out["outcomes_final"]
    ok_bin = float((final[binary] == truth[binary]).float().mean())
    ok_sc = float(((final[E - n_sc:] - (20.0 * truth[E - n_sc:] - 5.0))
                   .abs() <= 1e-3).float().mean())
    log(f"{label}: {rate:.4f} resolutions/s ({1e3 / rate:.3f} ms each) on "
        f"{card}; peak {peak:.3f} GiB; binary outcomes == truth "
        f"{ok_bin:.6f}, scaled outcomes == 20 truth - 5 {ok_sc:.6f}; "
        f"launches {counts}")
    if ok_bin < 0.99 or ok_sc < 0.99:
        raise RuntimeError(f"{label}: the outcomes do not recover the truth")
    if args.profile:
        profile_resolution(torch, sharded_consensus, xf,
                           ConsensusParams(power_tol=1e-5, pca_method="auto"),
                           card, "sztorc_scaled_plain", event_bounds=bounds)
    del xf
    torch.cuda.empty_cache()

    rg = min(R, 4096)
    x8, truth = gen_reports(torch, rg, E, args.seed + 5, dev)
    xg = float_reports(torch, x8, 0)
    del x8
    for algo in ("sztorc", "fixed-variance", "ica"):
        for mi in (1, 3):
            p = ConsensusParams(algorithm=algo, max_iterations=mi,
                                pca_method="auto")
            resolved = resolve_params(p._replace(any_scaled=False), rg, E,
                                      dev)
            if resolved.fused_resolution or resolved.pca_method != \
                    "eigh-gram":
                raise RuntimeError(f"{algo} at R={rg}: resolved to "
                                   f"{resolved.pca_method}")
            label = f"{algo} {rg}x{E} Gram eigh, max_iterations={mi}"
            torch.cuda.reset_peak_memory_stats()
            out, rate, counts = drive(xg, p, label, "gram plain")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check_result(torch, out, rg, E, algo)
            correct = float((out["outcomes_adjusted"] == truth)
                            .float().mean())
            log(f"{label}: {rate:.4f} resolutions/s ({1e3 / rate:.3f} ms "
                f"each) on {card}; peak {peak:.3f} GiB; iterations "
                f"{int(out['iterations'])}, outcomes == truth "
                f"{correct:.6f}")
            if correct < 0.99:
                raise RuntimeError(f"{label}: the outcomes do not recover "
                                   "the truth")
    del xg
    torch.cuda.empty_cache()


def sharded_oracle_phase(torch, args, card, dev, launches):
    """Phase 5: ``ShardedOracle`` on the generator's matrix (host int8
    sentinel storage, decoded by the ``Oracle``'s intake) with
    ``storage_dtype="int8"``: its rate as passed (the float reports
    uploaded every call) and after ``place()`` (the int8 storage placed
    once), beside ``sharded_consensus`` on the same matrix pre-encoded on
    the card, each with the launch counts set to 0 just before and read
    just after (B.1, B.2 and B.3 must launch). Then a ``FaultPlan`` with a
    NaN storm at ``oracle.raw_result``: exactly one hop, ``power-fused ->
    eigh-gram``, counted in ``pyconsensus_fallbacks_total``, and the
    recovered outcomes equal to a clean ``pca_method="eigh-gram"``
    resolution's (a ``ShardedOracle``: the plain core without the (R, E)
    outputs, as the rung runs it) and to the truth; the seconds and peak
    device memory of both. Then the span tree of one traced
    resolution and the counters it moved."""
    import numpy as np

    from pyconsensus_tpu_torch import (ConsensusParams, ShardedOracle,
                                       faults, obs, sharded_consensus)
    from pyconsensus_tpu_torch.ops import cuda_kernels as ck

    R, E = args.reporters, args.events
    method = "auto" if R > 4096 else "power-fused"
    x8, truth = gen_reports(torch, R, E, args.seed + 6, dev)
    truth = truth.cpu().numpy()
    host = x8.cpu().numpy()
    kw = dict(storage_dtype="int8", power_tol=1e-5, pca_method=method)

    def timed(fn, n, label):
        """A warm-up, then ``n`` timed calls between launch-count resets;
        the kernels of sztorc's fused path must have launched."""
        fn()
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        rate = n / (time.perf_counter() - t0)
        counts = ck.launch_counts()
        for k in KERNELS:
            launches[k] += counts[k]
        missing = [k for k in PATH_KERNELS["sztorc"] if counts[k] == 0]
        if missing:
            raise RuntimeError(f"{label}: kernels of the path never "
                               f"launched: {missing} ({counts})")
        per = {k: v / n for k, v in counts.items() if v}
        log(f"{label}: {rate:.4f} resolutions/s ({1e3 / rate:.3f} ms "
            f"each) on {card}; launches a resolution {per}")
        return out, rate

    def outcomes(out):
        o = out["events"]["outcomes_final"] if "events" in out else \
            out["outcomes_final"].cpu().numpy()
        return np.asarray(o)

    t0 = time.perf_counter()
    oracle = ShardedOracle(reports=host, encoded=True, device=dev, **kw)
    log(f"ShardedOracle intake (int8 decoded to float64 on the host, "
        f"quarantine, parameters): {time.perf_counter() - t0:.3f} s; "
        f"pca_method {oracle.params.pca_method}, fused "
        f"{oracle.params.fused_resolution}")
    if not oracle.params.fused_resolution:
        raise RuntimeError("ShardedOracle did not open the fused path")
    res = {}
    out, res["as passed"] = timed(oracle.consensus, SHARDED_ORACLE_PASSED,
                                  "ShardedOracle as passed")
    as_passed = outcomes(out)
    t0 = time.perf_counter()
    oracle.place()
    torch.cuda.synchronize()
    log(f"ShardedOracle.place(): {time.perf_counter() - t0:.3f} s")
    out, res["placed"] = timed(oracle.consensus, args.resolutions,
                               "ShardedOracle placed")
    placed = outcomes(out)
    p = ConsensusParams(max_iterations=1, **kw)
    out, res["sharded_consensus"] = timed(
        lambda: sharded_consensus(x8, params=p, device=dev),
        args.resolutions, "sharded_consensus on the card's int8 storage")
    direct = outcomes(out)
    del x8
    for label, o in (("as passed", as_passed), ("placed", placed)):
        if not np.array_equal(o, direct):
            raise RuntimeError(f"ShardedOracle {label}: outcomes differ from "
                               "sharded_consensus's")
    correct = float((placed == truth).mean())
    log(f"ShardedOracle rates on {card}: as passed "
        f"{res['as passed']:.4f}, placed {res['placed']:.4f}, "
        f"sharded_consensus {res['sharded_consensus']:.4f} resolutions/s; "
        f"outcomes == truth {correct:.6f}, equal to sharded_consensus's")
    if correct < 0.99:
        raise RuntimeError("ShardedOracle: the outcomes do not recover the "
                           "truth")

    # the chain: one hop, power-fused -> eigh-gram, on the card
    storm = {"site": "oracle.raw_result", "kind": "nan_storm",
             "occurrences": [0], "args": {"fraction": 1.0}}

    def hops():
        series = obs.REGISTRY.snapshot().get(
            "pyconsensus_fallbacks_total", {}).get("series", {})
        return {tuple(json.loads(k)[n] for n in ("from", "to", "reason")): v
                for k, v in series.items()}

    before = hops()
    plan = faults.FaultPlan(seed=args.seed, rules=[storm])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with faults.armed(plan):
        recovered = oracle.consensus()
    torch.cuda.synchronize()
    t_recovery = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec_counts = {k: v for k, v in ck.launch_counts().items() if v}
    after = hops()
    moved = {k: after[k] - before.get(k, 0.0) for k in after
             if after[k] != before.get(k, 0.0)}
    if moved != {("power-fused", "eigh-gram", "nonfinite_result"): 1.0}:
        raise RuntimeError(f"the NaN storm walked {moved} (fired "
                           f"{plan.fired}), not one power-fused -> "
                           "eigh-gram hop")
    # the clean run: the same plain core, light as the rung is
    clean_oracle = ShardedOracle(reports=oracle.reports,
                                 pca_method="eigh-gram", power_tol=1e-5,
                                 device=dev)
    if clean_oracle.params.fused_resolution:
        raise RuntimeError("the eigh-gram run opened the fused path")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    clean = clean_oracle.consensus()
    torch.cuda.synchronize()
    t_clean = time.perf_counter() - t0
    peak_clean = torch.cuda.max_memory_allocated() / 2 ** 30
    got = outcomes(recovered)
    if not np.array_equal(got, outcomes(clean)):
        raise RuntimeError("the recovered outcomes differ from a clean "
                           "eigh-gram resolution's")
    if not np.isfinite(recovered["agents"]["smooth_rep"]).all():
        raise RuntimeError("the recovered reputation is not finite")
    correct = float((got == truth).mean())
    log(f"fallback on {card}: fired {plan.fired}, hops {moved}; recovery "
        f"{t_recovery:.3f} s (the fused attempt, then eigh-gram on the "
        f"card), peak {peak:.3f} GiB, launches {rec_counts}; clean "
        f"eigh-gram resolution {t_clean:.3f} s, peak {peak_clean:.3f} GiB "
        f"(the placed int8 storage included); recovered outcomes equal "
        f"the clean run's, == truth {correct:.6f}")
    if correct < 0.99:
        raise RuntimeError("the recovered outcomes do not recover the truth")
    del clean_oracle

    obs.reset()
    oracle.consensus()
    tree = obs.span_tree(obs.events())
    if [t["name"] for t in tree] != ["oracle.consensus"] or [
            c["name"] for c in tree[0]["children"]] != ["pipeline.dispatch"]:
        raise RuntimeError(f"span tree {obs.report()}")
    log("span tree of one traced ShardedOracle resolution:")
    for line in obs.report().splitlines():
        log(f"  {line}")
    log("counters it moved:")
    for name, entry in obs.REGISTRY.snapshot().items():
        if entry["kind"] != "histogram":
            for key, v in entry["series"].items():
                log(f"  {name}{key or ''} {v}")
    del oracle
    torch.cuda.empty_cache()


def sim_phase(torch, args, ck, card, dev):
    """Phase 7's simulator half: the recorded 10,000-trial sweep
    (``SIM_R`` x ``SIM_E``, ``SIM_LF`` x ``SIM_VAR`` x ``SIM_T``, seed
    ``args.seed``) through ``CollusionSimulator.run`` on the card at each
    of ``SIM_ITERS``: one untimed warm-up, then 3 timed runs, each ending
    in ``torch.cuda.synchronize()``, with the storage kernels' launch
    counts set to 0 before and read after (every one must read 0: no TPU
    kernel is on this path). Prints trials/s, peak memory, the draw's
    time against the whole run's and the power sweeps a lane takes. Then
    ``SIM_REPLAY`` lanes through the ``Oracle`` on the card (exact metrics
    equal), a 1,000-trial sub-grid on the card against the CPU (float32
    bit for bit, and the float64 band), ``RoundsSimulator(n_rounds=10)``
    over 1,000 trials, and ``CheckpointedSweep`` over the 10,000 trials in
    ``SIM_CHUNK``-trial chunks, whose ``gather()`` must equal the
    monolithic run bit for bit."""
    import tempfile

    import numpy as np

    from pyconsensus_tpu_torch import Oracle
    from pyconsensus_tpu_torch.sim import (CheckpointedSweep,
                                           CollusionSimulator,
                                           RoundsSimulator, _batched,
                                           collusion, generate_reports)

    n = len(SIM_LF) * len(SIM_VAR) * SIM_T
    shape = f"{SIM_R}x{SIM_E}, {n} trials"
    mono = {}
    for mi in SIM_ITERS:
        sim = CollusionSimulator(n_reporters=SIM_R, n_events=SIM_E,
                                 max_iterations=mi)
        sim.run(SIM_LF, SIM_VAR, SIM_T, seed=args.seed)       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = sim.run(SIM_LF, SIM_VAR, SIM_T, seed=args.seed)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        counts = ck.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        mono[mi] = res
        if any(counts.values()):
            raise RuntimeError(f"sweep max_iterations={mi}: storage kernels "
                               f"launched {counts}")
        for key in ("correct_rate", "capture_rate", "liar_rep_share"):
            if not np.isfinite(res[key]).all():
                raise RuntimeError(f"sweep: {key} is not finite")
        mean = res["mean"]
        at0 = float(mean["correct_rate"][0].min())
        share = mean["liar_rep_share"]
        # the draw alone, and the power sweeps a lane takes
        _, _, glf, gvar = collusion.flat_grid(SIM_LF, SIM_VAR, SIM_T)
        keys = collusion._fold_keys(args.seed, np.arange(n))
        lf = torch.as_tensor(glf, dtype=torch.float32, device=dev)
        var = torch.as_tensor(gvar, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, _, _ = generate_reports(keys, lf, var, SIM_R, SIM_E)
        torch.cuda.synchronize()
        t_draw = time.perf_counter() - t0
        stats = {}
        rep0 = torch.full((n, SIM_R), 1.0 / SIM_R, device=dev)
        _batched.iterate(x, rep0, sim.params, stats)
        log(f"sweep {shape} max_iterations={mi} power_iters=64: "
            f"{n / min(secs):.1f} trials/s (best of 3; runs "
            f"{', '.join(f'{t:.4f}' for t in secs)} s) on {card}; peak "
            f"{peak:.3f} GiB; the draw alone {t_draw:.4f} s; power sweeps "
            f"{stats['sweeps']} over the iterations (the slowest lane's), "
            f"{stats['lane_sweeps'] / n:.2f} a lane on average; mean "
            f"correct_rate "
            f"at liar fraction 0 {at0:.6f}; liar_rep_share by liar "
            f"fraction {np.round(share, 6).tolist()}; converged "
            f"{float(res['converged'].mean()):.4f}; storage kernel "
            f"launches {sum(counts.values())}")
        if at0 < 0.99:
            raise RuntimeError(f"sweep: mean correct_rate at liar fraction "
                               f"0 is {at0}")
        if not (share[4] >= share[1]).all():
            raise RuntimeError("sweep: liar_rep_share at 0.4 is below that "
                               "at 0.1")
        del x, rep0
    res = mono[SIM_ITERS[0]]

    # lanes replayed through the Oracle on the card
    idx = np.linspace(0, n - 1, SIM_REPLAY).astype(np.int64)
    _, _, glf, gvar = collusion.flat_grid(SIM_LF, SIM_VAR, SIM_T)
    keys = collusion._fold_keys(args.seed, idx)
    flat = {k: res[k].reshape(n) for k in ("correct_rate", "capture_rate",
                                           "ambiguous_rate", "converged",
                                           "iterations", "liar_rep_share")}
    worst = 0.0
    for j, i in enumerate(idx):
        x, truth, liar = generate_reports(keys[j], float(glf[i]),
                                          float(gvar[i]), SIM_R, SIM_E)
        r = Oracle(reports=x.cpu().numpy(), pca_method="power",
                   power_iters=64, max_iterations=SIM_ITERS[0]).consensus()
        out = np.asarray(r["events"]["outcomes_final"], dtype=np.float32)
        truth = truth.cpu().numpy()
        got = {"correct_rate": np.float32(np.sum(out == truth))
               * np.float32(1.0 / SIM_E),
               "capture_rate": np.float32(np.sum(out == 1 - truth))
               * np.float32(1.0 / SIM_E),
               "ambiguous_rate": np.float32(np.sum(out == 0.5))
               * np.float32(1.0 / SIM_E),
               "converged": r["convergence"],
               "iterations": r["iterations"]}
        for key, v in got.items():
            if v != flat[key][i]:
                raise RuntimeError(f"lane {i} replayed through the Oracle: "
                                   f"{key} {v} != {flat[key][i]}")
        share = float(np.asarray(r["agents"]["smooth_rep"])[
            liar.cpu().numpy()].sum())
        worst = max(worst, abs(share - float(flat["liar_rep_share"][i])))
    log(f"{SIM_REPLAY} sweep lanes replayed through Oracle(pca_method="
        f"'power', power_iters=64) on {card}: exact metrics equal, "
        f"liar_rep_share max |diff| {worst:.3e}")

    # a 1,000-trial sub-grid: the card against the CPU
    sub_lf, sub_t = (0.1, 0.3), 250
    kw = dict(n_reporters=SIM_R, n_events=SIM_E, max_iterations=5)
    a = CollusionSimulator(**kw).run(sub_lf, SIM_VAR, sub_t, seed=args.seed)
    t0 = time.perf_counter()
    b = CollusionSimulator(device="cpu", **kw).run(sub_lf, SIM_VAR, sub_t,
                                                   seed=args.seed)
    t_cpu = time.perf_counter() - t0
    for key in a:
        if key not in ("mean",) and not np.array_equal(a[key], b[key]):
            raise RuntimeError(f"sub-grid card vs cpu (float32): {key} "
                               "differs")
    # the float32 band: the same float32-drawn trials resolved in float64
    _, _, glf, gvar = collusion.flat_grid(sub_lf, SIM_VAR, sub_t)
    keys = collusion._fold_keys(args.seed, np.arange(len(glf)))
    x, truth, liar = generate_reports(
        keys, torch.as_tensor(glf, dtype=torch.float32, device=dev),
        torch.as_tensor(gvar, dtype=torch.float32, device=dev), SIM_R,
        SIM_E)
    p5 = CollusionSimulator(max_iterations=5, device="cpu").params
    out = {}
    for tag, xs in (("card float32", x), ("cpu float64", x.cpu().double())):
        rep0 = torch.full(xs.shape[:2], 1.0 / SIM_R, dtype=xs.dtype,
                          device=xs.device)
        rep, conv, iters = _batched.iterate(xs, rep0, p5)
        outcomes = _batched.resolve_binary(xs, rep, p5.catch_tolerance)
        out[tag] = (outcomes.cpu().double(), conv.cpu(), iters.cpu(),
                    (rep * liar.to(rep.dtype).to(rep.device)).sum(1)
                    .cpu().double())
    (o32, c32, i32, s32), (o64, c64, i64, s64) = out.values()
    lanes = int(((o32 != o64).any(1) | (c32 != c64) | (i32 != i64)).sum())
    band = float((s32 - s64).abs().max())
    log(f"sub-grid {SIM_R}x{SIM_E} 1000 trials max_iterations=5: card and "
        f"cpu (float32) equal bit for bit (cpu {t_cpu:.3f} s); the same "
        f"float32-drawn trials resolved in float64 on the cpu: {lanes} of "
        f"1000 lanes differ in an outcome, convergence or iteration count, "
        f"liar_rep_share max |diff| {band:.3e}")
    del x

    # reputation carried over 10 rounds
    rounds = RoundsSimulator(n_rounds=10, n_reporters=SIM_R, n_events=SIM_E)
    rounds.run((0.2,), (0.05,), 8, seed=args.seed)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rr = rounds.run((0.1, 0.3), SIM_VAR, sub_t, seed=args.seed)
    torch.cuda.synchronize()
    t_rounds = time.perf_counter() - t0
    traj = rr["mean"]["liar_rep_share"]
    if not np.isfinite(rr["liar_rep_share"]).all():
        raise RuntimeError("RoundsSimulator: liar_rep_share is not finite")
    if not (traj[..., -1] <= traj[..., 0]).all():
        raise RuntimeError("RoundsSimulator: the liars' share grew over the "
                           "rounds")
    log(f"RoundsSimulator(n_rounds=10) {SIM_R}x{SIM_E} 1000 trials: "
        f"{t_rounds:.3f} s ({1000 * 10 / t_rounds:.1f} trial-rounds/s) on "
        f"{card}; liar_rep_share round 1 -> 10 by cell "
        f"{np.round(traj[..., 0], 4).tolist()} -> "
        f"{np.round(traj[..., -1], 4).tolist()}")

    # the 10,000 trials chunked and checkpointed
    sim = CollusionSimulator(n_reporters=SIM_R, n_events=SIM_E,
                             max_iterations=SIM_ITERS[0])
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        sweep = CheckpointedSweep(sim, SIM_LF, SIM_VAR, SIM_T,
                                  seed=args.seed, checkpoint_dir=d,
                                  trials_per_chunk=SIM_CHUNK)
        done = sweep.run()
        got = sweep.gather()
        t_sweep = time.perf_counter() - t0
    for key in res:
        if key == "mean":
            continue
        if not np.array_equal(got[key], res[key]):
            raise RuntimeError(f"CheckpointedSweep: {key} differs from the "
                               "monolithic run")
    log(f"CheckpointedSweep {shape} in {done} chunks of {SIM_CHUNK}: "
        f"{t_sweep:.3f} s with the fsynced chunk writes and gather(); "
        f"equal to the monolithic run bit for bit")


def persistence_phase(torch, args, ck, card, dev):
    """Phase 7's persistence half: the generator's ``args.reporters`` x
    ``args.events`` matrix (``generate_reports``, liar fraction 0.1,
    variance 0.05) written with ``save_reports`` as int8 ``.npy``, read
    onto the card by ``load_reports_encoded`` and resolved by
    ``sharded_consensus`` (int8 storage), outcomes equal to the in-memory
    run's, with the seconds and GB/s of the write and the read; a CSV at
    ``args.mid_r`` x ``args.mid_e`` through the native loader; a ledger of
    3 rounds at that size through the ``Oracle`` on the card, saved,
    verified, loaded, and its 4th round equal to an uninterrupted
    ledger's."""
    import tempfile

    import numpy as np

    from pyconsensus_tpu_torch import (ConsensusParams, _native,
                                       encode_reports, io,
                                       sharded_consensus)
    from pyconsensus_tpu_torch.ledger import ReputationLedger
    from pyconsensus_tpu_torch.ops import prng
    from pyconsensus_tpu_torch.sim import generate_reports

    R, E = args.reporters, args.events
    t0 = time.perf_counter()
    x, truth, _ = generate_reports(prng.key_torch(args.seed + 9, dev), 0.1,
                                   0.05, R, E)
    x8 = encode_reports(x)
    del x
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    p = ConsensusParams(storage_dtype="int8", power_tol=1e-5,
                        pca_method="auto" if R > 4096 else "power-fused")
    want = sharded_consensus(x8, params=p)
    host = x8.cpu().numpy()
    gb = host.nbytes / 1e9
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = io.save_reports(os.path.join(d, "reports.npy"), host)
        t_save = time.perf_counter() - t0
        del host
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed = io.load_reports_encoded(path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    if placed.shards[0].dtype != torch.int8 or not torch.equal(
            placed.shards[0], x8):
        raise RuntimeError("load_reports_encoded: the placed storage differs "
                           "from the written matrix")
    got = sharded_consensus(placed, params=p)
    for key in ("outcomes_final", "smooth_rep", "certainty"):
        if not torch.equal(got[key], want[key]):
            raise RuntimeError(f"the loaded matrix resolves differently: "
                               f"{key}")
    correct = float((got["outcomes_final"] == truth).float().mean())
    log(f"generator {R}x{E} on {card}: drawn and encoded in {t_gen:.3f} s; "
        f"save_reports int8 .npy {gb:.3f} GB in {t_save:.3f} s "
        f"({gb / t_save:.3f} GB/s, fsynced); load_reports_encoded onto the "
        f"card {t_load:.3f} s ({gb / t_load:.3f} GB/s); sharded_consensus "
        f"on it equals the in-memory run (outcomes, reputation, "
        f"certainty); outcomes == truth {correct:.6f}")
    del placed, x8, want, got
    torch.cuda.empty_cache()

    # a CSV through the native loader
    Rm, Em = args.mid_r, args.mid_e
    t0 = time.perf_counter()
    if _native.load_loader() is None:
        raise RuntimeError("the native CSV loader did not build from "
                           "native/loader.cpp")
    t_build = time.perf_counter() - t0
    xm, _, _ = generate_reports(prng.key_torch(args.seed + 10, dev), 0.1,
                                 0.05, Rm, Em)
    mat = xm.double().cpu().numpy()
    mat[np.random.default_rng(args.seed).random(mat.shape) < 0.02] = np.nan
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = io.save_reports(os.path.join(d, "reports.csv"), mat)
        t_write = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        back = io.load_reports(path)
        t_read = time.perf_counter() - t0
    if not np.array_equal(back, mat, equal_nan=True):
        raise RuntimeError("the CSV read back differs from the matrix")
    log(f"CSV {Rm}x{Em} ({mb:.1f} MB, 2% NA): native loader built in "
        f"{t_build:.2f} s; save_reports {t_write:.3f} s, load_reports "
        f"{t_read:.3f} s ({mb / t_read:.1f} MB/s) through native/loader.cpp;"
        f" equal to the matrix")

    # a ledger of 3 rounds, saved, loaded, and its 4th round
    keys = prng.split_torch(prng.key_torch(args.seed + 11, dev), 4)
    rounds = []
    for k in keys:
        xr, _, _ = generate_reports(k, 0.2, 0.05, Rm, Em)
        rounds.append(xr.double().cpu().numpy())
    whole = ReputationLedger(n_reporters=Rm, max_iterations=3)
    part = ReputationLedger(n_reporters=Rm, max_iterations=3)
    secs = []
    for xr in rounds[:3]:
        whole.resolve(xr)
        t0 = time.perf_counter()
        part.resolve(xr)
        secs.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ledger.npz")
        t0 = time.perf_counter()
        part.save(path)
        summary = ReputationLedger.verify(path)
        resumed = ReputationLedger.load(path)
        t_ckpt = time.perf_counter() - t0
    a = whole.resolve(rounds[3])
    b = resumed.resolve(rounds[3])
    for key in ("outcomes_final",):
        if not np.array_equal(a["events"][key], b["events"][key]):
            raise RuntimeError(f"ledger round 4: {key} differs")
    if not np.array_equal(whole.reputation, resumed.reputation):
        raise RuntimeError("ledger round 4: the reputation differs")
    log(f"ReputationLedger {Rm}x{Em} on {card}: rounds "
        f"{', '.join(f'{t:.3f}' for t in secs)} s; save + verify + load "
        f"{t_ckpt:.3f} s ({summary}); round 4 after the reload equals the "
        f"uninterrupted ledger's bit for bit (outcomes and reputation)")


def serve_reports(rng, R, E, na_frac=SERVE_NA, n_scaled=0):
    """A collusion round drawn with numpy (a fifth of the reporters on the
    anti-truth, honest ones flipping at 0.1, ``na_frac`` absent), the last
    ``n_scaled`` events scaled on [-5, 15]. Returns ``(reports, bounds,
    truth)``."""
    import numpy as np

    truth = rng.choice([0.0, 1.0], size=E)
    x = np.tile(truth, (R, 1))
    x = np.abs(x - (rng.random((R, E)) < 0.1))
    x[: R // 5] = 1.0 - truth
    x[rng.random((R, E)) < na_frac] = np.nan
    bounds = None
    if n_scaled:
        bounds = [None] * (E - n_scaled) + [
            {"scaled": True, "min": -5.0, "max": 15.0}] * n_scaled
        x[:, E - n_scaled:] = x[:, E - n_scaled:] * 20.0 - 5.0
    return x, bounds, truth


def served_close(got, ref, atol, what, exact_all=False):
    """Outcomes and iterations equal; every continuous key of the nested
    results within ``atol`` (``exact_all``: every key bit for bit).
    Returns the largest continuous difference."""
    import numpy as np

    worst = 0.0
    for key in ("outcomes_adjusted", "outcomes_final"):
        if not np.array_equal(got["events"][key], ref["events"][key]):
            raise RuntimeError(f"{what}: {key} differ from the direct "
                               "resolution")
    if got["iterations"] != ref["iterations"]:
        raise RuntimeError(f"{what}: iterations {got['iterations']} != "
                           f"{ref['iterations']}")
    for group in ("agents", "events"):
        for key, v in ref[group].items():
            a = np.asarray(got[group][key], dtype=np.float64)
            b = np.asarray(v, dtype=np.float64)
            if key == "adj_first_loadings":
                a, b = np.abs(a), np.abs(b)
            d = float(np.max(np.abs(a - b))) if a.size else 0.0
            if exact_all and d != 0.0:
                raise RuntimeError(f"{what}: {key} is not bit for bit the "
                                   f"direct resolution's (max |diff| {d})")
            worst = max(worst, d)
    if worst > atol:
        raise RuntimeError(f"{what}: continuous keys {worst:.3e} > {atol}")
    return worst


def launch_text(counts):
    """``counts`` as a short text: the kernels that launched, or that
    none did."""
    hot = {k: v for k, v in counts.items() if v}
    return str(hot) if hot else "every launch count 0"


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def serve_phase(torch, ck, card, dev, launches, seed,
                requests=SERVE_REQUESTS, latency_shapes=LATENCY_SHAPES,
                samples=LATENCY_SAMPLES, top=TOP_REQUEST,
                session_r=SESSION_R, block_e=SESSION_BLOCK_E):
    """Phase 8, the serve tier (``pyconsensus_tpu_torch.serve``) on the
    card, each line beside ``card``:

    1. the reference's recorded serve block: ``SERVE_SHAPES`` warmed,
       ``requests`` closed-loop requests from ``SERVE_CONCURRENCY``
       threads; throughput, p50 / p99, mean batch occupancy, the cache
       hit ratio; no build after the warm-up, every launch count 0, each
       result equal to the direct ``Oracle(pca_method="power")``;
    2. the ``bucket_cuda`` class under the default config at
       ``latency_shapes``: ``samples`` blocking requests each, p50 / p99
       and B.1, B.2 and B.3 launches a request (each must launch), every
       result bit for bit the direct fused ``ShardedOracle`` and within
       ``SERVE_ATOL`` of the plain ``Oracle``;
    3. the top padded bucket: ``TOP_CONCURRENT`` concurrent ``top``
       requests with ``TOP_SCALED`` scaled events (no ``cuda`` ride),
       every launch count 0, each result against the direct ``Oracle``;
    4. a market session of ``session_r`` reporters, ``SESSION_BLOCKS``
       appended blocks of ``block_e`` events, exact and with
       ``incremental_sessions=True`` over ``SESSION_ROUNDS`` rounds: the
       seconds of an append and a resolve, outcomes equal to the direct
       ``Oracle`` on the assembled matrix, a warm round's drift within
       ``incremental_drift_band``, every launch count 0.

    ``dev`` may be the CPU for a rehearsal (then the class runs its plain
    versions and launches nothing)."""
    import concurrent.futures

    import numpy as np

    from pyconsensus_tpu_torch import Oracle, ShardedOracle, obs
    from pyconsensus_tpu_torch.serve import (ConsensusService, ServeConfig,
                                             incremental_drift_band)

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def counted():
        counts = ck.launch_counts()
        for k in counts:
            launches[k] += counts[k]
        return counts

    def occupancy():
        ser = obs.REGISTRY.snapshot().get(
            "pyconsensus_serve_batch_occupancy", {}).get("series", {})
        ser = next(iter(ser.values()), {"sum": 0.0, "count": 0})
        return ser["sum"], ser["count"]

    rng = np.random.default_rng(seed + 14)

    # 1. the recorded serve block: the padded micro-batching tier
    cfg = ServeConfig(batch_window_ms=2.0, max_batch=8,
                      pallas_buckets=False)
    svc = ConsensusService(cfg, device=dev)
    buckets = svc.buckets_for(SERVE_SHAPES)
    svc.warm_buckets(buckets)
    svc.start(warmup=False)
    warm_builds = svc.cache.builds
    mats = [serve_reports(rng, *SERVE_SHAPES[i % 2])[0]
            for i in range(requests)]
    lat = [0.0] * requests
    results = [None] * requests
    occ0 = occupancy()
    sync()
    ck.reset_launch_counts()

    def client(worker):
        for i in range(worker, requests, SERVE_CONCURRENCY):
            t0 = time.perf_counter()
            results[i] = svc.submit(reports=mats[i]).result(timeout=120)
            lat[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(SERVE_CONCURRENCY) as pool:
        list(pool.map(client, range(SERVE_CONCURRENCY)))
    wall = time.perf_counter() - t0
    counts = counted()
    builds = svc.cache.builds - warm_builds
    hit = svc.cache.hit_ratio()
    occ1 = occupancy()
    svc.close(drain=True)
    if any(counts.values()):
        raise RuntimeError(f"serve block: kernels launched on the padded "
                           f"path: {counts}")
    if builds:
        raise RuntimeError(f"serve block: {builds} builds after warm-up")
    worst = max(served_close(results[i], Oracle(
        reports=mats[i], pca_method="power", device=dev).consensus(),
        SERVE_ATOL, f"serve block request {i}") for i in range(requests))
    mean_occ = (occ1[0] - occ0[0]) / max(1, occ1[1] - occ0[1])
    ms = [1e3 * x for x in lat]
    log(f"serve block {SERVE_SHAPES} (buckets {buckets}), {requests} "
        f"requests at concurrency {SERVE_CONCURRENCY}, pipeline depth "
        f"{svc.pipeline_depth}: {requests / wall:.4f} requests/s, p50 "
        f"{percentile(ms, 0.5):.3f} ms, p99 {percentile(ms, 0.99):.3f} "
        f"ms, mean occupancy {mean_occ:.3f}, cache hit ratio {hit:.4f}; "
        f"builds after warm-up {builds}, {launch_text(counts)}; outcomes "
        f"equal to the direct Oracle, continuous max |diff| {worst:.3e} "
        f"on {card}")

    # 2. the bucket_cuda class at the reference's latency shapes and at
    # the class bound
    svc = ConsensusService(ServeConfig(pallas_warmup=tuple(latency_shapes),
                                       pallas_buckets=True),
                           device=dev)
    svc.start()
    warm_builds = svc.cache.builds
    for R, E in latency_shapes:
        reqs = [serve_reports(rng, R, E)[0] for _ in range(samples)]
        lat, outs = [], []
        sync()
        ck.reset_launch_counts()
        for x in reqs:
            t0 = time.perf_counter()
            outs.append(svc.resolve(reports=x, timeout=120))
            lat.append(1e3 * (time.perf_counter() - t0))
        counts = counted()
        per = {k: counts[k] / samples for k in CUDA_TIER_KERNELS}
        if on_card and not all(counts[k] >= samples
                               for k in CUDA_TIER_KERNELS):
            raise RuntimeError(f"bucket_cuda {R}x{E}: a kernel of the "
                               f"class was not launched by every request: "
                               f"{counts}")
        stray = {k: v for k, v in counts.items()
                 if v and k not in CUDA_TIER_KERNELS}
        if stray:
            raise RuntimeError(f"bucket_cuda {R}x{E}: other kernels "
                               f"launched: {stray}")
        worst_plain = 0.0
        for i, (x, got) in enumerate(zip(reqs, outs)):
            served_close(got, ShardedOracle(
                x, pca_method="power", device=dev).consensus(), 0.0,
                f"bucket_cuda {R}x{E} request {i}", exact_all=True)
            worst_plain = max(worst_plain, served_close(
                got, Oracle(reports=x, pca_method="power",
                            device=dev).consensus(),
                SERVE_ATOL, f"bucket_cuda {R}x{E} request {i} vs plain"))
        log(f"bucket_cuda {R}x{E}, {samples} blocking requests: p50 "
            f"{percentile(lat, 0.5):.3f} ms, p99 {percentile(lat, 0.99):.3f}"
            f" ms; launches a request B.1 {per['apply_weighted_cov']:.2f}, "
            f"B.2 {per['scores_dirfix_pass']:.2f}, B.3 "
            f"{per['resolve_certainty_fused']:.2f}; every result bit for "
            f"bit the direct fused ShardedOracle, the plain Oracle within "
            f"{worst_plain:.3e} on {card}")
    builds = svc.cache.builds - warm_builds
    svc.close(drain=True)
    if builds:
        raise RuntimeError(f"bucket_cuda: {builds} builds after warm-up")

    # 3. the top padded bucket, filled by concurrent scaled requests
    svc = ConsensusService(ServeConfig(), device=dev).start()
    R, E = top
    reqs = [serve_reports(rng, R, E, n_scaled=TOP_SCALED)
            for _ in range(TOP_CONCURRENT + 1)]
    svc.resolve(reports=reqs[0][0], event_bounds=reqs[0][1],
                timeout=120)                       # builds the bucket
    warm_builds = svc.cache.builds
    sync()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    futs = [svc.submit(reports=x, event_bounds=b) for x, b, _ in reqs[1:]]
    outs = [f.result(timeout=240) for f in futs]
    wall = time.perf_counter() - t0
    counts = counted()
    builds = svc.cache.builds - warm_builds
    key = svc.cache.keys()[0]
    svc.close(drain=True)
    if any(counts.values()) or builds:
        raise RuntimeError(f"top bucket: launches {counts}, builds "
                           f"{builds} (0 and 0 expected)")
    worst = 0.0
    for i, ((x, b, truth), got) in enumerate(zip(reqs[1:], outs)):
        worst = max(worst, served_close(got, Oracle(
            reports=x, event_bounds=b, pca_method="power",
            device=dev).consensus(), SERVE_ATOL, f"top bucket request {i}"))
        o = got["events"]["outcomes_final"]
        right = float(np.mean(np.concatenate([
            o[:E - TOP_SCALED] == truth[:E - TOP_SCALED],
            o[E - TOP_SCALED:] == 20.0 * truth[E - TOP_SCALED:] - 5.0])))
        if right < 0.99:
            raise RuntimeError(f"top bucket request {i}: outcomes do not "
                               f"recover the truth ({right})")
    log(f"top bucket {key.rows}x{key.events} x {key.batch} lanes, "
        f"{TOP_CONCURRENT} concurrent {R}x{E} requests with {TOP_SCALED} "
        f"scaled events: {wall:.3f} s for all ({TOP_CONCURRENT / wall:.4f}"
        f" requests/s); {launch_text(counts)}, builds 0; outcomes and "
        f"iterations equal to the direct Oracle, continuous max |diff| "
        f"{worst:.3e} on {card}")

    # 4. a market session, exact then incremental
    for incremental in (False, True):
        svc = ConsensusService(ServeConfig(
            incremental_sessions=incremental), device=dev).start()
        svc.create_session("m", n_reporters=session_r)
        sess = svc.sessions.get("m")
        appends, resolves, drifts = [], [], []
        paths = []
        sync()
        ck.reset_launch_counts()
        for rnd in range(SESSION_ROUNDS if incremental else 1):
            rep_in = sess.reputation.copy()
            blocks = [serve_reports(rng, session_r, block_e)[0]
                      for _ in range(SESSION_BLOCKS)]
            for blk in blocks:
                t0 = time.perf_counter()
                svc.append("m", blk)
                sync()
                appends.append(time.perf_counter() - t0)
            exact = sess.peek_resolve() if incremental else None
            t0 = time.perf_counter()
            got = svc.submit(session="m").result(timeout=120)
            resolves.append(time.perf_counter() - t0)
            paths.append(sess.last_resolve_path)
            full = np.concatenate(blocks, axis=1)
            ref = Oracle(reports=full, reputation=rep_in,
                         device=dev).consensus()
            if not np.array_equal(got["events"]["outcomes_adjusted"],
                                  ref["events"]["outcomes_adjusted"]):
                raise RuntimeError(f"session round {rnd}: outcomes differ "
                                   "from the direct Oracle")
            if exact is not None and sess.last_resolve_path ==                     "incremental":
                d = max(float(np.max(np.abs(
                    np.asarray(got["agents"][a]) - exact[b])))
                    for a, b in (("smooth_rep", "smooth_rep"),
                                 ("this_rep", "this_rep")))
                drifts.append(d)
        counts = counted()
        svc.close(drain=True)
        if any(counts.values()):
            raise RuntimeError(f"session: kernels launched {counts}")
        band = incremental_drift_band(sess.dtype)
        if any(d > band for d in drifts):
            raise RuntimeError(f"session: warm drift {max(drifts)} > band "
                               f"{band}")
        log(f"session {session_r} reporters x {SESSION_BLOCKS} blocks of "
            f"{block_e} events, {'incremental' if incremental else 'exact'}"
            f" ({', '.join(paths)}): append {np.mean(appends):.4f} s "
            f"(max {max(appends):.4f}), resolve "
            + ", ".join(f"{r:.4f}" for r in resolves)
            + f" s; outcomes equal to the direct Oracle"
            + (f"; warm drift max {max(drifts):.3e} <= {band}"
               if drifts else "")
            + f"; {launch_text(counts)} on {card}")


def geometry_knobs(E):
    """The clustering radii that follow the generator's geometry at E
    events, and k-means' two clusters."""
    return dict(num_clusters=2, dbscan_eps=(DBSCAN_EPS2_PER_E * E) ** 0.5,
                dbscan_min_samples=4,
                hierarchy_threshold=(HIER_T2_PER_E * E) ** 0.5)


def clustering_paths(torch, args, drive, card, dev):
    """The clustering phase's device half: ``sharded_consensus`` on the
    generator's float32 reports at full size with the storage that
    ``resolve_auto_storage`` picks (the reference's ``bench.py
    --algorithm k-means|dbscan-jit``): k-means at ``max_iterations`` 1
    and 3, dbscan-jit at the defaults (every reporter is noise at this
    width) and at the radius that follows the geometry. Each prints its
    rate, peak device memory and storage, launches no storage kernel, and
    must recover the truth."""
    from pyconsensus_tpu_torch import ConsensusParams
    from pyconsensus_tpu_torch.parallel.sharded import (resolve_auto_storage,
                                                        resolve_params)

    R, E = args.reporters, args.events
    x8, truth = gen_reports(torch, R, E, args.seed + 7, dev)
    xf = float_reports(torch, x8, 0)
    del x8
    geo = geometry_knobs(E)
    for algo, knobs, tag in (
            ("k-means", dict(max_iterations=1), "max_iterations=1"),
            ("k-means", dict(max_iterations=3), "max_iterations=3"),
            ("dbscan-jit", {}, "defaults (eps 0.5, min_samples 2)"),
            ("dbscan-jit", dict(dbscan_eps=geo["dbscan_eps"],
                                dbscan_min_samples=4),
             f"eps {geo['dbscan_eps']:.4f} = sqrt({DBSCAN_EPS2_PER_E} E), "
             "min_samples 4")):
        p = ConsensusParams(algorithm=algo, **knobs)
        storage, reason = resolve_auto_storage(p._replace(any_scaled=False),
                                               R, E, dev)
        p = p._replace(storage_dtype=storage)
        resolved = resolve_params(p._replace(any_scaled=False), R, E, dev)
        if resolved.fused_resolution:
            raise RuntimeError(f"{algo}: the fused gate opened")
        label = f"{algo} {R}x{E} {tag}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, rate, counts = drive(xf, p, label, "clustering")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_result(torch, out, R, E, algo)
        correct = float((out["outcomes_adjusted"] == truth).float().mean())
        groups = int(torch.unique(out["this_rep"]).numel())
        log(f"{label}: {rate:.4f} resolutions/s ({1e3 / rate:.3f} ms each) "
            f"on {card}; peak {peak:.3f} GiB; storage {storage!r} ({reason});"
            f" iterations {int(out['iterations'])}, distinct this_rep "
            f"values {groups}, outcomes == truth {correct:.6f}; storage "
            f"kernel launches {sum(counts.values())}")
        if correct < 0.99:
            raise RuntimeError(f"{label}: the outcomes do not recover the "
                               "truth")
    del xf
    torch.cuda.empty_cache()


def hybrid_paths(torch, args, card, dev):
    """The clustering phase's hybrid half at ``HYBRID_R`` x ``HYBRID_E``
    (float64 host reports from the generator), after one untimed
    warm-up: hierarchical and dbscan through ``ShardedOracle`` at the
    defaults and at the radius that follows the geometry, and through
    ``Oracle(backend="torch")`` at the latter. Each prints its seconds split by the spans into
    ``hybrid.device_prep``, ``hybrid.cluster`` and the finish (the rest
    of ``oracle.consensus``), its peak device memory and cluster count;
    every clustering span must report ``native=True``, the outcomes must
    recover the truth, and at the geometry radius the largest cluster
    must be the honest block's."""
    import numpy as np

    from pyconsensus_tpu_torch import Oracle, ShardedOracle, obs

    R, E = args.hybrid_r, args.hybrid_e
    x8, truth = gen_reports(torch, R, E, args.seed + 8, dev)
    # a liar reports the anti-truth: most of its present votes differ
    agree = (x8 == (2.0 * truth).to(torch.int8)[None, :]).float().mean(1)
    honest = (agree > 0.5).cpu().numpy()
    host = float_reports(torch, x8, 0).double().cpu().numpy()
    truth = truth.cpu().numpy()
    del x8
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ShardedOracle(reports=host, algorithm="dbscan").consensus()
    log(f"hybrid warm-up (dbscan, untimed cell): "
        f"{time.perf_counter() - t0:.3f} s")
    geo = geometry_knobs(E)
    for algo in ("hierarchical", "dbscan"):
        knob = (dict(hierarchy_threshold=geo["hierarchy_threshold"])
                if algo == "hierarchical" else
                dict(dbscan_eps=geo["dbscan_eps"], dbscan_min_samples=4))
        for cls, knobs, tag in ((ShardedOracle, {}, "defaults"),
                                (ShardedOracle, knob, "geometry"),
                                (Oracle, knob, "geometry")):
            label = (f"{cls.__name__} {algo} {R}x{E} {tag} "
                     f"{knobs or ''}").rstrip()
            oracle = cls(reports=host, algorithm=algo, **knobs)
            obs.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = oracle.consensus()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            events = obs.events()
            secs = {name: sum(e["duration_s"] for e in events
                              if e["name"] == name)
                    for name in ("oracle.consensus", "hybrid.device_prep",
                                 "hybrid.cluster")}
            spans = [e for e in events if e["name"] == f"clustering.{algo}"]
            if not spans or not all(e["attrs"]["native"] is True
                                    for e in spans):
                raise RuntimeError(f"{label}: the host clustering did not "
                                   f"run on the native library: "
                                   f"{[e['attrs'] for e in spans]}")
            clusters = spans[-1]["attrs"]["clusters"]
            finish = (secs["oracle.consensus"] - secs["hybrid.device_prep"]
                      - secs["hybrid.cluster"])
            correct = float((res["events"]["outcomes_final"] == truth)
                            .mean())
            this = res["agents"]["this_rep"]
            top = np.isclose(this, this.max(), rtol=1e-6, atol=0)
            top_honest = bool(top[~honest].sum() == 0
                              and top.sum() >= 0.9 * honest.sum())
            log(f"{label}: {secs['oracle.consensus']:.3f} s = "
                f"hybrid.device_prep {secs['hybrid.device_prep']:.3f} s + "
                f"hybrid.cluster {secs['hybrid.cluster']:.3f} s + finish "
                f"{finish:.3f} s on {card}; peak {peak:.3f} GiB; native "
                f"True; clusters {clusters}; largest cluster honest "
                f"{top_honest} ({int(top.sum())} reporters, "
                f"{int(honest.sum())} honest); outcomes == truth "
                f"{correct:.6f}")
            if correct < 0.99:
                raise RuntimeError(f"{label}: the outcomes do not recover "
                                   "the truth")
            if tag == "geometry" and not top_honest:
                raise RuntimeError(f"{label}: the largest cluster is not "
                                   "the honest block")
            del oracle
    torch.cuda.empty_cache()


def clustering_card_vs_cpu(torch, ck, xm_cpu):
    """The four clustering algorithms at the middle size through the
    ``Oracle`` on the card against its CPU run at the geometry radius,
    ``max_iterations=3``: exact keys equal, the clusters (through
    ``this_rep``) and the reputation's order equal, the rest within
    ``MID_ATOL``; then ``compare_algorithms`` over all seven on the card
    and on the CPU, whose disagreement matrices must be equal."""
    import numpy as np

    from pyconsensus_tpu_torch import (Oracle, compare_algorithms,
                                       disagreement_matrix)

    R, E = xm_cpu.shape
    host = float_reports(torch, xm_cpu, 0).double().numpy()
    geo = geometry_knobs(E)

    def partition(v):
        v = np.asarray(torch.as_tensor(v).cpu().double())
        return np.isclose(v[:, None], v[None, :], rtol=1e-5, atol=0)

    for algo in ("k-means", "dbscan-jit", "hierarchical", "dbscan"):
        kw = dict(reports=host, algorithm=algo, max_iterations=3, **geo)
        ck.reset_launch_counts()
        a = Oracle(**kw).resolve_raw()
        counts = {k: v for k, v in ck.launch_counts().items() if v}
        b = Oracle(device="cpu", **kw).resolve_raw()
        what = f"Oracle {algo} {R}x{E}: card vs cpu"
        worst = compare_outputs(torch, a, b, MID_ATOL, what)
        if counts:
            raise RuntimeError(f"{what}: storage kernels launched {counts}")
        if not np.array_equal(partition(a["this_rep"]),
                              partition(b["this_rep"])):
            raise RuntimeError(f"{what}: the clusters differ")
        order = [np.argsort(np.asarray(v.cpu().double()), kind="stable")
                 for v in (a["smooth_rep"], b["smooth_rep"])]
        if not np.array_equal(*order):
            raise RuntimeError(f"{what}: the reputation's order differs")
        groups = int(np.unique(np.asarray(b["this_rep"].cpu())).size)
        log(f"{what} agree (exact keys, clusters and reputation order "
            f"equal, continuous max |diff| {worst:.3e} <= {MID_ATOL}); "
            f"iterations {int(a['iterations'])}, distinct this_rep values "
            f"{groups}")
    kw = dict(max_iterations=3, **geo)
    card_res = compare_algorithms(host, **kw)
    cpu_res = compare_algorithms(host, device="cpu", **kw)
    m_card = disagreement_matrix(card_res)
    m_cpu = disagreement_matrix(cpu_res)
    log(f"compare_algorithms {R}x{E} over {list(card_res)}: disagreement "
        f"matrix on the card {m_card.tolist()}, on the cpu "
        f"{m_cpu.tolist()}")
    if not np.array_equal(m_card, m_cpu):
        raise RuntimeError("compare_algorithms: the card's disagreement "
                           "matrix differs from the cpu's")


def oracle_card_vs_cpu(torch, ck, xm_cpu, n_scaled):
    """Phase 5's Oracle: ``backend="torch"`` on the card against its own
    CPU run (sztorc within ``MID_ATOL``, fixed-variance and ica within
    ``MULTI_ATOL``), with and without scaled events, under ``"auto"`` and
    ``"power-fused"`` at a fixed sweep count (sztorc's sweeps then launch
    on the card); then ``backend="numpy"`` against ``backend="torch"`` on
    the CPU, on the first 256 reporters and 1024 events."""
    from pyconsensus_tpu_torch import Oracle

    R, E = xm_cpu.shape
    n_sc = min(n_scaled, E // 4)
    host = float_reports(torch, xm_cpu, 0).double().numpy()
    scaled_host = host.copy()
    scaled_host[:, -n_sc:] = 20.0 * scaled_host[:, -n_sc:] - 5.0
    cases = (("binary", host, None),
             ("scaled", scaled_host, scaled_bounds(E, n_sc)))
    for algo, atol in (("sztorc", MID_ATOL), ("fixed-variance", MULTI_ATOL),
                       ("ica", MULTI_ATOL)):
        for tag, reports, bounds in cases:
            for method in ("auto", "power-fused"):
                kw = dict(reports=reports, event_bounds=bounds,
                          algorithm=algo, pca_method=method,
                          max_iterations=3, power_iters=64, power_tol=-1.0)
                ck.reset_launch_counts()
                a = Oracle(backend="torch", **kw).resolve_raw()
                counts = ck.launch_counts()
                b = Oracle(backend="torch", device="cpu", **kw).resolve_raw()
                what = f"Oracle {algo} {tag} {method}: card vs cpu"
                worst = compare_outputs(torch, a, b, atol, what,
                                        scaled_from=E - n_sc if bounds
                                        else None)
                sweeps = counts["apply_weighted_cov"]
                if (algo == "sztorc" and method == "power-fused") != \
                        (sweeps > 0):
                    raise RuntimeError(f"{what}: apply_weighted_cov launched "
                                       f"{sweeps} times")
                log(f"{what} agree (exact keys equal, continuous max |diff| "
                    f"{worst:.3e} <= {atol}); iterations "
                    f"{int(a['iterations'])}, apply_weighted_cov launches "
                    f"{sweeps}")
    n_corner = min(n_sc, 512)
    corner = host[:256, -1024:].copy()
    corner[:, -n_corner:] = 20.0 * corner[:, -n_corner:] - 5.0
    bounds = scaled_bounds(1024, n_corner)
    for algo, atol in (("sztorc", MID_ATOL), ("fixed-variance", MULTI_ATOL),
                       ("ica", MULTI_ATOL)):
        kw = dict(reports=corner, event_bounds=bounds, algorithm=algo,
                  max_iterations=3)
        a = Oracle(backend="numpy", **kw).resolve_raw()
        b = Oracle(backend="torch", device="cpu", **kw).resolve_raw()
        worst = compare_outputs(torch, a, b, atol,
                                f"Oracle {algo}: numpy vs torch",
                                scaled_from=1024 - n_corner)
        log(f"Oracle {algo} 256x1024, {n_corner} scaled: numpy (float64) "
            f"and torch (cpu, float32) agree (exact keys equal, continuous "
            f"max |diff| {worst:.3e} <= {atol})")


def check_result(torch, out, R, E, algorithm="sztorc", lattice=None):
    """Finite values of the expected shapes, outcomes on the lattice (on
    the events of ``lattice``, a slice, where some are scaled)."""
    shapes = {"smooth_rep": (R,), "this_rep": (R,), "na_row": (R,),
              "outcomes_adjusted": (E,), "certainty": (E,),
              "participation_columns": (E,), "reporter_bonus": (R,),
              "author_bonus": (E,)}
    if algorithm == "ica":
        shapes["ica_converged"] = ()
    elif algorithm in ("sztorc", "fixed-variance"):
        shapes["first_loading"] = (E,)
    for key, shape in shapes.items():
        v = out[key]
        if tuple(v.shape) != shape:
            raise RuntimeError(f"{key}: shape {tuple(v.shape)} != {shape}")
        if v.dtype != torch.bool and not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"{key}: non-finite values")
    o = out["outcomes_adjusted"][lattice or slice(None)]
    if not bool(((o == 0) | (o == 0.5) | (o == 1)).all()):
        raise RuntimeError("outcomes off the {0, 0.5, 1} lattice")
    if abs(float(out["smooth_rep"].sum()) - 1.0) > 1e-4:
        raise RuntimeError("reputation does not sum to 1")


def compare_outputs(torch, a, b, atol, what, scaled_from=None):
    """Exact keys equal, the others within ``atol`` (``first_loading`` up
    to sign, NaN where the other has NaN). With ``scaled_from``, the
    events from that index on are scaled on [-5, 15]: their snapped
    outcomes within ``atol``, their final ones within ``20 atol``.
    Values may be tensors or numpy. Returns the largest continuous
    difference."""
    exact = ("outcomes_adjusted", "outcomes_final", "na_row", "iterations",
             "convergence", "ica_converged")
    if set(a) != set(b):
        raise RuntimeError(f"{what}: keys differ")
    worst = 0.0
    for key, va in a.items():
        va, vb = torch.as_tensor(va).cpu(), torch.as_tensor(b[key]).cpu()
        if key in exact:
            if scaled_from is None or key not in ("outcomes_adjusted",
                                                  "outcomes_final"):
                if not torch.equal(va.to(vb.dtype), vb):
                    raise RuntimeError(f"{what}: {key} differs")
                continue
            n = scaled_from
            if not torch.equal(va[:n].to(vb.dtype), vb[:n]):
                raise RuntimeError(f"{what}: {key} differs")
            va, vb = va[n:], vb[n:]
            if key == "outcomes_final":
                va, vb = va / 20.0, vb / 20.0
        if key == "first_loading":
            va, vb = va.abs(), vb.abs()
        va, vb = va.double(), vb.double()
        nan = torch.isnan(va)
        if not torch.equal(nan, torch.isnan(vb)):
            raise RuntimeError(f"{what}: {key} has NaN elsewhere")
        d = (va - vb)[~nan].abs().max().item() if va.numel() else 0.0
        worst = max(worst, d)
        if d > atol:
            raise RuntimeError(f"{what}: {key} differs by {d:.3e} (atol "
                               f"{atol})")
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reporters", type=int, default=10_000)
    ap.add_argument("--events", type=int, default=100_000)
    ap.add_argument("--mid-r", type=int, default=1024)
    ap.add_argument("--mid-e", type=int, default=8192)
    ap.add_argument("--hybrid-r", type=int, default=HYBRID_R)
    ap.add_argument("--hybrid-e", type=int, default=HYBRID_E)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20,
                    help="timed calls per kernel (median reported)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one main-path resolution")
    ap.add_argument("--resolutions", type=int, default=5,
                    help="timed resolutions per main-path configuration")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="run the mesh over this many distinct cards "
                    f"(default: {MESH_SHARDS} shards on card 0)")
    args = ap.parse_args(argv)
    try:
        return run(args)
    except Exception:                 # noqa: BLE001 — report, exit non-zero
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
