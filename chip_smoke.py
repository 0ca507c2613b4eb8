#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pyconsensus_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py                      # 10000 x 100000, one card
    python3 chip_smoke.py --mesh-devices 4     # the meshes over four cards,
                                               # four processes over NCCL
    python3 chip_smoke.py --mesh-devices 4 --only process
                                               # phases 1, 2 and 11 alone
    python3 chip_smoke.py --only stateplane    # phases 1, 2 and the state
                                               # plane and kernel store
    python3 chip_smoke.py --only elastic       # phases 1, 2 and the elastic
                                               # fleet and economy
    python3 chip_smoke.py --only tune          # phases 1, 2 and the
                                               # launch-shape autotuner
    python3 chip_smoke.py --only witness       # phases 1, 2 and the
                                               # static analysis and its
                                               # runtime witnesses

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
   Then the launch-shape autotuner (``tune_phase``, about a minute): on
   the generator's 10,000 x 100,000 int8 matrix, every legal split count
   of the two tile passes (through the covariance sweep B.1) and every
   legal resolve panel width swept into a cache under a temporary
   directory (never the default file, so every other phase keeps the
   built-in shapes), each candidate timed with CUDA events in
   interleaved rounds and held to the built-in (snapped outcomes and
   absent counts bit for bit, the rest within ``FULL_RTOL``) and to the
   plain versions (within ``FULL_RTOL``), a candidate persisted only
   when its interquartile range lies below the built-in's;
   ``python -m pyconsensus_tpu_torch.tune`` in a fresh process on that
   cache (a hit of every kind, 0 sweeps, the file untouched); the fused
   int8 sztorc resolution under the installed winners against the
   built-in shapes, in turn (identical outcomes, continuous keys within
   ``MID_ATOL``, the same B.1/B.2/B.3 launches; both rates, no claim);
   the serve pipeline depth swept at ``TUNE_DEPTH_SHAPE`` through a
   service at each depth, on the padded ring route it paces; and the
   measured stream bandwidth beside the nominal 3.35 TB/s;
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
   and ``SIM_TIMED`` (1) timed run each, with trials/s, peak memory, the
   draw's seconds, the power sweeps a lane takes and every launch count 0;
   ``SIM_REPLAY`` (8) of its lanes replayed through the ``Oracle`` (exact metrics equal); a
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
   Then the state plane and the kernel-build store
   (``stateplane_phase``, about two minutes, most of it two cold workers'
   ``nvcc`` builds running beside the rest): ``bucket_cuda`` keys and
   this checkout's libraries persisted into a store; three worker
   processes from copies of the package without ``csrc/build/``: one
   adopting from the store (``nvcc`` 0, ``store_adopt`` 2, B.1, B.2 and
   B.3 launched by every request), a cold one building with ``nvcc``, one
   whose stored library has a flipped byte (refused as ``digest``,
   rebuilt, never loaded), each with its boot and first-request seconds
   and 48 structured 1024 x 4096 requests bit for bit between the two and
   the direct fused ``ShardedOracle``; 128 durable sessions of 1,024
   reporters (cut from 1,024 for the script's time) compacted under a
   64-session hot tier, 32 hydrated and
   resolved (hydration p50 / p99, the tiers' gauges, peak memory), 32 of
   them bit for bit their uncompacted twins; and a socket worker
   SIGKILLed after it compacted and shipped a session, the standby
   adopting the shipped compacted log;
   Then the elastic fleet and the economy (``elastic_phase``): a socket
   fleet of one worker on card 0 whose workers adopt their kernels from
   a store warmed at 1024 x 4096, grown by ``AutoScaler`` on an
   ``SloMonitor`` of the merged worker view under a closed-loop burst of
   all-binary 1024 x 4096 requests (a p99 target one edge below the
   unloaded p99) to ``ELASTIC_MAX`` workers, drained in the idle tail
   (its sessions live-migrated bit for bit), a SIGKILLed worker replaced
   under a fresh name: each worker's boot seconds and ``nvcc`` (0), B.1,
   B.2 and B.3 a request in every worker, the seconds from the first
   breached window to the new worker's ring entry, requests/s and p99
   before and after the scale-up, the decisions, a ``/metrics`` scrape,
   the flight dumps and ``pyconsensus-serve-torch --autoscale`` over a
   socket fleet; then the reference's economy block (cut from 1,002 to
   501 market sessions for the script's time, 3 rounds, camouflage,
   sybil_split and flash_crowd at concurrency 32) through one service of
   the default config, twice (the same digest; the binary mirrors on
   ``bucket_cuda``), and the economy's
   command line over a two-worker fleet SIGKILLed mid-economy and run
   again (the uninterrupted digest) and with ``--autoscale``;
   Then the port's static analysis and its runtime witnesses
   (``witness_phase``, about a minute): ``python -m
   pyconsensus_tpu_torch.analysis --strict`` (exit 0, 0 findings), and a
   fresh interpreter (``--witness-worker cuda``) that installs the lock
   witness before it imports the package, then the protocol and digest
   witnesses, over a 3-worker in-process fleet on card 0 whose libraries
   come from a kernel store (all-binary 1024 x 4096 requests at
   concurrency 8, B.1/B.2/B.3 3/1/1 a request, one ``kill_worker``, a
   durable session's takeover, every result bit for bit) and the economy
   block at 8 markets a strategy: violations 0, abandoned 0, the card's
   locks taken (the build lock, ``_LINALG_LOCK``, the executable cache,
   the launch counters), the observed lock edges, the protocol events
   and the digests re-derived;
9. streaming and the CLI (``streaming_phase``), which launch none of the
   kernels but the CLI's in-memory ``--shard`` run: sztorc streamed from
   the host at full size (panels of ``STREAM_PANEL``) against the
   in-memory ``Oracle`` (seconds side by side, 0 outcome flips, the
   ``smooth_rep`` gap under ``STREAM_REP_RTOL`` of its largest value);
   the recorded out-of-core configuration, 10,000 x 500,000 float32,
   cut to 10,000 x 160,000 (``OOC_E``, and further to fit the disk),
   staged to ``.npy`` in
   ``STAGE_DIR`` and resolved memory-mapped under sztorc,
   fixed-variance and dbscan-jit (seconds, panels a pass, peak device
   memory below the source's bytes and, for sztorc, within 10% of the
   full-size streaming peak); k-means at ``KMEANS_OOC_E`` events;
   hierarchical and dbscan at the hybrid shape against the in-memory
   ``Oracle``; two hosts on one card (threads) equal to one (the
   reputations within ``STREAM_REP_RTOL`` of their largest value); and
   ``python -m pyconsensus_tpu_torch`` as three subprocesses side by
   side: ``--example``,
   ``--file <.npy> --shard`` (B.1, B.2 and B.3 launched on one card;
   B.5, B.6 and B.3 over several) and ``--file <.npy> --stream`` with
   equal outcome counts;
10. the batch x event mesh (``batch_mesh_phase``), on virtual grids of
   card 0 (``--mesh-devices 4``: on the four cards): sztorc on a 2 x 2
   grid, bit for bit the 1 x 2 event mesh (B.5, B.6, B.3 launched); the
   serve block on a 2 x 4 grid (``sharded_buckets=True``, 48 requests of
   ``GRID_REQUEST`` at concurrency 8) beside the same block on the
   single-device bucket, every request held to a direct ``Oracle``; the
   10,000-trial sweep under sztorc and fixed-variance over
   ``make_mesh(batch=4, event=1)``, bit for bit the single-device sweep;
   sztorc streamed at full size over 4 event shards against phase 9's
   one-device result; and the CLI's ``--shard --simulate`` and ``--shard
   --stream`` as subprocesses;
11. the event mesh across processes (``process_mesh_phase``): the
   generator's int8 matrix written once as ``.npy``, every rank a
   ``--process-worker`` process under ``PROCESS_TIMEOUT`` that
   memory-maps it and places its own columns. On one card one process,
   an NCCL group of one over ``PROCESS_SHARDS`` shards of card 0: int8
   sztorc at ``max_iterations`` 1 and 3, bit for bit the one-controller
   mesh, B.5, B.6 and B.3 launched. With ``--mesh-devices N``, N
   processes, one a card, each timed beside the one-controller N-card
   mesh and one device: int8 sztorc (bit for bit), fixed-variance on
   float32 and hierarchical at the hybrid shape (0 flips), and sztorc
   streamed over N NCCL hosts against phase 9's single host;
12. run the same paths at a middle size on the card and on the CPU
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
13. print the ``kernels`` JSON line (each kernel with the storage types it
   takes and its bfloat16 time, plain time and bound beside the int8
   ones), then the result line.

``--only process`` runs phases 1, 2 and 11 (with ``--mesh-devices``,
after part 1 of phase 9's one-host stream, which phase 11 compares the
NCCL hosts with) and prints the result line with ``"only": "process"``;
``--only fleet``, ``--only stateplane``, ``--only elastic``, ``--only
tune`` and ``--only witness`` run phases 1, 2 and that phase.

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
SIM_REPLAY = 8
#: timed runs of each sweep (cut from 3 for the script's time)
SIM_TIMED = 1
SIM_CHUNK = 1024
#: the simulator's other algorithms on the same sweep, at
#: ``max_iterations`` 1 (and 5 for the first); dbscan-jit at the
#: reference docstring's radius ``sqrt(2 * variance * E)`` at the sweep's
#: larger variance; the sub-grid's iterations against the CPU
SIM_ALGORITHMS = ("fixed-variance", "ica", "k-means", "dbscan-jit")
SIM_ALGO_EPS = (2 * 0.1 * SIM_E) ** 0.5
SIM_ALGO_SUB_ITERS = 3
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
#: the streaming phase: the driver's default panel; the recorded
#: out-of-core configuration (``docs/MEASUREMENTS_r05.json:257-325``,
#: "beyond HBM": 10,000 x 500,000 float32, memory-mapped from .npy, its
#: events cut to 160,000 to keep the whole script inside its limit, a
#: source still larger than the streaming peak);
#: k-means' width (each of its 32 Lloyd iterations is two passes over
#: the source; two panels, 4,096 events in all, cut from four default
#: panels to keep the whole script inside its limit);
#: the staging directory beside the checkout (listed in .gitignore); the
#: largest reputation gap of a streamed result against the in-memory one
#: or two hosts against one, over the largest reputation (a reputation is
#: about 1/R, so an absolute band would pass one wrong by all of itself)
STREAM_PANEL = 8192
OOC_E = 160_000
#: the command line's ``.npy`` (part 5): the first ``CLI_E`` events of
#: part 1's matrix (cut from all of its events for the script's time)
CLI_E = 10_000
KMEANS_OOC_E = 4_096
STAGE_DIR = ".ooc_stage"
STREAM_REP_RTOL = 1e-6
#: the batch x event phase (``batch_mesh_phase``): the serve block's
#: request shape and absent share on the grid; the grid's devices on one
#: card (the serve block's 2 x 4, the sweep's trial groups, the stream's
#: shards and the 2 x 2 grid's); the sweeps' algorithms; the shape of the
#: ``--shard --stream`` file
GRID_REQUEST, GRID_NA = (1024, 4096), 0.02
GRID_SERVE_DEVICES, GRID_SHARDS = 8, 4
GRID_SIM_ALGORITHMS = ("sztorc", "fixed-variance")
GRID_CLI = (1024, 4096)
#: the process-mesh phase (``process_mesh_phase``): the virtual shards of
#: card 0 under an NCCL group of one; the seconds every worker of one
#: launch may take together (each is killed after it, and its peers when
#: one fails)
PROCESS_SHARDS = 4
PROCESS_TIMEOUT = 600
#: the fleet phase (``fleet_phase``): a 3-worker in-process fleet on the
#: card under the default ``ServeConfig`` (all-binary requests at the
#: ``bucket_cuda`` class bound, 2% absent, distinct matrices cycled),
#: beside one service; the kill after the 16th completion and the
#: clients' retry budget; a durable session (1024 reporters, blocks of
#: 512 events, 3 rounds of two appends and a resolve, its owner killed
#: after round 2's first append); the serve command line's run
FLEET_WORKERS = 3
FLEET_REQUEST, FLEET_NA = (1024, 4096), 0.02
FLEET_REQUESTS, FLEET_CONCURRENCY, FLEET_DISTINCT = 16, 8, 12
FLEET_KILL_AFTER, FLEET_RETRIES = 8, 6
FLEET_SESSION_R, FLEET_SESSION_E, FLEET_SESSION_ROUNDS = 1024, 512, 3
FLEET_CLI = ("--fleet-workers", "3", "--requests", "12", "--concurrency",
             "8", "--shapes", "1024x4096")
#: the state plane and kernel store phase: ``AOT_REQUESTS`` structured
#: requests (``AOT_DISTINCT`` distinct matrices) through the adopted and
#: the cold worker; ``STATE_SESSIONS`` durable sessions of ``STATE_R``
#: reporters (the reference's "100k+ owned" cut by the phase's time),
#: ``STATE_HOT`` hot, blocks of ``STATE_BLOCK_E`` events with ``STATE_NA``
#: absent, ``STATE_HYDRATE`` hydrated in a seeded order, ``STATE_TWINS``
#: uncompacted twins, set up by ``STATE_PROCS`` processes; a worker's
#: boot (an ``nvcc`` build included) is waited on ``WORKER_BOOT_TIMEOUT``
AOT_REQUESTS, AOT_DISTINCT = 48, 12
STATE_SESSIONS, STATE_HOT, STATE_R, STATE_BLOCK_E = 128, 64, 1024, 128
STATE_HYDRATE, STATE_TWINS, STATE_NA, STATE_PROCS = 32, 16, 0.02, 4
WORKER_BOOT_TIMEOUT = 900
#: the elastic fleet and economy phase (``elastic_phase``): a socket fleet
#: grown from one worker up to ``ELASTIC_MAX`` (all on card 0) by
#: ``ELASTIC_CLIENTS`` closed-loop clients of all-binary ``FLEET_REQUEST``
#: requests; the SLO monitor's window, the autoscaler's period, streaks
#: and cool-down, and its queue-depth target; ``ELASTIC_SESSIONS`` durable
#: sessions of ``ELASTIC_SESSION_R`` reporters (blocks of
#: ``ELASTIC_SESSION_E`` events) for the rebalances, drains and takeover
#: to move; the unloaded requests that set the latency target, the burst's
#: bound and its tail after the ceiling. The reference's economy block
#: (``bench.py:228-236``): ``ECON_SESSIONS`` markets of ``ECON_STRATEGIES``
#: (the reference's 1,002, cut to 501 for the script's time)
#: over ``ECON_ROUNDS`` rounds at concurrency ``ECON_CONCURRENCY``; its
#: SIGKILL stage cut to ``ECON_KILL_MARKETS`` markets a strategy
ELASTIC_MAX, ELASTIC_CLIENTS, ELASTIC_WINDOW_S = 3, 8, 3.0
ELASTIC_INTERVAL_S, ELASTIC_UP, ELASTIC_DOWN = 0.25, 2, 4
ELASTIC_COOLDOWN_S, ELASTIC_QUEUE_TARGET = 3.0, 64.0
ELASTIC_SESSIONS, ELASTIC_SESSION_R, ELASTIC_SESSION_E = 4, 256, 256
ELASTIC_CALIBRATE, ELASTIC_BURST_S, ELASTIC_AFTER_S = 8, 150.0, 3.0
ECON_SESSIONS, ECON_ROUNDS, ECON_CONCURRENCY = 500, 3, 32
ECON_STRATEGIES = ("camouflage", "sybil_split", "flash_crowd")
ECON_KILL_MARKETS = 8
#: the witness phase (``witness_phase``): in a fresh interpreter under
#: the lock, protocol and digest witnesses, a ``FLEET_WORKERS``-worker
#: in-process fleet on card 0 under the default ``ServeConfig`` with a
#: kernel store: ``WITNESS_REQUESTS`` all-binary ``FLEET_REQUEST``
#: requests (``FLEET_NA`` absent, ``WITNESS_DISTINCT`` distinct matrices)
#: at ``FLEET_CONCURRENCY``, then as many again across one
#: ``kill_worker``; a durable session of ``WITNESS_SESSION_R`` reporters
#: (blocks of ``WITNESS_SESSION_E`` events, two rounds, its owner killed
#: after round 2's first append); the economy block at
#: ``WITNESS_ECON_MARKETS`` markets a strategy (cut from the elastic
#: phase's ``ECON_SESSIONS``); the worker's time limit
WITNESS_REQUESTS, WITNESS_DISTINCT = 16, 4
WITNESS_SESSION_R, WITNESS_SESSION_E = 256, 256
WITNESS_ECON_MARKETS = 8
WITNESS_TIMEOUT = 600
#: the locks only the card's paths take: the kernel build (and the
#: store's adoption under it), the first ``torch.linalg`` call, the
#: ``bucket_cuda`` class's executable cache, the launch counters
WITNESS_CUDA_LOCKS = ("build._LOCK", "service._LINALG_LOCK",
                      "ExecutableCache._lock", "cuda_kernels._COUNTS_LOCK")
#: the autotuner phase (``tune_phase``): interleaved timing rounds of each
#: candidate, the serve shape of the pipeline-depth sweep (in the event
#: ladder's top class, which ``pipeline_depth=0`` reads), its full
#: batches a candidate and its rounds, the stream-bandwidth buffer
TUNE_REPEATS = 7
TUNE_DEPTH_SHAPE, TUNE_DEPTH_DISPATCHES, TUNE_DEPTH_REPEATS = \
    (256, 4096), 4, 5
TUNE_STREAM_MBYTES = 1024

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
    # the plain mesh core and the hybrid path over shards: no kernel
    "mesh plain": (),
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
    "mesh plain": tuple(KERNELS),
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
                noise=0.05, rows=1000, liar=None):
    """The collusion threat model of the JAX package's simulator (honest
    reporters flip the truth at ``noise``, a ``liar_frac`` share reports
    the shared anti-truth, ``na_frac`` of entries absent), drawn with an
    explicit ``torch.Generator`` straight into int8 sentinel storage.
    ``liar`` (an (R,) bool tensor) fixes the colluding block, so column
    chunks drawn apart share it. Returns ``(x int8 (R, E), truth (E,)
    float32)``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    truth = torch.rand(E, generator=g, device=device) < 0.5
    if liar is None:
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


def make_drive(torch, args, launches):
    """``drive(x, p, label, path=None, **kw)``, which times one main path
    and adds its launch counts to ``launches``."""
    from pyconsensus_tpu_torch import sharded_consensus
    from pyconsensus_tpu_torch.ops import cuda_kernels as ck

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

    return drive


def card_line() -> str:
    """The first card's line of ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader``."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found")
    return subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]


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
        card = card_line()
        log(card)

    cold = None
    if args.only in (None, "stateplane"):
        # the state-plane phase's cold worker builds its own kernels from
        # an empty copy of the package, beside this build
        cold = start_cold_worker(torch, dev, here)
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
    launches = {k: 0 for k in KERNELS}
    drive = make_drive(torch, args, launches)
    process_where = (f"{args.mesh_devices} processes, one a card, over NCCL"
                     if args.mesh_devices else
                     f"an NCCL group of one over {PROCESS_SHARDS} shards "
                     "of one card")
    socket_cards = (list(range(args.mesh_devices)) if args.mesh_devices
                    else None)
    if args.only == "fleet":
        with phase("fleet"):
            fleet_phase(torch, ck, card, dev, launches, args.seed, here,
                        cards=socket_cards)
        log(f"chip_smoke --only fleet total "
            f"{time.perf_counter() - t_start:.3f} s")
        log(json.dumps({"ok": True, "only": "fleet", "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.only == "stateplane":
        with phase("state plane and kernel store"):
            stateplane_phase(torch, ck, card, dev, launches, args.seed, here,
                             cold=cold)
        log(f"chip_smoke --only stateplane total "
            f"{time.perf_counter() - t_start:.3f} s")
        log(json.dumps({"ok": True, "only": "stateplane", "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.only == "elastic":
        with phase("elastic fleet and economy"):
            elastic_phase(torch, ck, card, dev, launches, args.seed, here)
        log(f"chip_smoke --only elastic total "
            f"{time.perf_counter() - t_start:.3f} s")
        log(json.dumps({"ok": True, "only": "elastic", "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.only == "tune":
        with phase(f"launch-shape autotuner {R}x{E} int8"):
            tune_phase(torch, args, ck, card, dev, drive, here)
        log(f"chip_smoke --only tune total "
            f"{time.perf_counter() - t_start:.3f} s")
        log(json.dumps({"ok": True, "only": "tune", "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.only == "witness":
        with phase("static analysis and witnesses"):
            witness_phase(torch, card, dev, launches, here)
        log(f"chip_smoke --only witness total "
            f"{time.perf_counter() - t_start:.3f} s")
        log(json.dumps({"ok": True, "only": "witness", "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.only == "process":
        kept = {}
        if args.mesh_devices > 1:
            with phase("streaming, one host (what the process phase "
                       "compares with)"):
                host, truth, out, secs, peaks = one_host_stream(
                    torch, ck, args, dev)
                kept["stream"] = (host, truth, out, secs[1], max(peaks))
        with phase(f"process mesh ({process_where})"):
            process_mesh_phase(torch, args, card, dev, drive, kept, here)
        log(f"chip_smoke --only process total "
            f"{time.perf_counter() - t_start:.3f} s")
        log(json.dumps({"ok": True, "only": "process", "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    stats = kernel_phase(torch, args, ck, _fill_stats, dev, card)

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

    with phase(f"launch-shape autotuner {R}x{E} int8"):
        tune_phase(torch, args, ck, card, dev, drive, here)

    with phase(f"every algorithm on an event mesh ({where})"):
        mesh_algorithms_phase(torch, args, drive, mesh, where, card, dev)

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
        sim_algorithms_phase(torch, args, ck, card, dev)
        persistence_phase(torch, args, ck, card, dev)

    with phase("serve"):
        serve_phase(torch, ck, card, dev, launches, args.seed)

    with phase("fleet"):
        fleet_phase(torch, ck, card, dev, launches, args.seed, here,
                    cards=socket_cards)

    with phase("state plane and kernel store"):
        stateplane_phase(torch, ck, card, dev, launches, args.seed, here,
                         cold=cold)

    with phase("elastic fleet and economy"):
        elastic_phase(torch, ck, card, dev, launches, args.seed, here)

    with phase("static analysis and witnesses"):
        witness_phase(torch, card, dev, launches, here)

    kept = {}
    with phase("streaming and the CLI"):
        streaming_phase(torch, args, ck, card, dev, launches, here, kept)

    grid_where = (f"{args.mesh_devices} cards" if args.mesh_devices
                  else "virtual grids of one card")
    with phase(f"batch x event mesh ({grid_where})"):
        batch_mesh_phase(torch, args, ck, card, dev, drive, kept, here)

    with phase(f"process mesh ({process_where})"):
        process_mesh_phase(torch, args, card, dev, drive, kept, here)
        kept.clear()

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


def mesh_flips(out, one):
    """Events whose final outcome on the mesh differs from one device."""
    return int((out["outcomes_final"] != one["outcomes_final"]).sum())


def shard_kernel_times(torch, args, ck, xs, card):
    """B.5, B.6 (k = 1) and B.3 on one bfloat16 shard of the mesh (the
    float32 shard ``xs`` cast as the fused mesh casts it), each held
    against its plain version on the card and timed with CUDA events
    beside its bound (the shard read once, at the memory rate)."""
    R, W = xs.shape
    xb = xs.to(torch.bfloat16)
    g = torch.Generator(device=xs.device)
    g.manual_seed(args.seed + 12)
    fill = (torch.rand(W, generator=g, device=xs.device) < 0.5).float()
    rep = torch.full((R,), 1.0 / R, device=xs.device)
    v = torch.randn(W, generator=g, device=xs.device)
    total = rep.sum()
    bound, by = bound_ms(R * W * 2, 2 * R * W)
    cells = (
        ("storage_matvec", lambda: ck.storage_matvec(xb, v, fill),
         lambda: ck.storage_matvec_plain(xb, v, fill)),
        ("storage_rows_matmat", lambda: ck.storage_rows_matmat(
            xb, rep[None], fill),
         lambda: ck.storage_rows_matmat_plain(xb, rep[None], fill)),
        ("resolve_certainty_fused", lambda: ck.resolve_certainty_fused(
            xb, rep, fill, total, 0.1),
         lambda: ck.resolve_certainty_fused_plain(xb, rep, fill, total,
                                                  0.1)))
    for name, kernel, plain in cells:
        got, ref = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        worst = 0.0
        for a, b in zip(got, ref):
            d, rel = max_rel_err(torch, a, b)
            worst = max(worst, rel)
            if rel > FULL_RTOL:
                raise RuntimeError(f"{name} on a {R}x{W} bfloat16 shard: "
                                   f"max |diff| {d:.3e} against its plain "
                                   "version")
        ms = time_ms(torch, kernel, args.reps)
        log(f"{name} [bfloat16 shard {R}x{W}]: {ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}) on {card}; agrees with its plain version "
            f"to {worst:.3e} of its scale")
    del xb


def mesh_algorithms_phase(torch, args, drive, mesh, where, card, dev):
    """Every algorithm on the event mesh at full size, each against the
    same resolution on one device (0 outcome flips) and printed with its
    rate and peak device memory:
    - sztorc on the fused mesh, bfloat16 storage with the last
      ``SCALED_FUSED[0]`` events scaled (each shard's gather-median
      tail): B.5, B.6 and B.3 launch on every shard, never the one-device
      sweeps; the binary outcomes recover the truth and the scaled ones
      ``20 truth - 5``; then B.5, B.6 and B.3 timed on one bfloat16 shard;
    - fixed-variance and ica on the plain mesh core, float32,
      ``max_iterations`` 1 (``"auto"``: the orthogonal iteration over the
      shards' products);
    - k-means and dbscan-jit (the geometry radius) on bfloat16 storage;
    - hierarchical and dbscan at ``--hybrid-r`` x ``--hybrid-e``, the
      distances folded over the shards.
    The plain mesh core and the hybrid path launch no kernel."""
    from pyconsensus_tpu_torch import ConsensusParams, sharded_consensus
    from pyconsensus_tpu_torch.ops import cuda_kernels as ck
    from pyconsensus_tpu_torch.parallel.mesh import place_event_shards
    from pyconsensus_tpu_torch.parallel.sharded import resolve_params

    R, E = args.reporters, args.events
    n_sh = len(mesh)
    n = args.resolutions
    x8, truth = gen_reports(torch, R, E, args.seed + 11, dev)
    n_sc = min(SCALED_FUSED[0], E // 8)
    xf = float_reports(torch, x8, n_sc)
    bounds = scaled_bounds(E, n_sc)
    binary = slice(0, E - n_sc)

    def cell(x, p, label, path, one, **kw):
        """Drive ``x`` on the mesh, print the rate, peak and flips against
        the one-device result ``one``; returns ``(out, counts)``."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, rate, counts = drive(x, p, label, path, **kw)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        flips = mesh_flips(out, one)
        check_result(torch, out, *x.shape, p.algorithm,
                     lattice=binary if kw else None)
        log(f"{label}: {rate:.4f} resolutions/s ({1e3 / rate:.3f} ms each) "
            f"on {card}; peak {peak:.3f} GiB; iterations "
            f"{int(out['iterations'])}; outcome flips against one device "
            f"{flips}")
        if flips:
            raise RuntimeError(f"{label}: {flips} outcomes differ from one "
                               "device")
        return out, counts

    p = ConsensusParams(storage_dtype="bfloat16", power_tol=1e-5,
                        pca_method="auto" if R > 4096 else "power-fused")
    resolved = resolve_params(p._replace(any_scaled=True, n_scaled=n_sc), R,
                              E, mesh[0], n_sh)
    if not resolved.fused_resolution:
        raise RuntimeError("sztorc, scaled, bfloat16: the fused mesh did not "
                           "open")
    one = sharded_consensus(xf, params=p, event_bounds=bounds)
    t0 = time.perf_counter()
    placed = place_event_shards(xf, mesh)
    torch.cuda.synchronize()
    log(f"mesh placement of the float32 reports ({where}): "
        f"{time.perf_counter() - t0:.4f} s")
    label = (f"sztorc mesh ({where}), {n_sc} scaled, bfloat16 fused, "
             "max_iterations=1")
    out, counts = cell(placed, p, label, "sztorc mesh", one,
                       event_bounds=bounds)
    final = out["outcomes_final"]
    ok_bin = float((final[binary] == truth[binary]).float().mean())
    ok_sc = float((final[E - n_sc:] == 20.0 * truth[E - n_sc:] - 5.0)
                  .float().mean())
    per = {k: counts[k] / (n * n_sh) for k in (
        "storage_matvec", "storage_rows_matmat", "resolve_certainty_fused")}
    log(f"{label}: binary outcomes == truth {ok_bin:.6f}, scaled outcomes "
        f"== 20 truth - 5 {ok_sc:.6f}; launches a shard a resolution: B.5 "
        f"{per['storage_matvec']:g}, B.6 {per['storage_rows_matmat']:g}, "
        f"B.3 {per['resolve_certainty_fused']:g}; launches {counts}")
    if ok_bin < 0.99 or ok_sc < 0.99:
        raise RuntimeError(f"{label}: the outcomes do not recover the truth")
    if per["resolve_certainty_fused"] != 1:
        raise RuntimeError(f"{label}: resolve did not launch once a shard")
    shard_kernel_times(torch, args, ck, placed.shards[0], card)
    del placed, one, out, xf
    torch.cuda.empty_cache()

    xf = float_reports(torch, x8, 0)
    del x8
    binary = slice(None)
    placed = place_event_shards(xf, mesh)
    geo = geometry_knobs(E)
    for algo, knobs in (
            ("fixed-variance", {}), ("ica", {}),
            ("k-means", dict(storage_dtype="bfloat16")),
            ("dbscan-jit", dict(storage_dtype="bfloat16",
                                dbscan_eps=geo["dbscan_eps"],
                                dbscan_min_samples=4))):
        p = ConsensusParams(algorithm=algo, max_iterations=1,
                            power_tol=1e-5, **knobs)
        resolved = resolve_params(p._replace(any_scaled=False), R, E,
                                  mesh[0], n_sh)
        if resolved.fused_resolution:
            raise RuntimeError(f"{algo} mesh: the fused gate opened")
        one = sharded_consensus(xf, params=p)
        pca = (f", pca_method {resolved.pca_method}"
               if algo in ("fixed-variance", "ica") else "")
        label = (f"{algo} mesh ({where}) {R}x{E} "
                 f"{knobs.get('storage_dtype', 'float32')}{pca}, "
                 "max_iterations=1")
        out, _ = cell(placed, p, label, "mesh plain", one)
        correct = float((out["outcomes_adjusted"] == truth).float().mean())
        log(f"{label}: outcomes == truth {correct:.6f}")
        if correct < 0.99:
            raise RuntimeError(f"{label}: the outcomes do not recover the "
                               "truth")
        del one, out
    del placed, xf
    torch.cuda.empty_cache()

    Rh, Eh = args.hybrid_r, args.hybrid_e
    x8, truth = gen_reports(torch, Rh, Eh, args.seed + 13, dev)
    xf = float_reports(torch, x8, 0)
    del x8
    placed = place_event_shards(xf, mesh)
    geo = geometry_knobs(Eh)
    for algo, knob in (
            ("hierarchical",
             dict(hierarchy_threshold=geo["hierarchy_threshold"])),
            ("dbscan", dict(dbscan_eps=geo["dbscan_eps"],
                            dbscan_min_samples=4))):
        p = ConsensusParams(algorithm=algo, **knob)
        one = sharded_consensus(xf, params=p)
        label = f"{algo} mesh ({where}) {Rh}x{Eh} geometry"
        out, _ = cell(placed, p, label, "mesh plain", one)
        correct = float((out["outcomes_final"] == truth).float().mean())
        same = bool(torch.equal(out["this_rep"] > out["this_rep"].median(),
                                one["this_rep"] > one["this_rep"].median()))
        log(f"{label}: outcomes == truth {correct:.6f}; the clusters' "
            f"upper half as one device's {same}")
        if correct < 0.99:
            raise RuntimeError(f"{label}: the outcomes do not recover the "
                               "truth")
        del one, out
    del placed, xf
    torch.cuda.empty_cache()


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
        f.write("\n\nby host time\n")
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=40))


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
    of ``SIM_ITERS``: one untimed warm-up, then ``SIM_TIMED`` timed runs,
    each ending in ``torch.cuda.synchronize()``, with the storage kernels'
    launch counts set to 0 before and read after (every one must read 0: no TPU
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
        for _ in range(SIM_TIMED):
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
            f"{n / min(secs):.1f} trials/s (best of {SIM_TIMED}; runs "
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


def _sim_knobs(algorithm, **kw):
    kw = dict(kw, algorithm=algorithm, n_reporters=SIM_R, n_events=SIM_E)
    if algorithm == "dbscan-jit":
        kw["dbscan_eps"] = SIM_ALGO_EPS
    return kw


def _loop_text(stats, n):
    """The inner loops' counts of one sweep: the passes (the slowest
    lane's, summed over the iterations) and the mean a lane."""
    names = {"orth_sweeps": "orthogonal-iteration sweeps",
             "ica_iters": "FastICA iterations",
             "kmeans_updates": "k-means updates",
             "dbscan_rounds": "propagation rounds"}
    return "; ".join(f"{label} {stats[key]} (slowest lane), "
                     f"{stats['lane_' + key] / n:.2f} a lane"
                     for key, label in names.items() if key in stats)


def sim_algorithms_phase(torch, args, ck, card, dev):
    """Phase 7's other algorithms: fixed-variance, ica, k-means and
    dbscan-jit (``SIM_ALGORITHMS``) on the recorded 10,000-trial sweep,
    each at ``max_iterations`` 1 and the first also at 5: one untimed
    warm-up, then ``SIM_TIMED`` timed runs ending in
    ``torch.cuda.synchronize()``,
    the storage kernels' launch counts set to 0 before and read after
    (each must read 0). Prints trials/s, peak memory and the inner loops'
    counts (the slowest lane's and the mean a lane). Then, for each,
    ``SIM_REPLAY`` lanes replayed through the ``Oracle`` on the card
    (exact metrics equal), a 1,000-trial sub-grid on the card against the
    CPU in float32, bit for bit (power, and eigh-cov for the two PCA
    algorithms: their eigensolves are float64 LAPACK calls on the host on
    either device), and for the first a ``CheckpointedSweep`` in
    ``SIM_CHUNK``-trial chunks equal to the monolithic run bit for
    bit."""
    import tempfile

    import numpy as np

    from pyconsensus_tpu_torch import Oracle
    from pyconsensus_tpu_torch.sim import (CheckpointedSweep,
                                           CollusionSimulator, _batched,
                                           collusion, generate_reports)

    n = len(SIM_LF) * len(SIM_VAR) * SIM_T
    shape = f"{SIM_R}x{SIM_E}, {n} trials"
    _, _, glf, gvar = collusion.flat_grid(SIM_LF, SIM_VAR, SIM_T)
    keys = collusion._fold_keys(args.seed, np.arange(n))
    x, _, _ = generate_reports(
        keys, torch.as_tensor(glf, dtype=torch.float32, device=dev),
        torch.as_tensor(gvar, dtype=torch.float32, device=dev), SIM_R,
        SIM_E)
    rep0 = torch.full((n, SIM_R), 1.0 / SIM_R, device=dev)
    for algo in SIM_ALGORITHMS:
        mono = None
        for mi in ((1, 5) if algo == SIM_ALGORITHMS[0] else (1,)):
            sim = CollusionSimulator(**_sim_knobs(algo, max_iterations=mi))
            sim.run(SIM_LF, SIM_VAR, SIM_T, seed=args.seed)   # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ck.reset_launch_counts()
            secs = []
            for _ in range(SIM_TIMED):
                t0 = time.perf_counter()
                res = sim.run(SIM_LF, SIM_VAR, SIM_T, seed=args.seed)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            counts = ck.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            mono = mono or res
            if any(counts.values()):
                raise RuntimeError(f"{algo} sweep max_iterations={mi}: "
                                   f"storage kernels launched {counts}")
            for key in ("correct_rate", "capture_rate", "liar_rep_share"):
                if not np.isfinite(res[key]).all():
                    raise RuntimeError(f"{algo} sweep: {key} is not finite")
            stats = {}
            _batched.iterate(x, rep0, sim.params, stats)
            mean = res["mean"]
            log(f"{algo} sweep {shape} max_iterations={mi}: "
                f"{n / min(secs):.1f} trials/s (best of {SIM_TIMED}; runs "
                f"{', '.join(f'{t:.4f}' for t in secs)} s) on {card}; peak "
                f"{peak:.3f} GiB; {_loop_text(stats, n) or 'no inner loop'}"
                f"; mean correct_rate by liar fraction "
                f"{np.round(mean['correct_rate'].mean(1), 4).tolist()}; "
                f"liar_rep_share by liar fraction "
                f"{np.round(mean['liar_rep_share'].mean(1), 4).tolist()}; "
                f"converged {float(res['converged'].mean()):.4f}; storage "
                f"kernel launches {sum(counts.values())}")
            if float(mean["correct_rate"][0].min()) < 0.9:
                raise RuntimeError(f"{algo} sweep: mean correct_rate at "
                                   "liar fraction 0 is under 0.9")

        # lanes replayed through the Oracle on the card
        idx = np.linspace(0, n - 1, SIM_REPLAY).astype(np.int64)
        flat = {k: mono[k].reshape(n) for k in
                ("correct_rate", "capture_rate", "ambiguous_rate",
                 "converged", "iterations", "liar_rep_share")}
        knobs = _sim_knobs(algo, max_iterations=1)
        okw = {k: knobs[k] for k in ("algorithm", "dbscan_eps")
               if k in knobs}
        worst = 0.0
        for j, i in enumerate(idx):
            xi, truth, liar = generate_reports(keys[i], float(glf[i]),
                                               float(gvar[i]), SIM_R, SIM_E)
            r = Oracle(reports=xi.cpu().numpy(), pca_method="power",
                       power_iters=64, max_iterations=1, **okw).consensus()
            out = np.asarray(r["events"]["outcomes_final"],
                             dtype=np.float32)
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
                    raise RuntimeError(f"{algo} lane {i} replayed through "
                                       f"the Oracle: {key} {v} != "
                                       f"{flat[key][i]}")
            share = float(np.asarray(r["agents"]["smooth_rep"])[
                liar.cpu().numpy()].sum())
            worst = max(worst, abs(share - float(flat["liar_rep_share"][i])))
        log(f"{algo}: {SIM_REPLAY} sweep lanes replayed through Oracle("
            f"algorithm={algo!r}) on {card}: exact metrics equal, "
            f"liar_rep_share max |diff| {worst:.3e}")

        # a 1,000-trial sub-grid: the card against the CPU
        sub_lf, sub_t = (0.1, 0.3), 250
        for pca in (("power", "eigh-cov") if algo in SIM_ALGORITHMS[:2]
                    else ("power",)):
            kw = _sim_knobs(algo, max_iterations=SIM_ALGO_SUB_ITERS,
                            pca_method=pca)
            t0 = time.perf_counter()
            a = CollusionSimulator(**kw).run(sub_lf, SIM_VAR, sub_t,
                                             seed=args.seed)
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            b = CollusionSimulator(device="cpu", **kw).run(
                sub_lf, SIM_VAR, sub_t, seed=args.seed)
            t_cpu = time.perf_counter() - t0
            for key in a:
                if key != "mean" and not np.array_equal(a[key], b[key]):
                    raise RuntimeError(f"{algo} {pca} sub-grid card vs cpu "
                                       f"(float32): {key} differs")
            log(f"{algo} sub-grid {SIM_R}x{SIM_E} 1000 trials "
                f"max_iterations={SIM_ALGO_SUB_ITERS} {pca}: card and cpu "
                f"(float32) equal bit for bit (card {t_card:.3f} s, cpu "
                f"{t_cpu:.3f} s)")

        if algo == SIM_ALGORITHMS[0]:
            sim = CollusionSimulator(**_sim_knobs(algo, max_iterations=1))
            with tempfile.TemporaryDirectory() as d:
                t0 = time.perf_counter()
                sweep = CheckpointedSweep(sim, SIM_LF, SIM_VAR, SIM_T,
                                          seed=args.seed, checkpoint_dir=d,
                                          trials_per_chunk=SIM_CHUNK)
                done = sweep.run()
                got = sweep.gather()
                t_sweep = time.perf_counter() - t0
            for key in mono:
                if key != "mean" and not np.array_equal(got[key],
                                                        mono[key]):
                    raise RuntimeError(f"{algo} CheckpointedSweep: {key} "
                                       "differs from the monolithic run")
            log(f"{algo} CheckpointedSweep {shape} in {done} chunks of "
                f"{SIM_CHUNK}: {t_sweep:.3f} s; equal to the monolithic run "
                "bit for bit")
    del x, rep0


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

    # 1. the recorded serve block: the padded micro-batching tier on one
    # device (every service of this phase is single-device, whatever
    # cards the machine holds)
    cfg = ServeConfig(batch_window_ms=2.0, max_batch=8,
                      pallas_buckets=False, sharded_buckets=False)
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
                                       pallas_buckets=True,
                                       sharded_buckets=False),
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
    svc = ConsensusService(ServeConfig(sharded_buckets=False),
                           device=dev).start()
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
            incremental_sessions=incremental, sharded_buckets=False),
            device=dev).start()
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


def fleet_phase(torch, ck, card, dev, launches, seed, here,
                request=FLEET_REQUEST, requests=FLEET_REQUESTS,
                session_r=FLEET_SESSION_R, block_e=FLEET_SESSION_E,
                cli_args=FLEET_CLI, cfg=None, cards=None):
    """The replicated serve fleet on the card (``serve/fleet.py``), each
    number beside ``card``:

    1. ``requests`` all-binary ``request`` matrices (``FLEET_NA``
       absent) from ``FLEET_CONCURRENCY`` closed-loop clients through a
       ``FLEET_WORKERS``-worker fleet under the default ``ServeConfig``,
       then through one ``ConsensusService`` of the same config:
       requests/s, p50 and p99 of each, B.1, B.2 and B.3 launches a
       request (each must launch), every result bit for bit the direct
       fused ``ShardedOracle``;
    2. the same block through a fresh fleet with ``kill_worker("w1")``
       after the ``FLEET_KILL_AFTER``-th completion, the clients retrying
       the retryable sheds (PYC401/501/502, the load generator's waits,
       ``FLEET_RETRIES`` a request): the sheds by code, the retries,
       abandoned (must be 0), p50 and p99 of the requests in flight
       during the takeover window against the others, the seconds from
       the kill to the first result of a request the kill shed less its
       retry waits, every result bit for bit;
    3. a durable session of ``session_r`` reporters, blocks of
       ``block_e`` events, ``FLEET_SESSION_ROUNDS`` rounds of two appends
       and a resolve, its owner killed after round 2's first append: the
       takeover's seconds, a standalone verify and replay of the log, and
       every resolve bit for bit a never-killed session of the same
       call;
    4. ``python -m pyconsensus_tpu_torch.serve.cli`` with ``cli_args``
       as a subprocess: exit 0, failed 0, abandoned 0, ``cuda`` in its
       kernel-path block;
    5. the socket fleet (``serve/transport``), one worker process a card
       of ``cards`` (None: ``FLEET_WORKERS`` processes on card 0; at
       least ``FLEET_WORKERS`` workers): :func:`_socket_fleet_part`.

    ``dev`` may be the CPU for a rehearsal (then nothing launches; pass
    ``cfg=ServeConfig(pallas_buckets=True)`` so the requests ride the
    class's plain versions; the socket workers run on the CPU). The
    replication logs live under ``OUT_DIR`` while the phase runs and are
    removed after it."""
    import tempfile

    log_root = tempfile.mkdtemp(prefix="fleet-", dir=os.path.join(
        here, OUT_DIR))
    try:
        _fleet_parts(torch, ck, card, dev, launches, seed, here, request,
                     requests, session_r, block_e, cli_args, cfg, log_root,
                     cards)
    finally:
        shutil.rmtree(log_root, ignore_errors=True)


def _fleet_parts(torch, ck, card, dev, launches, seed, here, request,
                 requests, session_r, block_e, cli_args, cfg, log_root,
                 cards):
    """The five parts of :func:`fleet_phase` over the log root
    ``log_root``."""
    import concurrent.futures
    import tempfile
    import threading

    import numpy as np

    from pyconsensus_tpu_torch import ShardedOracle
    from pyconsensus_tpu_torch.serve import (ConsensusFleet,
                                             ConsensusService, FleetConfig,
                                             LoadGenerator, MarketSession,
                                             ReplicationLog, ServeConfig,
                                             replay_session)
    from pyconsensus_tpu_torch.serve.loadgen import RETRYABLE_CODES

    on_card = dev.type == "cuda"
    rng = np.random.default_rng(seed + 20)
    R, E = request
    mats = [serve_reports(rng, R, E, na_frac=FLEET_NA)[0]
            for _ in range(FLEET_DISTINCT)]
    want = [ShardedOracle(m, pca_method="power", device=dev).consensus()
            for m in mats]
    cfg = cfg or ServeConfig()

    def counted():
        counts = ck.launch_counts()
        for k in counts:
            launches[k] += counts[k]
        return counts

    def exact(got, i, what):
        served_close(got, want[i % FLEET_DISTINCT], 0.0,
                     f"{what} request {i}", exact_all=True)

    def closed_loop(front, kill=None):
        """``requests`` requests from the clients; returns latencies (ms),
        results, wall seconds and the retry tally (with each request's
        start and end, and the first shed request's retry waits)."""
        lat = [0.0] * requests
        results = [None] * requests
        tally = {"sheds": {}, "retried": 0, "abandoned": 0,
                 "completed": 0, "t_kill": None, "after_kill": None,
                 "after_kill_waits": None, "spans": [None] * requests}
        lock = threading.Lock()
        pacer = LoadGenerator(None, shapes=((1, 1),), seed=seed)

        def one(i):
            t0 = time.perf_counter()
            shed, waits = False, 0.0
            for attempt in range(FLEET_RETRIES + 1):
                try:
                    results[i] = front.submit(
                        reports=mats[i % FLEET_DISTINCT]).result(
                            timeout=300)
                    break
                except Exception as exc:  # noqa: BLE001 — tallied
                    code = getattr(exc, "error_code", None)
                    if code not in RETRYABLE_CODES:
                        raise
                    with lock:
                        tally["sheds"][code] = tally["sheds"].get(code,
                                                                  0) + 1
                        if attempt == FLEET_RETRIES:
                            tally["abandoned"] += 1
                            return
                        tally["retried"] += 1
                    shed = True
                    wait = pacer._retry_delay(exc, i, attempt)
                    waits += wait
                    time.sleep(wait)
            now = time.perf_counter()
            lat[i] = 1e3 * (now - t0)
            tally["spans"][i] = (t0, now)
            with lock:
                tally["completed"] += 1
                if (shed and tally["t_kill"] is not None
                        and tally["after_kill"] is None):
                    tally["after_kill"] = now - tally["t_kill"]
                    tally["after_kill_waits"] = waits
                fire = (kill is not None
                        and tally["completed"] == FLEET_KILL_AFTER)
                if fire:
                    tally["t_kill"] = now
            if fire:            # outside the lock: the other clients'
                kill()          # completions go on during the takeover

        def client(c):
            for i in range(c, requests, FLEET_CONCURRENCY):
                one(i)

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(
                FLEET_CONCURRENCY) as pool:
            list(pool.map(client, range(FLEET_CONCURRENCY)))
        return lat, results, time.perf_counter() - t0, tally

    def warm(services):
        # the default config builds the class's key at a shape's first
        # request: one untimed request through each worker's front door
        for svc in services:
            svc.resolve(reports=mats[0], timeout=300)

    # 1. the fleet beside one service, same config, same requests
    rates, tails = {}, {}
    for label in ("fleet", "one service"):
        if label == "fleet":
            front = ConsensusFleet(FleetConfig(
                n_workers=FLEET_WORKERS, log_dir=log_root, worker=cfg),
                device=dev)
            front.start()
            warm([w.service for w in front.workers.values()])
        else:
            front = ConsensusService(cfg, device=dev).start()
            warm([front])
        if on_card:
            torch.cuda.synchronize()
        ck.reset_launch_counts()
        try:
            lat, results, wall, _ = closed_loop(front)
        finally:
            front.close(drain=True)
        counts = counted()
        per = {k: counts[k] / requests for k in CUDA_TIER_KERNELS}
        if on_card and not all(counts[k] >= requests
                               for k in CUDA_TIER_KERNELS):
            raise RuntimeError(f"{label}: a kernel of the class was not "
                               f"launched by every request: {counts}")
        for i, got in enumerate(results):
            exact(got, i, label)
        rates[label] = requests / wall
        tails[label] = (percentile(lat, 0.5), percentile(lat, 0.99))
        log(f"{label} ({FLEET_WORKERS if label == 'fleet' else 1} "
            f"worker(s), default ServeConfig): {requests} {R}x{E} binary "
            f"requests at concurrency {FLEET_CONCURRENCY}: "
            f"{rates[label]:.4f} requests/s, p50 {percentile(lat, 0.5):.3f}"
            f" ms, p99 {percentile(lat, 0.99):.3f} ms; launches a request "
            f"B.1 {per['apply_weighted_cov']:.2f}, B.2 "
            f"{per['scores_dirfix_pass']:.2f}, B.3 "
            f"{per['resolve_certainty_fused']:.2f}; every result bit for "
            f"bit the direct fused ShardedOracle on {card}")
    log(f"fleet / one service: {rates['fleet'] / rates['one service']:.4f}"
        f"x requests/s on {card}")

    # 2. the same block with a worker killed mid-traffic
    fleet = ConsensusFleet(FleetConfig(n_workers=FLEET_WORKERS,
                                       log_dir=log_root, worker=cfg),
                           device=dev)
    fleet.start()
    warm([w.service for w in fleet.workers.values()])
    killed = {}
    ck.reset_launch_counts()
    try:
        lat, results, wall, tally = closed_loop(
            fleet, kill=lambda: killed.update(fleet.kill_worker("w1")))
        status = fleet.status()
    finally:
        fleet.close(drain=True)
    counts = counted()
    if tally["abandoned"] or not killed or status["workers"]["w1"]["alive"]:
        raise RuntimeError(f"kill mid-traffic: abandoned "
                           f"{tally['abandoned']}, kill {killed}, status "
                           f"{status}")
    for i, got in enumerate(results):
        exact(got, i, "kill mid-traffic")
    after, waits = tally["after_kill"], tally["after_kill_waits"]
    # the takeover window: the kill to the end of the retry hint it sets
    w0 = tally["t_kill"]
    w1 = w0 + fleet.config.takeover_window_s
    inside = [lat[i] for i, (a, b) in enumerate(tally["spans"])
              if a <= w1 and b >= w0]
    outside = [lat[i] for i, (a, b) in enumerate(tally["spans"])
               if not (a <= w1 and b >= w0)]

    def tail(xs):
        return (f"n {len(xs)}, p50 {percentile(xs, 0.5):.3f} ms, p99 "
                f"{percentile(xs, 0.99):.3f} ms" if xs else "n 0")

    log(f"fleet with kill_worker('w1') after completion "
        f"{FLEET_KILL_AFTER}: {requests} requests in {wall:.3f} s "
        f"({requests / wall:.4f} requests/s, p50 "
        f"{percentile(lat, 0.5):.3f} ms, p99 {percentile(lat, 0.99):.3f} "
        f"ms); queued shed at the kill {killed['shed_queued']}, sheds by "
        f"code {tally['sheds'] or 'none'}, retries {tally['retried']}, "
        f"abandoned 0; requests in flight during the takeover window "
        f"({fleet.config.takeover_window_s} s from the kill): "
        f"{tail(inside)}; the others: {tail(outside)}; kill to the first "
        f"result of a shed request "
        + (f"{after:.4f} s, of which its retry waits {waits:.4f} s, so "
           f"{after - waits:.4f} s the fleet's own" if after is not None
           else "n/a (none shed)")
        + f"; every result bit for bit the direct fused ShardedOracle; "
        f"{launch_text(counts)} on {card}")

    # 3. a durable session killed mid-round, against a never-killed one
    blocks = [[serve_reports(rng, session_r, block_e)[0] for _ in range(2)]
              for _ in range(FLEET_SESSION_ROUNDS)]
    whole = MarketSession("ref", session_r, device=dev)
    want_rounds = []
    for rnd in blocks:
        for b in rnd:
            whole.append(b)
        want_rounds.append(whole.resolve())
    fleet = ConsensusFleet(FleetConfig(n_workers=FLEET_WORKERS,
                                       log_dir=log_root, worker=cfg),
                           device=dev)
    fleet.start()
    ck.reset_launch_counts()
    try:
        fleet.create_session("market", n_reporters=session_r)
        got, take = [], None
        for k, rnd in enumerate(blocks):
            for j, b in enumerate(rnd):
                fleet.append("market", b)
                if k == 1 and j == 0:
                    victim = fleet.owner_of("market")
                    t0 = time.perf_counter()
                    info = fleet.kill_worker(victim)
                    if on_card:
                        torch.cuda.synchronize()
                    take = time.perf_counter() - t0
            got.append(fleet.submit(session="market").result(timeout=300))
        owner = fleet.owner_of("market")
    finally:
        fleet.close(drain=True)
    counts = counted()
    if info["sessions_migrated"] != [("market", owner)]:
        raise RuntimeError(f"session takeover: {info}, owner {owner}")
    for k, (g, w) in enumerate(zip(got, want_rounds)):
        for path, key in (("agents", "smooth_rep"), ("agents", "old_rep"),
                          ("events", "outcomes_final"),
                          ("events", "outcomes_adjusted")):
            if not np.array_equal(np.asarray(g[path][key]),
                                  np.asarray(w[key])):
                raise RuntimeError(f"session round {k}: {key} is not the "
                                   f"never-killed session's bits")
        if int(g["iterations"]) != int(np.asarray(w["iterations"])):
            raise RuntimeError(f"session round {k}: iterations differ")
    # the log after the run holds the last committed round: verify and
    # replay it standalone, timed
    t0 = time.perf_counter()
    summary = ReplicationLog(log_root, "market").verify()
    t_verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    standby = replay_session(log_root, "market", device=dev)
    if on_card:
        torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    if not np.array_equal(standby.reputation, whole.reputation):
        raise RuntimeError("session: the replayed reputation is not the "
                           "never-killed session's")
    log(f"durable session {session_r} reporters x blocks of {block_e} "
        f"events, {FLEET_SESSION_ROUNDS} rounds, owner {victim} killed "
        f"after round 2's first append: takeover (fence, verify, replay "
        f"of 1 block, adopt) {take:.4f} s; standalone verify "
        f"{t_verify:.4f} s and replay {t_replay:.4f} s of the final log "
        f"({summary['round']} rounds); every resolve bit for bit the "
        f"never-killed session's; {launch_text(counts)} on {card}")

    # 4. the serve command line
    with tempfile.TemporaryDirectory(dir=os.path.join(here, OUT_DIR)) as d:
        args = [*cli_args, "--log-dir", d]
        if not on_card:
            args += ["--device", "cpu"]
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "pyconsensus_tpu_torch.serve.cli",
             *args], capture_output=True, text=True, cwd=here, timeout=600)
        secs = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"serve cli exited {run.returncode}:\n"
                           f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
    stats = json.loads(run.stdout[run.stdout.index("{"):])
    paths = stats.get("kernel_paths") or {}
    if stats["failed"] or stats["abandoned"] or (on_card
                                                 and "cuda" not in paths):
        raise RuntimeError(f"serve cli: failed {stats['failed']}, "
                           f"abandoned {stats['abandoned']}, kernel paths "
                           f"{paths}")
    sweeps = stats["kernel_launches"].get("apply_weighted_cov", 0)
    log(f"pyconsensus_tpu_torch.serve.cli {' '.join(cli_args)}: exit 0 in "
        f"{secs:.3f} s, {stats['warmed_executables']} executables warmed "
        f"before the timed run, {stats['succeeded']} succeeded, failed 0, "
        f"abandoned 0, {stats['throughput_rps']} requests/s, p50 "
        f"{stats['latency_p50_ms']} ms, p99 {stats['latency_p99_ms']} ms, "
        f"kernel paths {paths}, B.1 {sweeps / max(1, stats['succeeded']):.2f}"
        f" launches a request (warm-up included) on {card}")

    # 5. the socket fleet: one worker process a card
    _socket_fleet_part(torch, card, dev, launches, here, request, requests,
                       cli_args, cfg, log_root, cards, mats, want, rates,
                       tails, closed_loop, exact, blocks, want_rounds,
                       session_r, block_e)


def _hist_delta(after, before, name, **labels):
    """``name``'s histogram series of ``labels`` in two registry
    snapshots: (count, sum, median bucket's upper edge in seconds) of what
    was observed between them."""
    key = json.dumps(labels, sort_keys=True) if labels else ""
    a = after.get(name, {}).get("series", {}).get(key)
    if a is None:
        return 0, 0.0, None
    b = before.get(name, {}).get("series", {}).get(
        key, {"count": 0, "sum": 0.0, "counts": [0] * len(a["counts"])})
    counts = [x - y for x, y in zip(a["counts"], b["counts"])]
    n = a["count"] - b["count"]
    edges = list(after[name]["edges"]) + [float("inf")]
    run, median = 0, None
    for edge, c in zip(edges, counts):
        run += c
        if 2 * run >= n and n:
            median = edge
            break
    return n, a["sum"] - b["sum"], median


def _series_sum(snapshot, name, worker_prefix=""):
    """The sum of ``name``'s counter series whose ``worker`` label starts
    with ``worker_prefix`` ("" for every series)."""
    total = 0.0
    for key, v in snapshot.get(name, {}).get("series", {}).items():
        labels = json.loads(key) if key else {}
        if str(labels.get("worker", "")).startswith(worker_prefix):
            total += float(v)
    return total


def _socket_fleet_part(torch, card, dev, launches, here, request, requests,
                       cli_args, cfg, log_root, cards, mats, want, rates,
                       tails, closed_loop, exact, blocks, want_rounds,
                       session_r, block_e):
    """Part 5 of :func:`fleet_phase`: the socket fleet
    (``serve/transport``), each number beside ``card``.

    a. ``max(len(cards), FLEET_WORKERS)`` worker processes, one a card of
       ``cards`` in turn (None: all on card 0; every worker on the CPU off
       the card), each warmed by one untimed request; the part-1 block
       (``requests`` requests at ``FLEET_CONCURRENCY``) through it:
       requests/s, p50, p99 beside part 1's in-process fleet and one
       service; B.1, B.2 and B.3 launches a request read from the
       workers' ``stats`` (each must launch); the wire codec, the router's
       wire bytes a request sent and received
       (``pyconsensus_transport_bytes_total``) and the median and mean
       ``pyconsensus_transport_rpc_seconds{method="submit"}``; every
       result bit for bit the direct fused ``ShardedOracle``; the merged
       metric view's per-worker labels and request total against the sum
       of the workers' own; after a graceful close, ``obs.merge_jsonl``
       over the router's and each worker's span file: every traced
       request's worker span under its router parent;
    b. a fresh socket fleet with ``w1``'s process SIGKILLed
       (``kill_worker``) after the ``FLEET_KILL_AFTER``-th completion:
       sheds by code, retries, abandoned (must be 0), the seconds from the
       kill to a shed request's result; then, on the survivors, part 3's
       durable session with its owner's process SIGKILLed after round 2's
       first append: the standby adopts the shipped log, every resolve
       bit for bit the never-killed session's;
    c. the serve command line with ``--transport socket`` as a
       subprocess: exit 0, failed 0, abandoned 0, ``cuda`` in its kernel
       paths (the workers')."""
    import glob
    import tempfile

    import numpy as np

    from pyconsensus_tpu_torch import obs
    from pyconsensus_tpu_torch.serve import ConsensusFleet, FleetConfig
    from pyconsensus_tpu_torch.serve.transport import SocketTransport, wire

    on_card = dev.type == "cuda"
    placement = list(cards) if cards else [0]
    n = max(len(placement), FLEET_WORKERS)
    where = (f"{n} worker processes on the CPU" if not on_card else
             f"{n} worker processes on card 0" if len(placement) == 1 else
             f"{n} worker processes over cards {placement}")
    R, E = request

    def socket_fleet(sub):
        transport = SocketTransport(devices=placement) if on_card \
            else "socket"
        t0 = time.perf_counter()
        fleet = ConsensusFleet(FleetConfig(
            n_workers=n, transport=transport, worker=cfg,
            log_dir=os.path.join(log_root, sub)), device=dev).start()
        boot = time.perf_counter() - t0
        # one untimed request through each worker, all at once (the
        # class's key builds at a shape's first request)
        t0 = time.perf_counter()
        for fut in [w.submit_stateless(mats[0], tenant="warm")
                    for w in fleet.workers.values()]:
            fut.result(timeout=300)
        return fleet, boot, time.perf_counter() - t0

    def worker_launches(fleet):
        """Each live worker's launch counts, by name."""
        return {name: w.call("stats")["launches"]
                for name, w in fleet.workers.items() if w.alive}

    def add_launches(after, before):
        """The launches of the workers alive at both reads, between
        them (a SIGKILLed worker's are gone with it)."""
        counts = {k: sum(int(after[w][k]) - int(before[w][k])
                         for w in after if w in before) for k in KERNELS}
        for k in counts:
            launches[k] += counts[k]
        return counts

    # a. the block through the socket fleet, its wire, metrics and spans
    old_source = obs.TRACER.source
    obs.TRACER.source = "router"
    try:
        fleet, boot, warm_s = socket_fleet("a")
        try:
            stats = {name: w.call("stats")
                     for name, w in sorted(fleet.workers.items())}
            before = worker_launches(fleet)
            snap0 = obs.REGISTRY.snapshot()
            lat, results, wall, _ = closed_loop(fleet)
            snap1 = obs.REGISTRY.snapshot()
            # at FleetConfig's heartbeat bound, no live worker declared
            # dead under this traffic
            declared = sorted(name for name, w in fleet.workers.items()
                              if not w.alive)
            counts = add_launches(worker_launches(fleet), before)
            merged = fleet.merged_snapshot()
            own = sum(_series_sum(w.metrics_snapshot()["metrics"],
                                  "pyconsensus_serve_requests_total")
                      for w in fleet.workers.values())
        finally:
            fleet.close(drain=True)
        router_events = [ev for ev in obs.events()
                         if ev.get("source") == "router"]
    finally:
        obs.TRACER.source = old_source
    if declared:
        raise RuntimeError(f"socket fleet: live workers {declared} were "
                           f"declared dead under load")
    per = {k: counts[k] / requests for k in CUDA_TIER_KERNELS}
    if on_card and not all(counts[k] >= requests for k in CUDA_TIER_KERNELS):
        raise RuntimeError(f"socket fleet: a kernel of the class was not "
                           f"launched by every request in the workers: "
                           f"{counts}")
    for i, got in enumerate(results):
        exact(got, i, "socket fleet")
    pinned = {name: (st["device"], st["visible_devices"])
              for name, st in stats.items()}
    by_dir = {d: (snap1["pyconsensus_transport_bytes_total"]["series"]
                  .get(json.dumps({"direction": d}), 0)
                  - snap0.get("pyconsensus_transport_bytes_total", {})
                  .get("series", {}).get(json.dumps({"direction": d}), 0))
              for d in ("sent", "received")}
    n_rpc, sum_rpc, med_rpc = _hist_delta(
        snap1, snap0, "pyconsensus_transport_rpc_seconds", method="submit")
    if n_rpc < requests or by_dir["sent"] <= 0:
        raise RuntimeError(f"socket fleet: {n_rpc} submit RPCs timed, "
                           f"{by_dir} wire bytes for {requests} requests")
    rate = requests / wall
    log(f"socket fleet ({where}, each pinned: {pinned}; boot "
        f"{boot:.3f} s, one warm request each {warm_s:.3f} s): {requests} "
        f"{R}x{E} binary requests at concurrency {FLEET_CONCURRENCY}: "
        f"{rate:.4f} requests/s, p50 {percentile(lat, 0.5):.3f} ms, p99 "
        f"{percentile(lat, 0.99):.3f} ms; beside the in-process fleet "
        f"{rates['fleet']:.4f} requests/s (p50 {tails['fleet'][0]:.3f}, "
        f"p99 {tails['fleet'][1]:.3f} ms) and one service "
        f"{rates['one service']:.4f} (p50 {tails['one service'][0]:.3f}, "
        f"p99 {tails['one service'][1]:.3f} ms): socket / in-process "
        f"{rate / rates['fleet']:.4f}x, socket / one service "
        f"{rate / rates['one service']:.4f}x; launches a request in the "
        f"workers B.1 {per['apply_weighted_cov']:.2f}, B.2 "
        f"{per['scores_dirfix_pass']:.2f}, B.3 "
        f"{per['resolve_certainty_fused']:.2f}; every result bit for bit "
        f"the direct fused ShardedOracle on {card}")
    log(f"socket fleet wire: codec {wire.codec_name()}; router wire bytes "
        f"a request sent {by_dir['sent'] / requests:.0f}, received "
        f"{by_dir['received'] / requests:.0f} (heartbeats included); "
        f"pyconsensus_transport_rpc_seconds{{method=\"submit\"}} over "
        f"{n_rpc} calls: median bucket <= {med_rpc} s, mean "
        f"{sum_rpc / n_rpc:.4f} s")
    series = merged["pyconsensus_serve_requests_total"]["series"]
    labels = {json.loads(k).get("worker") for k in series}
    merged_total = _series_sum(merged, "pyconsensus_serve_requests_total",
                               "w")
    # the timed requests and one warm-up request a worker
    if not set(stats) <= labels or merged_total != own \
            or merged_total != requests + n:
        raise RuntimeError(f"merged view: worker labels {labels}, worker "
                           f"total {merged_total} against their own {own} "
                           f"and {requests} + {n} requests sent")
    files = sorted(glob.glob(os.path.join(log_root, "a", "*",
                                          "trace-*.jsonl")))
    forest = obs.trace_forest(obs.merge_jsonl(files) + router_events)
    roots = [r for rs in forest.values() for r in rs]

    def walk(node):
        yield node
        for c in node["children"]:
            yield from walk(c)
    mine = [r for r in roots if r["source"] == "router"
            and r["name"] == "fleet.submit"]
    crossed = sum(any(s["name"] == "rpc.submit" and s["source"] in stats
                      for s in walk(r)) for r in mine)
    orphans = [r for r in roots if r["source"] in stats]
    if len(files) != n or len(mine) != requests or crossed != requests \
            or orphans:
        raise RuntimeError(f"trace forest: {len(files)} worker files, "
                           f"{len(mine)} router roots, {crossed} with a "
                           f"worker span, {len(orphans)} worker roots")
    log(f"socket fleet telemetry: the merged view labels workers "
        f"{sorted(labels)}, its worker request total {merged_total:.0f} = "
        f"the workers' own {own:.0f} = {requests} timed + {n} warm-up; obs.merge_jsonl over {len(files)} "
        f"worker trace files and the router's spans: {crossed} of "
        f"{requests} traced requests rebuild their worker's rpc.submit span "
        f"under the router's fleet.submit, 0 worker spans without their "
        f"router parent")

    # b. a worker process SIGKILLed mid-traffic, then a session's owner
    fleet, boot, _ = socket_fleet("b")
    killed = {}
    try:
        before = worker_launches(fleet)
        lat, results, wall, tally = closed_loop(
            fleet, kill=lambda: killed.update(fleet.kill_worker("w1")))
        counts = add_launches(worker_launches(fleet), before)
        fleet.create_session("market", n_reporters=session_r)
        got, take, info, victim = [], None, None, None
        for k, rnd in enumerate(blocks):
            for j, b in enumerate(rnd):
                fleet.append("market", b)
                if k == 1 and j == 0:
                    victim = fleet.owner_of("market")
                    t0 = time.perf_counter()
                    info = fleet.kill_worker(victim)
                    take = time.perf_counter() - t0
            got.append(fleet.submit(session="market").result(timeout=300))
        owner = fleet.owner_of("market")
        status = fleet.status()
    finally:
        fleet.close(drain=True)
    declared = sorted(name for name, st in status["workers"].items()
                      if not st["alive"] and name not in ("w1", victim))
    if tally["abandoned"] or not killed or status["workers"]["w1"]["alive"] \
            or declared:
        raise RuntimeError(f"socket kill mid-traffic: abandoned "
                           f"{tally['abandoned']}, kill {killed}, live "
                           f"workers declared dead {declared}, status "
                           f"{status}")
    for i, res in enumerate(results):
        exact(res, i, "socket kill mid-traffic")
    if info["sessions_migrated"] != [("market", owner)] or owner == victim:
        raise RuntimeError(f"socket session takeover: {info}, owner "
                           f"{owner}")
    for k, (g, w) in enumerate(zip(got, want_rounds)):
        for path, key in (("agents", "smooth_rep"), ("agents", "old_rep"),
                          ("events", "outcomes_final"),
                          ("events", "outcomes_adjusted")):
            if not np.array_equal(np.asarray(g[path][key]),
                                  np.asarray(w[key])):
                raise RuntimeError(f"socket session round {k}: {key} is "
                                   f"not the never-killed session's bits")
    after, waits = tally["after_kill"], tally["after_kill_waits"]
    log(f"socket fleet with w1's process SIGKILLed after completion "
        f"{FLEET_KILL_AFTER} (boot {boot:.3f} s): {requests} requests in "
        f"{wall:.3f} s ({requests / wall:.4f} requests/s, p50 "
        f"{percentile(lat, 0.5):.3f} ms, p99 {percentile(lat, 0.99):.3f} "
        f"ms); sheds by code {tally['sheds'] or 'none'}, retries "
        f"{tally['retried']}, abandoned 0; kill to the first result of a "
        f"shed request "
        + (f"{after:.4f} s, of which its retry waits {waits:.4f} s"
           if after is not None else "n/a (none shed)")
        + f"; every result bit for bit the direct fused ShardedOracle; "
        f"{launch_text(counts)} in the surviving workers on {card}")
    log(f"socket durable session {session_r} reporters x blocks of "
        f"{block_e} events, {len(blocks)} rounds, owner {victim}'s process "
        f"SIGKILLed after round 2's first append: takeover (SIGKILL, "
        f"verify and adopt of the shipped log, replay of 1 block in "
        f"{owner}'s process) {take:.4f} s; every resolve bit for bit the "
        f"never-killed session's on {card}")

    # c. the serve command line over the socket transport
    args = [*cli_args, "--transport", "socket"]
    args[args.index("--fleet-workers") + 1] = str(n)
    if not on_card:
        args += ["--device", "cpu"]
    with tempfile.TemporaryDirectory(dir=os.path.join(here, OUT_DIR)) as d:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "pyconsensus_tpu_torch.serve.cli",
             *args, "--log-dir", d], capture_output=True, text=True,
            cwd=here, timeout=900)
        secs = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"socket serve cli exited {run.returncode}:\n"
                           f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
    cli = json.loads(run.stdout[run.stdout.index("{"):])
    paths = cli.get("kernel_paths") or {}
    declared = sorted(name for name, st in cli["fleet"]["workers"].items()
                      if not st["alive"])
    if cli["failed"] or cli["abandoned"] or declared or (
            on_card and "cuda" not in paths):
        raise RuntimeError(f"socket serve cli: failed {cli['failed']}, "
                           f"abandoned {cli['abandoned']}, live workers "
                           f"declared dead {declared}, kernel paths "
                           f"{paths}")
    sweeps = cli["kernel_launches"].get("apply_weighted_cov", 0)
    log(f"pyconsensus_tpu_torch.serve.cli {' '.join(args)}: exit 0 "
        f"in {secs:.3f} s, {cli['warmed_executables']} executables warmed "
        f"in the workers before the timed run, {cli['succeeded']} "
        f"succeeded, failed 0, abandoned 0, {cli['throughput_rps']} "
        f"requests/s, p50 {cli['latency_p50_ms']} ms, p99 "
        f"{cli['latency_p99_ms']} ms, kernel paths {paths}, B.1 "
        f"{sweeps / max(1, cli['succeeded']):.2f} launches a request in "
        f"the workers (warm-up included) on {card}")


def _package_copy(here, dest):
    """A copy of the package with no built library and no bytecode (a
    fresh checkout's state), at ``dest``; returns ``dest``."""
    shutil.copytree(os.path.join(here, "pyconsensus_tpu_torch"),
                    os.path.join(dest, "pyconsensus_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    return dest


#: every process the state-plane phase starts, stopped by :func:`main`
#: on any way out
_STARTED = []


class _Child:
    """One process the state-plane phase starts, with its standard
    output read line by line into ``lines`` (a queue) and its standard
    error kept; ``ready_s`` is the seconds from its start to its first
    ``READY`` line."""

    def __init__(self, name, cmd, cwd, env):
        import queue
        import threading

        self.name = name
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=cwd, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE)
        _STARTED.append(self)
        self.lines = queue.Queue()
        self.port, self.ready_s, self.err = None, None, []
        self._ready = threading.Event()
        threading.Thread(target=self._out, daemon=True).start()
        threading.Thread(target=self._errs, daemon=True).start()

    def _out(self):
        for line in self.proc.stdout:
            if line.startswith("READY ") and self.port is None:
                self.port = int(line.split()[1])
                self.ready_s = time.perf_counter() - self.t0
                self._ready.set()
            self.lines.put(line)
        self._ready.set()
        self.lines.put(None)

    def _errs(self):
        for line in self.proc.stderr:
            self.err.append(line)

    def failure(self):
        return (f"{self.name} exited {self.proc.poll()}: "
                f"{''.join(self.err[-40:])}")

    def client(self, torch, dev, timeout_s=WORKER_BOOT_TIMEOUT):
        """Wait for ``READY <port>`` and connect to the worker (the
        handshake compares this process's fingerprint field by field)."""
        from pyconsensus_tpu_torch.serve.transport.rpc import RpcClient
        from pyconsensus_tpu_torch.tune.fingerprint import \
            runtime_fingerprint

        if not self._ready.wait(timeout_s) or self.port is None:
            raise RuntimeError(f"never ready: {self.failure()}")
        return RpcClient("127.0.0.1", self.port, pool=2,
                         timeout_s=WORKER_BOOT_TIMEOUT, label=self.name,
                         expect_fingerprint=runtime_fingerprint(dev))

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


def _aot_worker(torch, name, copy, log_root, cfg, dev):
    """A ``pyconsensus-fleet-worker-torch`` process run from the package
    copy ``copy`` (its working directory and only package root, so
    nothing of this checkout is imported), pinned to card 0 on the
    card."""
    from pyconsensus_tpu_torch.serve.transport.supervisor import \
        worker_subprocess_env

    env = worker_subprocess_env(0 if dev.type == "cuda" else None)
    env["PYTHONPATH"] = copy
    cmd = [sys.executable, "-m",
           "pyconsensus_tpu_torch.serve.transport.worker",
           "--name", name, "--log-root", log_root,
           "--config-json", json.dumps(cfg), "--device", dev.type,
           "--dtype", str(torch.get_default_dtype()).split(".")[-1]]
    return _Child(name, cmd, copy, env)


def _aot_config(aot_shapes, **extra):
    """The workers' config: ``bucket_cuda`` warmed at ``aot_shapes``."""
    return {"warmup": [], "batch_window_ms": 1.0, "pallas_buckets": True,
            "pallas_warmup": [list(s) for s in aot_shapes], **extra}


def start_cold_worker(torch, dev, here, aot_shapes=LATENCY_SHAPES):
    """The state-plane phase's cold worker, started with the build: a
    worker process from an empty copy of the package and no store, so it
    runs ``nvcc`` on every source (beside the build of this checkout)
    before ``READY``. Returns ``(worker, root)``; the phase stops it and
    removes ``root``."""
    import tempfile

    stage, _, _, _ = staging_root(here)
    root = tempfile.mkdtemp(prefix="stateplane-", dir=stage)
    copy = _package_copy(here, os.path.join(root, "copy-cold"))
    return (_aot_worker(torch, "aot-cold", copy,
                        os.path.join(root, "log-cold"),
                        _aot_config(aot_shapes), dev), root)


def stateplane_phase(torch, ck, card, dev, launches, seed, here,
                     cold=None, aot_shapes=LATENCY_SHAPES,
                     request=(1024, 4096), requests=AOT_REQUESTS,
                     sessions=STATE_SESSIONS, hot=STATE_HOT, R=STATE_R,
                     block_e=STATE_BLOCK_E, hydrate=STATE_HYDRATE,
                     twins=STATE_TWINS, setup_procs=STATE_PROCS):
    """The state plane and the kernel-build store (``serve/stateplane.py``,
    ``serve/aotcache.py``), each number beside ``card``:

    a. the kernel store. This process warms ``bucket_cuda`` at
       ``aot_shapes`` with a store in a temporary directory (the keys and
       this checkout's libraries persisted). Three worker processes, each
       from its own copy of the package without ``csrc/build/``: the cold
       one (no store; ``cold``, started with the build by
       :func:`start_cold_worker`, runs ``nvcc`` on every source), the
       adopted one (the store) and the flipped one (a copy of the store
       with one byte of ``resolve.cu``'s library flipped). Printed: each
       one's compile-monitor events (the adopted worker: ``nvcc`` 0,
       ``store_adopt`` 2; the flipped one: the entry refused as
       ``digest``, that source built by ``nvcc``, the flipped bytes never
       installed), boot seconds and ``build_seconds()``, the first
       request's latency on the adopted and the cold worker, B.1, B.2 and
       B.3 launches a request in the adopted worker, and whether
       ``requests`` structured ``request`` matrices (2% absent) are bit
       for bit equal between the two workers and to the direct fused
       ``ShardedOracle``;
    b. the state plane. ``setup_procs`` processes give each of
       ``sessions`` durable sessions of ``R`` reporters one resolved round
       over a ``block_e``-event lattice block, then two more in its
       journal (about 2 GiB over all at full size), and compact it; a
       service with ``hot_sessions=hot`` adopts each as it is done (the
       takeover path: verify and replay), so it owns them all and holds
       ``hot``. Printed: the journal bytes before and after; then
       ``hydrate`` cold sessions in a seeded order hydrated (seconds, p50
       and p99) and resolved through the service, with
       ``pyconsensus_sessions_hot`` (at most ``hot``),
       ``pyconsensus_serve_sessions``, the peak device memory and the
       resolves' launch counts (the Gram eigh at ``R`` reporters: none);
       ``twins`` of them keep an uncompacted twin, and each resolve must
       equal its twin's replay bit for bit. Beside it, on a thread, a
       socket fleet of two workers compacts a session
       (``compact_journal_bytes=1``), ships the snapshot, and its owner's process
       is SIGKILLed: the standby adopts the shipped compacted log and
       resolves bit for bit the session's twin.

    The reference's "100k+ owned" sessions are cut to ``sessions`` by the
    phase's time. ``dev`` may be the CPU for a rehearsal (then nothing
    builds or launches; the compile events and launches are printed, not
    held). Everything the phase writes lives under the staging directory
    and is removed after it."""
    import concurrent.futures
    import hashlib
    import tempfile
    import threading

    import numpy as np

    from pyconsensus_tpu_torch import ShardedOracle, obs
    from pyconsensus_tpu_torch.ops import build
    from pyconsensus_tpu_torch.serve import (AotCache, ConsensusService,
                                             ServeConfig)

    on_card = dev.type == "cuda"
    stage, free, fstype, mount = staging_root(here)
    if cold is None:
        cold = start_cold_worker(torch, dev, here, aot_shapes)
    cold, root = cold
    log(f"state-plane root {root}: {free / 1e9:.3f} GB free ({fstype} at "
        f"{mount}); the reference's 100k+ owned sessions cut to "
        f"{sessions} by the phase's time")
    attached = build.attached_store()   # a service with a store attaches
    children = [cold]
    t_phase = time.perf_counter()
    try:
        store_dir = os.path.join(root, "aot")
        # a. 1: the keys and the libraries into the store
        t0 = time.perf_counter()
        svc = ConsensusService(ServeConfig(pallas_buckets=True,
                                           aot_cache_dir=store_dir),
                               device=dev)
        warmed = svc.warm_cuda_class(aot_shapes)
        svc.close(drain=False)
        store = AotCache(store_dir, device=dev)
        log(f"store primed with {warmed} bucket_cuda keys at "
            f"{', '.join(f'{r}x{e}' for r, e in aot_shapes)} in "
            f"{time.perf_counter() - t0:.3f} s: "
            f"{sorted(os.listdir(store_dir))} "
            f"({obs.value('pyconsensus_aot_cache_bytes')} bytes)")
        if on_card and not store.has_libraries():
            raise RuntimeError("the store holds no kernel libraries")
        flipped_dir = os.path.join(root, "aot-flipped")
        shutil.copytree(store_dir, flipped_dir)
        bad_sha = None
        if on_card:
            libs = store.verify_libraries()
            entry = os.path.join(flipped_dir,
                                 os.path.basename(store.kernels_path()))
            raw = bytearray(open(entry, "rb").read())
            raw[-1000] ^= 0x10          # inside resolve.cu's library
            with open(entry, "wb") as f:
                f.write(bytes(raw))
            bad = bytearray(libs[build.lib_name("resolve.cu")])
            bad[-1000] ^= 0x10
            bad_sha = hashlib.sha256(bytes(bad)).hexdigest()
        # a. 2: the adopted and the flipped worker, from empty copies
        adopted = _aot_worker(
            torch, "aot-adopted",
            _package_copy(here, os.path.join(root, "copy-adopted")),
            os.path.join(root, "log-adopted"),
            _aot_config(aot_shapes, aot_cache_dir=store_dir), dev)
        flipped = _aot_worker(
            torch, "aot-flipped",
            _package_copy(here, os.path.join(root, "copy-flipped")),
            os.path.join(root, "log-flipped"),
            _aot_config((), aot_cache_dir=flipped_dir), dev)
        children += [adopted, flipped]
        # b. 5 on a thread, beside the sessions
        killed = {}

        def kill_part():
            try:
                killed["log"] = _killed_compacted_owner(
                    torch, dev, card, root, store_dir, R, block_e, seed)
            except BaseException as exc:    # noqa: BLE001 — re-raised
                killed["error"] = exc
        killer = threading.Thread(target=kill_part, name="kill-part")
        killer.start()
        # b. 1-4
        _state_sessions(torch, ck, card, dev, here, root, sessions, hot, R,
                        block_e, hydrate, twins, seed, setup_procs)
        killer.join()
        if "error" in killed:
            raise killed["error"]
        log(killed["log"])

        # a. 3: the adopted and the cold worker, side by side
        rng = np.random.default_rng(seed + 40)
        Rq, Eq = request
        mats = [serve_reports(rng, Rq, Eq, na_frac=FLEET_NA)[0]
                for _ in range(AOT_DISTINCT)]
        want = [ShardedOracle(m, pca_method="power",
                              device=dev).consensus() for m in mats]

        def serve(w):
            c = w.client(torch, dev)
            try:
                before = c.call("stats")
                t0 = time.perf_counter()
                got0 = c.call("submit", {"reports": mats[0],
                                         "tenant": "first"})
                first_s = time.perf_counter() - t0
                mid = c.call("stats")
                with concurrent.futures.ThreadPoolExecutor(2) as pool:
                    got = list(pool.map(lambda i: c.call(
                        "submit", {"reports": mats[i % AOT_DISTINCT],
                                   "tenant": "aot"}), range(requests)))
                after = c.call("stats")
            finally:
                c.close()
            return before, got0, first_s, mid, got, after

        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            served = dict(zip((adopted.name, cold.name),
                              pool.map(serve, (adopted, cold))))
        per = None
        for w in (adopted, cold):
            before, got0, first_s, mid, got, after = served[w.name]
            served_close(got0, want[0], 0.0, f"{w.name} first request",
                         exact_all=True)
            for i, g in enumerate(got):
                served_close(g, want[i % AOT_DISTINCT], 0.0,
                             f"{w.name} request {i}", exact_all=True)
            delta = {k: after["launches"][k] - mid["launches"][k]
                     for k in KERNELS}
            for k in KERNELS:
                launches[k] += (after["launches"][k]
                                - before["launches"][k])
            rate = {k: delta[k] / requests for k in CUDA_TIER_KERNELS}
            if w is adopted:
                per = rate
                if on_card and not all(delta[k] >= requests
                                       for k in CUDA_TIER_KERNELS):
                    raise RuntimeError(f"adopted worker: a kernel of the "
                                       f"class did not launch at every "
                                       f"request: {delta}")
                if on_card and (after["compile_events"]["nvcc"] != 0
                                or after["compile_events"]["store_adopt"]
                                != len(build.SOURCES)
                                or after["builds"] != 0):
                    raise RuntimeError(f"the adopted worker built: {after}")
            log(f"{w.name}: boot {w.ready_s:.3f} s; compile events "
                f"{after['compile_events']}; build_seconds "
                f"{after['build_seconds']}; keys built {after['builds']}, "
                f"adopted {after['adopted']}; first {Rq}x{Eq} request "
                f"{first_s:.4f} s; {requests} more bit for bit the direct "
                f"fused ShardedOracle; launches a request {rate} on {card}")
        for a, b in zip([served[adopted.name][1]] + served[adopted.name][4],
                        [served[cold.name][1]] + served[cold.name][4]):
            served_close(a, b, 0.0, "adopted vs cold worker",
                         exact_all=True)
        log(f"adopted and cold worker: {requests + 1} results bit for bit "
            f"equal; boot {adopted.ready_s:.3f} s (adopted) vs "
            f"{cold.ready_s:.3f} s (cold, nvcc beside the build); first "
            f"request {served[adopted.name][2]:.4f} s vs "
            f"{served[cold.name][2]:.4f} s; B.1/B.2/B.3 a request in the "
            f"adopted worker {per}")
        # a. 4: the flipped library
        c = flipped.client(torch, dev)
        try:
            st = c.call("stats")
            digest = c.call("metric", {"name": "pyconsensus_aot_reject_"
                                               "total",
                                       "labels": {"reason": "digest"}})
        finally:
            c.close()
        built_dir = os.path.join(root, "copy-flipped",
                                 "pyconsensus_tpu_torch", "csrc", "build")
        loaded = {n: hashlib.sha256(open(os.path.join(built_dir, n),
                                         "rb").read()).hexdigest()
                  for n in (sorted(os.listdir(built_dir))
                            if os.path.isdir(built_dir) else ())}
        log(f"{flipped.name}: boot {flipped.ready_s:.3f} s; refusals "
            f"reason=digest {digest['value']}; compile events "
            f"{st['compile_events']}; build_seconds {st['build_seconds']}; "
            f"libraries loaded {loaded}; the flipped bytes' sha256 "
            f"{bad_sha} loaded: {bad_sha in loaded.values()}")
        if on_card and (digest["value"] != 1.0
                        or st["compile_events"]["nvcc"] != 1
                        or st["compile_events"]["store_adopt"]
                        != len(build.SOURCES) - 1
                        or bad_sha in loaded.values()):
            raise RuntimeError(f"the flipped library was not refused and "
                               f"rebuilt: {st} {digest}")
        log(f"state plane and kernel store: {time.perf_counter() - t_phase:.3f}"
            f" s after the build (the cold worker's nvcc ran beside it)")
    finally:
        for child in children:
            child.stop()
        build.attach_store(attached)
        shutil.rmtree(root, ignore_errors=True)


def _lattice_block(rng, R, e, na=STATE_NA):
    """An all-binary ``R x e`` block with ``na`` absent (lattice exact:
    its journal record and its snapshot member are int8-encodable)."""
    import numpy as np

    x = rng.choice([0.0, 1.0], size=(R, e))
    x[: R // 5] = 1.0 - x[R // 4]
    x[rng.random((R, e)) < na] = np.nan
    return x


def state_setup_worker(spec) -> int:
    """``--state-setup SPEC``: one of the state-plane phase's setup
    processes. ``SPEC`` is a JSON object with ``log_dir``, ``twin_dir``,
    ``names``, ``twins``, ``R``, ``block_e``, ``seed``, ``device`` and
    ``dtype``. Each session gets one resolved round and two journaled
    blocks, a copy of its log in ``twin_dir`` when it is a twin, and a
    compaction; a line ``SESSION <name> <journal bytes before> <after>
    <blocks covered>`` follows each."""
    import numpy as np
    import torch

    from pyconsensus_tpu_torch.serve import DurableSession

    spec = json.loads(spec)
    torch.set_default_dtype(getattr(torch, spec["dtype"]))
    dev = torch.device(spec["device"])
    R, e = int(spec["R"]), int(spec["block_e"])
    twins = set(spec["twins"])
    for name in spec["names"]:
        rng = np.random.default_rng([spec["seed"], int(name[1:])])
        s = DurableSession.create(spec["log_dir"], name, R, device=dev)
        s.append(_lattice_block(rng, R, e))
        s.resolve()
        for _ in range(2):
            s.append(_lattice_block(rng, R, e))
        before = s.journal_bytes()
        if name in twins:
            shutil.copytree(os.path.join(spec["log_dir"], name),
                            os.path.join(spec["twin_dir"], name))
        report = s.compact()
        print(f"SESSION {name} {before} {report['bytes_after']} "
              f"{report['blocks']}", flush=True)
    return 0


def _state_sessions(torch, ck, card, dev, here, root, sessions, hot, R,
                    block_e, hydrate, twins, seed, procs):
    """Part b. 1-4 of :func:`stateplane_phase`."""
    import numpy as np

    from pyconsensus_tpu_torch import assemble_result, obs
    from pyconsensus_tpu_torch.serve import (FleetWorker, ServeConfig,
                                             replay_session)

    log_dir = os.path.join(root, "sessions")
    twin_dir = os.path.join(root, "twins")
    os.makedirs(twin_dir, exist_ok=True)
    worker = FleetWorker("sp", ServeConfig(hot_sessions=hot,
                                           batch_window_ms=1.0),
                         log_dir=log_dir, device=dev)
    svc = worker.service
    svc.start(warmup=False)
    names = [f"m{i:05d}" for i in range(sessions)]
    order = [names[i] for i in
             np.random.default_rng(seed + 41).permutation(sessions)]
    # twins for the first ``twins + hot`` of the order: at least ``twins``
    # of them go cold, whichever stay hot
    twin_set = set(order[:twins + hot])
    sessions0 = obs.value("pyconsensus_serve_sessions") or 0.0
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    dtype = str(torch.get_default_dtype()).split(".")[-1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = here
    t0 = time.perf_counter()
    setups = []
    for k in range(procs):
        part = names[k::procs]
        spec = json.dumps({"log_dir": log_dir, "twin_dir": twin_dir,
                           "names": part,
                           "twins": sorted(twin_set & set(part)), "R": R,
                           "block_e": block_e, "seed": seed,
                           "device": str(dev), "dtype": dtype})
        setups.append(_Child(f"setup-{k}", [
            sys.executable, os.path.join(here, "chip_smoke.py"),
            "--state-setup", spec], here, env))
    # adopt each session as its setup reports it done: the takeover path
    # (verify and replay), so the service owns every one
    journal_before = journal_after = adopted = 0
    done = set()
    while len(done) < len(setups):
        for child in setups:
            if child.name in done:
                continue
            try:
                line = child.lines.get(timeout=0.05)
            except Exception:   # noqa: BLE001 — queue.Empty: next child
                continue
            if line is None:
                child.proc.wait(timeout=60)
                if child.proc.returncode != 0:
                    raise RuntimeError(f"setup failed: {child.failure()}")
                done.add(child.name)
                continue
            if not line.startswith("SESSION "):
                continue
            _, name, before, after, blocks = line.split()
            if int(blocks) != 2:
                raise RuntimeError(f"{name}: compacted {blocks} blocks")
            journal_before += int(before)
            journal_after += int(after)
            worker.adopt_session(name)      # evicts the least recently used
            adopted += 1
    setup_s = time.perf_counter() - t0
    if adopted != sessions:
        raise RuntimeError(f"adopted {adopted} of {sessions} sessions")
    snap_bytes = sum(os.path.getsize(os.path.join(log_dir, n,
                                                  "snapshot.npz"))
                     for n in names)
    hot_now = set(svc.sessions.hot_names())
    log(f"{sessions} durable sessions of {R} reporters (one resolved round, "
        f"then two {R}x{block_e} lattice blocks, {STATE_NA:.0%} absent), "
        f"set up and compacted by {procs} processes and adopted by the "
        f"service in {setup_s:.3f} s; journal bytes {journal_before} before "
        f"compaction, {journal_after} after (snapshots {snap_bytes} "
        f"bytes); hot {len(hot_now)}, owned {len(svc.sessions.names())}")
    if journal_after != 0 or len(hot_now) > hot:
        raise RuntimeError("compaction left journal records, or the hot "
                           "tier overflowed")

    # 3-4: hydrate and resolve cold ones in a seeded order
    picks = [n for n in order if n not in hot_now][:hydrate]
    checked = set([n for n in picks if n in twin_set][:twins])
    provider = {k: v for k, v in svc.session_defaults({}).items()
                if k in ("executable_provider", "device", "dtype")}
    hyd, res_s, hot_max, held = [], [], 0, 0
    ck.reset_launch_counts()
    t_all = time.perf_counter()
    for name in picks:
        t0 = time.perf_counter()
        svc.sessions.get(name)              # the hydration
        hyd.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        got = svc.submit(session=name).result(300)
        res_s.append(time.perf_counter() - t0)
        hot_max = max(hot_max, obs.value("pyconsensus_sessions_hot") or 0)
        if name in checked:
            want = replay_session(twin_dir, name, **provider).resolve()
            served_close(got, assemble_result(want), 0.0,
                         f"hydrated {name} vs its uncompacted twin",
                         exact_all=True)
            held += 1
    counts = ck.launch_counts()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
            else float("nan"))
    hot_gauge = obs.value("pyconsensus_sessions_hot")
    owned = (obs.value("pyconsensus_serve_sessions") or 0.0) - sessions0
    log(f"hydrated and resolved {len(picks)} cold sessions in a seeded "
        f"order in {time.perf_counter() - t_all:.3f} s: "
        f"hydration p50 {percentile(hyd, 0.5):.4f} s, p99 "
        f"{percentile(hyd, 0.99):.4f} s; resolve p50 "
        f"{percentile(res_s, 0.5):.4f} s; pyconsensus_sessions_hot "
        f"{hot_gauge} (max {hot_max} <= {hot}); pyconsensus_serve_sessions "
        f"{owned} owned; peak device memory {peak:.3f} GiB; launches "
        f"{launch_text(counts)} on {card}; {held} resolves bit for bit "
        f"their uncompacted twins' replays")
    worker.close(drain=True)
    if hot_max > hot or owned != sessions or held != twins \
            or len(picks) != hydrate:
        raise RuntimeError(f"the tiers miscounted or a twin was skipped: "
                           f"hot {hot_max}, owned {owned}, twins {held}")


def _killed_compacted_owner(torch, dev, card, root, store_dir, R, block_e,
                            seed):
    """Part b. 5 of :func:`stateplane_phase`: a socket fleet's worker
    compacts a session and ships the snapshot; its process is SIGKILLed;
    the standby adopts the shipped compacted log. Returns the line to
    print."""
    import numpy as np

    from pyconsensus_tpu_torch import assemble_result
    from pyconsensus_tpu_torch.faults import CheckpointCorruptionError
    from pyconsensus_tpu_torch.serve import (ConsensusFleet, DurableSession,
                                             FleetConfig, ServeConfig)
    from pyconsensus_tpu_torch.serve.stateplane import load_snapshot
    from pyconsensus_tpu_torch.serve.transport import SocketTransport

    log_dir = os.path.join(root, "fleet")
    # any journaled byte makes a session due: the compactor covers each
    # append at its next sweep
    cfg = ServeConfig(warmup=(), batch_window_ms=1.0,
                      compact_journal_bytes=1, compact_interval_s=0.2)
    transport = (SocketTransport(devices=[0], aot_cache_dir=store_dir)
                 if dev.type == "cuda" else "socket")
    rng = np.random.default_rng(seed + 42)
    blocks = [_lattice_block(rng, R, block_e) for _ in range(5)]
    twin = DurableSession.create(os.path.join(root, "fleet-twin"), "sk", R,
                                 device=dev)
    t0 = time.perf_counter()
    fleet = ConsensusFleet(FleetConfig(
        n_workers=2, transport=transport, log_dir=log_dir, worker=cfg,
        heartbeat_timeout_s=120.0), device=dev).start(warmup=False)
    boot = time.perf_counter() - t0
    try:
        fleet.create_session("sk", n_reporters=R)
        for b in blocks[:2]:
            fleet.append("sk", b)
            twin.append(b)
        fleet.submit(session="sk").result(300)
        twin.resolve()
        fleet.append("sk", blocks[2])
        twin.append(blocks[2])
        owner = fleet.owner_of("sk")
        local = os.path.join(log_dir, owner, "sk", "snapshot.npz")
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < 60:
            # the owner's compactor covers the open round's block
            try:
                snap = load_snapshot(local)
                if snap["round"] == 1 and snap["blocks"]:
                    break
            except (OSError, CheckpointCorruptionError):
                pass
            time.sleep(0.1)
        else:
            raise RuntimeError("the owner never compacted the open round")
        # the next append ships the snapshot the compaction wrote
        fleet.append("sk", blocks[3])
        twin.append(blocks[3])
        shipped = os.path.join(log_dir, "_shipped", "sk", "snapshot.npz")
        snap = load_snapshot(shipped)
        if snap["round"] != 1 or not snap["blocks"]:
            raise RuntimeError(f"the shipped snapshot covers round "
                               f"{snap['round']}, {len(snap['blocks'])} "
                               "blocks, not the compacted open round")
        snap_bytes = os.path.getsize(shipped)
        t1 = time.perf_counter()
        fleet.kill_worker(owner)
        standby = fleet.owner_of("sk")
        takeover = time.perf_counter() - t1
        fleet.append("sk", blocks[4])
        twin.append(blocks[4])
        got = fleet.submit(session="sk").result(300)
        served_close(got, assemble_result(twin.resolve()), 0.0,
                     "the adopted compacted session vs its twin",
                     exact_all=True)
        status = fleet.status()
    finally:
        fleet.close(drain=False)
    if status["failed_sessions"] or status["sessions"].get("sk") != standby:
        raise RuntimeError(f"the takeover abandoned the session: {status}")
    return (f"socket fleet (2 workers, boot {boot:.3f} s): a session of {R} "
            f"reporters compacted by its owner {owner} "
            f"(compact_journal_bytes=1), the snapshot shipped ({snap_bytes} "
            f"bytes, {len(snap['blocks'])} block(s) of round 1); SIGKILL of "
            f"{owner}: takeover onto {standby} in {takeover:.3f} s, the "
            f"next resolve bit for bit the twin's on {card}; failed "
            f"sessions {status['failed_sessions']}, every operation after "
            f"the kill answered on its first try")


def elastic_phase(torch, ck, card, dev, launches, seed, here,
                  request=FLEET_REQUEST, sessions=ELASTIC_SESSIONS,
                  session_r=ELASTIC_SESSION_R, session_e=ELASTIC_SESSION_E,
                  burst_s=ELASTIC_BURST_S, econ_sessions=ECON_SESSIONS,
                  kill_markets=ECON_KILL_MARKETS, cli_requests=24, cfg=None):
    """The elastic fleet and the adversarial economy
    (``serve/autoscale.py``, ``obs/slo.py``, ``obs/httpd.py``,
    ``obs/flightrec.py``, ``econ/``), each number beside ``card``:

    a. a socket fleet of one worker process on card 0 (``max_workers``
       ``ELASTIC_MAX``) whose workers adopt their kernels from a store
       warmed at ``request``: an ``AutoScaler`` on an ``SloMonitor`` of
       the merged worker view through a closed-loop burst of all-binary
       ``request`` matrices (2% absent) until the fleet reaches its
       ceiling, an idle tail and a SIGKILLed worker
       (:func:`_elastic_fleet`);
    b. the reference's economy block at its own scale through one
       ``ConsensusService`` of the default config, twice, then the
       economy's command line over a two-worker fleet SIGKILLed
       mid-economy and run again over its log, and once with
       ``--autoscale`` (:func:`_economy`); the economy's two runs (the
       second through the command line's one service, a process of its
       own) and the command lines of a and b run side by side.

    ``dev`` may be the CPU for a rehearsal (nothing launches; pass
    ``cfg=ServeConfig(pallas_buckets=True)`` so the requests ride the
    class's plain versions; the workers run on the CPU). Everything the
    phase writes lives in a temporary directory under ``OUT_DIR`` and is
    removed after it."""
    import concurrent.futures
    import tempfile

    from pyconsensus_tpu_torch.ops import build
    from pyconsensus_tpu_torch.serve import ServeConfig

    cfg = cfg or ServeConfig()
    root = tempfile.mkdtemp(prefix="elastic-", dir=os.path.join(here,
                                                                OUT_DIR))
    attached = build.attached_store()   # a service with a store attaches
    try:
        t0 = time.perf_counter()
        serve_cli = _elastic_fleet(torch, ck, card, dev, launches, seed,
                                   here, root, request, sessions, session_r,
                                   session_e, burst_s, cli_requests, cfg)
        build.attach_store(attached)
        t1 = time.perf_counter()
        first_run, second_run, stages = _economy(
            torch, ck, card, dev, launches, seed, here, root, econ_sessions,
            kill_markets, cfg)
        # the economy's two runs side by side, the second and the command
        # lines each a process of its own (their exit codes, summaries and
        # digests are what they check)
        t2 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(f)
                    for f in (second_run, serve_cli, *stages)]
            first, text = first_run(
                1, beside=" (beside run 2 and the command lines)")
            second, second_text = futs[0].result()
            texts = [text, second_text] + [f.result() for f in futs[1:]]
        for text in texts:
            log(text)
        if first != second:
            raise RuntimeError(f"economy digests differ: {first}, {second}")
        log(f"elastic fleet {t1 - t0:.3f} s, the economy's set-up "
            f"{t2 - t1:.3f} s, its two runs beside the command lines "
            f"{time.perf_counter() - t2:.3f} s")
    finally:
        build.attach_store(attached)
        shutil.rmtree(root, ignore_errors=True)


def _wait_for(pred, timeout_s, poll_s=0.02):
    """Poll ``pred`` until it holds or ``timeout_s`` passes; its last
    value."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = pred()
        if got or time.monotonic() > deadline:
            return got
        time.sleep(poll_s)


def _elastic_fleet(torch, ck, card, dev, launches, seed, here, root, request,
                   sessions, session_r, session_e, burst_s, cli_requests,
                   cfg):
    """Part a of :func:`elastic_phase`:

    1. ``bucket_cuda`` at ``request`` warmed into a kernel store; one
       socket worker (``aot_cache_dir`` the store, ``flightrec_dir`` set)
       started; ``sessions`` durable sessions created and resolved once;
       a ``/metrics`` endpoint on the fleet's merged view;
    2. ``ELASTIC_CALIBRATE`` requests from one client: the unloaded
       windowed p99 (a bucket edge of the workers' latency histogram);
       the SLO target is the edge below it, so a loaded fleet breaks it
       at any size and the burst drives the fleet to its ceiling;
    3. the autoscaler (``ELASTIC_*``) on a monitor with that p99 target
       and the queue-depth target; ``ELASTIC_CLIENTS`` clients, retrying
       the retryable sheds, until the ceiling has served
       ``ELASTIC_AFTER_S`` seconds (at most ``burst_s``); a scrape of the
       endpoint at the ceiling must label every live worker and carry the
       target gauge;
    4. the idle tail until a scale-down, a SIGKILL of a ring worker
       (``kill_worker``) while two are left, its replacement under a fresh
       name (the order is the other way round when the burst ended below
       the ceiling);
    5. every session resolved again, bit for bit a never-moved
       ``MarketSession``; four direct requests on each live worker
       (B.1 3.00, B.2 1.00, B.3 1.00 a request); every worker's
       ``nvcc`` 0; the flight recorder's dumps. Returned: a stage that
       runs ``pyconsensus-serve-torch --fleet-workers 1 --transport
       socket --autoscale`` as a subprocess and returns its line.

    Printed: each worker's boot seconds, the seconds from the first
    breached window to the new worker's ring entry, requests/s and p99
    before the first scale-up and after the last, the decision counts,
    sheds, retries and abandoned (0), every result bit for bit the
    direct fused ``ShardedOracle``."""
    import itertools
    import threading
    import urllib.request

    import numpy as np

    from pyconsensus_tpu_torch import ShardedOracle, obs
    from pyconsensus_tpu_torch.obs import read_flight_dir
    from pyconsensus_tpu_torch.obs.metrics import DURATION_BUCKETS
    from pyconsensus_tpu_torch.serve import (AutoScaler, AutoscaleConfig,
                                             ConsensusFleet, ConsensusService,
                                             FleetConfig, LoadGenerator,
                                             MarketSession, ServeConfig)
    from pyconsensus_tpu_torch.serve.loadgen import RETRYABLE_CODES
    from pyconsensus_tpu_torch.serve.transport import SocketTransport

    on_card = dev.type == "cuda"
    R, E = request
    store_dir = os.path.join(root, "aot")
    frd = os.path.join(root, "flightrec")
    # 1. the store, the fleet, its sessions and the endpoint
    t0 = time.perf_counter()
    svc = ConsensusService(ServeConfig(pallas_buckets=True,
                                       aot_cache_dir=store_dir), device=dev)
    svc.warm_cuda_class([request])
    svc.close(drain=False)
    warm_s = time.perf_counter() - t0
    wcfg = ServeConfig.from_dict({**cfg.__dict__,
                                  "aot_cache_dir": store_dir,
                                  "flightrec_dir": frd})
    rng = np.random.default_rng(seed + 60)
    mats = [serve_reports(rng, R, E, na_frac=FLEET_NA)[0]
            for _ in range(FLEET_DISTINCT)]
    want = [ShardedOracle(m, pca_method="power", device=dev).consensus()
            for m in mats]
    blocks = {f"s{j:02d}": [serve_reports(rng, session_r, session_e)[0]
                            for _ in range(2)] for j in range(sessions)}
    fleet = ConsensusFleet(FleetConfig(
        n_workers=1, log_dir=os.path.join(root, "log"), worker=wcfg,
        transport=(SocketTransport(devices=[0]) if on_card else "socket")),
        device=dev).start()
    srv = obs.start_metrics_server(0, fleet.render_metrics)
    if srv is None:
        raise RuntimeError("the /metrics endpoint did not bind")
    seen, scaler, monitors, per = {}, None, [], {}
    lock = threading.Lock()
    direct = 4

    def read_stats():
        """Each live worker's boot seconds and stats, at first sight, and
        four direct requests on it (bit for bit; B.1, B.2 and B.3 a
        request)."""
        for name, w in sorted(fleet.workers.items()):
            if not w.alive or name in seen:
                continue
            before = w.call("stats")
            for j in range(direct):
                served_close(w.submit_stateless(
                    mats[j], tenant="direct").result(timeout=300),
                    want[j], 0.0, f"{name} direct request {j}",
                    exact_all=True)
            after = w.call("stats")
            seen[name] = (w.process.ready_s, after)
            delta = {k: after["launches"][k] - before["launches"][k]
                     for k in KERNELS}
            for k in KERNELS:
                launches[k] += delta[k]
            per[name] = {k: delta[k] / direct for k in CUDA_TIER_KERNELS}
            if on_card and any(delta[k] < direct
                               for k in CUDA_TIER_KERNELS):
                raise RuntimeError(f"{name}: a kernel of the class did not "
                                   f"launch at every request: {delta}")

    try:
        read_stats()
        for name, (b0, _) in blocks.items():
            fleet.create_session(name, n_reporters=session_r)
            fleet.append(name, b0)
            fleet.submit(session=name).result(timeout=300)

        done, errors = [], []
        tally = {"sheds": {}, "retried": 0, "abandoned": 0}
        pacer = LoadGenerator(None, shapes=((1, 1),), seed=seed)
        counter = itertools.count()
        stop = threading.Event()

        def one(i):
            t_start = time.time()
            for attempt in range(FLEET_RETRIES + 1):
                try:
                    res = fleet.submit(
                        reports=mats[i % FLEET_DISTINCT]).result(timeout=300)
                    break
                except Exception as exc:  # noqa: BLE001 — tallied
                    code = getattr(exc, "error_code", None)
                    if code not in RETRYABLE_CODES:
                        raise
                    with lock:
                        tally["sheds"][code] = tally["sheds"].get(code,
                                                                  0) + 1
                        if attempt == FLEET_RETRIES:
                            tally["abandoned"] += 1
                            return
                        tally["retried"] += 1
                    time.sleep(pacer._retry_delay(exc, i, attempt))
            with lock:
                done.append((i, t_start, time.time(), res))

        def client():
            try:
                while not stop.is_set():
                    one(next(counter))
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                errors.append(exc)

        # 2. the unloaded latency sets the target
        calib = obs.SloMonitor(window_s=600.0,
                               snapshot_fn=fleet.merged_snapshot)
        calib.sample()
        for _ in range(ELASTIC_CALIBRATE):
            one(next(counter))
        unloaded = calib.sample()["p99_ms"]
        edges = [1e3 * e for e in DURATION_BUCKETS]
        below = [e for e in edges if e < (unloaded or 0.0)]
        if not below:
            raise RuntimeError(f"unloaded p99 {unloaded} ms has no bucket "
                               f"edge below it")
        target = below[-1]
        log(f"elastic fleet: store warmed at {R}x{E} in {warm_s:.3f} s; "
            f"{ELASTIC_CALIBRATE} unloaded requests through 1 worker: "
            f"windowed p99 <= {unloaded} ms (the workers' latency "
            f"histogram), so the p99 target is the edge below, {target} "
            f"ms, with queue depth <= {ELASTIC_QUEUE_TARGET} on {card}")

        # 3. the burst under the autoscaler
        slo = obs.SloMonitor(targets={"p99_ms": target,
                                      "queue_depth": ELASTIC_QUEUE_TARGET},
                             window_s=ELASTIC_WINDOW_S,
                             snapshot_fn=fleet.merged_snapshot)
        monitors.append(slo)
        scaler = AutoScaler(fleet, slo, AutoscaleConfig(
            min_workers=1, max_workers=ELASTIC_MAX,
            interval_s=ELASTIC_INTERVAL_S, up_signals=ELASTIC_UP,
            down_signals=ELASTIC_DOWN, cooldown_s=ELASTIC_COOLDOWN_S))
        decisions = []
        evaluate = scaler.evaluate

        def logged(now=None):
            t_call = time.time()
            d = evaluate(now)
            with lock:
                decisions.append((t_call, d))
            return d
        scaler.evaluate = logged

        def count(action):
            with lock:
                return sum(d["action"] == action for _, d in decisions)

        slo.run_in_thread(interval_s=ELASTIC_INTERVAL_S)
        scaler.run_in_thread()
        t_burst = time.time()
        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(ELASTIC_CLIENTS)]
        for t in threads:
            t.start()
        top = _wait_for(lambda: len(fleet.ring.workers()) >= ELASTIC_MAX
                        or errors, burst_s)
        if errors:
            raise errors[0]
        if top:
            time.sleep(ELASTIC_AFTER_S)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/metrics",
                    timeout=60) as r:
                scrape = r.read().decode()
            labels = {name for name, w in fleet.workers.items() if w.alive}
            missing = [n for n in labels | {"router"}
                       if f'worker="{n}"' not in scrape]
            if missing or "pyconsensus_autoscale_target_workers{" \
                    not in scrape:
                raise RuntimeError(f"/metrics scrape: labels {missing} or "
                                   f"the target gauge missing")
        stop.set()
        for t in threads:
            t.join(timeout=600)
        if errors:
            raise errors[0]
        t_idle = time.time()
        read_stats()
        ring_at_end = len(fleet.ring.workers())

        # 4. the idle tail, the SIGKILL and its replacement
        def kill():
            victim = sorted(fleet.ring.workers())[-1]
            t_kill = time.perf_counter()
            info = fleet.kill_worker(victim)
            return victim, time.perf_counter() - t_kill, info

        with lock:
            changes = [(round(t - t_burst, 3), d["action"], d.get("worker"),
                        d.get("sessions_rebalanced"))
                       for t, d in decisions if d["action"] != "hold"]
        spans = [(ev["name"], ev["attrs"].get("worker"),
                  round(ev["duration_s"], 3)) for ev in obs.events()
                 if ev.get("name", "").startswith("autoscale.")
                 and ev.get("start_s", 0) >= t_burst]
        log(f"elastic burst: {len(done)} requests in "
            f"{t_idle - t_burst:.3f} s, ring {list(fleet.ring.workers())}; "
            f"changes (s from the burst's start, action, worker, sessions "
            f"rebalanced) {changes}; spans (name, worker, s) {spans}")
        idle_wait = ELASTIC_WINDOW_S + ELASTIC_COOLDOWN_S + 60.0
        if ring_at_end >= 3:
            _wait_for(lambda: count("scale_down") >= 1, idle_wait)
        killed = kill()
        if not _wait_for(lambda: count("replace") >= 1, 300.0):
            raise RuntimeError(f"no replacement of {killed[0]} "
                               f"({scaler.status()})")
        # the idle fleet drains the replacement at once (its spawn
        # outlasts the cool-down, which runs from the decision's start):
        # read it with the loop stopped, then let the tail go on
        scaler.stop()
        read_stats()
        log(f"elastic tail: {killed[0]} SIGKILLed, replaced; ring "
            f"{list(fleet.ring.workers())}")
        if not count("scale_down"):
            scaler.run_in_thread()
            _wait_for(lambda: count("scale_down") >= 1, idle_wait)
            scaler.stop()
        slo.stop()

        # 5. the sessions, direct requests, compile events, dumps
        moved = {}
        for _, d in decisions:
            if d["action"] == "scale_down":
                moved[d["worker"]] = d.get("sessions_migrated", 0)
        for name, (b0, b1) in blocks.items():
            ref = MarketSession(name, session_r, device=dev)
            ref.append(b0)
            ref.resolve()
            ref.append(b1)
            w1 = ref.resolve()
            fleet.append(name, b1)
            g = fleet.submit(session=name).result(timeout=300)
            for path, key in (("agents", "smooth_rep"),
                              ("agents", "old_rep"),
                              ("events", "outcomes_final"),
                              ("events", "outcomes_adjusted")):
                if not np.array_equal(np.asarray(g[path][key]),
                                      np.asarray(w1[key])):
                    raise RuntimeError(f"session {name}: {key} is not the "
                                       f"never-moved session's bits")
        final_ring = list(fleet.ring.workers())
    finally:
        if scaler is not None:
            scaler.stop()
        for m in monitors:
            m.stop()
        fleet.close(drain=True)
        srv.close()
    for i, _, _, res in done:
        served_close(res, want[i % FLEET_DISTINCT], 0.0,
                     f"elastic request {i}", exact_all=True)
    acts = {a: count(a) for a in ("hold", "scale_up", "scale_down",
                                  "replace", "error")}
    if not (acts["scale_up"] and acts["scale_down"] and acts["replace"]) \
            or acts["error"] or tally["abandoned"]:
        raise RuntimeError(f"elastic fleet: decisions {acts}, abandoned "
                           f"{tally['abandoned']}")
    if not any(moved.values()):
        raise RuntimeError(f"no drain migrated a session: {moved}")
    nvcc = {n: st["compile_events"]["nvcc"] for n, (_, st) in seen.items()}
    if on_card and any(nvcc.values()):
        raise RuntimeError(f"a spawned worker ran nvcc: {nvcc}")
    replaced = [d["worker"] for _, d in decisions
                if d["action"] == "replace"]
    if killed[0] in replaced:
        raise RuntimeError(f"the replacement reused {killed[0]}")
    auto = read_flight_dir(os.path.join(frd, "autoscaler"))
    router = {r["reason"] for r in read_flight_dir(os.path.join(frd,
                                                                "router"))}
    changes = acts["scale_up"] + acts["scale_down"] + acts["replace"]
    if len(auto) != changes or not {"takeover", "drain"} <= router:
        raise RuntimeError(f"flight dumps: {len(auto)} autoscaler for "
                           f"{changes} changes, router {router}")
    # the windows before the first scale-up and after the last
    spawns = sorted((ev["start_s"] + ev["duration_s"], ev["attrs"])
                    for ev in obs.events()
                    if ev.get("name") == "autoscale.spawn"
                    and ev.get("start_s", 0) >= t_burst)
    ups = [t for t, a in spawns if a.get("action") == "scale_up"]
    breach = min(t for t, d in decisions if d.get("breached"))
    early = [(a, b) for _, a, b, _ in done if t_burst <= a and b <= ups[0]]
    late = [(a, b) for _, a, b, _ in done if a >= ups[-1] and b <= t_idle]

    def window(xs, t0, t1):
        if not xs or t1 <= t0:
            return "n 0"
        lat = [1e3 * (b - a) for a, b in xs]
        return (f"{len(xs)} requests, {len(xs) / (t1 - t0):.4f} requests/s,"
                f" p50 {percentile(lat, 0.5):.3f} ms, p99 "
                f"{percentile(lat, 0.99):.3f} ms")

    boots = {n: (round(b, 3) if b is not None else None)
             for n, (b, _) in sorted(seen.items())}
    log(f"elastic fleet ({ELASTIC_CLIENTS} clients of {R}x{E} binary "
        f"requests, 1 worker to at most {ELASTIC_MAX} on card 0): "
        f"{len(done)} requests, every one bit for bit the direct fused "
        f"ShardedOracle; sheds {tally['sheds'] or 'none'}, retries "
        f"{tally['retried']}, abandoned 0; decisions {acts}; first "
        f"breached window to the new worker's ring entry "
        f"{ups[0] - breach:.3f} s; before the first scale-up "
        f"{window(early, t_burst, ups[0])}; after the last "
        f"{window(late, ups[-1], t_idle)}; on {card}")
    log(f"elastic fleet workers: boot s {boots}; nvcc {nvcc}; B.1/B.2/B.3 "
        f"a direct request {per}; SIGKILL of {killed[0]} (takeover "
        f"{killed[1]:.4f} s, sessions {len(killed[2]['sessions_migrated'])})"
        f" replaced by {replaced}; sessions a drain migrated {moved}; "
        f"{sessions} sessions bit for bit never-moved ones after the "
        f"rebalances, drains and takeover; /metrics at the ceiling "
        f"labelled every live worker and the target gauge; flight dumps: "
        f"{len(auto)} autoscaler for {changes} membership changes, router "
        f"{sorted(router)}; final ring {final_ring} on {card}")

    # the serve command line with the autoscaler over a socket fleet, a
    # stage the phase runs beside the economy's command-line runs
    args = ["--fleet-workers", "1", "--transport", "socket", "--autoscale",
            "--autoscale-max", str(ELASTIC_MAX), "--autoscale-interval-s",
            str(ELASTIC_INTERVAL_S), "--autoscale-cooldown-s",
            str(ELASTIC_COOLDOWN_S), "--slo-p99-ms", str(target),
            "--slo-queue-depth", str(ELASTIC_QUEUE_TARGET),
            "--slo-window-s", str(ELASTIC_WINDOW_S), "--requests",
            str(cli_requests), "--concurrency", str(ELASTIC_CLIENTS),
            "--shapes", f"{R}x{E}", "--na-frac", str(FLEET_NA),
            "--retries", str(FLEET_RETRIES), "--metrics-port", "0",
            "--aot-cache", store_dir, "--log-dir",
            os.path.join(root, "cli-log")]
    if not on_card:
        args += ["--device", "cpu", "--pallas-buckets", "on"]

    def serve_cli():
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m",
                              "pyconsensus_tpu_torch.serve.cli", *args],
                             capture_output=True, text=True, cwd=here,
                             timeout=900)
        secs = time.perf_counter() - t0
        if run.returncode != 0:
            raise RuntimeError(f"autoscaled serve cli exited "
                               f"{run.returncode}:\n{run.stdout[-4000:]}\n"
                               f"{run.stderr[-4000:]}")
        out = json.loads(run.stdout[run.stdout.index("{"):])
        if out["failed"] or out["abandoned"] or "autoscale" not in out:
            raise RuntimeError(f"autoscaled serve cli: {out}")
        return (f"pyconsensus_tpu_torch.serve.cli {' '.join(args[:6])} ...: "
                f"exit 0 in {secs:.3f} s, {out['succeeded']} succeeded, "
                f"abandoned 0, {out['throughput_rps']} requests/s, p99 "
                f"{out['latency_p99_ms']} ms, decisions "
                f"{out['autoscale']['decisions']}, slo "
                f"{out['slo']['violation_s']} violation s, workers "
                f"{sorted(out['fleet']['workers'])} on {card}")
    return serve_cli


def _economy(torch, ck, card, dev, launches, seed, here, root,
             econ_sessions, kill_markets, cfg):
    """Part b of :func:`elastic_phase`: ``econ_sessions`` markets of
    ``ECON_STRATEGIES`` (the reference's ``bench.py`` economy block),
    ``ECON_ROUNDS`` rounds at concurrency ``ECON_CONCURRENCY``, through
    one ``ConsensusService`` of ``cfg`` in this process and through the
    command line's one service in another (both returned as stages, the
    phase runs them side by side): wall seconds,
    resolutions/s, p50 / p99, sheds, each strategy's ROI and
    time-to-catch, the digest (equal across the runs), the mirrors on
    ``bucket_cuda`` with B.1, B.2 and B.3 launched, 0 abandoned. Then
    ``python -m pyconsensus_tpu_torch.econ --fleet-workers 2`` at
    ``kill_markets`` markets a strategy, SIGKILLed once round 1 has a
    journaled block and run again over its log: the digest must be that
    of the same economy run uninterrupted here, through a fleet of the
    command line's config; then with ``--autoscale --autoscale-max 3``
    (exit 0). The command lines' runs are returned as two stages, each
    returning its line."""
    import glob
    import signal

    import numpy as np

    from pyconsensus_tpu_torch import obs
    from pyconsensus_tpu_torch.econ import MarketEconomy, build_scenario
    from pyconsensus_tpu_torch.serve import (ConsensusFleet,
                                             ConsensusService, FleetConfig,
                                             ServeConfig)

    on_card = dev.type == "cuda"
    per = -(-max(len(ECON_STRATEGIES), econ_sessions)
            // len(ECON_STRATEGIES))
    scenario = build_scenario(seed=seed, rounds=ECON_ROUNDS,
                              strategies=ECON_STRATEGIES,
                              markets_per_strategy=per,
                              concurrency=ECON_CONCURRENCY)
    def one_run(run, beside=""):
        """One economy through a fresh service of ``cfg``: its digest and
        its line."""
        cuda0 = obs.value("pyconsensus_serve_requests_total",
                          path="bucket_cuda", outcome="ok") or 0.0
        ck.reset_launch_counts()
        svc = ConsensusService(cfg, device=dev).start(warmup=False)
        try:
            res = MarketEconomy(svc, scenario).run()
        finally:
            svc.close(drain=True)
        counts = ck.launch_counts()
        for k in counts:
            launches[k] += counts[k]
        cuda = (obs.value("pyconsensus_serve_requests_total",
                          path="bucket_cuda", outcome="ok") or 0.0) - cuda0
        service = res["service"]
        # every market resolved every round (an exhausted retry raises in
        # run()); the stateless mirrors are recorded, not retried, when the
        # queue sheds them, as the reference's: their count is the storm's
        # shed rate, printed
        played = np.asarray(res["trajectories"]["cartel_share"])
        if not np.isfinite(played).all() or (on_card and (
                cuda <= 0 or not all(counts[k] > 0
                                     for k in CUDA_TIER_KERNELS))):
            raise RuntimeError(f"economy run {run}: rounds played "
                               f"{played.tolist()}, bucket_cuda requests "
                               f"{cuda}, launches {counts}, errors "
                               f"{service['errors']}")
        n = res["n_sessions"] * res["rounds"]
        strat = {s: (v["cartel_roi"], v["time_to_catch_rounds"],
                     v["caught_fraction"])
                 for s, v in res["per_strategy"].items()}
        return res["mechanism_digest"], (
            f"economy run {run}{beside}: {res['n_sessions']} market "
            f"sessions x {res['rounds']} rounds "
            f"({', '.join(ECON_STRATEGIES)}, concurrency "
            f"{ECON_CONCURRENCY}, one service, default config): "
            f"{res['wall_s']} s, {n / res['wall_s']:.4f} resolutions/s; "
            f"requests {service['requests']}, p50 "
            f"{service['latency_p50_ms']} ms, p99 "
            f"{service['latency_p99_ms']} ms, sheds "
            f"{service['sheds_observed']} {service['errors'] or ''} "
            f"(shed rate {service['shed_rate']}), resolutions retried "
            f"{service['retried']} and abandoned 0, mirrors shed and not "
            f"retried {service['mirrors_abandoned']}; mirrors on "
            f"bucket_cuda {cuda:.0f}, {launch_text(counts)}; (ROI, "
            f"time-to-catch rounds, caught fraction) {strat}; digest "
            f"{res['mechanism_digest']} on {card}")

    def second_run():
        """The same scenario again, through the command line's single
        service (the default config) in a process of its own: its digest
        and its line. The phase runs it beside the first run."""
        out = os.path.join(root, "econ-second.json")
        cmd = [sys.executable, "-m", "pyconsensus_tpu_torch.econ",
               "--strategies", ",".join(ECON_STRATEGIES),
               "--markets-per-strategy", str(per), "--rounds",
               str(ECON_ROUNDS), "--concurrency", str(ECON_CONCURRENCY),
               "--seed", str(seed), "--json-out", out]
        if not on_card:
            cmd += ["--device", "cpu", "--dtype",
                    str(torch.get_default_dtype()).split(".")[-1]]
        res, secs = finished(cmd, "the economy's second run")
        service = res["service"]
        n = res["n_sessions"] * res["rounds"]
        return res["mechanism_digest"], (
            f"economy run 2 (the command line's one service, beside run 1 "
            f"and the other command lines): {res['n_sessions']} market "
            f"sessions x {res['rounds']} rounds, {res['wall_s']} s "
            f"({secs:.3f} s with the process), "
            f"{n / res['wall_s']:.4f} resolutions/s; p50 "
            f"{service['latency_p50_ms']} ms, p99 "
            f"{service['latency_p99_ms']} ms, sheds "
            f"{service['sheds_observed']}, resolutions abandoned 0, mirrors "
            f"shed and not retried {service['mirrors_abandoned']}; digest "
            f"{res['mechanism_digest']} on {card}")

    def econ_cmd(log_dir, *extra):
        cmd = [sys.executable, "-m", "pyconsensus_tpu_torch.econ",
               "--strategies", ",".join(ECON_STRATEGIES),
               "--markets-per-strategy", str(kill_markets), "--rounds",
               str(ECON_ROUNDS), "--concurrency", str(ECON_CONCURRENCY),
               "--seed", str(seed), "--fleet-workers", "2", "--log-dir",
               os.path.join(root, log_dir), *extra]
        if not on_card:
            cmd += ["--device", "cpu"]
        return cmd

    def finished(cmd, what):
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, cwd=here,
                             timeout=900)
        if run.returncode != 0:
            raise RuntimeError(f"{what} exited {run.returncode}:\n"
                               f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
        return (json.loads(run.stdout.strip().splitlines()[-1]),
                time.perf_counter() - t0)

    # the uninterrupted digest, in process, over the command line's fleet
    # and config (the digest is the mechanism's: neither the front door
    # nor the process changes it)
    t0 = time.perf_counter()
    fleet = ConsensusFleet(FleetConfig(
        n_workers=2, log_dir=os.path.join(root, "econ-whole"),
        worker=ServeConfig(batch_window_ms=2.0, max_batch=8,
                           max_queue=256)), device=dev).start(warmup=False)
    try:
        whole = MarketEconomy(fleet, build_scenario(
            seed=seed, rounds=ECON_ROUNDS, strategies=ECON_STRATEGIES,
            markets_per_strategy=kill_markets,
            concurrency=ECON_CONCURRENCY)).run()
    finally:
        fleet.close(drain=True)
    whole_s = time.perf_counter() - t0

    def killed_and_resumed():
        cmd = econ_cmd("econ-killed")
        proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            staged = os.path.join(root, "econ-killed", "*", "staged",
                                  "round_000001_*")
            _wait_for(lambda: glob.glob(staged) or proc.poll() is not None,
                      600.0, poll_s=0.005)
            if proc.poll() is not None:
                raise RuntimeError("the economy ended before its SIGKILL")
            at_kill = len(glob.glob(staged))
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        resumed, resumed_s = finished(cmd, "resumed economy cli")
        if resumed["mechanism_digest"] != whole["mechanism_digest"] \
                or not resumed["resumed_markets"]:
            raise RuntimeError(f"the resumed economy's digest "
                               f"{resumed['mechanism_digest']} is not the "
                               f"uninterrupted {whole['mechanism_digest']}")
        return (f"economy cli, {kill_markets} markets a strategy (cut from "
                f"{per} for the phase's time), {ECON_ROUNDS} rounds, a "
                f"2-worker fleet: uninterrupted (in this process) "
                f"{whole_s:.3f} s, digest {whole['mechanism_digest']}; "
                f"SIGKILLed with {at_kill} round-1 block(s) journaled, run "
                f"again over its log in {resumed_s:.3f} s: "
                f"{resumed['resumed_markets']} markets resumed, the same "
                f"digest on {card}")

    def autoscaled():
        scaled, scaled_s = finished(
            econ_cmd("econ-autoscale", "--autoscale", "--autoscale-max",
                     "3"), "autoscaled economy cli")
        return (f"economy cli --autoscale --autoscale-max 3: exit 0 in "
                f"{scaled_s:.3f} s, workers "
                f"{scaled['autoscale']['workers_start']} -> "
                f"{scaled['autoscale']['workers_end']}, decisions "
                f"{scaled['autoscale']['decisions']} on {card}")
    return one_run, second_run, (killed_and_resumed, autoscaled)


def witness_phase(torch, card, dev, launches, here,
                  worker_device="cuda"):
    """The port's own static analysis and its runtime witnesses
    (``pyconsensus_tpu_torch/analysis``), each number beside ``card``:

    a. ``python -m pyconsensus_tpu_torch.analysis --strict`` over the
       checkout, in a subprocess: exit 0, its findings (0) and seconds;
    b. ``--witness-worker`` in a fresh interpreter
       (:func:`witness_worker`): the lock witness installed before the
       package is imported, then the protocol and digest witnesses, over
       a fleet block and the economy block on ``worker_device``. Its
       violations (0; a violation fails the worker), abandoned requests
       (0), B.1/B.2/B.3 launches a request (3/1/1), the CUDA paths'
       locks taken, the observed lock edges, the protocol events and the
       digests re-derived are printed here, and its launches added to
       ``launches``.

    The CPU tests never take the card's locks; this phase does. ``dev``
    may be the CPU for a rehearsal, with ``worker_device="cpu"`` (the
    worker then runs its blocks at a small size on the plain versions,
    and nothing launches)."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "pyconsensus_tpu_torch.analysis", "--strict",
         "--format", "json"], capture_output=True, text=True, cwd=here,
        timeout=600)
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"consensus-lint --strict exited "
                           f"{run.returncode}:\n{run.stdout[-4000:]}\n"
                           f"{run.stderr[-4000:]}")
    lint = json.loads(run.stdout)
    if lint["findings"] or lint["stale_baseline"]:
        raise RuntimeError(f"consensus-lint --strict: {lint['findings']}")
    log(f"python -m pyconsensus_tpu_torch.analysis --strict: exit 0, "
        f"findings 0 (baselined {lint['baselined']}), {secs:.3f} s "
        f"({lint['elapsed_s']} s inside the analysis) on the host of "
        f"{card}")

    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, os.path.join(here, "chip_smoke.py"),
         "--witness-worker", worker_device], capture_output=True,
        text=True, cwd=here, timeout=WITNESS_TIMEOUT)
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"the witness worker exited {run.returncode}:\n"
                           f"{run.stdout[-6000:]}\n{run.stderr[-6000:]}")
    for line in run.stdout.strip().splitlines()[:-1]:
        log(f"  witness worker: {line}")
    rep = json.loads(run.stdout.strip().splitlines()[-1])["witness"]
    for k, v in rep["launches"].items():
        launches[k] += v
    per = rep["per_request"]
    if rep["violations"] or rep["abandoned"]:
        raise RuntimeError(f"witness: violations {rep['violations']}, "
                           f"abandoned {rep['abandoned']}")
    on_card = worker_device == "cuda"
    if on_card and (per["B.1"], per["B.2"], per["B.3"]) != (3.0, 1.0, 1.0):
        raise RuntimeError(f"witness: B.1/B.2/B.3 launches a request "
                           f"{per}, not 3/1/1")
    missing = [n for n in WITNESS_CUDA_LOCKS if n not in rep["taken"]]
    if on_card and missing:
        raise RuntimeError(f"witness: the card's locks {missing} were never "
                           f"taken under the witness ({rep['taken']})")
    s = rep["seconds"]
    log(f"witnessed fleet ({FLEET_WORKERS} workers on {worker_device}, "
        f"default ServeConfig, a kernel store): {rep['requests']} "
        f"{rep['request']} binary requests at concurrency "
        f"{FLEET_CONCURRENCY}, {rep['rate']:.4f} requests/s, B.1/B.2/B.3 "
        f"{per['B.1']:.2f}/{per['B.2']:.2f}/{per['B.3']:.2f} launches a "
        f"request; then kill_worker('w1') across {rep['requests']} more: "
        f"shed at the kill {rep['kill']['shed_queued']}, sheds by code "
        f"{rep['kill']['sheds'] or 'none'}, retries "
        f"{rep['kill']['retried']}, abandoned 0; every result bit for bit "
        f"the direct fused ShardedOracle; a durable session's takeover "
        f"{rep['takeover_s']:.4f} s, every resolve bit for bit a "
        f"never-killed session's; libraries adopted from the store "
        f"{rep['store']['adopted']}, nvcc runs {rep['store']['nvcc']}; "
        f"{s['fleet']:.3f} s on {card}")
    log(f"witnessed economy ({rep['economy']['markets']} markets x "
        f"{ECON_ROUNDS} rounds, one service): {rep['economy']['wall_s']} s, "
        f"digest {rep['economy']['digest']}; {s['economy']:.3f} s on {card}")
    log(f"lock witness: {rep['locks']} package locks witnessed (the import's "
        f"included), {len(rep['taken'])} taken, the card's "
        f"{[n for n in WITNESS_CUDA_LOCKS if n in rep['taken']]} among "
        f"them; {len(rep['lock_edges'])} observed edges, acyclic and "
        f"consistent with the static graph's {rep['static_edges']} on "
        f"{card}: {rep['lock_edges']}")
    log(f"protocol witness: operations {rep['protocol']['ops']}, event "
        f"orders {rep['protocol']['orders']}, unscoped "
        f"{rep['protocol']['unscoped']}, consistent with the static "
        f"happens-before graph; digest witness: {rep['digests']['recorded']}"
        f" digests recorded, {rep['digests']['checked']} re-derived from "
        f"the durable artifacts, {rep['digests']['skipped']} skipped, "
        f"{rep['digests']['by_op']}; violations 0 on {card}")
    log(f"witness worker: {secs:.3f} s in all (imports and static graphs "
        f"{s['setup']:.3f} s, checks {s['checks']:.3f} s) on {card}")


def witness_worker(device_name: str) -> int:
    """The witnessed blocks of :func:`witness_phase`, in a fresh
    interpreter (``--witness-worker cuda``; ``cpu`` rehearses them at a
    small size on the plain versions). The lock witness is loaded from
    its file and installed BEFORE the package is imported, so the locks
    the package builds at import (``ops/build.py _LOCK``,
    ``serve/service.py _LINALG_LOCK``) are witnessed too; then the
    protocol and digest witnesses; then the fleet and economy blocks;
    then each witness is checked (a violation raises). The card's blocks
    run on CUDA tensors and raise without a card. Prints one JSON line
    last."""
    import importlib.util
    import tempfile

    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    if any(m.startswith("pyconsensus_tpu_torch") for m in sys.modules):
        raise RuntimeError("the package was imported before the witness")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_lock_witness", os.path.join(
            here, "pyconsensus_tpu_torch", "analysis", "witness.py"))
    lockw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lockw)
    lock_w = lockw.LockWitness().install()
    sys.path.insert(0, here)
    import torch

    from pyconsensus_tpu_torch.analysis.concurrency import lock_order_edges
    from pyconsensus_tpu_torch.analysis.determinism_witness import \
        DigestWitness
    from pyconsensus_tpu_torch.analysis.protocol_witness import (
        ProtocolWitness, static_protocol_graph)
    from pyconsensus_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device(device_name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--witness-worker cuda: no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_default_dtype(torch.float64)
    static_locks = lock_order_edges()
    static_proto = static_protocol_graph()
    proto_w = ProtocolWitness().install()
    digest_w = DigestWitness().install()
    t_setup = time.perf_counter() - t_start
    os.makedirs(os.path.join(here, OUT_DIR), exist_ok=True)
    # a violation raises, naming the lock cycle, the operation and its
    # events, or the op and both digests; the dumps stay under OUT_DIR
    dump = os.path.join(here, OUT_DIR, "witness_")
    root = tempfile.mkdtemp(prefix="witness-",
                            dir=os.path.join(here, OUT_DIR))
    try:
        try:
            rep = _witness_blocks(torch, ck, dev, here, root)
        finally:
            for w in (proto_w, digest_w, lock_w):
                w.uninstall()
        t0 = time.perf_counter()
        proto_rep = proto_w.check(static=static_proto,
                                  dump_path=dump + "protocol.json")
        digest_rep = digest_w.check(dump_path=dump + "digest.json")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lock_rep = lock_w.check(static=static_locks,
                            dump_path=dump + "lock.json")
    t_checks = time.perf_counter() - t0
    names = static_locks["locks"]

    def named(key):
        return names.get(key, key)

    ops, orders = {}, {}
    for r in proto_rep["ops"]:
        ops[r["kind"]] = ops.get(r["kind"], 0) + 1
        if r["ok"]:
            orders.setdefault(r["kind"], set()).add(" ".join(r["events"]))
    by_op = {}
    for r in digest_rep["records"]:
        by_op[r["op"]] = by_op.get(r["op"], 0) + 1
    rep.update(
        violations=0, locks=len(lock_rep["locks"]),
        taken=sorted(named(k) for k in lock_rep["taken"]),
        lock_edges=sorted(f"{named(e['from'])} -> {named(e['to'])}"
                          for e in lock_rep["edges"]),
        static_edges=len(static_locks["edges"]),
        protocol={"ops": dict(sorted(ops.items())),
                  "orders": {k: sorted(v) for k, v in sorted(orders.items())},
                  "unscoped": proto_rep["unscoped"]},
        digests={"recorded": digest_rep["recorded"],
                 "checked": digest_rep["checked"],
                 "skipped": digest_rep["skipped"],
                 "by_op": dict(sorted(by_op.items()))})
    rep["seconds"].update(setup=t_setup, checks=t_checks,
                          total=time.perf_counter() - t_start)
    print(json.dumps({"witness": rep}), flush=True)
    return 0


def _witness_blocks(torch, ck, dev, here, root) -> dict:
    """The fleet and economy blocks of :func:`witness_worker` (sizes in
    ``WITNESS_*``; on the CPU a small rehearsal) over the directory
    ``root``. Returns the numbers it measured."""
    import concurrent.futures
    import threading
    from pathlib import Path

    import numpy as np

    from pyconsensus_tpu_torch import ShardedOracle
    from pyconsensus_tpu_torch.econ import MarketEconomy, build_scenario
    from pyconsensus_tpu_torch.ops import build
    from pyconsensus_tpu_torch.serve import (AotCache, ConsensusFleet,
                                             ConsensusService, FleetConfig,
                                             LoadGenerator, MarketSession,
                                             ServeConfig)
    from pyconsensus_tpu_torch.serve.loadgen import RETRYABLE_CODES

    on_card = dev.type == "cuda"
    if on_card:
        (R, E), n_req, session_r, block_e, markets = (
            FLEET_REQUEST, WITNESS_REQUESTS, WITNESS_SESSION_R,
            WITNESS_SESSION_E, WITNESS_ECON_MARKETS)
    else:
        (R, E), n_req, session_r, block_e, markets = (48, 192), 8, 16, 8, 1
    store_dir = os.path.join(root, "store")
    events = []
    if on_card:
        # the kernel store holds this checkout's libraries; the worker's
        # build directory is empty, so the first launch adopts them from
        # the store under the build lock (no nvcc)
        store = AotCache(store_dir, device=dev)
        if not store.persist_libraries():
            raise RuntimeError("the kernel store did not take the libraries")
        build.BUILD_DIR = Path(root) / "build"
        build.attach_store(store)
        build.add_listener(lambda ev, src, secs: events.append((ev, src)))
        cfg = ServeConfig(aot_cache_dir=store_dir)
    else:
        cfg = ServeConfig(pallas_buckets=True)
    rng = np.random.default_rng(40)
    mats = [serve_reports(rng, R, E, na_frac=FLEET_NA)[0]
            for _ in range(WITNESS_DISTINCT)]
    want = [ShardedOracle(m, pca_method="power", device=dev).consensus()
            for m in mats]
    out = {"request": f"{R}x{E}", "requests": n_req}

    def one_block(fleet, kill=False):
        """``n_req`` requests from ``FLEET_CONCURRENCY`` clients, the
        retryable sheds retried; with ``kill`` one ``kill_worker('w1')``
        after half of them. Returns (wall seconds, tally)."""
        tally = {"sheds": {}, "retried": 0, "abandoned": 0, "done": 0,
                 "shed_queued": None}
        lock = threading.Lock()
        pacer = LoadGenerator(None, shapes=((1, 1),), seed=40)

        def one(i):
            for attempt in range(FLEET_RETRIES + 1):
                try:
                    got = fleet.submit(
                        reports=mats[i % WITNESS_DISTINCT]).result(300)
                    break
                except Exception as exc:  # noqa: BLE001 — tallied
                    code = getattr(exc, "error_code", None)
                    if code not in RETRYABLE_CODES:
                        raise
                    with lock:
                        tally["sheds"][code] = tally["sheds"].get(code,
                                                                  0) + 1
                        if attempt == FLEET_RETRIES:
                            tally["abandoned"] += 1
                            return
                        tally["retried"] += 1
                    time.sleep(pacer._retry_delay(exc, i, attempt))
            served_close(got, want[i % WITNESS_DISTINCT], 0.0,
                         f"witnessed request {i}", exact_all=True)
            with lock:
                tally["done"] += 1
                fire = kill and tally["done"] == n_req // 2
            if fire:
                tally["shed_queued"] = fleet.kill_worker("w1")[
                    "shed_queued"]

        def client(c):
            for i in range(c, n_req, FLEET_CONCURRENCY):
                one(i)

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(
                FLEET_CONCURRENCY) as pool:
            list(pool.map(client, range(FLEET_CONCURRENCY)))
        return time.perf_counter() - t0, tally

    t0 = time.perf_counter()
    fleet = ConsensusFleet(FleetConfig(
        n_workers=FLEET_WORKERS, log_dir=os.path.join(root, "log"),
        worker=cfg), device=dev).start(warmup=False)
    try:
        for w in fleet.workers.values():     # each worker's key, untimed
            w.service.resolve(reports=mats[0], timeout=300)
        if on_card:
            torch.cuda.synchronize()
        ck.reset_launch_counts()
        wall, _ = one_block(fleet)
        counts = ck.launch_counts()
        out["rate"] = n_req / wall
        out["per_request"] = {
            b: counts[k] / n_req for b, k in zip(
                ("B.1", "B.2", "B.3"), CUDA_TIER_KERNELS)}
        launched = dict(counts)
        ck.reset_launch_counts()
        _, tally = one_block(fleet, kill=True)
        if tally["abandoned"] or tally["shed_queued"] is None:
            raise RuntimeError(f"witnessed kill: {tally}")
        out["kill"] = tally
        out["abandoned"] = tally["abandoned"]
        # a durable session, its owner killed after round 2's first append
        blocks = [[serve_reports(rng, session_r, block_e)[0]
                   for _ in range(2)] for _ in range(2)]
        whole = MarketSession("ref", session_r, device=dev)
        want_rounds = []
        for rnd in blocks:
            for b in rnd:
                whole.append(b)
            want_rounds.append(whole.resolve())
        fleet.create_session("market", n_reporters=session_r)
        got = []
        for k, rnd in enumerate(blocks):
            for j, b in enumerate(rnd):
                fleet.append("market", b)
                if k == 1 and j == 0:
                    victim = fleet.owner_of("market")
                    t1 = time.perf_counter()
                    info = fleet.kill_worker(victim)
                    out["takeover_s"] = time.perf_counter() - t1
            got.append(fleet.submit(session="market").result(timeout=300))
        if info["sessions_migrated"] != [("market",
                                          fleet.owner_of("market"))]:
            raise RuntimeError(f"witnessed session takeover: {info}")
        for k, (g, w) in enumerate(zip(got, want_rounds)):
            for path, key in (("agents", "smooth_rep"),
                              ("events", "outcomes_adjusted")):
                if not np.array_equal(np.asarray(g[path][key]),
                                      np.asarray(w[key])):
                    raise RuntimeError(f"witnessed session round {k}: {key}"
                                       f" is not the never-killed bits")
    finally:
        fleet.close(drain=True)
    for k, v in ck.launch_counts().items():
        launched[k] += v
    fleet_s = time.perf_counter() - t0
    out["store"] = {
        "adopted": sorted(src for ev, src in events if ev == "store_adopt"),
        "nvcc": sum(1 for ev, _ in events if ev == "nvcc")}
    if on_card and (out["store"]["nvcc"]
                    or out["store"]["adopted"] != sorted(build.SOURCES)):
        raise RuntimeError(f"witnessed fleet: the libraries did not come "
                           f"from the store: {events}")

    # the economy block at reduced depth, through one service
    t0 = time.perf_counter()
    ck.reset_launch_counts()
    svc = ConsensusService(cfg, device=dev).start(warmup=False)
    try:
        res = MarketEconomy(svc, build_scenario(
            seed=40, rounds=ECON_ROUNDS, strategies=ECON_STRATEGIES,
            markets_per_strategy=markets,
            concurrency=ECON_CONCURRENCY)).run()
    finally:
        svc.close(drain=True)
    for k, v in ck.launch_counts().items():
        launched[k] += v
    played = np.asarray(res["trajectories"]["cartel_share"])
    if not np.isfinite(played).all():
        raise RuntimeError(f"witnessed economy: {played.tolist()}")
    out["economy"] = {"markets": res["n_sessions"], "wall_s": res["wall_s"],
                      "digest": res["mechanism_digest"]}
    out["launches"] = launched
    out["seconds"] = {"fleet": fleet_s,
                      "economy": time.perf_counter() - t0}
    return out


def stream_check(torch, out, R, E, algorithm, truth, label):
    """``check_result`` on a streamed (host numpy) result, and the truth
    recovered (>= 0.99 of the snapped outcomes). Returns that share."""
    check_result(torch, {k: torch.as_tensor(v) for k, v in out.items()},
                 R, E, algorithm)
    correct = float((out["outcomes_adjusted"] == truth).mean())
    if correct < 0.99:
        raise RuntimeError(f"{label}: the outcomes do not recover the truth "
                           f"({correct:.6f})")
    return correct


def report_chunks(torch, R, E, seed, dev, chunk=16_384):
    """The generator's float32 reports (NaN absent) drawn on the card in
    column chunks with one colluding block: yields ``(c0, c1, reports
    (R, c1 - c0) float32 host, truth (c1 - c0,) float64 host)``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    liar = torch.rand(R, generator=g, device=dev) < 0.1
    for i, c0 in enumerate(range(0, E, chunk)):
        c1 = min(E, c0 + chunk)
        x8, t = gen_reports(torch, R, c1 - c0, seed * 1000 + i, dev,
                            liar=liar)
        yield (c0, c1, float_reports(torch, x8, 0).cpu().numpy(),
               t.double().cpu().numpy())
        del x8


def host_reports(torch, R, E, seed, dev):
    """:func:`report_chunks` gathered into one host matrix:
    ``(reports (R, E) float32, truth (E,) float64)``."""
    import numpy as np

    out = np.empty((R, E), dtype=np.float32)
    truth = np.empty(E)
    for c0, c1, x, t in report_chunks(torch, R, E, seed, dev):
        out[:, c0:c1] = x
        truth[c0:c1] = t
    return out, truth


def streamed(torch, ck, src, p, panel, label, **kw):
    """One ``streaming_consensus`` call on the card with the launch counts
    set to 0 just before and read just after (the driver launches no
    kernel of ours: every count must stay 0) and the peak device memory
    from a reset. Returns ``(out, seconds, peak GiB)``."""
    from pyconsensus_tpu_torch import streaming_consensus

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    out = streaming_consensus(src, panel_events=panel, params=p, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = ck.launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"{label}: the streaming driver launched a "
                           f"kernel: {counts}")
    return out, secs, peak


def one_host_stream(torch, ck, args, dev):
    """Part 1 of the streaming phase's parity: the generator's float32
    ``--reporters`` x ``--events`` reports with NaN on the host, sztorc at
    ``max_iterations=1`` streamed in panels of ``STREAM_PANEL`` twice
    (the first carries the warm-ups). Returns ``(host, truth, out,
    [seconds of each call], [peak GiB of each call])``; ``out`` is the
    second call's."""
    from pyconsensus_tpu_torch import ConsensusParams

    R, E = args.reporters, args.events
    host, truth = host_reports(torch, R, E, args.seed + 11, dev)
    secs, peaks = [], []
    for _ in range(2):
        out, t, peak = streamed(torch, ck, host,
                                ConsensusParams(max_iterations=1),
                                STREAM_PANEL, f"sztorc {R}x{E} float32+NaN")
        secs.append(t)
        peaks.append(peak)
    return host, truth, out, secs, peaks


def two_hosts(torch, src, p, panel):
    """Two threads as hosts on the card, panels ``h::2`` each, summing
    through a rendezvous in host order (``contrib[0] + contrib[1]``, on
    the card for the statistics, on the host for the (R, k) and output
    stacks). Returns both results."""
    import threading

    from pyconsensus_tpu_torch import streaming_consensus

    bar = threading.Barrier(2, timeout=600)
    contrib, summed, results, errors = {}, {}, {}, []

    def make_allreduce(i):
        def allreduce(x):
            contrib[i] = x
            bar.wait()
            if i == 0:
                summed["v"] = contrib[0] + contrib[1]
            bar.wait()
            out = summed["v"]
            bar.wait()
            return out
        return allreduce

    def host(i):
        try:
            results[i] = streaming_consensus(
                src, panel_events=panel, params=p, host_id=i, n_hosts=2,
                allreduce=make_allreduce(i))
        except Exception as exc:           # noqa: BLE001 — re-raised below
            errors.append(exc)
            bar.abort()

    threads = [threading.Thread(target=host, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1200)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a host thread of the two-host split hung")
    return results[0], results[1]


def rep_gap(a, b):
    """The largest gap of two reputation vectors over the largest
    reputation of ``b``."""
    import numpy as np

    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / np.abs(b).max())


def hosts_equal_one(torch, results, single, what):
    """Each host's result against the single host's: ``compare_outputs``
    within ``MID_ATOL``, and ``this_rep`` and ``smooth_rep`` within
    ``STREAM_REP_RTOL`` of their largest value. Returns both worst
    gaps."""
    worst = rel = 0.0
    for i, r in enumerate(results):
        worst = max(worst, compare_outputs(torch, r, single, MID_ATOL,
                                           f"{what} host {i}"))
        for key in ("this_rep", "smooth_rep"):
            gap = rep_gap(r[key], single[key])
            if gap > STREAM_REP_RTOL:
                raise RuntimeError(f"{what} host {i}: {key} differs by "
                                   f"{gap:.3e} of its largest value")
            rel = max(rel, gap)
    return worst, rel


def staging_root(here):
    """The staging directory beside the checkout (``.ooc_stage/``, listed
    in ``.gitignore``; never ``chiprun_out/``, which is merged back), its
    free bytes and its file system's type (from ``/proc/mounts``)."""
    root = os.path.join(here, STAGE_DIR)
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    fstype, best = "unknown", ""
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) > 2 and root.startswith(parts[1]) \
                        and len(parts[1]) > len(best):
                    best, fstype = parts[1], parts[2]
    except OSError:
        pass
    return root, free, fstype, best


def stage_npy(torch, path, R, E, seed, dev):
    """Write :func:`report_chunks`' float32 reports (R, E) to an ``.npy``
    column chunk by column chunk, so the host holds one chunk. Returns
    ``(truth (E,), seconds)``."""
    import numpy as np

    t0 = time.perf_counter()
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                   shape=(R, E))
    truth = np.empty(E)
    for c0, c1, x, t in report_chunks(torch, R, E, seed, dev):
        mm[:, c0:c1] = x
        truth[c0:c1] = t
    mm.flush()
    del mm
    return truth, time.perf_counter() - t0


def streaming_phase(torch, args, ck, card, dev, launches, here,
                    keep=None):
    """Phase "streaming and the CLI": the out-of-core driver
    (``streaming_consensus``) and the command line on the card.

    1. parity at the bench shape: the generator's float32 reports with NaN
       (``--reporters`` x ``--events``) on the host, sztorc at
       ``max_iterations=1`` streamed in panels of ``STREAM_PANEL``
       against the in-memory ``Oracle(backend="torch")``: seconds side by
       side, 0 outcome flips, the largest ``smooth_rep`` gap under
       ``STREAM_REP_RTOL`` of its largest value, the peak device memory;
    2. the recorded out-of-core configuration, cut to ``OOC_E``
       (160,000 of its 500,000) columns of float32 staged column-chunk
       by column-chunk to an ``.npy`` in ``STAGE_DIR`` (E cut to fit the
       free disk, never R), resolved memory-mapped under sztorc,
       fixed-variance and dbscan-jit: seconds, panels a pass, peak device
       memory (below the source's bytes; sztorc's within 10% of part 1's
       streaming peak), the truth;
    3. k-means at R x ``KMEANS_OOC_E`` (4,096), and hierarchical and
       dbscan at ``--hybrid-r`` x ``--hybrid-e`` against the in-memory
       ``Oracle`` (outcomes equal, the host clustering native);
    4. two hosts on one card (threads) equal to one, the reputations
       within ``STREAM_REP_RTOL`` of their largest value: sztorc at part
       1's shape, k-means at part 3's;
    5. the command line as three subprocesses side by side:
       ``--example`` (under
       ``--profile``), ``--file <part 1's matrix as .npy> --shard``
       (B.1-B.3 launches printed; B.5, B.6, B.3 over several cards)
       and ``--file ... --stream``, each
       exiting 0, the streamed outcome counts equal to the in-memory
       run's.

    ``keep`` (a dict) gains ``"stream"``: part 1's host matrix, truth,
    streamed result, seconds and peak, for the batch x event phase.
    """
    import numpy as np

    from pyconsensus_tpu_torch import ConsensusParams, Oracle, obs
    from pyconsensus_tpu_torch.models.clustering import KMEANS_ITERS

    R, E, P = args.reporters, args.events, STREAM_PANEL
    stage, free, fstype, mount = staging_root(here)
    log(f"staging directory {stage}: {free / 1e9:.3f} GB free "
        f"(shutil.disk_usage), file system {fstype} at {mount!r}")
    try:
        # -- 1. parity at the bench shape --------------------------------
        host, truth, out_s, secs_s, peaks = one_host_stream(torch, ck, args,
                                                            dev)
        p1 = ConsensusParams(max_iterations=1)
        tag = f"sztorc {R}x{E} float32+NaN"
        # whether the prefetched panel is allocated at the peak is a race
        # of the two threads: one panel (0.31 GiB at 10k x 8192) either way
        peak_s = max(peaks)
        stream_check(torch, out_s, R, E, "sztorc", truth, tag)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        oracle = Oracle(reports=host, max_iterations=1)
        t_intake = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = oracle.consensus()
        t_mem = time.perf_counter() - t0
        del oracle
        torch.cuda.empty_cache()
        flips = int((res["events"]["outcomes_adjusted"]
                     != out_s["outcomes_adjusted"]).sum())
        gap = rep_gap(res["agents"]["smooth_rep"], out_s["smooth_rep"])
        n_panels = -(-E // P)
        log(f"streaming parity {tag}: out of core {secs_s[1]:.3f} s "
            f"(first call {secs_s[0]:.3f} s; {n_panels} panels of {P}, two "
            f"passes), peak {peak_s:.3f} GiB (the two calls {peaks[0]:.3f}, "
            f"{peaks[1]:.3f}); in memory Oracle "
            f"consensus() {t_mem:.3f} s + intake {t_intake:.3f} s; out of "
            f"core / in memory {secs_s[1] / t_mem:.2f}x "
            f"({secs_s[1] / (t_mem + t_intake):.2f}x with the intake) on "
            f"{card}; outcome flips {flips}, max |smooth_rep gap| "
            f"{gap:.3e} of its largest value (limit {STREAM_REP_RTOL})")
        if flips or gap > STREAM_REP_RTOL:
            raise RuntimeError(f"{tag}: the streamed resolution differs "
                               "from the in-memory one")
        if keep is not None:
            keep["stream"] = (host, truth, out_s, secs_s[1], peak_s)

        # -- 4a. two hosts at the bench shape (part 1's single host) ------
        t0 = time.perf_counter()
        worst, rel = hosts_equal_one(torch, two_hosts(torch, host, p1, P),
                                     out_s, f"two hosts {tag}")
        log(f"two hosts on one card {tag}: {time.perf_counter() - t0:.3f} s"
            f"; each host equal to one host (exact keys equal, continuous "
            f"max |diff| {worst:.3e} <= {MID_ATOL}, reputations within "
            f"{rel:.3e} of their largest <= {STREAM_REP_RTOL})")

        # -- 5. the command line ------------------------------------------
        cli_phase(torch, host[:, :CLI_E], stage, launches, card)
        del host, res

        # -- 2. the recorded out-of-core configuration -------------------
        E_ooc = min(OOC_E, int(0.4 * free / (4 * R)) // P * P)
        if E_ooc < OOC_E:
            log(f"out-of-core E cut from {OOC_E} to {E_ooc} to "
                f"fit 40% of the staging disk's {free / 1e9:.3f} GB free")
        path = os.path.join(stage, "reports.npy")
        truth_ooc, t_stage = stage_npy(torch, path, R, E_ooc,
                                       args.seed + 12, dev)
        src_bytes = 4 * R * E_ooc
        log(f"staged {R}x{E_ooc} float32 ({src_bytes / 1e9:.3f} GB) to "
            f"{os.path.relpath(path, here)} in {t_stage:.3f} s "
            f"({src_bytes / 1e9 / t_stage:.3f} GB/s)")
        geo = geometry_knobs(E_ooc)
        for algo, knobs in (("sztorc", {}), ("fixed-variance", {}),
                            ("dbscan-jit", dict(
                                dbscan_eps=geo["dbscan_eps"],
                                dbscan_min_samples=4))):
            p = ConsensusParams(algorithm=algo, max_iterations=1, **knobs)
            label = f"{algo} {R}x{E_ooc} memory-mapped .npy"
            out, secs, peak = streamed(torch, ck, path, p, P, label)
            correct = stream_check(torch, out, R, E_ooc, algo, truth_ooc,
                                   label)
            log(f"out of core {label}: {secs:.3f} s on {card}; "
                f"{-(-E_ooc // P)} panels a pass; peak {peak:.3f} GiB of a "
                f"{src_bytes / 2 ** 30:.3f} GiB source; outcomes == truth "
                f"{correct:.6f}; iterations {out['iterations']}")
            if peak * 2 ** 30 >= src_bytes:
                raise RuntimeError(f"{label}: the peak device memory is not "
                                   "below the source's bytes")
            if algo == "sztorc" and abs(peak - peak_s) > 0.1 * peak_s:
                raise RuntimeError(
                    f"{label}: the peak {peak:.3f} GiB grew with E from "
                    f"{peak_s:.3f} GiB at {R}x{E}")
        os.unlink(path)

        # -- 3. k-means, and the hybrids against the in-memory Oracle ------
        Ek = KMEANS_OOC_E
        host_k, truth_k = host_reports(torch, R, Ek, args.seed + 13, dev)
        pk = ConsensusParams(algorithm="k-means", max_iterations=1)
        label = f"k-means {R}x{Ek}"
        Pk = Ek // 2            # two panels of k-means' width
        out_k, secs, peak = streamed(torch, ck, host_k, pk, Pk, label)
        correct = stream_check(torch, out_k, R, Ek, "k-means", truth_k,
                               label)
        passes = 3 + 2 * KMEANS_ITERS
        log(f"out of core {label}: {secs:.3f} s on {card}; "
            f"{-(-Ek // Pk)} panels a pass, {passes} passes (the seeds, "
            f"{KMEANS_ITERS} Lloyd iterations of two, the final assignment,"
            f" the resolve); peak {peak:.3f} GiB; outcomes == truth "
            f"{correct:.6f}")
        t0 = time.perf_counter()
        worst, rel = hosts_equal_one(torch,
                                     two_hosts(torch, host_k, pk, Pk),
                                     out_k, f"two hosts {label}")
        log(f"two hosts on one card {label}: "
            f"{time.perf_counter() - t0:.3f} s; each host equal to one "
            f"host (exact keys equal, continuous max |diff| {worst:.3e} <= "
            f"{MID_ATOL}, reputations within {rel:.3e} of their largest "
            f"<= {STREAM_REP_RTOL})")
        del host_k
        Rh, Eh = args.hybrid_r, args.hybrid_e
        host_h, truth_h = host_reports(torch, Rh, Eh, args.seed + 14, dev)
        geo = geometry_knobs(Eh)
        for algo in ("hierarchical", "dbscan"):
            knobs = (dict(hierarchy_threshold=geo["hierarchy_threshold"])
                     if algo == "hierarchical" else
                     dict(dbscan_eps=geo["dbscan_eps"],
                          dbscan_min_samples=4))
            p = ConsensusParams(algorithm=algo, max_iterations=1, **knobs)
            label = f"{algo} {Rh}x{Eh}"
            obs.reset()
            out, secs, peak = streamed(torch, ck, host_h, p, P, label)
            spans = [e for e in obs.events()
                     if e["name"] == f"clustering.{algo}"]
            if not spans or not all(e["attrs"]["native"] is True
                                    for e in spans):
                raise RuntimeError(f"{label}: the host clustering did not "
                                   "run on the native library")
            stream_check(torch, out, Rh, Eh, algo, truth_h, label)
            t0 = time.perf_counter()
            ref = Oracle(reports=host_h, algorithm=algo, max_iterations=1,
                         **knobs).consensus()
            t_mem = time.perf_counter() - t0
            if not np.array_equal(ref["events"]["outcomes_adjusted"],
                                  out["outcomes_adjusted"]):
                raise RuntimeError(f"{label}: outcomes differ from the "
                                   "in-memory Oracle's")
            log(f"out of core {label}: {secs:.3f} s (in memory Oracle "
                f"{t_mem:.3f} s) on {card}; peak {peak:.3f} GiB; clusters "
                f"{spans[-1]['attrs']['clusters']}; native True; outcomes "
                f"equal to the in-memory Oracle's")
        del host_h
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    torch.cuda.empty_cache()


def grid_devices(args, n):
    """``n`` devices for the batch x event phase: the first ``n`` cards
    under ``--mesh-devices``, else ``n`` virtual devices of card 0."""
    if args.mesh_devices:
        return [f"cuda:{i}" for i in range(min(n, args.mesh_devices))]
    return ["cuda:0"] * n


def batch_mesh_phase(torch, args, ck, card, dev, drive, kept, here):
    """Phase "batch x event mesh": the grid (``make_mesh(batch > 1)``)
    and what runs on it, each line beside ``card``. On one card every
    grid is virtual (devices of card 0); ``--mesh-devices 4`` puts it on
    the cards (the serve mesh is then ``serve_mesh``'s 2 x 2).

    1. sztorc on a 2 x 2 grid through ``drive`` (B.5, B.6 and B.3
       launched): every key bit for bit the 1 x 2 event mesh's, and the
       rates of both;
    2. the serve block on the grid (``sharded_buckets=True``,
       ``max_batch=8``, 48 requests of ``GRID_REQUEST`` float32 with
       ``GRID_NA`` absent, from ``SERVE_CONCURRENCY`` threads) beside the
       same block on the single-device bucket: requests/s, p50 and p99;
       every grid request on ``path="bucket_sharded"``, every launch
       count 0, each result held to the direct ``Oracle`` (outcomes and
       iterations exact, the rest within ``SERVE_ATOL``);
    3. the 10,000-trial sweep (``SIM_R`` x ``SIM_E``) under
       ``GRID_SIM_ALGORITHMS`` over ``make_mesh(batch=4, event=1)``:
       trials/s beside one device's, every key bit for bit;
    4. sztorc streamed at ``--reporters`` x ``--events`` float32 in
       panels of ``STREAM_PANEL`` over 4 event shards: seconds and peak,
       0 outcome flips and ``smooth_rep`` within ``STREAM_REP_RTOL`` of
       its largest value against the streaming phase's one-device result
       (``kept["stream"]``, not run again);
    5. ``--shard --simulate`` and ``--shard --stream`` (a ``GRID_CLI``
       corner of that matrix as ``.npy``) as subprocesses, exit 0.
    """
    import concurrent.futures

    import numpy as np

    from pyconsensus_tpu_torch import ConsensusParams, Oracle, obs
    from pyconsensus_tpu_torch.parallel.mesh import make_mesh
    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig
    from pyconsensus_tpu_torch.serve.sharded import mesh_fingerprint
    from pyconsensus_tpu_torch.sim import CollusionSimulator

    R, E = args.reporters, args.events
    four = grid_devices(args, GRID_SHARDS)

    def peaks_reset():
        torch.cuda.synchronize()
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)

    def peak():
        return max(torch.cuda.max_memory_allocated(i)
                   for i in range(torch.cuda.device_count())) / 2 ** 30

    # -- 1. one matrix on a 2 x 2 grid -----------------------------------
    x8, truth = gen_reports(torch, R, E, args.seed + 20, dev)
    p = ConsensusParams(storage_dtype="int8", max_iterations=1,
                        power_tol=1e-5,
                        pca_method="auto" if R > 4096 else "power-fused")
    grid = make_mesh(batch=2, devices=four)
    row = make_mesh(devices=four[:2])
    out_g, rate_g, counts = drive(x8, p, "sztorc on a 2x2 grid",
                                  path="sztorc mesh", mesh=grid)
    out_r, rate_r, _ = drive(x8, p, "sztorc on a 1x2 event mesh",
                             path="sztorc mesh", mesh=row)
    differ = [k for k, v in out_r.items() if isinstance(v, torch.Tensor)
              and not torch.equal(out_g[k], v)]
    if differ:
        raise RuntimeError(f"2x2 grid: keys differ from the 1x2 event "
                           f"mesh's: {differ}")
    correct = float((out_g["outcomes_adjusted"] == truth).float().mean())
    log(f"sztorc {R}x{E} int8 on a 2x2 grid ({four}): {rate_g:.4f} "
        f"resolutions/s, the 1x2 event mesh {rate_r:.4f} on {card}; every "
        f"key bit for bit; outcomes == truth {correct:.6f}; "
        f"{launch_text(counts)}")
    del x8, out_g, out_r
    torch.cuda.empty_cache()

    # -- 2. the serve block on the grid and on one device -------------------
    rng = np.random.default_rng(args.seed + 21)
    Rq, Eq = GRID_REQUEST
    mats = [serve_reports(rng, Rq, Eq, na_frac=GRID_NA)[0]
            for _ in range(SERVE_REQUESTS)]
    serve_devs = grid_devices(args, GRID_SERVE_DEVICES)

    def block(sharded, label):
        cfg = ServeConfig(sharded_buckets=sharded, max_batch=8,
                          batch_window_ms=2.0, pallas_buckets=False)
        svc = (ConsensusService(cfg, devices=serve_devs) if sharded
               else ConsensusService(cfg, device=dev))
        if sharded and svc.mesh is None:
            raise RuntimeError(f"{label}: no serving mesh over {serve_devs}")
        svc.warm_buckets(svc.buckets_for([GRID_REQUEST]))
        svc.start(warmup=False)
        path = "bucket_sharded" if sharded else "bucket"
        before = obs.value("pyconsensus_serve_requests_total", path=path,
                           outcome="ok") or 0
        lat = [0.0] * len(mats)
        results = [None] * len(mats)
        torch.cuda.synchronize()
        ck.reset_launch_counts()

        def client(worker):
            for i in range(worker, len(mats), SERVE_CONCURRENCY):
                t0 = time.perf_counter()
                results[i] = svc.submit(reports=mats[i]).result(timeout=300)
                lat[i] = time.perf_counter() - t0

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(SERVE_CONCURRENCY) as pool:
            list(pool.map(client, range(SERVE_CONCURRENCY)))
        wall = time.perf_counter() - t0
        counts = ck.launch_counts()
        svc.close(drain=True)
        served = (obs.value("pyconsensus_serve_requests_total", path=path,
                            outcome="ok") or 0) - before
        if served != len(mats):
            raise RuntimeError(f"{label}: {served} of {len(mats)} requests "
                               f"on path={path!r}")
        if any(counts.values()):
            raise RuntimeError(f"{label}: kernels launched: {counts}")
        topo = mesh_fingerprint(svc.mesh) if sharded else "single"
        ms = [1e3 * x for x in lat]
        return results, (f"{len(mats) / wall:.4f} requests/s, p50 "
                         f"{percentile(ms, 0.5):.3f} ms, p99 "
                         f"{percentile(ms, 0.99):.3f} ms ({topo})")

    on_grid, grid_text = block(True, "serve block on the grid")
    on_one, one_text = block(False, "serve block on one device")
    worst = 0.0
    for i, m in enumerate(mats):
        direct = Oracle(reports=m, pca_method="power",
                        device=dev).consensus()
        worst = max(worst, served_close(on_grid[i], direct, SERVE_ATOL,
                                        f"grid request {i}"),
                    served_close(on_one[i], direct, SERVE_ATOL,
                                 f"one-device request {i}"))
    log(f"serve block {SERVE_REQUESTS} requests of {Rq}x{Eq} float32 "
        f"({GRID_NA:.0%} absent) at concurrency {SERVE_CONCURRENCY}, "
        f"max_batch 8: grid {grid_text}; single-device bucket {one_text}; "
        f"on {card}; every request's outcomes and iterations equal to the "
        f"direct Oracle's, continuous max |diff| {worst:.3e} <= "
        f"{SERVE_ATOL}; every launch count 0")
    del mats, on_grid, on_one

    # -- 3. the sweep's trials over the devices -----------------------------
    sim_mesh = make_mesh(batch=GRID_SHARDS, event=1, devices=four)
    for algo in GRID_SIM_ALGORITHMS:
        kw = _sim_knobs(algo, max_iterations=1)
        res, secs = {}, {}
        for tag, sim in (("one", CollusionSimulator(device=dev, **kw)),
                         ("mesh", CollusionSimulator(mesh=sim_mesh, **kw))):
            sim.run(SIM_LF, SIM_VAR, SIM_T, seed=args.seed)     # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[tag] = sim.run(SIM_LF, SIM_VAR, SIM_T, seed=args.seed)
            secs[tag] = time.perf_counter() - t0
        differ = [k for k, v in res["one"].items() if k != "mean"
                  and not np.array_equal(res["mesh"][k], v)]
        if differ:
            raise RuntimeError(f"{algo} sweep over the mesh: keys differ "
                               f"from one device's: {differ}")
        n = len(SIM_LF) * len(SIM_VAR) * SIM_T
        log(f"{algo} sweep {SIM_R}x{SIM_E}, {n} trials over "
            f"make_mesh(batch={GRID_SHARDS}, event=1) ({four}): "
            f"{n / secs['mesh']:.1f} trials/s, one device "
            f"{n / secs['one']:.1f} trials/s, on {card}; every key bit for "
            f"bit the single-device sweep's")

    # -- 4. the streamed panels over event shards -----------------------------
    # the process-mesh phase reads it too; run() clears it after that
    host, truth, out_1, secs_1, peak_1 = kept["stream"]
    peaks_reset()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    from pyconsensus_tpu_torch import streaming_consensus

    out_m = streaming_consensus(host, panel_events=STREAM_PANEL,
                                params=ConsensusParams(max_iterations=1),
                                mesh=make_mesh(devices=four))
    torch.cuda.synchronize()
    secs_m = time.perf_counter() - t0
    peak_m = peak()
    counts = ck.launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"streamed over shards: kernels launched "
                           f"{counts}")
    flips = int((out_m["outcomes_adjusted"]
                 != out_1["outcomes_adjusted"]).sum())
    gap = rep_gap(out_m["smooth_rep"], out_1["smooth_rep"])
    log(f"sztorc {R}x{E} float32+NaN streamed over {len(four)} event "
        f"shards ({four}), panels of {STREAM_PANEL}: {secs_m:.3f} s, peak "
        f"{peak_m:.3f} GiB (one device, phase 9: {secs_1:.3f} s, peak "
        f"{peak_1:.3f} GiB) on {card}; outcome flips {flips}, max "
        f"|smooth_rep gap| {gap:.3e} of its largest value (limit "
        f"{STREAM_REP_RTOL}); every launch count 0")
    if flips or gap > STREAM_REP_RTOL:
        raise RuntimeError("the sharded stream differs from one device's")

    # -- 5. the command line --------------------------------------------------
    stage = staging_root(here)[0]
    try:
        path = os.path.join(stage, "grid.npy")
        np.save(path, host[:GRID_CLI[0], :GRID_CLI[1]])
        del host
        t0 = time.perf_counter()
        out = _cli(["--file", path, "--stream", "--shard", "--panel-events",
                    "2048", "--iterations", "1"], here)
        t_stream = time.perf_counter() - t0
        if "device(s)) ===" not in out:
            raise RuntimeError("--shard --stream printed no mesh header")
        t0 = time.perf_counter()
        out = _cli(["--simulate", "--shard", "--trials", "200"], here)
        t_sim = time.perf_counter() - t0
        note = [ln for ln in out.splitlines() if "trials over" in ln]
        if not note:
            raise RuntimeError("--shard --simulate printed no mesh header")
        log(f"cli --file {GRID_CLI[0]}x{GRID_CLI[1]} .npy --stream --shard: "
            f"exit 0 in {t_stream:.3f} s; --simulate --shard: exit 0 in "
            f"{t_sim:.3f} s ({note[0].strip()}) on {card}")
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    torch.cuda.empty_cache()


def process_params(R, mi, **kw):
    """The int8 sztorc parameters of the process-mesh phase (the main
    path's)."""
    from pyconsensus_tpu_torch import ConsensusParams

    return ConsensusParams(storage_dtype="int8", max_iterations=mi,
                           power_tol=1e-5, has_na=True,
                           pca_method="auto" if R > 4096 else "power-fused",
                           **kw)


def hybrid_params(E):
    """hierarchical at the geometry threshold, as the mesh phase runs
    it."""
    from pyconsensus_tpu_torch import ConsensusParams

    return ConsensusParams(algorithm="hierarchical", has_na=True,
                           hierarchy_threshold=geometry_knobs(E)[
                               "hierarchy_threshold"])


def decoded(placed):
    """int8 shards as float32 with NaN absent (the pad columns stay
    present zeros)."""
    from pyconsensus_tpu_torch.models.pipeline import decode_reports

    return placed._replace(shards=tuple(decode_reports(x)
                                        for x in placed.shards))


def run_workers(args, here, stage, world):
    """``world`` ranks of ``chip_smoke.py --process-worker``, each writing
    its log to ``stage``; when one exits non-zero, or the time is up,
    every other is killed (a peer would wait in a collective) and this
    raises with the logs. Returns each rank's log."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    base = [sys.executable, os.path.join(here, "chip_smoke.py"),
            "--process-world", str(world), "--process-port", str(port),
            "--process-stage", stage, "--reporters", str(args.reporters),
            "--events", str(args.events), "--hybrid-r", str(args.hybrid_r),
            "--hybrid-e", str(args.hybrid_e), "--seed", str(args.seed),
            "--resolutions", str(args.resolutions),
            *(["--profile"] if args.profile else [])]
    logs = [os.path.join(stage, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(base + ["--process-worker", str(r)],
                                          stdout=f, stderr=subprocess.STDOUT,
                                          cwd=here))
    deadline = time.monotonic() + PROCESS_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    texts = []
    for path in logs:
        with open(path) as f:
            texts.append(f.read())
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(
            f"process-mesh ranks {bad} exited "
            f"{[procs[r].returncode for r in bad]} (each killed after "
            f"{PROCESS_TIMEOUT} s or when a peer failed):\n" + "\n".join(
                f"--- rank {r}\n{texts[r][-4000:]}" for r in bad))
    return texts


def process_worker(args) -> int:
    """One rank of ``process_mesh_phase`` (``--process-worker RANK``): it
    joins the NCCL group of ``--process-world`` ranks at
    ``localhost:--process-port`` on its card (``initialize``), builds the
    process mesh (its card; a group of one: ``PROCESS_SHARDS`` shards of
    card 0), memory-maps the phase's int8 ``.npy`` and places its own
    columns, then times int8 sztorc at ``max_iterations`` 1 and 3 with the
    launch counts set to 0 just before and read just after; in a group of
    several also fixed-variance (float32) and hierarchical (the hybrid
    shape) on the mesh, and sztorc streamed over the group's hosts. It
    writes ``rank<r>.pt`` (the results) and ``rank<r>.json`` (seconds,
    rates, launches, peaks) to ``--process-stage``."""
    import numpy as np
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from pyconsensus_tpu_torch import sharded_consensus, streaming_consensus
    from pyconsensus_tpu_torch.ops import cuda_kernels as ck
    from pyconsensus_tpu_torch.parallel import distributed
    from pyconsensus_tpu_torch.parallel.mesh import place_event_shards

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world, rank, stage = args.process_world, args.process_worker, \
        args.process_stage
    t0 = time.perf_counter()
    distributed.initialize(f"localhost:{args.process_port}", world, rank)
    mesh = distributed.make_process_mesh(
        None if world > 1 else ["cuda:0"] * PROCESS_SHARDS)
    stats = {"rank": rank, "devices": [str(d) for d in mesh.local],
             "join_s": time.perf_counter() - t0}
    card = card_line()
    log(f"[rank {rank}] {mesh} joined in {stats['join_s']:.3f} s")
    outs = {}

    def resolve(x, p, tag, n):
        """A warm-up, then ``n`` resolutions with the counts and the peak
        reset just before."""
        sharded_consensus(x, params=p)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        t = time.perf_counter()
        for _ in range(n):
            out = sharded_consensus(x, params=p)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t) / n
        stats[tag] = {"s": secs, "rate": 1.0 / secs,
                      "launches": ck.launch_counts(),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        outs[tag] = {k: v.cpu() for k, v in out.items()
                     if isinstance(v, torch.Tensor)}
        log(f"[rank {rank}] {tag}: {stats[tag]['rate']:.4f} resolutions/s "
            f"on {card}, launches {stats[tag]['launches']}")

    R = args.reporters
    t = time.perf_counter()
    placed = place_event_shards(
        np.load(os.path.join(stage, "x8.npy"), mmap_mode="r"), mesh)
    torch.cuda.synchronize()
    stats["place_s"] = time.perf_counter() - t
    for mi in (1, 3):
        resolve(placed, process_params(R, mi), f"sztorc_{mi}",
                args.resolutions)
    if args.profile:
        # every rank resolves (the collectives need all); each writes its
        # own table
        os.makedirs(os.path.join(here, OUT_DIR), exist_ok=True)
        profile_resolution(torch, sharded_consensus, placed,
                           process_params(R, 1),
                           f"{card} (rank {rank} of {world})",
                           f"process_mesh_rank{rank}")
    if world > 1:
        from pyconsensus_tpu_torch import ConsensusParams

        resolve(decoded(placed), ConsensusParams(
            algorithm="fixed-variance", max_iterations=1, power_tol=1e-5,
            has_na=True), "fixed_variance", args.resolutions)
        del placed
        hyb = decoded(place_event_shards(
            np.load(os.path.join(stage, "xh8.npy"), mmap_mode="r"), mesh))
        resolve(hyb, hybrid_params(args.hybrid_e), "hierarchical", 1)
        del hyb
        torch.cuda.empty_cache()
        secs = []
        for _ in range(2):             # the first carries the warm-ups
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = streaming_consensus(
                os.path.join(stage, "stream.npy"), panel_events=STREAM_PANEL,
                params=ConsensusParams(max_iterations=1), n_hosts=world,
                host_id=rank)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        stats["stream"] = {"s": secs[-1], "first_s": secs[0],
                           "peak_gib": torch.cuda.max_memory_allocated()
                           / 2 ** 30}
        outs["stream"] = {k: torch.as_tensor(np.asarray(v))
                          for k, v in out.items()}
        log(f"[rank {rank}] stream: {secs[-1]:.3f} s on {card}")
    torch.save(outs, os.path.join(stage, f"rank{rank}.pt"))
    with open(os.path.join(stage, f"rank{rank}.json"), "w") as f:
        json.dump(stats, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def process_mesh_phase(torch, args, card, dev, drive, kept, here):
    """Phase "process mesh": the event mesh across processes
    (``parallel/distributed.py make_process_mesh``), every rank a
    ``chip_smoke.py --process-worker`` process under ``PROCESS_TIMEOUT``
    (``run_workers``), the generator's int8 ``--reporters`` x
    ``--events`` matrix written once as ``.npy`` to ``STAGE_DIR`` and
    memory-mapped by every rank, which places its own columns.

    - One card: one process, an NCCL group of one over ``PROCESS_SHARDS``
      shards of card 0 (two processes cannot share a card under NCCL):
      int8 sztorc at ``max_iterations`` 1 and 3, every key bit for bit
      the one-controller mesh of as many shards (timed beside it), B.5,
      B.6 and B.3 launched.
    - ``--mesh-devices N``: N processes, one a card. Beside the
      one-controller N-card mesh (in this process) and one device: int8
      sztorc at ``max_iterations`` 1 and 3 (rates; every rank bit for bit
      the one-controller mesh; B.5, B.6, B.3 launches a rank),
      fixed-variance on the plain mesh core, float32 (rates, 0 outcome
      flips against one device), hierarchical at ``--hybrid-r`` x
      ``--hybrid-e`` (seconds, 0 flips), and sztorc streamed at full size
      over N NCCL hosts against the streaming phase's single host
      (``kept["stream"]``: seconds, 0 flips, ``smooth_rep`` within
      ``STREAM_REP_RTOL`` of its largest value). Every rank's results
      equal every other's bit for bit."""
    import numpy as np

    from pyconsensus_tpu_torch import ConsensusParams
    from pyconsensus_tpu_torch.models.pipeline import decode_reports
    from pyconsensus_tpu_torch.parallel.mesh import (make_mesh,
                                                     place_event_shards)

    R, E = args.reporters, args.events
    world = args.mesh_devices or 1
    if world > 1:
        mesh, where = make_mesh(event=world), f"{world} cards"
    else:
        mesh = make_mesh(devices=[dev] * PROCESS_SHARDS)
        where = f"{PROCESS_SHARDS} shards of one card"
    stage = os.path.join(here, STAGE_DIR, "process_mesh")
    shutil.rmtree(stage, ignore_errors=True)
    os.makedirs(stage)
    try:
        x8, truth = gen_reports(torch, R, E, args.seed + 30, dev)
        np.save(os.path.join(stage, "x8.npy"), x8.cpu().numpy())
        placed = place_event_shards(
            np.load(os.path.join(stage, "x8.npy"), mmap_mode="r"), mesh)
        ref, rates = {}, {}
        for mi in (1, 3):
            p = process_params(R, mi)
            out, rates["mesh", mi], _ = drive(
                placed, p, f"sztorc one-controller mesh ({where}) "
                f"max_iterations={mi}", "sztorc mesh")
            ref[f"sztorc_{mi}"] = out
            if world > 1:
                _, rates["one", mi], _ = drive(
                    x8, p, f"sztorc one device max_iterations={mi}")
        one = {}
        if world > 1:
            p = ConsensusParams(algorithm="fixed-variance", max_iterations=1,
                                power_tol=1e-5, has_na=True)
            one["fixed_variance"], rates["one", "fv"] = timed(
                torch, decode_reports(x8), p, args.resolutions)
            ref["fixed_variance"], rates["mesh", "fv"], _ = drive(
                decoded(placed), p, f"fixed-variance one-controller mesh "
                f"({where}) float32", "mesh plain")
            Rh, Eh = args.hybrid_r, args.hybrid_e
            xh8, _ = gen_reports(torch, Rh, Eh, args.seed + 31, dev)
            np.save(os.path.join(stage, "xh8.npy"), xh8.cpu().numpy())
            ph = hybrid_params(Eh)
            one["hierarchical"], rates["one", "hier"] = timed(
                torch, decode_reports(xh8), ph, 1)
            ref["hierarchical"], rates["mesh", "hier"] = timed(
                torch, decoded(place_event_shards(xh8, mesh)), ph, 1)
            del xh8
            np.save(os.path.join(stage, "stream.npy"), kept["stream"][0])
        del placed
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        texts = run_workers(args, here, stage, world)
        log(f"{world} worker process(es) ran in "
            f"{time.perf_counter() - t0:.3f} s")
        for text in texts:
            for line in text.strip().splitlines():
                log(f"  {line}")
        ranks = [torch.load(os.path.join(stage, f"rank{r}.pt"))
                 for r in range(world)]
        stats = []
        for r in range(world):
            with open(os.path.join(stage, f"rank{r}.json")) as f:
                stats.append(json.load(f))
        for r in range(1, world):
            for tag, got in ranks[r].items():
                differ = [k for k, v in ranks[0][tag].items()
                          if not torch.equal(got[k], v)]
                if differ:
                    raise RuntimeError(f"process mesh {tag}: rank {r} "
                                       f"differs from rank 0 in {differ}")
        for mi in (1, 3):
            tag = f"sztorc_{mi}"
            want = ref[tag]
            differ = [k for k, v in ranks[0][tag].items()
                      if not torch.equal(v, want[k].cpu())]
            if differ:
                raise RuntimeError(f"process mesh {tag}: keys differ from "
                                   f"the one-controller mesh's: {differ}")
            per = [{k: st[tag]["launches"][k] / (args.resolutions
                                                 * len(st["devices"]))
                    for k in PATH_KERNELS["sztorc mesh"]} for st in stats]
            if any(v == 0 for rank_ in per for v in rank_.values()):
                raise RuntimeError(f"process mesh {tag}: a rank did not "
                                   f"launch B.5, B.6 and B.3: {per}")
            correct = float((ranks[0][tag]["outcomes_adjusted"]
                             == truth.cpu()).float().mean())
            beside = (f", one device {rates['one', mi]:.4f}"
                      if world > 1 else "")
            log(f"sztorc {R}x{E} int8 max_iterations={mi} on the process "
                f"mesh ({world} rank(s)): "
                f"{[round(st[tag]['rate'], 4) for st in stats]} "
                f"resolutions/s a rank, the one-controller mesh ({where}) "
                f"{rates['mesh', mi]:.4f}{beside} on {card}; every rank's "
                f"keys bit for bit the one-controller mesh's; outcomes == "
                f"truth {correct:.6f}; launches a shard a resolution "
                f"(B.5, B.6, B.3) by rank "
                f"{[[round(v, 3) for v in p_.values()] for p_ in per]}; "
                f"peak {[round(st[tag]['peak_gib'], 3) for st in stats]} "
                f"GiB; placement {[round(st['place_s'], 3) for st in stats]}"
                f" s, joining {[round(st['join_s'], 3) for st in stats]} s")
        if world > 1:
            for tag, key, what in (("fixed_variance", "fv",
                                    "fixed-variance float32"),
                                   ("hierarchical", "hier",
                                    f"hierarchical {args.hybrid_r}x"
                                    f"{args.hybrid_e}")):
                got = ranks[0][tag]
                flips = int((got["outcomes_final"] != one[tag][
                    "outcomes_final"].cpu()).sum())
                same = all(torch.equal(v, ref[tag][k].cpu())
                           for k, v in got.items())
                log(f"{what} on the process mesh: "
                    f"{[round(st[tag]['rate'], 4) for st in stats]} "
                    f"resolutions/s a rank, the one-controller mesh "
                    f"{rates['mesh', key]:.4f}, one device "
                    f"{rates['one', key]:.4f} on {card}; outcome flips "
                    f"against one device {flips}; bit for bit the "
                    f"one-controller mesh {same}")
                if flips:
                    raise RuntimeError(f"process mesh {what}: {flips} "
                                       "outcomes differ from one device")
            _, _, single, secs1, _ = kept["stream"]
            got = {k: v.numpy() for k, v in ranks[0]["stream"].items()}
            flips = int((got["outcomes_final"]
                         != single["outcomes_final"]).sum())
            gap = rep_gap(got["smooth_rep"], single["smooth_rep"])
            log(f"sztorc {R}x{E} float32 streamed over {world} NCCL hosts: "
                f"{[round(st['stream']['s'], 3) for st in stats]} s a rank "
                f"(first run "
                f"{[round(st['stream']['first_s'], 3) for st in stats]}), "
                f"one host {secs1:.3f} s (the streaming phase) on {card}; "
                f"peak {[round(st['stream']['peak_gib'], 3) for st in stats]}"
                f" GiB; outcome flips {flips}, smooth_rep gap {gap:.3e}")
            if flips or gap > STREAM_REP_RTOL:
                raise RuntimeError("process mesh stream: the hosts differ "
                                   "from one host")
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    torch.cuda.empty_cache()


def timed(torch, x, p, n):
    """One warm-up and ``n`` timed resolutions of ``sharded_consensus``:
    ``(out, resolutions/s)``."""
    from pyconsensus_tpu_torch import sharded_consensus

    sharded_consensus(x, params=p)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        out = sharded_consensus(x, params=p)
    torch.cuda.synchronize()
    return out, n / (time.perf_counter() - t)


def _cli(args, here, timeout=900):
    """``python -m pyconsensus_tpu_torch <args>`` from the checkout; on
    failure its output is raised."""
    run = subprocess.run([sys.executable, "-m", "pyconsensus_tpu_torch",
                          *args], capture_output=True, text=True,
                         cwd=here, timeout=timeout)
    if run.returncode != 0:
        raise RuntimeError(f"pyconsensus_tpu_torch {' '.join(args)} exited "
                           f"{run.returncode}:\n{run.stdout[-4000:]}\n"
                           f"{run.stderr[-4000:]}")
    return run.stdout


def cli_phase(torch, host, stage, launches, card):
    """Part 5: the command line as subprocesses on the card, the three
    side by side (each is mostly its own process's start; no longer in
    turn, for the script's time): the default demo under
    ``--profile`` (a ``torch.profiler`` trace holding device kernels), and
    the first ``CLI_E`` events of part 1's matrix as an ``.npy`` through
    ``--shard`` (``ShardedOracle`` in memory; the module runs under a
    wrapper that prints its launch counts at exit) and through
    ``--stream``, one iteration each. Each exits 0, and the streamed
    outcome counts equal the in-memory run's."""
    import re

    import numpy as np

    here = os.path.dirname(stage)
    prof = os.path.join(stage, "profile")
    path = os.path.join(stage, "bench.npy")
    np.save(path, host)
    wrapper = ("import atexit, json, runpy, sys; "
               "from pyconsensus_tpu_torch.ops import cuda_kernels as ck; "
               "atexit.register(lambda: print('LAUNCHES ' + "
               "json.dumps(ck.launch_counts()), flush=True)); "
               "sys.argv = ['pyconsensus_tpu_torch'] + sys.argv[1:]; "
               "runpy.run_module('pyconsensus_tpu_torch', "
               "run_name='__main__', alter_sys=True)")
    module = [sys.executable, "-m", "pyconsensus_tpu_torch"]
    cmds = {"--example --profile": module + ["--example", "--profile", prof],
            "--shard": [sys.executable, "-c", wrapper, "--file", path,
                        "--shard", "--iterations", "1"],
            "--stream": module + ["--file", path, "--stream",
                                  "--iterations", "1"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, cwd=here)
             for k, c in cmds.items()}
    outs, secs = {}, {}
    try:
        for k, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            secs[k] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"cli {k} exited {proc.returncode}:\n"
                                   f"{out[-4000:]}\n{err[-4000:]}")
            outs[k] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if "Example (dense binary)" not in outs["--example --profile"]:
        raise RuntimeError("--example printed no demo table")
    traces = [f for f in os.listdir(prof) if f.startswith("trace-")]
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    on_card = sum(1 for e in events if e.get("cat") == "kernel")
    if not on_card:
        raise RuntimeError("--profile recorded no device kernel")
    out = outs["--shard"]
    counts = json.loads(out.rsplit("LAUNCHES ", 1)[1].splitlines()[0])
    # --shard puts the events over every local card: one card runs the
    # single-device fused path, several the fused mesh
    path_kernels = (CUDA_TIER_KERNELS if torch.cuda.device_count() == 1
                    else PATH_KERNELS["sztorc mesh"])
    for k in path_kernels:
        if counts.get(k, 0) == 0:
            raise RuntimeError(f"cli --shard: {k} never launched: {counts}")
        launches[k] += counts[k]
    finals, in_events = [], False
    for line in out.splitlines():
        s = line.strip()
        if s == "Events":
            in_events = True
        elif in_events and re.match(r"^\d+\s", s):
            finals.append(float(s.split()[2]))
        elif in_events and s.startswith("participation"):
            break
    finals = np.asarray(finals)
    mem_counts = "/".join(str(int((finals == v).sum()))
                          for v in (0.0, 0.5, 1.0))
    m = re.search(r"outcomes 0/0\.5/1: (\d+/\d+/\d+)", outs["--stream"])
    if m is None or m.group(1) != mem_counts or len(finals) != host.shape[1]:
        raise RuntimeError(f"cli --stream outcome counts "
                           f"{m and m.group(1)} != --shard's {mem_counts} "
                           f"({len(finals)} events parsed)")
    os.unlink(path)
    log(f"cli side by side, seconds from the common start: --example "
        f"--profile exit 0 after {secs['--example --profile']:.3f} s, "
        f"{len(traces)} torch.profiler trace(s), {len(events)} events, "
        f"{on_card} of them device kernels; --file {host.shape[0]}x"
        f"{host.shape[1]} .npy --shard exit 0 after {secs['--shard']:.3f} "
        f"s, launches { {k: counts[k] for k in path_kernels}}; --stream "
        f"exit 0 after {secs['--stream']:.3f} s; outcomes 0/0.5/1 "
        f"{m.group(1)} in both, on {card}")


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


def tune_phase(torch, args, ck, card, dev, drive, here):
    """The launch-shape autotuner at full size (``--only tune``, or after
    the main paths): the sweeps into a cache under a temporary directory,
    a fresh process's cache hit, the main path under the installed
    winners against the built-in shapes, the pipeline-depth sweep and the
    stream bandwidth (the module docstring). Every provider it installs is
    taken out again, so the other phases keep the built-in shapes."""
    import tempfile

    from pyconsensus_tpu_torch import ConsensusParams, obs
    from pyconsensus_tpu_torch.tune import (autotune_cov,
                                            autotune_pipeline_depth,
                                            autotune_resolve,
                                            default_provider,
                                            device_generation,
                                            stream_bandwidth_bytes_per_s)

    R, E = args.reporters, args.events
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    path = os.path.join(tmp, "autotune.json")
    kinds = ("row_tile_splits", "col_tile_splits", "resolve_block_cols")
    try:
        x8, truth = gen_reports(torch, R, E, args.seed + 2, dev)
        torch.cuda.synchronize()
        log(f"generation {device_generation(dev)}; cache {path} (never "
            "the default file)")
        t0 = time.perf_counter()
        entries = dict(autotune_cov(E, n_reporters=R, storage_dtype="int8",
                                    x=x8, path=path, force=True,
                                    repeats=TUNE_REPEATS))
        entries["resolve_block_cols"] = autotune_resolve(
            R, n_events=E, storage_dtype="int8", x=x8, path=path,
            force=True, repeats=TUNE_REPEATS)
        log(f"sweeps of {R}x{E} int8 took "
            f"{time.perf_counter() - t0:.3f} s")
        what = {"row_tile_splits": "row-tile pass split count (through "
                "B.1)", "col_tile_splits": "column-tile pass split count "
                "(through B.1)", "resolve_block_cols": "resolve panel width "
                "(B.3)"}
        for kind in kinds:
            e = entries[kind]
            times = ", ".join(
                f"{c}: {e['timings_ms'][str(c)]:.4f} "
                f"[{e['iqr_ms'][str(c)][0]:.4f}, {e['iqr_ms'][str(c)][1]:.4f}]"
                for c in e["candidates"])
            log(f"{what[kind]}: every candidate agrees with the built-in "
                f"{e['builtin']} (snapped outcomes and absent counts bit "
                f"for bit, the rest within {FULL_RTOL} of max(max |ref|, "
                f"1)) and with the plain version (every output within that "
                f"band); fastest median {e['fastest']}, persisted "
                f"{e['value']} (a candidate replaces the built-in only when "
                f"its interquartile range lies below the built-in's); median "
                f"[first, third quartile] ms a call by candidate "
                f"({TUNE_REPEATS} interleaved rounds, CUDA events) "
                f"{{{times}}} on {card}")

        # a fresh process on that cache: a hit of every kind, no sweep,
        # the file as it was
        st = os.stat(path)
        before = (st.st_ino, st.st_mtime_ns, open(path, "rb").read())
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "pyconsensus_tpu_torch.tune",
             "--reporters", str(R), "--events", str(E), "--storage-dtype",
             "int8", "--cache", path], capture_output=True, text=True,
            cwd=here, timeout=600)
        secs = time.perf_counter() - t0
        if run.returncode != 0:
            raise RuntimeError(f"python -m pyconsensus_tpu_torch.tune "
                               f"exited {run.returncode}:\n"
                               f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
        lines = run.stdout.strip().splitlines()
        if len(lines) != 1:
            raise RuntimeError(f"the tune command printed {len(lines)} "
                               "lines, not one")
        line = json.loads(lines[0])
        for kind in kinds:
            if line[kind] != entries[kind]:
                raise RuntimeError(f"the fresh process's {kind} is not the "
                                   "persisted entry")
        if "sweeps 0, cache hits 3" not in run.stderr:
            raise RuntimeError(f"the fresh process swept: {run.stderr}")
        st = os.stat(path)
        if (st.st_ino, st.st_mtime_ns, open(path, "rb").read()) != before:
            raise RuntimeError("the fresh process rewrote the cache")
        log(f"python -m pyconsensus_tpu_torch.tune in a fresh process: "
            f"cache hits 3, sweeps 0, the file untouched ({secs:.3f} s)")

        # the main path under the winners against the built-in shapes, in
        # turn (built-in, tuned, tuned, built-in)
        p = ConsensusParams(algorithm="sztorc", storage_dtype="int8",
                            max_iterations=1, power_tol=1e-5,
                            pca_method="auto" if R > 4096 else "power-fused")
        provider = default_provider(path, device=dev)
        hits0 = {k: obs.value("pyconsensus_autotune_cache_hits_total",
                              kind=k) or 0 for k in kinds}
        runs = {"built-in": [], "tuned": []}
        for label in ("built-in", "tuned", "tuned", "built-in"):
            with ck.tuned_shapes(provider if label == "tuned" else None):
                runs[label].append(drive(x8, p, f"sztorc under the {label} "
                                         "launch shapes"))
        hits = {k: (obs.value("pyconsensus_autotune_cache_hits_total",
                              kind=k) or 0) - hits0[k] for k in kinds}
        if min(hits.values()) < 1:
            raise RuntimeError(f"the tuned run did not look every kind up "
                               f"in the cache: {hits}")
        counts = [c for label in runs for _, _, c in runs[label]]
        if any(c != counts[0] for c in counts):
            raise RuntimeError(f"the launches differ between the shapes: "
                               f"{counts}")
        n = args.resolutions
        per = {k: counts[0][k] / n for k in CUDA_TIER_KERNELS}
        if per["scores_dirfix_pass"] != 1 or \
                per["resolve_certainty_fused"] != 1:
            raise RuntimeError(f"B.2/B.3 launched {per} a resolution")
        base = runs["built-in"][0][0]
        worst = max(compare_outputs(torch, out, base, MID_ATOL,
                                    "tuned vs built-in launch shapes")
                    for out, _, _ in runs["tuned"])
        compare_outputs(torch, runs["built-in"][1][0], base, 0.0,
                        "the built-in launch shapes twice")
        correct = float((base["outcomes_adjusted"] == truth).float().mean())
        if correct < 0.99:
            raise RuntimeError("the outcomes do not recover the truth")
        rate = {k: sum(r for _, r, _ in v) / len(v) for k, v in runs.items()}
        log(f"sztorc max_iterations=1 under the tuned shapes (row splits "
            f"{entries['row_tile_splits']['value']}, column splits "
            f"{entries['col_tile_splits']['value']}, resolve width "
            f"{entries['resolve_block_cols']['value']}) against the "
            f"built-in ({entries['row_tile_splits']['builtin']}, "
            f"{entries['col_tile_splits']['builtin']}, "
            f"{entries['resolve_block_cols']['builtin']}): outcomes "
            f"identical, continuous max |diff| {worst:.3e} <= {MID_ATOL}, "
            f"outcomes == truth {correct:.6f}; B.1/B.2/B.3 "
            f"{per['apply_weighted_cov']:g}/{per['scores_dirfix_pass']:g}/"
            f"{per['resolve_certainty_fused']:g} a resolution under both; "
            f"cache hits {hits}; {rate['tuned']:.4f} (tuned) and "
            f"{rate['built-in']:.4f} (built-in) resolutions/s, each the "
            f"mean of two runs of {n} taken in turn, on {card} (no claim)")
        del x8
        torch.cuda.empty_cache()

        rq, eq = TUNE_DEPTH_SHAPE
        t0 = time.perf_counter()
        e = autotune_pipeline_depth(rq, eq, path=path, force=True,
                                    repeats=TUNE_DEPTH_REPEATS,
                                    dispatches=TUNE_DEPTH_DISPATCHES)
        times = ", ".join(
            f"{d}: {e['timings_ms'][str(d)]:.3f} "
            f"[{e['iqr_ms'][str(d)][0]:.3f}, {e['iqr_ms'][str(d)][1]:.3f}]"
            for d in e["candidates"])
        log(f"pipeline depth at {rq}x{eq} ({e['requests']} requests with "
            f"one scaled event a candidate, a service at each depth, every "
            f"one served on the {e['route']} ring route, the same bits at "
            f"every depth): fastest median {e['fastest']}, persisted "
            f"{e['value']} (fallback {e['builtin']}), median [first, third "
            f"quartile] wall ms by depth ({TUNE_DEPTH_REPEATS} interleaved "
            f"rounds) {{{times}}} "
            f"on {card} ({time.perf_counter() - t0:.3f} s)")
        bw = stream_bandwidth_bytes_per_s(mbytes=TUNE_STREAM_MBYTES,
                                          repeats=5, device=dev)
        log(f"stream bandwidth (y = x + 0.5 over {TUNE_STREAM_MBYTES} MiB "
            f"float32, CUDA events, median of 5): {bw / 1e12:.4f} TB/s, "
            f"{bw / HBM_BYTES_PER_S:.4f} of the nominal 3.35 TB/s, on "
            f"{card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    ap.add_argument("--mid-r", type=int, default=512)
    ap.add_argument("--mid-e", type=int, default=4096)
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
    ap.add_argument("--only", choices=("process", "fleet", "stateplane",
                                       "elastic", "tune", "witness"),
                    help="run only this phase after the build (the process "
                    "mesh, with --mesh-devices after the streaming "
                    "phase's one-host stream that it compares with; the "
                    "fleet; the state plane and kernel store; the "
                    "elastic fleet and economy; the launch-shape "
                    "autotuner; or the static analysis and its "
                    "witnesses)")
    ap.add_argument("--process-worker", type=int, default=None,
                    metavar="RANK", help=argparse.SUPPRESS)
    ap.add_argument("--process-world", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--process-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--process-stage", default="", help=argparse.SUPPRESS)
    ap.add_argument("--state-setup", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)
    ap.add_argument("--witness-worker", default=None,
                    choices=("cuda", "cpu"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.witness_worker is not None:
        # the witness phase's fresh interpreter: nothing of the package
        # may be imported before its lock witness is installed
        return witness_worker(args.witness_worker)
    if args.process_worker is not None:
        # one rank of the process-mesh phase, started by that phase
        return process_worker(args)
    if args.state_setup is not None:
        # one setup process of the state-plane phase
        return state_setup_worker(args.state_setup)
    try:
        return run(args)
    except Exception:                 # noqa: BLE001 — report, exit non-zero
        traceback.print_exc()
        return 1
    finally:
        # the state-plane phase's workers, whichever way the run ended
        for child in _STARTED:
            child.stop()


if __name__ == "__main__":
    sys.exit(main())
