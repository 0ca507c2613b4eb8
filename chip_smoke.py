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
   goes to ``chiprun_out/chip_smoke_build.log``);
3. hold each kernel against its plain torch version on the card at full
   size, on int8 sentinel storage and on float32+NaN storage, and time
   both with CUDA events: the sztorc sweeps, resolve, the block
   covariance at k = 5 with and without its centered projections, the
   uncentered products (``storage_matvec``, ``storage_matmat`` at k = 12
   in one launch, the rows product at k = 6) and the fill statistics;
   ``storage_matmat`` is also timed on int8 at k = 4 and k = 16, the rows
   product at k = 1, 12 and 16 (one launch each), and the uncentered
   products against one PyTorch call (``torch.mv``, ``@``) on a dense
   float32 matrix. The row halves of the sztorc sweeps and
   ``storage_matvec`` are the row-tile pass at k = 1: on int8 each must
   equal the k = 1 call of ``storage_matmat`` or
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
   ``col_tile_kernel<...>``);
5. run the same paths at a middle size on the card and on the CPU
   (``device="cpu"``, or a mesh of as many CPU shards) and compare the
   two;
6. print the ``kernels`` JSON line, then the result line.

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
}
PATH_FORBIDS = {
    "sztorc": ("storage_matvec",),
    "fixed-variance": ("storage_matmat",),
    "ica": ("storage_matmat",),
    "sztorc mesh": ("apply_weighted_cov", "scores_dirfix_pass"),
    "fixed-variance separable": ("apply_weighted_cov_block",),
    "ica separable": ("apply_weighted_cov_block",),
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
        from pyconsensus_tpu_torch import ConsensusParams, sharded_consensus
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

    if args.mesh_devices > torch.cuda.device_count():
        raise RuntimeError(f"--mesh-devices {args.mesh_devices}: only "
                           f"{torch.cuda.device_count()} cards")
    stats = kernel_phase(torch, args, ck, _fill_stats, dev, card)
    launches = {k: 0 for k in KERNELS}

    def drive(x, p, label, path=None):
        """One main path: a warm-up, then ``args.resolutions`` timed
        resolutions with the launch counts set to 0 just before and read
        just after; the kernels of ``path`` (default: the algorithm) must
        have launched and those of another arm must not. Returns ``(out,
        resolutions/s, counts)``."""
        path = path or p.algorithm
        out = sharded_consensus(x, params=p)                 # warm-up
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(args.resolutions):
            out = sharded_consensus(x, params=p)
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

    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "sources": [KERNELS[k][0], *KERNELS[k][2:]],
         "replaces": KERNELS[k][1], "launches": launches[k],
         "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
         "plain_ms": stats[k]["plain_ms"],
         "bound_ms": stats[k]["bound_ms"],
         "bound_by": stats[k]["bound_by"],
         "library_ms": stats[k]["library_ms"],
         "float32_ms": stats[k].get("float32_ms")}
        for k in KERNELS]}))
    log(f"chip_smoke total {time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_phase(torch, args, ck, _fill_stats, dev, card) -> dict:
    """Phase 3: every kernel against its plain version at full size on
    int8 and float32+NaN storage, timed beside its bound, and the
    uncentered products beside one PyTorch call on dense float32.
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
        for storage, x in (("int8", x8), ("float32", xf)):
            nb = x.numel() * x.element_size()
            checks = {
                "apply_weighted_cov": (
                    lambda: ck.apply_weighted_cov(x, mu, rep, v, fill),
                    lambda: ck.apply_weighted_cov_plain(x, mu, rep, v, fill),
                    nb + 4 * (3 * E + R) + 4 * E, 4 * R * E),
                "scores_dirfix_pass": (
                    lambda: ck.scores_dirfix_pass(x, rep, v, fill),
                    lambda: ck.scores_dirfix_pass_plain(x, rep, v, fill),
                    nb + 4 * (2 * E + R) + 4 * (3 * E + R), 8 * R * E),
                "storage_matvec": (
                    lambda: ck.storage_matvec(x, v, fill),
                    lambda: ck.storage_matvec_plain(x, v, fill),
                    nb + 4 * 2 * E + 4 * R, 2 * R * E),
                # k = 12 in one row-tile launch (up to 16 columns a launch)
                "storage_matmat": (
                    lambda: ck.storage_matmat(x, V12, fill),
                    lambda: ck.storage_matmat_plain(x, V12, fill),
                    nb + 4 * (E + SEPARABLE_K * E) + 4 * SEPARABLE_K * R,
                    2 * SEPARABLE_K * R * E),
                "resolve_certainty_fused": (
                    lambda: ck.resolve_certainty_fused(x, rep, fill, 1.0,
                                                       0.1),
                    lambda: ck.resolve_certainty_fused_plain(x, rep, fill,
                                                             1.0, 0.1),
                    nb + 4 * (E + R) + 4 * (4 * E + 2 * R), 10 * R * E),
                # the loop's sweeps (no projections out); the final
                # Rayleigh-Ritz form is checked and timed below
                "apply_weighted_cov_block": (
                    lambda: ck.apply_weighted_cov_block(x, mu, rep, V, fill),
                    lambda: ck.apply_weighted_cov_block_plain(x, mu, rep, V,
                                                              fill),
                    nb + 4 * (2 * E + R + BLOCK_K * E) + 4 * BLOCK_K * E,
                    4 * BLOCK_K * R * E),
                "apply_weighted_cov_block emit_t": (
                    lambda: ck.apply_weighted_cov_block(x, mu, rep, V, fill,
                                                        emit_t=True),
                    lambda: ck.apply_weighted_cov_block_plain(
                        x, mu, rep, V, fill, emit_t=True),
                    nb + 4 * (2 * E + R + BLOCK_K * E)
                    + 4 * BLOCK_K * (E + R), 4 * BLOCK_K * R * E),
                "storage_rows_matmat": (
                    lambda: ck.storage_rows_matmat(x, W, fill),
                    lambda: ck.storage_rows_matmat_plain(x, W, fill),
                    nb + 4 * ((BLOCK_K + 1) * R + E)
                    + 4 * (BLOCK_K + 1) * E, 2 * (BLOCK_K + 1) * R * E),
                "fill_stats_pass": (
                    lambda: ck.fill_stats_pass(x, rep),
                    lambda: ck.fill_stats_pass_plain(x, rep),
                    nb + 4 * R + 4 * 2 * E, 5 * R * E),
            }
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
                stats[kname]["max_abs_err"] = max(
                    stats[kname]["max_abs_err"], worst_abs)
            # resolve's halves: the column-panel kernel (one read of X,
            # rep and fill; four E-vectors out), then the row-tile pass at
            # k = 2 over [cert; 1] (one read of X and 2E; 2R out)
            cert = ck._resolve_columns(x, rep, fill, 1.0, 0.1)[2]
            vt = torch.stack([cert, torch.ones_like(cert)])
            halves = (("column half", lambda: ck._resolve_columns(
                x, rep, fill, 1.0, 0.1), nb + 4 * (R + E) + 4 * 4 * E),
                      ("row half", lambda: ck._absent_rows(x, vt),
                       nb + 4 * 2 * E + 4 * 2 * R))
            for half, fn, n_bytes in halves:
                d_ms = device_ms(torch, fn, args.reps)
                log(f"resolve_certainty_fused [{storage}] {half}: "
                    f"{d_ms:.4f} ms of device time, bound "
                    f"{bound_ms(n_bytes, 0)[0]:.4f} ms (bytes) on {card}")
        log(f"resolve_certainty_fused around the call: int8 "
            f"{stats['resolve_certainty_fused']['ms']:.4f} ms, float32+NaN "
            f"{stats['resolve_certainty_fused']['float32_ms']:.4f} ms on "
            f"{card}")
        del xf
        # the matvecs are the row-tile pass at k = 1, whose tiling does
        # not depend on k: on int8 each equals the k = 1 block call
        same = {
            "storage_matvec": (ck.storage_matvec(x8, v, fill),
                               ck.storage_matmat(x8, v[:, None],
                                                 fill)[:, 0]),
            "scores_dirfix_pass": (ck.scores_dirfix_pass(x8, rep, v,
                                                         fill)[0],
                                   ck.storage_matvec(x8, v, fill)),
            "apply_weighted_cov": (
                ck.apply_weighted_cov(x8, mu, rep, v, fill),
                ck.apply_weighted_cov_block(x8, mu, rep, v[:, None],
                                            fill)[0][:, 0]),
        }
        for kname, (a, b) in same.items():
            if not torch.equal(a, b):
                raise RuntimeError(f"{kname} [int8]: not the bits of the "
                                   "k = 1 row-tile call")
        log("storage_matvec, scores_dirfix_pass t, apply_weighted_cov "
            "[int8]: equal bit for bit to the k = 1 block calls")
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


def profile_resolution(torch, sharded_consensus, x, p, card, tag):
    """One resolution under ``torch.profiler``: wall time, the device's
    kernel time and busy share, and device time by kernel name (the full
    table goes to ``profile_<tag>.txt`` under ``OUT_DIR``)."""
    from torch.profiler import ProfilerActivity, profile

    sharded_consensus(x, params=p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sharded_consensus(x, params=p)
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


def check_result(torch, out, R, E, algorithm="sztorc"):
    """Finite values of the expected shapes, outcomes on the lattice."""
    shapes = {"smooth_rep": (R,), "this_rep": (R,), "na_row": (R,),
              "outcomes_adjusted": (E,), "certainty": (E,),
              "participation_columns": (E,), "reporter_bonus": (R,),
              "author_bonus": (E,)}
    if algorithm == "ica":
        shapes["ica_converged"] = ()
    else:
        shapes["first_loading"] = (E,)
    for key, shape in shapes.items():
        v = out[key]
        if tuple(v.shape) != shape:
            raise RuntimeError(f"{key}: shape {tuple(v.shape)} != {shape}")
        if v.dtype != torch.bool and not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"{key}: non-finite values")
    o = out["outcomes_adjusted"]
    if not bool(((o == 0) | (o == 0.5) | (o == 1)).all()):
        raise RuntimeError("outcomes off the {0, 0.5, 1} lattice")
    if abs(float(out["smooth_rep"].sum()) - 1.0) > 1e-4:
        raise RuntimeError("reputation does not sum to 1")


def compare_outputs(torch, a, b, atol, what):
    """Exact keys equal, the others within ``atol`` (``first_loading`` up
    to sign). Returns the largest continuous difference."""
    exact = ("outcomes_adjusted", "outcomes_final", "na_row", "iterations",
             "convergence", "ica_converged")
    if set(a) != set(b):
        raise RuntimeError(f"{what}: keys differ")
    worst = 0.0
    for key, va in a.items():
        if not isinstance(va, torch.Tensor):
            continue
        va, vb = va.cpu(), b[key].cpu()
        if key in exact:
            if not torch.equal(va, vb):
                raise RuntimeError(f"{what}: {key} differs")
            continue
        if key == "first_loading":
            va, vb = va.abs(), vb.abs()
        d = (va.double() - vb.double()).abs().max().item()
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
