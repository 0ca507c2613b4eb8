#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pyconsensus_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py                      # 10000 x 100000, one card

Phases, each printing its seconds:

1. the device: ``torch.cuda.get_device_name`` and the raw line of
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
2. build the CUDA kernels from ``pyconsensus_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel; the compiler's ``-Xptxas -v`` report
   goes to ``chiprun_out/chip_smoke_build.log``);
3. hold each kernel against its plain torch version on the card at full
   size, on int8 sentinel storage and on float32+NaN storage, and time
   both with CUDA events;
4. drive the main path, ``sharded_consensus`` on pre-encoded int8 storage
   with the default device, at ``max_iterations`` 1 and 3, with the
   launch counts set to 0 just before and read just after; every kernel
   must have launched;
5. run the same path at a middle size on the card and with
   ``device="cpu"`` and compare the two;
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
OUT_DIR = "chiprun_out"

KERNELS = {
    "apply_weighted_cov": (
        "pyconsensus_tpu_torch/csrc/storage_sweeps.cu",
        "pyconsensus_tpu/ops/pallas_kernels.py:468"),
    "scores_dirfix_pass": (
        "pyconsensus_tpu_torch/csrc/storage_sweeps.cu",
        "pyconsensus_tpu/ops/pallas_kernels.py:1056"),
    "resolve_certainty_fused": (
        "pyconsensus_tpu_torch/csrc/resolve.cu",
        "pyconsensus_tpu/ops/pallas_kernels.py:1275"),
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
        from pyconsensus_tpu_torch.models.pipeline import _fill_stats
        from pyconsensus_tpu_torch.ops import build
        from pyconsensus_tpu_torch.ops import cuda_kernels as ck
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
            log(f"built {src} -> {os.path.relpath(path, here)}")
        os.makedirs(os.path.join(here, OUT_DIR), exist_ok=True)
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

    stats = {k: {"max_abs_err": 0.0} for k in KERNELS}
    with phase(f"kernels {R}x{E}"):
        x8, _ = gen_reports(torch, R, E, args.seed, dev)
        g = torch.Generator(device=dev)
        g.manual_seed(args.seed + 1)
        rep = torch.rand(R, generator=g, device=dev) + 0.5
        rep = rep / rep.sum()
        _, fill, tw, numer = _fill_stats(x8, rep, 0.1, "int8")
        mu = numer + (rep.sum() - tw) * fill
        v = torch.randn(E, generator=g, device=dev)
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
                "resolve_certainty_fused": (
                    lambda: ck.resolve_certainty_fused(x, rep, fill, 1.0,
                                                       0.1),
                    lambda: ck.resolve_certainty_fused_plain(x, rep, fill,
                                                             1.0, 0.1),
                    nb + 4 * (E + R) + 4 * (4 * E + 2 * R), 10 * R * E),
            }
            for kname, (kern, plain, n_bytes, n_flops) in checks.items():
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
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
                log(f"{kname} [{storage}]: max_abs_err {worst_abs:.3e}, "
                    f"max err / max(max|ref|, 1) {worst_rel:.3e} (limit "
                    f"{FULL_RTOL:.0e}) {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise RuntimeError(f"{kname} [{storage}] disagrees with "
                                       "its plain version")
                k_ms = time_ms(torch, kern, args.reps)
                p_ms = time_ms(torch, plain, max(3, args.reps // 3))
                b_ms, b_by = bound_ms(n_bytes, n_flops)
                log(f"{kname} [{storage}]: kernel {k_ms:.4f} ms, plain "
                    f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) on {card}")
                if storage == "int8":
                    stats[kname].update(ms=k_ms, plain_ms=p_ms,
                                        bound_ms=b_ms, bound_by=b_by)
                stats[kname]["max_abs_err"] = max(
                    stats[kname]["max_abs_err"], worst_abs)
        del xf
        torch.cuda.empty_cache()

    launches = {k: 0 for k in KERNELS}
    with phase(f"main path {R}x{E} int8"):
        truth = None
        x8, truth = gen_reports(torch, R, E, args.seed + 2, dev)
        torch.cuda.synchronize()
        for mi in (1, 3):
            # "auto" picks fused power iteration above 4096 reporters (the
            # Gram eigh below it is not ported); a smaller rehearsal names it
            p = ConsensusParams(storage_dtype="int8", max_iterations=mi,
                                power_tol=1e-5,
                                pca_method="auto" if R > 4096
                                else "power-fused")
            out = sharded_consensus(x8, params=p)            # warm-up
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(args.resolutions):
                out = sharded_consensus(x8, params=p)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = ck.launch_counts()
            for k in KERNELS:
                launches[k] += counts[k]
            check_result(torch, out, R, E)
            correct = (out["outcomes_adjusted"] == truth).float().mean()
            log(f"max_iterations={mi}: {args.resolutions / dt:.4f} "
                f"resolutions/s ({dt / args.resolutions * 1e3:.3f} ms each) "
                f"on {card}; iterations {int(out['iterations'])}, "
                f"converged {bool(out['convergence'])}, outcomes == truth "
                f"{float(correct):.6f}; launches {counts}")
            if any(counts[k] == 0 for k in KERNELS):
                raise RuntimeError(f"a kernel of the main path never "
                                   f"launched: {counts}")
            if float(correct) < 0.99:
                raise RuntimeError("the outcomes do not recover the truth")
        if args.profile:
            profile_resolution(torch, sharded_consensus, x8,
                               p._replace(max_iterations=1), card)
        del x8
        torch.cuda.empty_cache()

    with phase(f"card vs cpu {args.mid_r}x{args.mid_e}"):
        xm, _ = gen_reports(torch, args.mid_r, args.mid_e, args.seed + 3, dev)
        xm_cpu = xm.cpu()
        for mi in (1, 3):
            p = ConsensusParams(storage_dtype="int8", max_iterations=mi,
                                pca_method="power", power_tol=1e-5)
            a = sharded_consensus(xm, params=p)
            b = sharded_consensus(xm_cpu, params=p, device="cpu")
            compare_card_cpu(torch, a, b, mi)

    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches[k],
         "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
         "plain_ms": stats[k]["plain_ms"], "bound_ms": stats[k]["bound_ms"],
         "bound_by": stats[k]["bound_by"], "library_ms": None}
        for k in KERNELS]}))
    log(f"chip_smoke total {time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_resolution(torch, sharded_consensus, x, p, card):
    """One resolution under ``torch.profiler``: wall time, the device's
    kernel time and busy share, and device time by kernel name (the full
    table goes to ``chiprun_out/profile.txt``)."""
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
    log(f"profile max_iterations={p.max_iterations}: wall {wall_ms:.3f} ms, "
        f"device kernels {busy_ms:.3f} ms, busy share "
        f"{busy_ms / wall_ms:.4f} on {card}")
    for ms, n, key in rows[:14]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {key[:110]}")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, OUT_DIR, "profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))


def check_result(torch, out, R, E):
    """Finite values of the expected shapes, outcomes on the lattice."""
    shapes = {"smooth_rep": (R,), "this_rep": (R,), "na_row": (R,),
              "outcomes_adjusted": (E,), "certainty": (E,),
              "participation_columns": (E,), "reporter_bonus": (R,),
              "author_bonus": (E,), "first_loading": (E,)}
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


def compare_card_cpu(torch, a, b, mi):
    exact = ("outcomes_adjusted", "outcomes_final", "na_row", "iterations",
             "convergence")
    worst = 0.0
    for key, va in a.items():
        if not isinstance(va, torch.Tensor):
            continue
        va, vb = va.cpu(), b[key]
        if key in exact:
            if not torch.equal(va, vb):
                raise RuntimeError(f"card vs cpu: {key} differs")
            continue
        if key == "first_loading":
            va, vb = va.abs(), vb.abs()
        d = (va.double() - vb.double()).abs().max().item()
        worst = max(worst, d)
        if d > MID_ATOL:
            raise RuntimeError(f"card vs cpu: {key} differs by {d:.3e} "
                               f"(atol {MID_ATOL})")
    log(f"max_iterations={mi}: card and cpu agree (exact keys equal, "
        f"continuous max |diff| {worst:.3e} <= {MID_ATOL}); iterations "
        f"{int(a['iterations'])}")


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
    args = ap.parse_args(argv)
    try:
        return run(args)
    except Exception:                 # noqa: BLE001 — report, exit non-zero
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
