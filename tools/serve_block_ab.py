#!/usr/bin/env python3
"""Interleaved A/B of the port's padded serve tier between checkouts and
between batcher settings, on one card, in one call.

    git archive <commit> pyconsensus_tpu_torch | tar -x -C .proof/parent
    python3 tools/serve_block_ab.py --tree parent=.proof/parent \\
        --tree change=. --order parent,change,change,parent

Each run is a fresh process that imports ``pyconsensus_tpu_torch`` from
its tree. Per batcher setting (``max_batch`` 8 at ``pipeline_depth`` 2,
the defaults; ``max_batch`` 8 at depth 1; ``max_batch`` 1 at depth 2) it
drives the reference's recorded serve block through ``ConsensusService``
as ``chip_smoke.py`` phase 8 does (24 x 96 and 48 x 192 at na_frac 0.05,
48 closed-loop requests from 8 threads, ``batch_window_ms=2.0``, the
padded tier, its buckets warmed first), ``BLOCKS`` times, and prints
requests/s, p50 and p99 of each block and the mean batch occupancy. Then
the top padded bucket: 8 concurrent 1000 x 4000 requests with 8 scaled
events at ``max_batch`` 8 and 1, the seconds for all 8, ``BLOCKS``
times. Last, one more block at the defaults and one more batch-8 top
dispatch under ``torch.profiler``: the wall time, the device's kernel
time, its busy share and the kernels launched. The matrices come from a
seeded numpy generator, the same in every run. The padded tier launches
none of the port's kernels, so nothing is built. Compare trees and
settings only within one call: a card may run below its power limit's
clocks.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (label, max_batch, pipeline_depth)
SETTINGS = (("batch 8, depth 2", 8, 2),
            ("batch 8, depth 1", 8, 1),
            ("batch 1, depth 2", 1, 2))
TOP_SETTINGS = (("top, batch 8", 8), ("top, batch 1", 1))
BLOCKS = 3
SEED = 14
#: seconds allowed for each run
RUN_TIMEOUT = 600


def child(tree: str, device: str = "cuda", smoke=None) -> dict:
    """One run: every setting's blocks with the package of ``tree`` on
    ``device``; ``smoke`` is the ``chip_smoke`` module whose shapes and
    generator it takes (None: the one beside this script)."""
    import numpy as np
    import torch

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import pyconsensus_tpu_torch
    from pyconsensus_tpu_torch import obs
    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig

    if not os.path.abspath(pyconsensus_tpu_torch.__file__).startswith(tree):
        raise RuntimeError(f"imported {pyconsensus_tpu_torch.__file__}, not "
                           f"the package of {tree}")
    if smoke is None:
        spec = importlib.util.spec_from_file_location(
            "_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(SEED)
    shapes = smoke.SERVE_SHAPES
    n_req, conc = smoke.SERVE_REQUESTS, smoke.SERVE_CONCURRENCY
    blocks = [[smoke.serve_reports(rng, *shapes[i % 2])[0]
               for i in range(n_req)] for _ in range(BLOCKS)]
    top = [smoke.serve_reports(rng, *smoke.TOP_REQUEST,
                               n_scaled=smoke.TOP_SCALED)[:2]
           for _ in range(smoke.TOP_CONCURRENT)]

    def occupancy():
        ser = obs.REGISTRY.snapshot().get(
            "pyconsensus_serve_batch_occupancy", {}).get("series", {})
        ser = next(iter(ser.values()), {"sum": 0.0, "count": 0})
        return ser["sum"], ser["count"]

    def drive_block(svc, mats, label):
        lat = [0.0] * len(mats)

        def client(worker):
            for i in range(worker, len(mats), conc):
                t0 = time.perf_counter()
                r = svc.submit(reports=mats[i]).result(timeout=120)
                lat[i] = 1e3 * (time.perf_counter() - t0)
                if not np.all(np.isfinite(r["agents"]["smooth_rep"])):
                    raise RuntimeError(f"{label}: non-finite result")

        with concurrent.futures.ThreadPoolExecutor(conc) as pool:
            list(pool.map(client, range(conc)))
        return lat

    def drive_top(svc):
        futs = [svc.submit(reports=x, event_bounds=b) for x, b in top]
        for f in futs:
            f.result(timeout=300)

    def profiled(fn):
        """Wall ms, device kernel ms, busy share and kernels launched of
        one call of ``fn`` (CUDA only)."""
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall = 1e3 * (time.perf_counter() - t0)
        rows = [(ev.self_device_time_total / 1e3, ev.count)
                for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.self_device_time_total > 0]
        busy = sum(r[0] for r in rows)
        return {"wall_ms": wall, "device_ms": busy,
                "busy_share": busy / wall, "kernels": sum(r[1] for r in rows)}

    out = {}
    for label, max_batch, depth in SETTINGS:
        cfg = ServeConfig(batch_window_ms=2.0, max_batch=max_batch,
                          pipeline_depth=depth, pallas_buckets=False)
        svc = ConsensusService(cfg, device=dev)
        svc.warm_buckets(svc.buckets_for(shapes))
        svc.start(warmup=False)
        row = {"rps": [], "p50_ms": [], "p99_ms": []}
        occ0 = occupancy()
        for mats in blocks:
            t0 = time.perf_counter()
            lat = drive_block(svc, mats, label)
            row["rps"].append(n_req / (time.perf_counter() - t0))
            row["p50_ms"].append(smoke.percentile(lat, 0.5))
            row["p99_ms"].append(smoke.percentile(lat, 0.99))
        occ1 = occupancy()
        row["mean_occupancy"] = ((occ1[0] - occ0[0])
                                 / max(1, occ1[1] - occ0[1]))
        if dev.type == "cuda" and label == SETTINGS[0][0]:
            row["profile"] = profiled(
                lambda: drive_block(svc, blocks[0], label))
        svc.close(drain=True)
        out[label] = row
    for label, max_batch in TOP_SETTINGS:
        cfg = ServeConfig(batch_window_ms=2.0, max_batch=max_batch,
                          pallas_buckets=False)
        svc = ConsensusService(cfg, device=dev)
        svc.warm_buckets(svc.buckets_for([smoke.TOP_REQUEST]))
        svc.start(warmup=False)
        secs = []
        for _ in range(BLOCKS):
            sync()
            t0 = time.perf_counter()
            drive_top(svc)
            secs.append(time.perf_counter() - t0)
        out[label] = {"seconds_for_8": secs}
        if dev.type == "cuda" and label == TOP_SETTINGS[0][0]:
            out[label]["profile"] = profiled(lambda: drive_top(svc))
        svc.close(drain=True)
    return {"tree": tree, "settings": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a checkout holding "
                    "pyconsensus_tpu_torch (one or more)")
    ap.add_argument("--order", default="",
                    help="comma-separated tree names, one run each "
                    "(default: each tree once, in the order given)")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    if not trees or any(name not in trees for name in order):
        ap.error("give --tree NAME=PATH and an --order of their names")
    smi = shutil.which("nvidia-smi")
    if smi:
        card = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True
        ).stdout.strip().splitlines()[0]
        print(card, flush=True)
    runs = []
    for name in order:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             trees[name]], capture_output=True, text=True,
            timeout=RUN_TIMEOUT)
        if done.returncode != 0:
            sys.stderr.write(done.stdout + done.stderr)
            raise SystemExit(f"run of {name} failed with code "
                             f"{done.returncode}")
        result = json.loads(done.stdout.strip().splitlines()[-1])
        result["name"] = name
        print(json.dumps(result), flush=True)
        runs.append(result)

    def per_tree(label, key):
        return {name: [r["settings"][label][key] for r in runs
                       if r["name"] == name] for name in trees}

    print(json.dumps({"order": order, "requests_per_s": {
        label: per_tree(label, "rps") for label, *_ in SETTINGS},
        "top_seconds_for_8": {label: per_tree(label, "seconds_for_8")
                              for label, _ in TOP_SETTINGS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
