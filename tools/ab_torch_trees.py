#!/usr/bin/env python3
"""Interleaved A/B of the port's single-device resolutions between two
checkouts, on one card, in one call.

    git archive <commit> pyconsensus_tpu_torch | tar -x -C .proof/parent
    python3 tools/ab_torch_trees.py --tree parent=.proof/parent --tree change=. \\
        --order parent,change,change,parent

Each run is a fresh process that imports ``pyconsensus_tpu_torch`` from
its tree and builds that tree's kernels (cached in the tree after its
first run). It draws the 10,000 x 100,000 int8 matrix of
``chip_smoke.py`` (the one beside this script, so both trees get the
same bits) and, per configuration (sztorc, fixed-variance and ica at
their default components, then fixed-variance and ica at 12 components,
the separable arm, then sztorc on an event mesh of four shards on the
card, placed once before its warm-up), times 20 resolutions of ``sharded_consensus`` at
``max_iterations=1`` after one warm-up, with the host clock around them
and a ``torch.cuda.synchronize()`` at each end. It prints one JSON line per
run, then a summary of each tree's rates in run order. Compare two trees
only within one call: a card may run below its power limit's clocks.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (label, algorithm, max_components or None for the default, shards of
#: an event mesh on the card or 0 for one device)
CONFIGS = (("sztorc", "sztorc", None, 0),
           ("fixed-variance", "fixed-variance", None, 0),
           ("ica", "ica", None, 0),
           ("fixed-variance separable", "fixed-variance", 12, 0),
           ("ica separable", "ica", 12, 0),
           ("sztorc mesh", "sztorc", None, 4))
R, E = 10_000, 100_000
RESOLUTIONS = 20
SEED = 2
#: seconds allowed for each run, the build included
RUN_TIMEOUT = 600


def child(tree: str) -> dict:
    """One run: the rates of each configuration with the package of
    ``tree``."""
    import torch

    name, tree = tree, os.path.abspath(tree)
    sys.path.insert(0, tree)
    import pyconsensus_tpu_torch
    from pyconsensus_tpu_torch import ConsensusParams, sharded_consensus
    from pyconsensus_tpu_torch.ops import build
    from pyconsensus_tpu_torch.parallel.mesh import (make_mesh,
                                                     place_event_shards)

    if not os.path.abspath(pyconsensus_tpu_torch.__file__).startswith(tree):
        raise RuntimeError(f"imported {pyconsensus_tpu_torch.__file__}, not "
                           f"the package of {tree}")
    build.build_all()
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    x8, truth = smoke.gen_reports(torch, R, E, SEED, dev)
    rates, correct = {}, {}
    for label, algo, k, shards in CONFIGS:
        extra = {"max_components": k} if k else {}
        p = ConsensusParams(algorithm=algo, storage_dtype="int8",
                            max_iterations=1, power_tol=1e-5,
                            pca_method="auto", **extra)
        x = (place_event_shards(x8, make_mesh(devices=[dev] * shards))
             if shards else x8)
        sharded_consensus(x, params=p)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RESOLUTIONS):
            out = sharded_consensus(x, params=p)
        torch.cuda.synchronize()
        rates[label] = RESOLUTIONS / (time.perf_counter() - t0)
        correct[label] = float((out["outcomes_adjusted"] == truth)
                               .float().mean())
    return {"tree": name, "rates": rates, "outcomes_equal_truth": correct}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a checkout holding "
                    "pyconsensus_tpu_torch (give two or more)")
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
    if len(trees) < 2 or any(name not in trees for name in order):
        ap.error("give two or more --tree NAME=PATH and an --order of "
                 "their names")
    smi = shutil.which("nvidia-smi")
    if smi:
        card = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True
        ).stdout.strip().splitlines()[0]
        print(card, flush=True)
    rates = {name: [] for name in trees}
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
        rates[name].append(result["rates"])
    print(json.dumps({"resolutions_per_s": {
        name: {label: [r[label] for r in runs] for label, *_ in CONFIGS}
        for name, runs in rates.items()},
        "order": order, "max_iterations": 1, "shape": [R, E]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
