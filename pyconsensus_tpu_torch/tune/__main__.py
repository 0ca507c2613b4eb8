"""Re-tune the Hopper kernels' launch shapes for a target shape:

    python -m pyconsensus_tpu_torch.tune --reporters 10000 --events 100000 \
        --storage-dtype int8 [--cache PATH] [--force] [--repeats N] \
        [--device cpu]

Sweeps the two tile passes' split counts and resolve's panel width at the
shape (each kind a cache hit when its entry exists and ``--force`` is not
given), persists the winners (atomic write) and prints one JSON line with
sorted keys, so two runs over one cache print the same bytes. On stderr it
prints the sweeps and cache hits of the run. ``--device cpu`` sweeps the
machinery through the plain versions and persists the built-in choice
(``tune.autotune``'s module docstring); without it the card is timed.
"""

import argparse
import json
import sys

from .. import obs
from .autotune import autotune_cov, autotune_resolve, cache_path


def _total(name: str) -> int:
    entry = obs.REGISTRY.snapshot().get(name)
    return int(sum(entry["series"].values())) if entry else 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m pyconsensus_tpu_torch.tune",
                                 description=__doc__)
    ap.add_argument("--reporters", type=int, default=10_000)
    ap.add_argument("--events", type=int, default=100_000)
    ap.add_argument("--storage-dtype", default="",
                    help="storage encoding to tune for ('' = float32, "
                         "'bfloat16', 'int8')")
    ap.add_argument("--cache", default=None,
                    help="cache file (default: $PYCONSENSUS_AUTOTUNE_CACHE "
                         "or ~/.cache/pyconsensus_tpu_torch/autotune.json)")
    ap.add_argument("--force", action="store_true",
                    help="re-sweep even when a cache entry exists")
    ap.add_argument("--repeats", type=int, default=5,
                    help="interleaved timing rounds on the card")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the deterministic sweep (default: the "
                         "card)")
    args = ap.parse_args(argv)

    kw = dict(device=args.device, path=args.cache, force=args.force,
              repeats=args.repeats)
    cov = autotune_cov(args.events, n_reporters=args.reporters,
                       storage_dtype=args.storage_dtype, **kw)
    res = autotune_resolve(args.reporters, n_events=args.events,
                           storage_dtype=args.storage_dtype, **kw)
    print(json.dumps({"cache": str(cache_path(args.cache)), **cov,
                      "resolve_block_cols": res}, sort_keys=True))
    print(f"autotune: sweeps {_total('pyconsensus_autotune_sweeps_total')}, "
          f"cache hits {_total('pyconsensus_autotune_cache_hits_total')}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
