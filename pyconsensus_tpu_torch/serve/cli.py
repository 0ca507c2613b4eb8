"""``pyconsensus-serve-torch`` — the serve tier's operational front door
(``pyconsensus_tpu/serve/cli.py``; also ``python -m
pyconsensus_tpu_torch.serve.cli``).

The command line's job is the operational loop around the service: load
a config file, warm the configured buckets, optionally drive a
load-generation run against one live service or an N-worker
:class:`~.fleet.ConsensusFleet` (in process, or ``--transport socket``:
one worker process a card), and write the metrics exposition and the
span trace.

Usage::

    pyconsensus-serve-torch --config serve.json --warmup-only
    pyconsensus-serve-torch --requests 200 --concurrency 16 \\
        --shapes 16x64,32x128 --metrics-out serve.prom
    pyconsensus-serve-torch --fleet-workers 3 --log-dir /tmp/fleet \\
        --requests 64 --shapes 1024x4096
    pyconsensus-serve-torch --fleet-workers 4 --transport socket \\
        --requests 64 --shapes 1024x4096
    pyconsensus-serve-torch --aot-cache /var/cache/pyconsensus \\
        --warmup-only --shapes 1024x4096
    pyconsensus-serve-torch --fleet-workers 1 --transport socket \\
        --autoscale --autoscale-max 3 --slo-p99-ms 50 --metrics-port 9100

The flags are the reference's plus ``--device`` (the card by default;
``cpu`` on request; without a card and without ``--device cpu`` it exits
2). ``--aot-cache DIR`` is the kernel-build store (``serve/aotcache.py``:
the kernel libraries and the warmed keys, so the next run adopts them
with no ``nvcc``); the summary reports ``aot_loaded`` and
``aot_persisted``, and the compile monitor counts every ``nvcc`` run,
store adoption and library load. The ``--slo-*`` flags set the
declarative SLO targets (``ServeConfig.slo_*``): an ``obs.SloMonitor``
windows every run (a socket fleet's over the merged worker view) and its
summary lands under ``"slo"``. ``--metrics-port`` serves ``GET /metrics``
while the run lasts (a fleet's merged view, every worker labeled), and
``--metrics-hold-s`` keeps it open that long after the run.
``--autoscale`` (with ``--fleet-workers``) runs ``serve/autoscale.py``'s
control loop between ``--autoscale-min`` and ``--autoscale-max`` workers
on the monitor's window; its status and decision counts land under
``"autoscale"``. Both paths warm what the requests of ``--shapes`` ride
before the timed run, on every fleet worker too (a socket worker
through its ``warm`` RPC), so the printed rate is the steady state's.
Over the socket transport the kernel paths and launches are the
workers', read from the merged metric view and each worker's ``stats``.

Exit code 0 iff every generated request succeeded (under
``--allow-shed`` PYC401 sheds do not count: shedding is the configured
behavior of an overload probe).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

__all__ = ["main"]

def _parse_shapes(spec: str):
    shapes = []
    for part in spec.split(","):
        r, e = part.lower().split("x")
        shapes.append((int(r), int(e)))
    return shapes


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="pyconsensus-serve-torch",
        description="micro-batching consensus service: warmup preflight "
                    "+ in-process load generation, on one service or an "
                    "in-process fleet")
    ap.add_argument("--config", metavar="PATH",
                    help="ServeConfig JSON (flags below override)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the service's (every fleet worker's) device; "
                         "default: the card")
    ap.add_argument("--warmup-only", action="store_true",
                    help="build the configured buckets, print the "
                         "cache summary, exit")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--concurrency", type=int, default=8,
                    help="closed-loop workers (ignored with --rate)")
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop arrival rate (req/s)")
    ap.add_argument("--trace", default=None, metavar="JSON",
                    help="trace-driven open loop: a JSON rate trace "
                         "(path or literal; [[duration_s, rps], ...]) "
                         "— overrides --rate/--requests")
    ap.add_argument("--shapes", default="12x48,24x96",
                    help="comma-separated RxE request shapes")
    ap.add_argument("--na-frac", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--retries", type=int, default=0,
                    help="bounded client retries on PYC401/PYC5xx sheds "
                         "(honoring retry_after_s; 0 disables — the "
                         "summary reports retried/abandoned counts)")
    ap.add_argument("--window-ms", type=float, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    metavar="N",
                    help="in-flight padded dispatches before the batcher "
                         "blocks on a fetch: 1 = synchronous, 0 = the "
                         "default (the same bits at any depth)")
    ap.add_argument("--rate-limit", type=float, default=None,
                    help="per-tenant admission rate (req/s)")
    ap.add_argument("--pallas-buckets", choices=["auto", "on", "off"],
                    default=None,
                    help="the low-latency bucket_cuda class (the "
                         "reference's Pallas class): auto = an sm_90 card "
                         "only, on = any device (the plain versions off "
                         "the card), off = padded buckets only")
    ap.add_argument("--incremental", dest="incremental",
                    action="store_true", default=None,
                    help="sessions created through the service ride the "
                         "bucket_incremental tier (warm-started eigenpair "
                         "maintenance, an exact refresh every "
                         "--refresh-every rounds)")
    ap.add_argument("--no-incremental", dest="incremental",
                    action="store_false",
                    help="force the incremental session tier off "
                         "(overrides --config)")
    ap.add_argument("--refresh-every", type=int, default=None,
                    metavar="K",
                    help="incremental tier exact-refresh cadence (>= 1)")
    ap.add_argument("--aot-cache", metavar="DIR", default=None,
                    help="the kernel-build store: the kernel libraries "
                         "and the warmed keys, persisted and verified, so "
                         "a restart adopts them with no nvcc")
    ap.add_argument("--fleet-workers", type=int, default=0, metavar="N",
                    help="drive the loadgen through an N-worker "
                         "ConsensusFleet instead of a single service "
                         "(0 = single service)")
    ap.add_argument("--transport", choices=["inprocess", "socket"],
                    default="inprocess",
                    help="fleet worker transport (with --fleet-workers): "
                         "inprocess, or socket (one worker process a "
                         "card; with --device cpu every worker on the "
                         "CPU)")
    ap.add_argument("--log-dir", default=None, metavar="DIR",
                    help="fleet replication-log directory (required for "
                         "fleet sessions)")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the SLO-driven autoscaler control loop over "
                         "the fleet (needs --fleet-workers): sustained SLO "
                         "violation grows it, sustained idleness drains it")
    ap.add_argument("--autoscale-min", type=int, default=1, metavar="N",
                    help="autoscaler fleet-size floor")
    ap.add_argument("--autoscale-max", type=int, default=4, metavar="N",
                    help="autoscaler fleet-size ceiling")
    ap.add_argument("--autoscale-interval-s", type=float, default=0.5,
                    metavar="S", help="autoscaler control period")
    ap.add_argument("--autoscale-cooldown-s", type=float, default=3.0,
                    metavar="S",
                    help="quiet period after a membership change")
    ap.add_argument("--allow-shed", action="store_true",
                    help="shed requests (PYC401) do not fail the run — "
                         "the expected outcome of an overload probe")
    ap.add_argument("--metrics-out", metavar="PATH",
                    help="write the Prometheus exposition on exit")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve a live /metrics endpoint on this port "
                         "(0: the OS picks; a fleet serves its merged "
                         "view, every worker labeled)")
    ap.add_argument("--metrics-hold-s", type=float, default=0.0,
                    metavar="S",
                    help="hold the /metrics endpoint (and a fleet's "
                         "workers) open this long after the run")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write this process's span events as JSONL on "
                         "exit")
    for flag, metavar, what in (
            ("--slo-window-s", "S", "the SLO monitor's window"),
            ("--slo-p50-ms", "MS", "windowed p50 latency target"),
            ("--slo-p99-ms", "MS", "windowed p99 latency target"),
            ("--slo-shed-ratio", "RATIO", "windowed shed-fraction target"),
            ("--slo-queue-depth", "N", "sampled queue-depth target")):
        ap.add_argument(flag, type=float, default=None, metavar=metavar,
                        help=f"{what} (overrides --config; 0 disables "
                             f"a target)")
    return ap


def _config(ap, args):
    """The ServeConfig of ``--config`` with the flags' overrides."""
    from .service import ServeConfig

    if args.config:
        try:
            cfg = ServeConfig.load(args.config)
        except (OSError, ValueError) as exc:
            ap.error(f"--config: {exc}")
    else:
        cfg = ServeConfig()
    overrides = {}
    if args.window_ms is not None:
        overrides["batch_window_ms"] = float(args.window_ms)
    if args.max_batch is not None:
        overrides["max_batch"] = int(args.max_batch)
    if args.pipeline_depth is not None:
        overrides["pipeline_depth"] = int(args.pipeline_depth)
    if args.rate_limit is not None:
        overrides["rate_limit_rps"] = float(args.rate_limit)
    if args.pallas_buckets is not None:
        overrides["pallas_buckets"] = {"auto": "auto", "on": True,
                                       "off": False}[args.pallas_buckets]
    if args.aot_cache is not None:
        overrides["aot_cache_dir"] = args.aot_cache
    if args.incremental is not None:
        overrides["incremental_sessions"] = bool(args.incremental)
    if args.refresh_every is not None:
        overrides["incremental_refresh_every"] = int(args.refresh_every)
    for key in ("slo_window_s", "slo_p50_ms", "slo_p99_ms",
                "slo_shed_ratio", "slo_queue_depth"):
        value = getattr(args, key)
        if value is not None:
            overrides[key] = float(value)
    if overrides:
        cfg = ServeConfig.from_dict({**cfg.__dict__, **overrides})
    return cfg


def _refuse(ap, args, cfg) -> None:
    """Exit 2 on a config the service would refuse (an invalid value), on
    ``--autoscale`` without a fleet and on ``--device cuda`` without a
    card."""
    from ..faults import InputError
    from .service import _validate

    if args.autoscale and args.fleet_workers <= 0:
        ap.error("--autoscale resizes a fleet: pass --fleet-workers")
    try:
        _validate(cfg)
    except InputError as exc:
        ap.error(f"config: {exc}")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            ap.error("--device cuda: no CUDA device is available; pass "
                     "--device cpu to run on the CPU")


def _write_outputs(args, stats) -> int:
    """Print the summary, write the exposition and the trace, and return
    the exit code."""
    from .. import obs
    from ..ops.cuda_kernels import launch_counts

    # the kernels' launches in this process (a fleet's summary sets its
    # workers' own), warm-up included (0 off the card)
    stats.setdefault("kernel_launches", launch_counts())
    stats.setdefault("aot_loaded", obs.value("pyconsensus_aot_load_total",
                                             outcome="loaded"))
    stats.setdefault("aot_persisted", obs.value(
        "pyconsensus_aot_persist_total", outcome="written"))

    # sort_keys: two identical runs print identical key orders
    print(json.dumps(stats, indent=2, sort_keys=True))
    if args.metrics_out:
        obs.write_prom(args.metrics_out, obs.REGISTRY)
        print(f"metrics written to {args.metrics_out}", file=sys.stderr)
    if args.trace_out:
        obs.write_jsonl(args.trace_out, obs.events(),
                        meta={"source": obs.TRACER.source})
        print(f"trace written to {args.trace_out}", file=sys.stderr)
    hard_failures = stats["failed"]
    if args.allow_shed:
        hard_failures -= stats["errors"].get("PYC401", 0)
    return 0 if hard_failures == 0 else 1


def warm_for_shapes(svc, shapes, has_na: bool) -> int:
    """Warm what the requests of ``shapes`` ride on ``svc``: the
    configured buckets (else the shapes' ladder buckets) and the
    low-latency class's key at each shape it takes. Returns the count."""
    warm = list(svc.config.warmup) or svc.buckets_for(shapes)
    n = svc.warm_buckets(warm) + svc.warm_cuda_class(shapes,
                                                     has_na=has_na)
    print(f"warmed {n} executable(s) on {svc.device}: buckets "
          f"{', '.join(f'{r}x{e}' for r, e in warm) or 'none'}",
          file=sys.stderr)
    return n


def _metrics_server(args, render_fn):
    """The ``--metrics-port`` endpoint serving ``render_fn`` (None
    without the flag, or when the port cannot be bound)."""
    from .. import obs

    if args.metrics_port is None:
        return None
    srv = obs.start_metrics_server(args.metrics_port, render_fn)
    if srv is not None:
        print(f"metrics endpoint: http://127.0.0.1:{srv.port}/metrics",
              file=sys.stderr)
    return srv


def _hold(args, metrics_srv) -> None:
    """Keep the endpoint (and a fleet's workers) up ``--metrics-hold-s``
    after the run, for a scrape."""
    if metrics_srv is not None and args.metrics_hold_s > 0:
        print(f"holding /metrics open {args.metrics_hold_s:.1f}s",
              file=sys.stderr)
        time.sleep(args.metrics_hold_s)


def _run_load(gen, args) -> dict:
    from .loadgen import RateTrace

    if args.trace:
        return gen.run_trace(RateTrace.from_json(args.trace))
    if args.rate:
        return gen.run_open(args.requests, args.rate)
    return gen.run_closed(args.requests, args.concurrency)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    try:
        cfg = _config(ap, args)
    except ValueError as exc:
        ap.error(str(exc))
    _refuse(ap, args, cfg)
    try:
        shapes = _parse_shapes(args.shapes)
    except ValueError:
        ap.error(f"--shapes: cannot parse {args.shapes!r} (want RxE,...)")

    from .. import obs

    # before the first build, so the warm-up's are counted too
    obs.install_compile_monitor()
    if args.fleet_workers > 0:
        return _fleet_main(args, cfg, shapes)

    from .loadgen import (LoadGenerator, device_block, kernel_path_block,
                          mean_batch_occupancy)
    from .service import ConsensusService

    svc = ConsensusService(cfg, device=args.device)
    n_warm = warm_for_shapes(svc, shapes, args.na_frac > 0)
    if args.warmup_only:
        print(json.dumps({
            "warmed_buckets": n_warm,
            "cache_size": len(svc.cache),
            "n_devices": svc.n_devices,
            "builds": svc.cache.builds,
            "aot_loaded": obs.value("pyconsensus_aot_load_total",
                                    outcome="loaded"),
            "aot_persisted": obs.value("pyconsensus_aot_persist_total",
                                       outcome="written")}))
        if args.metrics_out:
            obs.write_prom(args.metrics_out, obs.REGISTRY)
        svc.close(drain=True)
        return 0

    svc.start(warmup=False)
    # the windowed SLO view of every run (all-zero targets still give
    # the windowed block)
    slo = obs.SloMonitor(targets=obs.targets_from_config(cfg),
                         window_s=cfg.slo_window_s)
    metrics_srv = _metrics_server(args, obs.render_prom)
    gen = LoadGenerator(svc, shapes=shapes, na_frac=args.na_frac,
                        seed=args.seed, max_retries=args.retries, slo=slo)
    try:
        stats = _run_load(gen, args)
        _hold(args, metrics_srv)
    finally:
        svc.close(drain=True)
        if metrics_srv is not None:
            metrics_srv.close()
    stats["warmed_executables"] = n_warm
    stats["cache"] = {"size": len(svc.cache),
                      "hit_ratio": svc.cache.hit_ratio(),
                      "builds": svc.cache.builds}
    stats["kernel_paths"] = kernel_path_block() or None
    occ = mean_batch_occupancy()
    if occ is not None:
        stats["mean_batch_occupancy"] = round(occ, 3)
    stats["pipeline_depth"] = svc.pipeline_depth
    stats["device"] = str(svc.device)
    stats.update(device_block(svc))
    return _write_outputs(args, stats)


def _fleet_main(args, cfg, shapes) -> int:
    """``--fleet-workers N``: the same loadgen run against a
    ConsensusFleet on ``--device`` over ``--transport``, every worker
    warmed as one service is, with the SLO monitor on the fleet's view,
    the ``/metrics`` endpoint on its merged view and, with
    ``--autoscale``, the control loop over it."""
    from .. import obs
    from .fleet import ConsensusFleet, FleetConfig
    from .loadgen import LoadGenerator, kernel_path_block

    obs.TRACER.source = "router"
    fleet = ConsensusFleet(FleetConfig(
        n_workers=args.fleet_workers, transport=args.transport,
        log_dir=args.log_dir, worker=cfg), device=args.device).start()
    metrics_srv = scaler = slo = None
    try:
        n_warm = sum(w.warm(shapes, args.na_frac > 0)
                     for _, w in sorted(fleet.workers.items()))
        # over the socket transport the request counters live in the
        # worker processes: the monitor samples the merged view. In-process
        # workers share this process's registry (the merged view would
        # count it twice)
        slo = obs.SloMonitor(
            targets=obs.targets_from_config(cfg),
            window_s=cfg.slo_window_s,
            snapshot_fn=(fleet.merged_snapshot
                         if args.transport == "socket" else None))
        metrics_srv = _metrics_server(args, fleet.render_metrics)
        gen = LoadGenerator(fleet, shapes=shapes, na_frac=args.na_frac,
                            seed=args.seed, max_retries=args.retries,
                            slo=slo)
        if args.autoscale:
            from .autoscale import AutoScaler, AutoscaleConfig

            scaler = AutoScaler(fleet, slo, AutoscaleConfig(
                min_workers=args.autoscale_min,
                max_workers=args.autoscale_max,
                interval_s=args.autoscale_interval_s,
                cooldown_s=args.autoscale_cooldown_s)).run_in_thread()
            # the loop reads the monitor's window: it samples for the
            # whole run, whatever the load generator's mode
            slo.run_in_thread()
        stats = _run_load(gen, args)
        if scaler is not None:
            scaler.stop()
        _hold(args, metrics_srv)
        status = fleet.status()     # before the drain marks workers down
        # the merged view holds the dispatches wherever they happened
        snapshot = fleet.merged_snapshot()
        stats["kernel_paths"] = kernel_path_block(snapshot) or None
        stats["kernel_launches"] = _fleet_launches(fleet)
        if scaler is not None:
            stats["autoscale"] = dict(scaler.status(), decisions={
                action: int(obs.value(
                    "pyconsensus_autoscale_decisions_total",
                    action=action) or 0)
                for action in ("hold", "scale_up", "scale_down",
                               "replace", "error")})
    finally:
        if scaler is not None:
            scaler.stop()
        if slo is not None:
            slo.stop()
        fleet.close(drain=True)
        if metrics_srv is not None:
            metrics_srv.close()
    stats["transport"] = args.transport
    stats["warmed_executables"] = n_warm
    stats["fleet"] = status
    stats["device"] = str(fleet.device)
    # the store's counters wherever the workers ran
    for key, name, outcome in (
            ("aot_loaded", "pyconsensus_aot_load_total", "loaded"),
            ("aot_persisted", "pyconsensus_aot_persist_total", "written")):
        stats[key] = _merged_total(snapshot, name, outcome=outcome)
    return _write_outputs(args, stats)


def _merged_total(snapshot: dict, name: str, **labels):
    """The sum over every worker of counter ``name``'s series whose
    labels include ``labels``, in a merged fleet snapshot (None when no
    worker emitted it)."""
    total = None
    for skey, value in snapshot.get(name, {}).get("series", {}).items():
        got = json.loads(skey) if skey else {}
        if all(got.get(k) == v for k, v in labels.items()):
            total = (total or 0.0) + float(value)
    return total


def _fleet_launches(fleet) -> dict:
    """The kernels' launches of a fleet: this process's (an in-process
    fleet's workers launch here) plus each live worker process's own."""
    from ..ops.cuda_kernels import launch_counts

    total = dict(launch_counts())
    for _, w in sorted(fleet.workers.items()):
        if not w.alive:
            continue
        for k, v in w.launch_counts().items():
            total[k] = total.get(k, 0) + int(v)
    return total


if __name__ == "__main__":
    sys.exit(main())
