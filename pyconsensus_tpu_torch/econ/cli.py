"""``pyconsensus-econ-torch`` / ``python -m pyconsensus_tpu_torch.econ`` —
the adversarial-economy front door (``pyconsensus_tpu/econ/cli.py``).

Run a scenario from a JSON config (or the quick flags) against an
in-process serve tier — a single :class:`ConsensusService` or an
N-worker :class:`ConsensusFleet` — and print the scoreboard as one JSON
document::

    pyconsensus-econ-torch --strategies camouflage,sybil_split \\
        --markets-per-strategy 8 --rounds 4 --json-out econ.json

    pyconsensus-econ-torch --scenario scenario.json \\
        --fleet-workers 2 --log-dir /shared/econ-log --metrics-out m.prom

With ``--log-dir`` the markets are durable fleet sessions: re-running
the same command over the same directory RESUMES the economy from the
replication log (the mid-economy SIGKILL recovery path).
``--fault-plan`` arms a seeded chaos plan over the run, exactly as on
the main CLI. ``--autoscale`` runs the SLO autoscaler over the fleet for
the economy's duration.

``--device`` is the service's (every fleet worker's): the card by
default, ``cpu`` on request; without a card and without ``--device cpu``
it exits 2. ``--dtype`` is the default float dtype the resolutions
compute in.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from .. import obs
from ..faults import plan as _faults
from .economy import MarketEconomy, Scenario, build_scenario
from .strategies import STRATEGIES


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="pyconsensus-econ-torch",
        description="adversarial market economy against the live "
                    "serve tier")
    ap.add_argument("--scenario", metavar="PATH",
                    help="scenario JSON (Scenario.to_dict shape); "
                         "overrides the quick flags below")
    ap.add_argument("--strategies",
                    default="camouflage,sybil_split,flash_crowd",
                    help=f"comma-separated strategy names from "
                         f"{sorted(STRATEGIES)}")
    ap.add_argument("--markets-per-strategy", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--fleet-workers", type=int, default=0,
                    help="run the economy through an N-worker fleet "
                         "instead of a single service (needs "
                         "--log-dir)")
    ap.add_argument("--log-dir", default=None,
                    help="replication-log directory: markets become "
                         "durable fleet sessions and an existing "
                         "directory RESUMES the economy")
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--incremental", action="store_true",
                    help="serve the economy's market sessions through "
                         "the bucket_incremental marginal-resolve tier "
                         "— the natural fit for slow_drip / "
                         "per-round re-resolution traffic. Continuous "
                         "reputations then sit within the documented "
                         "drift band between exact refreshes, so the "
                         "mechanism digest matches a full-resolve run "
                         "only at --refresh-every 1")
    ap.add_argument("--refresh-every", type=int, default=None,
                    metavar="K",
                    help="incremental exact-refresh cadence (with "
                         "--incremental; default: the tier default)")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the SLO autoscaler over the fleet for "
                         "the duration of the economy (needs "
                         "--fleet-workers): a cartel's "
                         "synchronized storm that sheds traffic grows "
                         "the fleet, quiet rounds drain it back with "
                         "live session migration")
    ap.add_argument("--autoscale-max", type=int, default=3,
                    help="autoscaler fleet-size ceiling")
    ap.add_argument("--autoscale-shed-ratio", type=float, default=0.05,
                    help="windowed shed-ratio SLO target driving the "
                         "autoscaler")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the service's (every fleet worker's) device; "
                         "default: the card")
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "float64"),
                    help="the default float dtype the resolutions compute "
                         "in (default: torch's, float32)")
    ap.add_argument("--fault-plan", metavar="PATH",
                    help="arm a seeded FaultPlan JSON over the run "
                         "(activation log printed on exit)")
    ap.add_argument("--json-out", metavar="PATH",
                    help="also write the scoreboard JSON here")
    ap.add_argument("--metrics-out", metavar="PATH",
                    help="write the Prometheus exposition here")
    return ap


def _scenario_from(args) -> Scenario:
    if args.scenario:
        return Scenario.from_dict(
            json.loads(pathlib.Path(args.scenario).read_text()))
    return build_scenario(
        seed=args.seed, rounds=args.rounds,
        strategies=tuple(s for s in args.strategies.split(",") if s),
        markets_per_strategy=args.markets_per_strategy,
        concurrency=args.concurrency)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    scenario = _scenario_from(args)

    import torch

    from ..serve import ConsensusService, ServeConfig

    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available; pass "
                 "--device cpu to run on the CPU")
    if args.dtype is not None:
        torch.set_default_dtype(getattr(torch, args.dtype))

    if args.refresh_every is not None and not args.incremental:
        # refuse rather than silently ignore: a cadence without the
        # tier has no effect, and the operator should learn that here
        print("ERROR: --refresh-every requires --incremental (the "
              "cadence configures the incremental tier's exact-refresh "
              "anchor)", file=sys.stderr)
        return 2
    incr = {}
    if args.incremental:
        incr["incremental_sessions"] = True
        if args.refresh_every is not None:
            incr["incremental_refresh_every"] = int(args.refresh_every)
    worker_cfg = ServeConfig(batch_window_ms=args.window_ms,
                             max_batch=args.max_batch,
                             max_queue=args.max_queue, **incr)
    plan = None
    if args.fault_plan:
        plan = _faults.arm(_faults.FaultPlan.load(args.fault_plan))
    if args.autoscale and args.fleet_workers <= 0:
        print("ERROR: --autoscale needs --fleet-workers (the "
              "autoscaler resizes a fleet)", file=sys.stderr)
        return 2
    service = None
    scaler = None
    slo = None
    try:
        if args.fleet_workers > 0:
            from ..serve.fleet import ConsensusFleet, FleetConfig

            if not args.log_dir:
                print("ERROR: --fleet-workers needs --log-dir (fleet "
                      "sessions must be durable)", file=sys.stderr)
                return 2
            service = ConsensusFleet(FleetConfig(
                n_workers=args.fleet_workers, worker=worker_cfg,
                log_dir=args.log_dir), device=args.device).start(
                warmup=False)
            if args.autoscale:
                from ..serve.autoscale import AutoScaler, AutoscaleConfig

                slo = obs.SloMonitor(
                    targets={"shed_ratio": args.autoscale_shed_ratio},
                    window_s=2.0)
                slo.run_in_thread(interval_s=0.1)
                scaler = AutoScaler(service, slo, AutoscaleConfig(
                    min_workers=args.fleet_workers,
                    max_workers=args.autoscale_max,
                    interval_s=0.2, up_signals=2, down_signals=8,
                    cooldown_s=1.0)).run_in_thread()
        else:
            service = ConsensusService(worker_cfg,
                                       device=args.device).start(
                warmup=False)
        result = MarketEconomy(service, scenario).run()
        if scaler is not None:
            scaler.stop()
            slo.stop()
            status = scaler.status()
            result["autoscale"] = {
                "workers_start": args.fleet_workers,
                "workers_end": len(service.ring.workers()),
                "target": status["target"],
                "decisions": {
                    action: int(obs.value(
                        "pyconsensus_autoscale_decisions_total",
                        action=action) or 0)
                    for action in ("scale_up", "scale_down",
                                   "replace", "error")},
            }
    finally:
        if scaler is not None:
            try:
                scaler.stop()
            except Exception:             # noqa: BLE001
                pass
        if service is not None:
            service.close(drain=True)
        if plan is not None:
            _faults.disarm()
            if plan.fired:
                print(f"fault activations: {plan.fired}",
                      file=sys.stderr)
    if args.json_out:
        pathlib.Path(args.json_out).write_text(
            json.dumps(result, indent=2) + "\n")
    if args.metrics_out:
        obs.write_prom(args.metrics_out, obs.REGISTRY)
        print(f"metrics written to {args.metrics_out}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
