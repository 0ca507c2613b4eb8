"""The command line (``pyconsensus_tpu/cli.py``): the demo runs with their
reporter and event tables, a reports file resolved in memory or out of
core, on one host or several, and the Monte-Carlo collusion sweep.

Usage::

    python -m pyconsensus_tpu_torch --example
    python -m pyconsensus_tpu_torch --missing --scaled --device cpu
    python -m pyconsensus_tpu_torch --file reports.npy --stream
    python -m pyconsensus_tpu_torch --simulate --trials 200

Every flag of the reference keeps its name, default and validation
message. ``--backend`` takes ``torch`` (the reference's ``jax`` reads as
``torch``) or ``numpy``; ``--device`` (the card by default, ``cpu`` on
request) is where the torch backend, the sweep and the out-of-core driver
run, and a run that needs the card fails cleanly without one. ``--shard``
uses every local card (the CPU alone with ``--device cpu``): it resolves
the demos and ``--file`` through ``ShardedOracle`` with the events over
the cards, shards each streamed panel over them with ``--stream``
(``make_mesh(batch=1)``), and spreads the sweep's trials over them with
``--simulate`` (``make_mesh(batch=<cards>, event=1)``), as the
reference's does. Several hosts join through
``parallel.distributed.initialize`` (``--coordinator``, ``--hosts``,
``--host-id``) only after every local check.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from .models.pipeline import JIT_ALGORITHMS
from .oracle import ALGORITHMS, BACKENDS, Oracle

__all__ = ["main", "EXAMPLE_REPORTS", "MISSING_REPORTS", "SCALED_REPORTS",
           "SCALED_BOUNDS"]

# The canonical demo matrices (6 reporters x 4 events, and the scaled one).
EXAMPLE_REPORTS = np.array([
    [1.0, 1.0, 0.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [1.0, 1.0, 0.0, 0.0],
    [1.0, 1.0, 1.0, 0.0],
    [0.0, 0.0, 1.0, 1.0],
    [0.0, 0.0, 1.0, 1.0],
])

MISSING_REPORTS = np.array([
    [1.0, 1.0, 0.0, np.nan],
    [1.0, 0.0, 0.0, 0.0],
    [1.0, np.nan, 0.0, 0.0],
    [1.0, 1.0, np.nan, 0.0],
    [np.nan, 0.0, 1.0, 1.0],
    [0.0, 0.0, 1.0, 1.0],
])

SCALED_REPORTS = np.array([
    [1.0, 1.0, 0.0, 0.0, 233.0, 16027.59],
    [1.0, 0.0, 0.0, 0.0, 199.1, np.nan],
    [1.0, 1.0, 0.0, 0.0, 233.0, 16027.59],
    [1.0, 1.0, 1.0, 0.0, 250.0, 0.0],
    [0.0, 0.0, 1.0, 1.0, 435.8, 8001.0],
    [0.0, 0.0, 1.0, 1.0, 435.8, 19999.0],
])
SCALED_BOUNDS = [None, None, None, None,
                 {"scaled": True, "min": 0.0, "max": 435.8},
                 {"scaled": True, "min": 0.0, "max": 20000.0}]

def _print_table(title: str, headers: Sequence[str], rows) -> None:
    print(f"\n{title}")
    widths = [max(len(h), 10) for h in headers]
    print("  " + "  ".join(h.ljust(w) for h, w in zip(headers, widths)))
    for row in rows:
        cells = [f"{v:.6f}" if isinstance(v, float) else str(v) for v in row]
        print("  " + "  ".join(c.ljust(w) for c, w in zip(cells, widths)))


def _backend(value: str) -> str:
    """``--backend``: the reference's ``jax`` names the port's torch."""
    return "torch" if value == "jax" else value


def _local_devices(args):
    """``--shard``'s devices: every local card, or the CPU alone with
    ``--device cpu``. Each host's mesh is its own: no collective spans
    hosts."""
    from .parallel import make_mesh

    return list(make_mesh(devices=["cpu"] if args.device == "cpu"
                          else None))


def _run_demo(name: str, reports, bounds, args) -> None:
    from .utils import trace

    if args.shard:
        from .parallel import ShardedOracle, make_mesh

        # every local card on the event axis (one CPU shard on request)
        mesh = make_mesh(batch=1, devices=_local_devices(args))
        print(f"=== {name} (events sharded over {len(mesh)} device(s)) ===")
        oracle = ShardedOracle(reports=reports, event_bounds=bounds,
                               algorithm=args.algorithm, backend="torch",
                               mesh=mesh, max_iterations=args.iterations,
                               verbose=args.verbose)
    else:
        print(f"=== {name} ===")
        oracle = Oracle(reports=reports, event_bounds=bounds,
                        algorithm=args.algorithm, backend=args.backend,
                        max_iterations=args.iterations, verbose=args.verbose,
                        device=args.device)
    with trace(args.profile):
        result = oracle.consensus()
    if args.profile:
        print(f"  profiler trace written to {args.profile}")
    agents = result["agents"]
    events = result["events"]
    _print_table("Reporters", ["reporter", "old_rep", "smooth_rep", "bonus"],
                 [(i, float(agents["old_rep"][i]),
                   float(agents["smooth_rep"][i]),
                   float(agents["reporter_bonus"][i]))
                  for i in range(len(agents["old_rep"]))])
    _print_table("Events", ["event", "outcome_raw", "outcome_final",
                            "certainty"],
                 [(j, float(events["outcomes_raw"][j]),
                   float(events["outcomes_final"][j]),
                   float(events["certainty"][j]))
                  for j in range(len(events["outcomes_raw"]))])
    print(f"\n  participation: {result['participation']:.6f}"
          f"   certainty: {result['certainty']:.6f}"
          f"   converged: {result['convergence']} "
          f"({result['iterations']} iteration(s))\n")


def _traced_sweep(sim, lf, var, args):
    """The sweep under --profile's trace (the resolution only; tables and
    plots stay untraced)."""
    from .utils import trace

    with trace(args.profile):
        res = sim.run(lf, var, args.trials, seed=args.seed)
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    return res


def _run_simulation(args) -> None:
    from .sim import CollusionSimulator, RoundsSimulator

    # the simulator is always the batched torch pipeline: --backend
    # applies to the demo runs only
    lf = [0.0, 0.1, 0.2, 0.3, 0.4]
    var = [0.0, 0.1, 0.2]
    knobs = dict(n_reporters=args.reporters, n_events=args.events,
                 max_iterations=args.iterations, algorithm=args.algorithm,
                 device=args.device)
    mesh_note = ""
    if args.shard:
        from .parallel import make_mesh

        # the trials over every local card: pure data parallelism
        devices = _local_devices(args)
        knobs.update(device=None, mesh=make_mesh(
            batch=len(devices), event=1, devices=devices))
        mesh_note = f", trials over {len(devices)} device(s)"
    if args.rounds > 1:
        print(f"=== Monte-Carlo repeated-game sweep ({args.rounds} rounds, "
              f"{args.trials} trials/cell, reputation carried"
              f"{mesh_note}) ===")
        sim = RoundsSimulator(n_rounds=args.rounds, **knobs)
        res = _traced_sweep(sim, lf, var, args)
        headers = ["liar_frac"] + [f"round {r}" for r in (1, args.rounds)]
        for metric, title in (("correct_rate", "Correct-outcome rate "
                                               "(variance 0.1)"),
                              ("liar_rep_share", "Liar reputation share "
                                                 "(variance 0.1)")):
            traj = res["mean"][metric]                  # (L, V, n_rounds)
            rows = [[f"{f:g}", float(traj[i, 1, 0]), float(traj[i, 1, -1])]
                    for i, f in enumerate(lf)]
            _print_table(f"{title}: first vs final round", headers, rows)
        print()
        if args.plot:
            from .io import ensure_parent
            from .sim import plot_round_trajectories

            ax = plot_round_trajectories(res, "liar_rep_share",
                                         variance_index=1)
            ax.figure.savefig(ensure_parent(args.plot), bbox_inches="tight")
            print(f"round-trajectory plot written to {args.plot}")
        return
    print(f"=== Monte-Carlo collusion sweep "
          f"({args.trials} trials/cell, batched torch pipeline"
          f"{mesh_note}) ===")
    sim = CollusionSimulator(**knobs)
    res = _traced_sweep(sim, lf, var, args)
    headers = ["liar_frac"] + [f"var={v:g}" for v in var]
    rows = [[f"{f:g}"] + [float(res["mean"]["correct_rate"][i, j])
                          for j in range(len(var))]
            for i, f in enumerate(lf)]
    _print_table("Correct-outcome rate", headers, rows)
    rows = [[f"{f:g}"] + [float(res["mean"]["liar_rep_share"][i, j])
                          for j in range(len(var))]
            for i, f in enumerate(lf)]
    _print_table("Liar reputation share (post-resolution)", headers, rows)
    print()
    if args.plot:
        from .sim import save_sweep_report

        save_sweep_report(res, args.plot)
        print(f"sweep report written to {args.plot}")


def _run_streaming(args, bounds) -> None:
    from .models.pipeline import ConsensusParams
    from .parallel import streaming_consensus
    from .utils import trace

    multi = args.hosts is not None and args.hosts > 1
    mesh = None
    if args.shard:
        from .parallel import make_mesh

        # each host's own cards shard its panels
        mesh = make_mesh(batch=1, devices=_local_devices(args))
    print(f"=== Streaming resolution of {args.file} "
          f"({args.panel_events} events/panel, "
          f"{args.iterations} iteration(s)"
          + (f", host {args.host_id}/{args.hosts}" if multi else "")
          + (f", {len(mesh)} device(s)" if mesh is not None else "")
          + ") ===")
    with trace(args.profile):
        out = streaming_consensus(
            args.file, event_bounds=bounds, panel_events=args.panel_events,
            params=ConsensusParams(algorithm=args.algorithm,
                                   max_iterations=args.iterations),
            host_id=args.host_id if multi else None,
            n_hosts=args.hosts if multi else None, mesh=mesh,
            device=None if mesh is not None else args.device)
    if args.profile:
        print(f"  profiler trace written to {args.profile}")
    rep = out["smooth_rep"]
    _print_table("Reporters (top 8 by reputation)",
                 ["reporter", "smooth_rep", "reporter_bonus"],
                 [(int(i), float(rep[i]), float(out["reporter_bonus"][i]))
                  for i in np.argsort(rep)[::-1][:8]])
    outcomes = out["outcomes_final"]
    # the scaled/binary split comes from the bounds, not by value: a scaled
    # outcome can land exactly on 0/0.5/1
    binary = np.array([not (b and b.get("scaled")) for b in bounds]
                      if bounds else [True] * len(outcomes))
    n_scaled = int((~binary).sum())
    counts = {v: int((outcomes[binary] == v).sum()) for v in (0.0, 0.5, 1.0)}
    print(f"\n  events: {len(outcomes)}   outcomes 0/0.5/1: "
          f"{counts[0.0]}/{counts[0.5]}/{counts[1.0]}"
          + (f" (+{n_scaled} scaled)" if n_scaled else "")
          + f"   avg certainty: {out['avg_certainty']:.6f}"
          f"   participation: {1.0 - out['percent_na']:.6f}\n")


def _parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=prog,
        description="Truthcoin/Sztorc oracle consensus on an NVIDIA card "
                    "(the PyTorch/CUDA port) — demo driver")
    ap.add_argument("-x", "--example", action="store_true",
                    help="run the canonical 6x4 binary example")
    ap.add_argument("-m", "--missing", action="store_true",
                    help="run the example with missing (NaN) reports")
    ap.add_argument("-s", "--scaled", action="store_true",
                    help="run the example with scaled events + event_bounds")
    ap.add_argument("--simulate", action="store_true",
                    help="run a Monte-Carlo collusion sweep")
    ap.add_argument("--plot", metavar="PATH",
                    help="with --simulate: write a PNG sweep report "
                         "(heatmaps + retention curves; with --rounds > 1, "
                         "a per-round liar-reputation trajectory plot "
                         "instead; needs matplotlib)")
    ap.add_argument("-f", "--file", metavar="PATH",
                    help="resolve a reports matrix loaded from PATH "
                         "(.npy or .csv; NA/NaN = missing report)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="verbose Oracle prints during demo/--file "
                         "resolutions")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace (Chrome / Perfetto "
                         "JSON) of each resolution (demo, --file, --stream, "
                         "or --simulate sweep) to DIR")
    ap.add_argument("--metrics-out", metavar="PATH",
                    help="write the run's metrics registry (convergence "
                         "iterations, phase durations, fallbacks, panels "
                         "streamed) as Prometheus text exposition to PATH "
                         "on exit")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write the run's span tree (one JSON object per "
                         "line; reconstruct with "
                         "pyconsensus_tpu_torch.obs.span_tree) to PATH on "
                         "exit")
    ap.add_argument("--obs-report", action="store_true",
                    help="print the human-readable span tree after the "
                         "run")
    ap.add_argument("--fault-plan", metavar="PATH",
                    help="arm a JSON fault-injection plan "
                         "(pyconsensus_tpu_torch.faults.FaultPlan schema) "
                         "for the whole run: the same plan over the same "
                         "inputs re-injects the same faults at the same "
                         "sites/occurrences; the activation log is printed "
                         "on exit")
    ap.add_argument("--bounds", metavar="PATH",
                    help="with --file: JSON event-bounds sidecar — a list "
                         "with one entry per event, null for binary or "
                         '{"scaled": true, "min": M, "max": X} for scaled '
                         "events (the Oracle event_bounds format)")
    ap.add_argument("--stream", action="store_true",
                    help="with --file: resolve out-of-core (streaming "
                         "passes over event panels; for matrices larger "
                         "than device memory; .npy is memory-mapped, .csv "
                         "is staged to .npy in row chunks)")
    ap.add_argument("--shard", action="store_true",
                    help="use EVERY local card (backend=torch only): "
                         "demo/--file resolutions shard events over the "
                         "mesh (ShardedOracle), --stream shards each "
                         "panel's events, --simulate spreads the trials "
                         "over the cards")
    ap.add_argument("--panel-events", type=int, default=8192,
                    help="with --stream: events per streamed panel")
    ap.add_argument("--coordinator", metavar="ADDR",
                    help="with --stream: join a MULTI-HOST streamed "
                         "resolution — the coordinator's host:port (the "
                         "same value on every host); run the same command "
                         "on each host with its own --host-id. Each host "
                         "streams its round-robin share of the event "
                         "panels and the sufficient statistics sum "
                         "across hosts (parallel.streaming_consensus "
                         "n_hosts semantics)")
    ap.add_argument("--hosts", type=int, default=None,
                    help="with --coordinator: total number of hosts in "
                         "the launch")
    ap.add_argument("--host-id", type=int, default=None,
                    help="with --coordinator: this host's id in "
                         "[0, --hosts)")
    ap.add_argument("--algorithm", default="sztorc", choices=ALGORITHMS)
    ap.add_argument("--backend", default="torch", type=_backend,
                    choices=BACKENDS,
                    help="torch (the reference's jax reads as torch) or "
                         "numpy")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the torch backend, the sweep and the "
                         "out-of-core driver run (default: the card)")
    ap.add_argument("--iterations", type=int, default=None,
                    help="max reputation-redistribution iterations "
                         "(default 5; with --stream default 1 — each "
                         "iteration is one full pass over the file)")
    ap.add_argument("--trials", type=int, default=100,
                    help="simulation trials per grid cell")
    ap.add_argument("--rounds", type=int, default=1,
                    help="with --simulate: rounds per trial with reputation "
                         "carried between rounds (the repeated-game "
                         "experiment; 1 = independent single-round trials)")
    ap.add_argument("--reporters", type=int, default=20)
    ap.add_argument("--events", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _validate(ap, args):
    """Every local check, in the reference's order; returns the parsed
    ``--bounds`` list (or None). Nothing here joins a process group."""
    for name in ("iterations", "trials", "reporters", "events", "rounds"):
        value = getattr(args, name)
        if value is not None and value < 1:
            ap.error(f"--{name} must be >= 1")
    if args.simulate and args.algorithm not in JIT_ALGORITHMS:
        ap.error(f"--simulate requires a jit-compatible algorithm "
                 f"(got {args.algorithm!r}); choose from "
                 f"{', '.join(JIT_ALGORITHMS)}")
    if not (args.example or args.missing or args.scaled or args.simulate
            or args.file):
        args.example = True  # default demo, like the reference CLI
    if args.stream and not args.file:
        ap.error("--stream requires --file")
    if args.shard and args.backend != "torch":
        ap.error("--shard requires --backend torch (the mesh path is "
                 "ShardedOracle)")
    multihost = (args.coordinator is not None or args.hosts is not None
                 or args.host_id is not None)
    if multihost:
        if (args.coordinator is None or args.hosts is None
                or args.host_id is None):
            ap.error("--coordinator, --hosts, and --host-id must be "
                     "given together")
        if not args.stream:
            ap.error("--coordinator requires --stream (multi-host "
                     "resolution is the out-of-core deployment)")
        if args.hosts < 2:
            ap.error("--hosts must be >= 2 (a single host needs no "
                     "coordinator)")
        if not 0 <= args.host_id < args.hosts:
            ap.error(f"--host-id {args.host_id} not in [0, {args.hosts})")
    if args.bounds and not args.file:
        ap.error("--bounds requires --file")
    file_bounds = None
    if args.bounds:
        import json

        try:
            with open(args.bounds) as f:
                file_bounds = json.load(f)
        except (OSError, ValueError) as exc:
            ap.error(f"--bounds: {exc}")
        if not isinstance(file_bounds, list):
            ap.error(f"--bounds: {args.bounds} must contain a JSON list "
                     "(one entry per event: null or a "
                     '{"scaled": ..., "min": ..., "max": ...} object)')
    if args.panel_events < 1:
        ap.error("--panel-events must be >= 1")
    needs_device = (args.backend == "torch" or args.stream or args.simulate)
    if needs_device and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            ap.error("--device cuda: no CUDA device is available; pass "
                     "--device cpu to run on the CPU")
    if multihost:
        import os

        if not os.path.isfile(args.file):
            ap.error(f"--file: {args.file} is not a readable file")
    return file_bounds


def main(argv: Optional[Sequence[str]] = None,
         prog: str = "pyconsensus_tpu_torch") -> int:
    ap = _parser(prog)
    args = ap.parse_args(argv)
    file_bounds = _validate(ap, args)
    if args.coordinator is not None:
        # joined only after EVERY local check (this host's copy of the
        # reports file included): a host that exits after connecting
        # would leave its peers blocked in their first collective
        from .parallel import initialize

        initialize(coordinator_address=args.coordinator,
                   num_processes=args.hosts, process_id=args.host_id,
                   device=args.device)
    if args.iterations is None:
        # streaming pays one full pass over the file per iteration
        args.iterations = 1 if args.stream else 5
    if args.metrics_out or args.trace_out or args.obs_report:
        from . import obs

        # before the first resolution, so the kernels' build or load is
        # counted too (pyconsensus_jax_compile_events_total)
        obs.install_compile_monitor()
    fault_plan = None
    if args.fault_plan:
        from . import faults

        try:
            fault_plan = faults.FaultPlan.load(args.fault_plan)
        except (OSError, ValueError, KeyError) as exc:
            ap.error(f"--fault-plan: {exc}")
        # armed for the whole run (every resolution below shares the
        # plan's occurrence counters, which makes a replay deterministic)
        faults.arm(fault_plan)
    try:
        if args.file:
            if args.stream:
                try:
                    _run_streaming(args, file_bounds)
                except (OSError, ValueError) as exc:
                    ap.error(f"--stream: {exc}")
            else:
                from .io import load_reports

                try:
                    file_reports = load_reports(args.file)
                except (OSError, ValueError) as exc:
                    ap.error(f"--file: {exc}")
                if file_bounds is not None:
                    from .oracle import parse_event_bounds

                    try:
                        parse_event_bounds(file_bounds, file_reports.shape[1])
                    except ValueError as exc:
                        ap.error(f"--bounds: {exc}")
                _run_demo(f"Reports from {args.file}", file_reports,
                          file_bounds, args)
        if args.example:
            _run_demo("Example (dense binary)", EXAMPLE_REPORTS, None, args)
        if args.missing:
            _run_demo("Example with missing reports", MISSING_REPORTS, None,
                      args)
        if args.scaled:
            _run_demo("Example with scaled events", SCALED_REPORTS,
                      SCALED_BOUNDS, args)
        if args.simulate:
            _run_simulation(args)
        if args.metrics_out or args.trace_out or args.obs_report:
            from . import obs

            if args.metrics_out:
                obs.write_prom(args.metrics_out, obs.REGISTRY)
                print(f"metrics written to {args.metrics_out} "
                      f"(Prometheus text exposition)")
            if args.trace_out:
                n = obs.write_jsonl(
                    args.trace_out, obs.events(),
                    meta={"prog": prog,
                          "argv": list(argv if argv is not None
                                       else sys.argv[1:])})
                print(f"span trace written to {args.trace_out} "
                      f"({n} JSONL record(s))")
            if args.obs_report:
                print("\n=== Span tree (slowest roots first) ===")
                print(obs.report())
    finally:
        if fault_plan is not None:
            from . import faults

            faults.disarm()
            if fault_plan.fired:
                print("\ninjected faults (site #occurrence: kind):")
                for site, occ, kind in fault_plan.fired:
                    print(f"  {site} #{occ}: {kind}")
            else:
                print("\nfault plan armed; no rule fired")
    return 0


if __name__ == "__main__":
    sys.exit(main())
