"""The port's windowed SLO monitor, metrics endpoint and flight recorder
(``pyconsensus_tpu_torch.obs.slo``, ``obs.httpd``, ``obs.flightrec``)
against the JAX package's, on the CPU.

- the SLO monitor: the same snapshot sequences (hand-built, and real
  registry snapshots of a serve run) through the port's and the
  reference's ``SloMonitor`` give equal windows, quantiles, rates,
  summaries and violation seconds; ``quantile_from_counts`` and
  ``targets_from_config`` are equal on the same inputs; the load
  generator's ``slo=`` summary carries the reference's keys;
- the metrics endpoint: a scrape over loopback equals ``render_prom``
  (and a fleet's merged view, each socket worker labeled), 404 off
  ``/metrics``, 500 when the render fails, ``None`` on a port already
  bound;
- a socket worker's telemetry has a connection of its own: an SLO
  sample answers while every data-plane connection is busy;
- the flight recorder: a dump the port writes is read by both
  ``read_flight_dir``\\ s and by ``tools/flightrec_dump.py``; the ring
  wraps at ``keep``; a CPU fleet's router dumps at a takeover and a
  drain, and a socket worker process at boot and shutdown;
- the new modules import neither jax nor the JAX package.
"""

import concurrent.futures
import json
import math
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pyconsensus_tpu.obs import SloMonitor as RefSloMonitor
from pyconsensus_tpu.obs import quantile_from_counts as ref_quantile
from pyconsensus_tpu.obs import read_flight_dir as ref_read_flight_dir
from pyconsensus_tpu.obs import targets_from_config as ref_targets
from pyconsensus_tpu.serve import ServeConfig as RefServeConfig
from pyconsensus_tpu_torch import obs
from pyconsensus_tpu_torch.obs import (FlightRecorder, MetricsServer,
                                       SloMonitor, quantile_from_counts,
                                       read_flight_dir,
                                       start_metrics_server,
                                       targets_from_config)
from pyconsensus_tpu_torch.serve import (ConsensusFleet, ConsensusService,
                                         FleetConfig, LoadGenerator,
                                         ServeConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGES = (0.005, 0.05, 0.5)


def _snap(requests=None, shed=None, queue=None, counts=None, edges=EDGES,
          workers=None):
    """A registry snapshot fixture: the serve counters, the queue gauge
    and the latency histogram, on one series or, with ``workers``, one
    series a worker (``{"w0": (requests, shed, queue, counts), ...}``)."""
    if workers is None:
        workers = {"": (requests, shed, queue, counts)}
    snap = {}

    def key(w):
        return json.dumps({"worker": w}) if w else ""

    for name, i in (("pyconsensus_serve_requests_total", 0),
                    ("pyconsensus_serve_shed_total", 1)):
        series = {key(w): float(v[i]) for w, v in workers.items()
                  if v[i] is not None}
        if series:
            snap[name] = {"kind": "counter", "labels": [],
                          "series": series}
    series = {key(w): float(v[2]) for w, v in workers.items()
              if v[2] is not None}
    if series:
        snap["pyconsensus_serve_queue_depth"] = {
            "kind": "gauge", "labels": [], "series": series}
    series = {key(w): {"sum": 0.0, "count": sum(v[3]),
                       "counts": list(v[3])}
              for w, v in workers.items() if v[3] is not None}
    if series:
        snap["pyconsensus_serve_request_seconds"] = {
            "kind": "histogram", "labels": [], "edges": list(edges),
            "series": series}
    return snap


#: timelines of (now, snapshot): counter deltas, quantiles, overflow, a
#: metric born inside the window, samples aging out, violations, a
#: worker joining and one leaving mid-window, a counter reset, a bucket
#: layout change and empty windows
TIMELINES = {
    "rates": [(0.0, _snap(0, 0, 2)), (1.0, _snap(10, 1, 2))],
    "quantiles": [(0.0, _snap(counts=[0, 0, 0, 0])),
                  (1.0, _snap(counts=[90, 9, 1, 0]))],
    "overflow": [(0.0, _snap(counts=[0, 0, 0, 0])),
                 (1.0, _snap(counts=[0, 0, 0, 5]))],
    "born_inside": [(0.0, _snap()), (1.0, _snap(counts=[0, 2, 0, 0]))],
    "age_out": [(0.0, _snap(0)), (5.0, _snap(100)), (12.0, _snap(110)),
                (12.0, _snap(111))],
    "violations": [(0.0, _snap(0, 0, 1, [0, 0, 0, 0])),
                   (2.0, _snap(10, 5, 9, [0, 0, 10, 0])),
                   (3.5, _snap(20, 5, 1, [10, 0, 10, 0])),
                   (4.0, _snap(40, 5, 0, [30, 0, 10, 0]))],
    "membership": [
        (0.0, _snap(workers={"w0": (5, 0, 1, [5, 0, 0, 0]),
                             "w1": (7, 1, 2, [0, 7, 0, 0])})),
        (1.0, _snap(workers={"w0": (9, 0, 0, [9, 0, 0, 0]),
                             "w1": (8, 1, 1, [0, 8, 0, 0]),
                             "w2": (4, 2, 3, [0, 0, 4, 0])})),
        (2.5, _snap(workers={"w0": (12, 0, 0, [12, 0, 0, 0]),
                             "w2": (9, 2, 0, [0, 0, 9, 0])}))],
    "reset": [(0.0, _snap(50, 5, 0, [40, 10, 0, 0])),
              (1.0, _snap(3, 0, 0, [3, 0, 0, 0]))],
    "relayout": [(0.0, _snap(counts=[1, 1, 1, 1])),
                 (1.0, _snap(counts=[2, 2, 2], edges=(0.01, 0.1)))],
    "empty": [(0.0, {}), (1.0, {}), (2.0, _snap(0, 0, 0))],
}
TARGETS = {"p50_ms": 20.0, "p99_ms": 100.0, "shed_ratio": 0.05,
           "queue_depth": 4.0}


def _feed(monitor, timeline):
    feed = {"snap": {}}
    monitor._snapshot_fn = lambda: feed["snap"]
    wins = []
    for now, snap in timeline:
        feed["snap"] = snap
        wins.append(monitor.sample(now=now))
    return wins


@pytest.mark.parametrize("window_s", [1.5, 60.0])
@pytest.mark.parametrize("targets", [{}, TARGETS])
@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_windows_equal_the_references(name, targets, window_s):
    ours = SloMonitor(targets=targets, window_s=window_s, snapshot_fn=dict)
    ref = RefSloMonitor(targets=targets, window_s=window_s,
                        snapshot_fn=dict)
    assert _feed(ours, TIMELINES[name]) == _feed(ref, TIMELINES[name])
    assert ours.window() == ref.window()
    got, want = ours.summary(), ref.summary()
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["violation_s"] == want["violation_s"]


def test_violation_seconds_feed_the_counter():
    obs.reset()
    m = SloMonitor(targets={"p99_ms": 10.0}, window_s=60.0,
                   snapshot_fn=dict)
    _feed(m, [(0.0, _snap(counts=[0, 0, 0, 0])),
              (2.0, _snap(counts=[0, 0, 10, 0]))])
    assert m.summary()["violation_s"] == {"p99_ms": 2.0}
    assert obs.value("pyconsensus_slo_violation_seconds",
                     slo="p99_ms") == 2.0


@pytest.mark.parametrize("counts", [[], [0, 0, 0], [90, 9, 1, 0],
                                    [0, 0, 0, 5], [1], [3, 0, 2, 7],
                                    [0, 100, 0, 0]])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_quantile_from_counts_is_the_references(counts, q):
    edges = list(EDGES)[:max(0, len(counts) - 1)]
    got, want = quantile_from_counts(edges, counts, q), ref_quantile(
        edges, counts, q)
    assert got == want or (math.isinf(got) and math.isinf(want))


@pytest.mark.parametrize("kw", [{}, {"slo_p99_ms": 50.0,
                                     "slo_shed_ratio": 0.01},
                                {"slo_p50_ms": 5.0, "slo_queue_depth": 3.0,
                                 "slo_window_s": 2.0}])
def test_targets_from_config_are_the_references(kw):
    assert targets_from_config(ServeConfig(**kw)) == ref_targets(
        RefServeConfig(**kw))


def test_monitor_refusals_are_the_references():
    for mon in (SloMonitor, RefSloMonitor):
        with pytest.raises(ValueError, match="p95_ms"):
            mon(targets={"p95_ms": 1.0})
        with pytest.raises(ValueError, match="window_s"):
            mon(window_s=0.0)


def test_real_registry_snapshots_through_both_monitors():
    """Snapshots of the port's own registry after each of a few serve
    runs, replayed into both monitors with the same clock."""
    obs.reset()
    snaps = [obs.REGISTRY.snapshot()]
    with ConsensusService(ServeConfig(warmup=(), batch_window_ms=1.0),
                          device="cpu") as svc:
        rng = np.random.default_rng(3)
        for n in (4, 7, 2):
            futs = [svc.submit(reports=rng.choice([0.0, 1.0],
                                                  size=(12, 24)))
                    for _ in range(n)]
            for f in futs:
                f.result(60)
            snaps.append(obs.REGISTRY.snapshot())
    timeline = [(float(i), s) for i, s in enumerate(snaps)]
    for targets in ({}, {"p50_ms": 0.001, "queue_depth": 100.0}):
        ours = SloMonitor(targets=targets, window_s=2.5, snapshot_fn=dict)
        ref = RefSloMonitor(targets=targets, window_s=2.5,
                            snapshot_fn=dict)
        assert _feed(ours, timeline) == _feed(ref, timeline)
        assert ours.summary() == ref.summary()
    assert ours.window()["request_rate_rps"] == 4.5     # (7 + 2) / 2 s


def test_sampler_thread_and_load_generator_summary():
    obs.reset()
    with ConsensusService(ServeConfig(warmup=(), batch_window_ms=1.0,
                                      slo_p99_ms=1e6),
                          device="cpu") as svc:
        slo = SloMonitor(targets=targets_from_config(svc.config),
                         window_s=5.0)
        gen = LoadGenerator(svc, shapes=((12, 24),), seed=1, slo=slo)
        stats = gen.run_closed(12, concurrency=3)
        assert stats["failed"] == 0
        open_stats = gen.run_open(6, rate_rps=200.0)
    ref = RefSloMonitor(targets={"p99_ms": 1e6}, window_s=5.0,
                        snapshot_fn=dict)
    ref.sample(now=0.0)
    for st in (stats, open_stats):
        assert set(st["slo"]) == set(ref.summary())
        assert st["slo"]["targets"] == {"p99_ms": 1e6}
        assert st["slo"]["violation_s"] == {}
        assert st["slo"]["samples"] >= 1    # stop() takes a last one
    assert slo._thread is None          # stopped with the run


# -- the metrics endpoint ---------------------------------------------------


def _get(port, path="/metrics"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def test_scrape_equals_render_prom():
    obs.reset()
    obs.counter("pyconsensus_serve_requests_total", "requests",
                labels=("path", "outcome")).inc(3, path="bucket",
                                                outcome="ok")
    obs.histogram("pyconsensus_serve_request_seconds", "latency").observe(
        0.02)
    srv = MetricsServer(0, obs.render_prom)
    try:
        status, ctype, body = _get(srv.port)
        assert status == 200 and ctype.startswith("text/plain")
        assert body == obs.render_prom()
        assert _get(srv.port, "/?x=1")[2] == obs.render_prom()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.port, "/other")
        assert ei.value.code == 404
    finally:
        srv.close()
        srv.close()                     # idempotent


def test_endpoint_reports_a_failed_render_and_a_bound_port(capsys):
    def boom():
        raise RuntimeError("half-dead fleet")

    srv = start_metrics_server(0, boom)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.port)
        assert ei.value.code == 500
        assert "half-dead fleet" in ei.value.read().decode()
        assert start_metrics_server(srv.port, obs.render_prom) is None
        assert "unavailable" in capsys.readouterr().err
    finally:
        srv.close()


def test_in_process_fleet_scrape_is_its_merged_view(tmp_path):
    # in-process workers share this registry: one "router" series
    fleet = ConsensusFleet(FleetConfig(
        n_workers=2, log_dir=str(tmp_path / "log"),
        worker=ServeConfig(warmup=(), batch_window_ms=1.0)),
        device="cpu").start(warmup=False)
    srv = start_metrics_server(0, fleet.render_metrics)
    try:
        fleet.submit(reports=np.ones((8, 12))).result(60)
        for _ in range(50):     # the batcher's bookkeeping after a result
            body = _get(srv.port)[2]
            if body == fleet.render_metrics():
                break
            time.sleep(0.05)
        assert body == fleet.render_metrics()
        assert 'worker="router"' in body
    finally:
        srv.close()
        fleet.close(drain=True)


# -- the flight recorder ----------------------------------------------------


def test_dumps_read_by_both_packages_and_the_tool(tmp_path):
    obs.reset()
    c = obs.counter("pyconsensus_flightrec_probe_total", "test probe")
    rec = FlightRecorder(tmp_path / "fr", source="t0", keep=3)
    with obs.span("flightrec.probe"):
        c.inc(3)
    rec.dump("boot")
    c.inc(2)
    rec.dump("shutdown")
    ours, ref = read_flight_dir(tmp_path / "fr"), ref_read_flight_dir(
        tmp_path / "fr")
    assert ours == ref
    assert [r["reason"] for r in ours] == ["boot", "shutdown"]
    assert all(r["format"] == "pyconsensus-flightrec-v1" and
               r["source"] == "t0" for r in ours)
    assert ours[1]["metric_deltas"]["pyconsensus_flightrec_probe_total"][
        "series"][""] == 2.0            # the delta, not the cumulative 5
    assert any(sp["name"] == "flightrec.probe" for sp in ours[0]["spans"])
    for reason in ("a", "b", "c"):      # the ring wraps at keep = 3
        rec.dump(reason)
    got = read_flight_dir(tmp_path / "fr")
    assert [r["reason"] for r in got] == ["a", "b", "c"]
    assert [r["seq"] for r in got] == [2, 3, 4]
    assert got == ref_read_flight_dir(tmp_path / "fr")
    assert read_flight_dir(tmp_path / "missing") == []
    with pytest.raises(ValueError):
        FlightRecorder(tmp_path, keep=0)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "flightrec_dump.py"),
         str(tmp_path / "fr")], capture_output=True, text=True,
        timeout=60)
    assert out.returncode == 0, out.stderr
    assert "reason=c" in out.stdout and "source=t0" in out.stdout


def test_router_dumps_at_takeover_and_drain(tmp_path):
    frd = tmp_path / "fr"
    fleet = ConsensusFleet(FleetConfig(
        n_workers=3, log_dir=str(tmp_path / "log"),
        worker=ServeConfig(warmup=(), batch_window_ms=1.0,
                           flightrec_dir=str(frd))),
        device="cpu").start(warmup=False)
    try:
        fleet.create_session("m", n_reporters=8)
        fleet.kill_worker(fleet.owner_of("m"))
        survivor = fleet.ring.workers()[0]
        assert fleet.drain_worker(survivor)["drained"]
    finally:
        fleet.close(drain=True)
    recs = read_flight_dir(frd / "router")
    assert [r["reason"] for r in recs] == ["takeover", "drain"]
    assert {r["source"] for r in recs} == {"router"}
    assert recs == ref_read_flight_dir(frd / "router")


def test_socket_fleet_scrape_and_worker_dumps(tmp_path):
    """A socket fleet's scrape labels each worker process; the worker
    dumps at boot, on SIGTERM and at shutdown."""
    frd = tmp_path / "fr"
    fleet = ConsensusFleet(FleetConfig(
        n_workers=1, transport="socket", log_dir=str(tmp_path / "log"),
        worker=ServeConfig(warmup=(), batch_window_ms=1.0,
                           flightrec_dir=str(frd))),
        device="cpu").start(warmup=False)
    srv = start_metrics_server(0, fleet.render_metrics)
    try:
        fleet.submit(reports=np.ones((8, 12))).result(120)
        body = _get(srv.port)[2]
        assert 'pyconsensus_serve_requests_total{' in body
        assert 'worker="w0"' in body and 'worker="router"' in body
        # every data-plane connection busy (as under a burst): the SLO
        # monitor's sample still answers at once, on its own connection
        data = fleet.workers["w0"]._data
        held = [data._checkout() for _ in range(data.pool)]
        slo = SloMonitor(window_s=5.0, snapshot_fn=fleet.merged_snapshot)
        pool = concurrent.futures.ThreadPoolExecutor(1)
        try:
            win = pool.submit(slo.sample).result(timeout=20)
            assert win["samples"] == 1
        finally:
            for sock in held:
                data._checkin(sock)
            pool.shutdown(wait=True)
    finally:
        srv.close()
        fleet.close(drain=True)
    recs = read_flight_dir(frd / "w0")
    assert [r["reason"] for r in recs] == ["boot", "sigterm", "shutdown"]
    assert {r["source"] for r in recs} == {"w0"}
    assert recs == ref_read_flight_dir(frd / "w0")


def test_worker_fences_and_dumps_when_shipping_fails(tmp_path):
    from pyconsensus_tpu_torch.faults import CheckpointCorruptionError
    from pyconsensus_tpu_torch.serve.transport.worker import \
        FleetWorkerProcess

    class BrokenShipper:
        def ship_file(self, *a, **k):
            raise OSError("standby disk gone")

    rec = FlightRecorder(tmp_path / "fr", source="w9")
    with ConsensusService(ServeConfig(warmup=()), device="cpu") as svc:
        proc = FleetWorkerProcess("w9", svc, tmp_path / "log",
                                  shipper=BrokenShipper(), recorder=rec)
        with pytest.raises(CheckpointCorruptionError, match="fenced"):
            proc.create_session({"name": "m", "n_reporters": 6})
    assert [r["reason"] for r in read_flight_dir(tmp_path / "fr")] == [
        "fence"]


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import pyconsensus_tpu_torch.obs.slo\n"
        "import pyconsensus_tpu_torch.obs.httpd\n"
        "import pyconsensus_tpu_torch.obs.flightrec\n"
        "import pyconsensus_tpu_torch.serve.autoscale\n"
        "import pyconsensus_tpu_torch.econ\n"
        "import pyconsensus_tpu_torch.econ.cli\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pyconsensus_tpu' or m.startswith('pyconsensus_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_two_endpoints_on_port_zero_bind_distinct_ports():
    """Port 0 binds an OS-picked port: two servers never collide."""
    a = MetricsServer(0, lambda: "a\n")
    b = MetricsServer(0, lambda: "b\n")
    try:
        assert a.port != b.port
        assert _get(a.port)[2] == "a\n" and _get(b.port)[2] == "b\n"
        with socket.create_connection(("127.0.0.1", a.port), timeout=5):
            pass
    finally:
        a.close()
        b.close()


@pytest.fixture(autouse=True)
def _float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


@pytest.fixture(autouse=True)
def _clean_registry():
    """Leave the process registry as found: a fleet's heartbeats add
    worker-labelled series that later tests of the same process do not
    expect."""
    yield
    obs.reset()
