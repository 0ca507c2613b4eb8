"""The port's load generator and serve command line
(``pyconsensus_tpu_torch.serve.loadgen``, ``serve.cli``) against the JAX
package's, on the CPU.

- the load generator: closed- and open-loop and trace-driven summaries
  carry the reference's keys and counts on the same scripted service,
  the bounded retry absorbs PYC401/501/502 sheds and abandons nothing
  within its budget, PYC503 and errors outside the taxonomy are not
  retried, the retry waits and the rate traces are the reference's;
- the command line: ``python -m pyconsensus_tpu_torch.serve.cli --device
  cpu`` exits 0 on one service and on a 3-worker fleet with a log
  directory (failed 0, abandoned 0), writes its exposition and span
  trace; the flags that once exited 2 (``--aot-cache``, ``--transport
  socket``, ``--autoscale*``, ``--metrics-port``, ``--metrics-hold-s``,
  ``--slo-*``) each do their work: the store is written then adopted,
  two socket workers serve, the autoscaler's block lands in the summary,
  a scrape during the hold equals ``render_prom``, and each SLO target
  reaches the monitor's summary.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import Future

import pytest
import torch

from pyconsensus_tpu.faults import PlacementError as RefPlacementError
from pyconsensus_tpu.faults import \
    ServiceOverloadError as RefServiceOverloadError
from pyconsensus_tpu.faults import WorkerLostError as RefWorkerLostError
from pyconsensus_tpu.serve import loadgen as ref_loadgen
from pyconsensus_tpu_torch.faults import (FailoverInProgressError,
                                          PlacementError,
                                          ServiceOverloadError,
                                          WorkerLostError)
from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig
from pyconsensus_tpu_torch.serve import cli, loadgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the summary keys that do not depend on the clock
COUNT_KEYS = ("requests", "succeeded", "failed", "errors", "retried",
              "abandoned")


@pytest.fixture(autouse=True)
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


class _Scripted:
    """A service that sheds each request ``fails`` times with
    ``make_exc()`` and then serves it (counted per corpus matrix, so the
    shapes must be distinct)."""

    def __init__(self, fails, make_exc):
        self.fails, self.make_exc = fails, make_exc
        self.seen: dict = {}

    def submit(self, reports=None, tenant="t", **kw):
        n = self.seen.get(id(reports), 0)
        self.seen[id(reports)] = n + 1
        if n < self.fails:
            raise self.make_exc()
        fut = Future()
        fut.set_result({"ok": True})
        return fut


SHAPES = ((2, 2), (2, 3), (2, 4), (2, 5))
SCRIPTS = {
    "lost_twice": (2, lambda m: m.WorkerLostError("lost",
                                                  retry_after_s=0.01)),
    "full_forever": (99, lambda m: m.ServiceOverloadError(
        "full", reason="queue_full", retry_after_s=0.01)),
    "failover_once": (1, lambda m: m.FailoverInProgressError(
        "moving", retry_after_s=0.01)),
    "empty_fleet": (99, lambda m: m.PlacementError("empty")),
    "foreign": (99, lambda m: ValueError("bad")),
}


class _RefErrors:
    WorkerLostError = RefWorkerLostError
    ServiceOverloadError = RefServiceOverloadError
    PlacementError = RefPlacementError

    @staticmethod
    def FailoverInProgressError(*a, **kw):
        from pyconsensus_tpu.faults import FailoverInProgressError as F
        return F(*a, **kw)


class _PortErrors:
    WorkerLostError = WorkerLostError
    ServiceOverloadError = ServiceOverloadError
    PlacementError = PlacementError
    FailoverInProgressError = FailoverInProgressError


def _counts(stats):
    return {k: stats[k] for k in COUNT_KEYS}


@pytest.mark.parametrize("mode", ["closed", "open", "trace"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("retries", [0, 3])
def test_summaries_match_the_references(mode, script, retries):
    fails, make = SCRIPTS[script]
    out = []
    for mod, errs in ((loadgen, _PortErrors), (ref_loadgen, _RefErrors)):
        svc = _Scripted(fails, lambda errs=errs: make(errs))
        gen = mod.LoadGenerator(svc, shapes=SHAPES, max_retries=retries,
                                retry_cap_s=0.02)
        if mode == "closed":
            stats = gen.run_closed(4, concurrency=1, timeout_s=10)
        elif mode == "open":
            stats = gen.run_open(4, rate_rps=400.0, timeout_s=10)
        else:
            stats = gen.run_trace(mod.RateTrace([(0.01, 400.0)]),
                                  timeout_s=10)
        out.append(stats)
    ours, ref = out
    assert set(ours) == set(ref)
    assert _counts(ours) == _counts(ref)
    if script in ("lost_twice", "failover_once") and retries:
        assert ours["succeeded"] == ours["requests"]
        assert ours["abandoned"] == 0


def test_retry_waits_are_the_references():
    ours = loadgen.LoadGenerator(None, shapes=((2, 2),), seed=7,
                                 retry_cap_s=1.5)
    ref = ref_loadgen.LoadGenerator(None, shapes=((2, 2),), seed=7,
                                    retry_cap_s=1.5)
    for hint in (0.0, 0.01, 0.3, 9.0):
        exc = WorkerLostError("lost", retry_after_s=hint)
        ref_exc = RefWorkerLostError("lost", retry_after_s=hint)
        for i in range(5):
            for attempt in range(6):
                assert ours._retry_delay(exc, i, attempt) == \
                    ref._retry_delay(ref_exc, i, attempt)
    assert loadgen.RETRYABLE_CODES == ref_loadgen.RETRYABLE_CODES


def test_rate_traces_and_summaries_are_the_references():
    for make in (lambda m: m.RateTrace.diurnal(2.0, 10.0, 4.0, steps=8),
                 lambda m: m.RateTrace.flash_crowd(1.0, 20.0, 0.5, 0.25,
                                                   0.5),
                 lambda m: m.RateTrace.from_json("[[0.5, 4], [0.25, 8]]")):
        a, b = make(loadgen), make(ref_loadgen)
        assert a.arrivals() == b.arrivals()
        assert a.describe() == b.describe()
        assert a.to_json() == b.to_json()
        assert loadgen.RateTrace.from_json(a.to_json()).segments == \
            a.segments
    with pytest.raises(ValueError):
        loadgen.RateTrace([(0.0, 1.0)])
    lat = [0.003, 0.001, 0.02, 0.002]
    assert loadgen.summarize(lat, {"PYC401": 1}, 2.0, 5, retried=3,
                             abandoned=1) == \
        ref_loadgen.summarize(lat, {"PYC401": 1}, 2.0, 5, retried=3,
                              abandoned=1)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert loadgen.quantile(sorted(lat), q) == \
            ref_loadgen.quantile(sorted(lat), q)


def test_load_generator_on_a_live_service():
    svc = ConsensusService(ServeConfig(batch_window_ms=1.0), device="cpu")
    with svc:
        gen = loadgen.LoadGenerator(svc, shapes=((12, 48), (24, 96)))
        closed = gen.run_closed(12, concurrency=4, timeout_s=60)
        opened = gen.run_open(6, rate_rps=200.0, timeout_s=60)
    for stats in (closed, opened):
        assert stats["failed"] == 0 and stats["abandoned"] == 0
        assert stats["succeeded"] == stats["requests"]
    block = loadgen.device_block(svc)
    assert block["n_devices"] == 1 and block["mesh_batch_lanes"] == 1
    assert loadgen.kernel_path_block().get("plain", 0) >= 1


# -- the command line ------------------------------------------------------


def _run_cli(args, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "pyconsensus_tpu_torch.serve.cli", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    return proc


def _summary(stdout):
    return json.loads(stdout[stdout.index("{"):])


def test_cli_one_service_exits_zero(tmp_path):
    prom, trace = tmp_path / "serve.prom", tmp_path / "trace.jsonl"
    proc = _run_cli(["--device", "cpu", "--requests", "16",
                     "--concurrency", "4", "--metrics-out", str(prom),
                     "--trace-out", str(trace)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    stats = _summary(proc.stdout)
    assert stats["failed"] == 0 and stats["abandoned"] == 0
    assert stats["succeeded"] == 16 and stats["device"] == "cpu"
    assert stats["kernel_paths"] == {"plain": 16}
    # the kernels' launch counts ride along: none off the card
    assert stats["kernel_launches"]
    assert not any(stats["kernel_launches"].values())
    assert "pyconsensus_serve_requests_total" in prom.read_text()
    assert any('"serve.dispatch"' in ln for ln in open(trace))


def test_cli_fleet_with_a_log_dir_exits_zero(tmp_path):
    rate = tmp_path / "trace.json"
    rate.write_text(json.dumps([[0.1, 60.0], [0.1, 120.0]]))
    proc = _run_cli(["--device", "cpu", "--fleet-workers", "3",
                     "--log-dir", str(tmp_path / "log"), "--requests",
                     "24", "--retries", "3", "--trace", str(rate)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    stats = _summary(proc.stdout)
    assert stats["failed"] == 0 and stats["abandoned"] == 0
    assert stats["requests"] == 18 and stats["trace"]["requests"] == 18
    assert stats["transport"] == "inprocess"
    assert set(stats["fleet"]["workers"]) == {"w0", "w1", "w2"}
    assert stats["fleet"]["alive"] == 3
    # every worker warmed what one service warms before the timed run:
    # the ladder buckets of the default --shapes 12x48,24x96
    assert stats["warmed_executables"] == 3 * 2


def test_cli_warmup_only_and_loadgen_main(capsys):
    assert cli.main(["--device", "cpu", "--warmup-only", "--shapes",
                     "12x48"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["warmed_buckets"] == 1 and out["builds"] == 1
    assert loadgen.main(["--device", "cpu", "--requests", "6",
                         "--shapes", "12x48"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["failed"] == 0 and stats["n_devices"] == 1


@pytest.mark.parametrize("flags,item", [
    (["--aot-cache", "/nonexistent"], "kernel-build cache"),
    (["--fleet-workers", "2", "--transport", "socket"],
     "socket transport"),
    (["--fleet-workers", "2", "--autoscale"], "autoscale.py"),
    (["--metrics-port", "0"], "obs/httpd.py"),
    (["--fleet-workers", "2", "--autoscale-min", "1"], "autoscale.py"),
    (["--fleet-workers", "2", "--autoscale-max", "8"], "autoscale.py"),
    (["--fleet-workers", "2", "--autoscale-interval-s", "0.5"],
     "autoscale.py"),
    (["--fleet-workers", "2", "--autoscale-cooldown-s", "3"],
     "autoscale.py"),
    (["--metrics-hold-s", "1"], "obs/httpd.py"),
    (["--slo-window-s", "10"], "obs/slo.py"),
    (["--slo-p50-ms", "20"], "obs/slo.py"),
    (["--slo-p99-ms", "50"], "obs/slo.py"),
    (["--slo-shed-ratio", "0.01"], "obs/slo.py"),
    (["--slo-queue-depth", "4"], "obs/slo.py")])
def test_refused_flags_exit_two_naming_the_item(flags, item, capsys,
                                               tmp_path, monkeypatch):
    if item == "kernel-build cache":
        # no longer refused: the store is written, then adopted from
        flags = ["--aot-cache", str(tmp_path / "aot")]
        for run in range(2):
            assert cli.main(["--device", "cpu", *flags, "--warmup-only",
                             "--shapes", "12x48"]) == 0
            out = json.loads(capsys.readouterr().out)
            assert out["builds"] == (1 if run == 0 else 0)
        return
    if item == "socket transport":
        # no longer refused: two CPU worker processes serve the run
        assert cli.main(["--device", "cpu", *flags, "--requests", "6",
                         "--shapes", "12x48"]) == 0
        stats = json.loads(capsys.readouterr().out)
        assert stats["transport"] == "socket"
        assert stats["failed"] == 0 and stats["abandoned"] == 0
        assert sorted(stats["fleet"]["workers"]) == ["w0", "w1"]
        return
    # no longer refused: each flag does its work
    base = ["--device", "cpu", "--requests", "8", "--shapes", "12x48"]
    if item == "autoscale.py":
        if "--autoscale" not in flags:
            flags = [*flags, "--autoscale"]
        assert cli.main([*base, *flags, "--autoscale-interval-s", "0.05",
                         "--log-dir", str(tmp_path / "log")]) == 0
        stats = json.loads(capsys.readouterr().out)
        block = stats["autoscale"]
        assert stats["failed"] == 0
        assert set(block["decisions"]) == {"hold", "scale_up",
                                           "scale_down", "replace", "error"}
        assert block["target"] in (None, 1, 2, 3, 4, 5, 6, 7, 8)
        assert len(stats["fleet"]["workers"]) >= 2
        return
    if item == "obs/httpd.py":
        import urllib.request

        from pyconsensus_tpu_torch import obs as obs_mod

        scraped = []
        hold = cli._hold

        def scrape_then_hold(args, srv):
            # the endpoint is up between the run and the close
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/metrics",
                    timeout=30) as r:
                scraped.append((r.read().decode(), obs_mod.render_prom()))
            t0 = time.monotonic()
            hold(args, srv)
            scraped.append(time.monotonic() - t0)

        extra = ["--metrics-port", "0"] if "--metrics-port" not in flags \
            else ["--metrics-hold-s", "0.2"]
        monkeypatch.setattr(cli, "_hold", scrape_then_hold)
        assert cli.main([*base, *flags, *extra]) == 0
        body, want = scraped[0]
        assert body == want and "pyconsensus_serve_requests_total" in body
        assert scraped[1] >= (1.0 if "1" in flags else 0.2)
        assert "metrics endpoint: http://127.0.0.1:" in \
            capsys.readouterr().err
        return
    assert item == "obs/slo.py"
    assert cli.main([*base, *flags]) == 0
    slo = json.loads(capsys.readouterr().out)["slo"]
    key, value = flags[0][len("--slo-"):].replace("-", "_"), float(flags[1])
    if key == "window_s":
        assert slo["targets"] == {} and slo["window_s"] <= value
    else:
        assert slo["targets"] == {key: value}
        assert slo["samples"] >= 1


def test_usage_errors_exit_two(tmp_path, capsys):
    cfg = tmp_path / "serve.json"
    cfg.write_text(json.dumps({"hot_sessions": -1}))
    bad = [["--device", "cpu", "--config", str(cfg)],
           ["--device", "cpu", "--shapes", "12by48"],
           ["--device", "cpu", "--refresh-every", "0"]]
    if not torch.cuda.is_available():
        bad.append(["--requests", "1"])      # the card by default
    for argv in bad:
        with pytest.raises(SystemExit) as ei:
            cli.main(argv)
        assert ei.value.code == 2, argv
    assert "hot_sessions must be >= 0" in capsys.readouterr().err


def test_console_script_is_declared():
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    assert 'pyconsensus-serve-torch = "pyconsensus_tpu_torch.serve.cli:main"' \
        in text
