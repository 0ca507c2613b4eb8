"""The port's command line (``python -m pyconsensus_tpu_torch``,
``pyconsensus_tpu_torch.cli``) on the CPU: the tests of
``tests/test_cli.py`` that need no multi-device mesh, with
``--device cpu``, and the printed results against the reference CLI's
on the same inputs (outcome counts exactly, printed reputations within
1e-6, i.e. equal to the printed digit).

The port's runs take float64 here (the ``float64`` fixture), as the
reference's x64 runs do; a subprocess runs in the port's default float32.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import collusion_reports, free_port
from pyconsensus_tpu.cli import main as ref_main
from pyconsensus_tpu_torch import io
from pyconsensus_tpu_torch.cli import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
#: printed to 6 decimals: equal to the printed digit
PRINT_ATOL = 1e-6 + 1e-12


@pytest.fixture(autouse=True)
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def save(tmp_path, name, seed=0, R=16, E=20, liars=4, na_frac=0.1):
    reports, _ = collusion_reports(np.random.default_rng(seed), R=R, E=E,
                                   liars=liars, na_frac=na_frac)
    return str(io.save_reports(tmp_path / name, reports))


def tables(text):
    """Every table row of a demo or file run: ``[(title, [floats])]``."""
    rows, title = [], None
    for line in text.splitlines():
        s = line.strip()
        if s in ("Reporters", "Events"):
            title = s
        elif title and re.match(r"^\d+\s", s):
            rows.append((title, [float(t) for t in s.split()]))
        elif not s:
            title = None
    return rows


def stream_summary(text):
    """``(outcome-count line, {reporter: (smooth_rep, bonus)})`` of a
    ``--stream`` run."""
    counts = re.search(r"outcomes 0/0\.5/1: (\d+/\d+/\d+)", text)
    assert counts, text
    rows = {int(m[0]): (float(m[1]), float(m[2])) for m in
            re.findall(r"^\s+(\d+)\s+([\d.e+-]+)\s+([\d.e+-]+)\s*$", text,
                       re.M)}
    assert len(rows) == 8, text
    return counts.group(1), rows


def assert_tables_match(got, ref):
    a, b = tables(got), tables(ref)
    assert [t for t, _ in a] == [t for t, _ in b] and a
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(x, y, atol=PRINT_ATOL, rtol=0)


def assert_stream_match(got, ref, atol=PRINT_ATOL):
    c_got, r_got = stream_summary(got)
    c_ref, r_ref = stream_summary(ref)
    assert c_got == c_ref
    assert r_got.keys() == r_ref.keys()
    for rid, vals in r_got.items():
        np.testing.assert_allclose(vals, r_ref[rid], atol=atol, rtol=0)


# -- the reference's suite -------------------------------------------------


def test_default_runs_example(capsys):
    assert main(CPU) == 0
    out = capsys.readouterr().out
    assert "Example (dense binary)" in out
    assert "Reporters" in out and "Events" in out
    assert "participation" in out


def test_all_demo_flags(capsys):
    assert main(["--example", "--missing", "--scaled", "--backend",
                 "numpy"]) == 0
    out = capsys.readouterr().out
    assert "missing reports" in out
    assert "scaled events" in out


def test_short_flags(capsys):
    assert main(["-x", "-m", "-s", "--iterations", "2", *CPU]) == 0
    assert "scaled events" in capsys.readouterr().out


@pytest.mark.parametrize("algorithm", ["k-means", "hierarchical",
                                       "dbscan-jit"])
def test_algorithm_selection(capsys, algorithm):
    assert main(["--example", "--algorithm", algorithm, *CPU]) == 0
    assert "Example (dense binary)" in capsys.readouterr().out


def test_simulate(capsys):
    assert main(["--simulate", "--trials", "5", "--reporters", "10",
                 "--events", "5", *CPU]) == 0
    out = capsys.readouterr().out
    assert "Correct-outcome rate" in out
    assert "Liar reputation share" in out


def test_simulate_rounds(capsys, tmp_path):
    pytest.importorskip("matplotlib").use("Agg")
    path = str(tmp_path / "rounds.png")
    assert main(["--simulate", "--rounds", "3", "--trials", "4",
                 "--reporters", "10", "--events", "5", "--plot", path,
                 *CPU]) == 0
    out = capsys.readouterr().out
    assert "repeated-game sweep" in out
    assert "first vs final round" in out
    assert (tmp_path / "rounds.png").exists()


@pytest.mark.parametrize("argv", [
    ["--simulate", "--rounds", "0"],
    ["--iterations", "0"],
    ["--simulate", "--algorithm", "hierarchical"],
    ["--panel-events", "0", "--file", "x.npy", "--stream"],
    ["--algorithm", "nope"],
])
def test_validation_exits(argv):
    with pytest.raises(SystemExit):
        main([*argv, *CPU])


def test_stream_file(capsys, tmp_path):
    path = save(tmp_path, "r.npy")
    assert main(["--file", path, "--stream", "--panel-events", "6",
                 *CPU]) == 0
    out = capsys.readouterr().out
    assert "Streaming resolution" in out
    assert "outcomes 0/0.5/1" in out


def test_stream_requires_file():
    with pytest.raises(SystemExit):
        main(["--stream", *CPU])


def test_stream_rejects_incompatible_flags():
    with pytest.raises(SystemExit):
        main(["--file", "x.npy", "--stream", "--algorithm", "k-means", *CPU])


def test_stream_iterations(capsys, tmp_path):
    path = save(tmp_path, "r.npy", R=12, E=10, liars=3, na_frac=0.0)
    assert main(["--file", path, "--stream", "--iterations", "3",
                 "--panel-events", "4", *CPU]) == 0
    assert "3 iteration(s)" in capsys.readouterr().out


def test_stream_bad_path_clean_error(capsys):
    with pytest.raises(SystemExit):
        main(["--file", "/nonexistent/x.npy", "--stream", *CPU])
    assert "--stream" in capsys.readouterr().err


def test_shard_example(capsys):
    """``--shard`` resolves the demo through ``ShardedOracle`` and prints
    the same tables as the plain run."""
    assert main(["--example", *CPU]) == 0
    plain = capsys.readouterr().out
    assert main(["--example", "--shard", *CPU]) == 0
    sharded = capsys.readouterr().out
    assert "sharded over 1 device(s)" in sharded
    assert_tables_match(sharded, plain)


def test_shard_file(capsys, tmp_path):
    path = save(tmp_path, "r.npy")
    assert main(["--file", path, *CPU]) == 0
    plain = capsys.readouterr().out
    assert main(["--file", path, "--shard", *CPU]) == 0
    assert_tables_match(capsys.readouterr().out, plain)


@pytest.mark.parametrize("mode", [["--stream"], ["--simulate"]])
def test_shard_with_stream_or_simulate_names_the_roadmap(capsys, tmp_path,
                                                         mode):
    path = save(tmp_path, "r.npy")
    with pytest.raises(SystemExit):
        main(["--file", path, *mode, "--shard", *CPU])
    assert "ROADMAP.md §A.10" in capsys.readouterr().err


def test_shard_validation():
    with pytest.raises(SystemExit):
        main(["--example", "--shard", "--backend", "numpy", *CPU])


def test_stream_multihost_flags_validation(tmp_path):
    """--coordinator/--hosts/--host-id come together, with --stream,
    hosts >= 2, and the host id in range."""
    path = save(tmp_path, "r.npy", R=8, E=6, liars=2, na_frac=0.0)
    base = ["--file", path, "--stream", *CPU]
    for bad in ([*base, "--hosts", "2"],
                [*base, "--coordinator", "localhost:1"],
                [*base, "--coordinator", "localhost:1", "--hosts", "2"],
                ["--file", path, "--coordinator", "localhost:1",
                 "--hosts", "2", "--host-id", "0", *CPU],
                [*base, "--coordinator", "localhost:1", "--hosts", "1",
                 "--host-id", "0"],
                [*base, "--coordinator", "localhost:1", "--hosts", "2",
                 "--host-id", "2"],
                ["--file", str(tmp_path / "missing.npy"), "--stream",
                 "--coordinator", "localhost:1", "--hosts", "2",
                 "--host-id", "0", *CPU]):
        with pytest.raises(SystemExit):
            main(bad)


def test_stream_csv_file(capsys, tmp_path):
    reports, _ = collusion_reports(np.random.default_rng(1), R=12, E=10,
                                   liars=3, na_frac=0.1)
    path = str(io.save_reports(tmp_path / "r.csv", reports))
    assert main(["--file", path, "--stream", "--panel-events", "4",
                 *CPU]) == 0
    assert "Streaming resolution" in capsys.readouterr().out
    assert [f for f in tmp_path.iterdir() if "stage" in f.name] == []


def _bounded(tmp_path):
    reports, _ = collusion_reports(np.random.default_rng(2), R=10, E=4,
                                   liars=3)
    reports[:, 3] = reports[:, 3] * 400.0 + 100.0        # into [100, 500]
    path = str(io.save_reports(tmp_path / "r.npy", reports))
    bounds = [None, None, None, {"scaled": True, "min": 100.0,
                                 "max": 500.0}]
    bpath = tmp_path / "bounds.json"
    bpath.write_text(json.dumps(bounds))
    return path, str(bpath)


def test_file_with_bounds(capsys, tmp_path):
    path, bpath = _bounded(tmp_path)
    assert main(["--file", path, "--bounds", bpath, *CPU]) == 0
    out = capsys.readouterr().out
    last_event_line = [ln for ln in out.splitlines()
                       if ln.strip().startswith("3 ")][-1]
    assert any(float(tok) > 1.0 for tok in last_event_line.split()[1:3])


def test_stream_with_bounds(capsys, tmp_path):
    path, bpath = _bounded(tmp_path)
    assert main(["--file", path, "--stream", "--bounds", bpath,
                 "--panel-events", "2", *CPU]) == 0
    assert "(+1 scaled)" in capsys.readouterr().out


def test_bounds_validation(capsys, tmp_path):
    with pytest.raises(SystemExit):
        main(["--bounds", "b.json", *CPU])               # requires --file
    bpath = tmp_path / "bounds.json"
    bpath.write_text(json.dumps({"not": "a list"}))
    with pytest.raises(SystemExit):
        main(["--file", "r.npy", "--bounds", str(bpath), *CPU])
    assert "JSON list" in capsys.readouterr().err
    path = str(io.save_reports(tmp_path / "r.npy", np.eye(3)))
    bpath.write_text(json.dumps([None]))
    with pytest.raises(SystemExit):
        main(["--file", path, "--bounds", str(bpath), *CPU])
    assert "entries" in capsys.readouterr().err


def test_profile_writes_trace(capsys, tmp_path):
    out = tmp_path / "trace"
    assert main(["--example", "--profile", str(out), *CPU]) == 0
    assert "profiler trace written" in capsys.readouterr().out
    traces = list(out.glob("trace-*.json"))
    assert traces and json.loads(traces[0].read_text())["traceEvents"]


def test_profile_covers_stream_and_simulate(capsys, tmp_path):
    path = save(tmp_path, "r.npy", R=10, E=8, liars=3, na_frac=0.0)
    out1 = tmp_path / "t1"
    assert main(["--file", path, "--stream", "--panel-events", "4",
                 "--profile", str(out1), *CPU]) == 0
    assert list(out1.glob("trace-*.json"))
    out2 = tmp_path / "t2"
    assert main(["--simulate", "--trials", "4", "--reporters", "8",
                 "--events", "5", "--profile", str(out2), *CPU]) == 0
    assert list(out2.glob("trace-*.json"))


def test_verbose_flag(capsys):
    assert main(["--example", "--verbose", "--backend", "numpy"]) == 0
    out = capsys.readouterr().out
    assert "pyconsensus_tpu_torch Oracle" in out
    assert "smooth_rep:" in out
    main(["--example", "--backend", "numpy"])
    assert "pyconsensus_tpu_torch Oracle" not in capsys.readouterr().out


def test_scaled_outcomes_unscaled_in_output(capsys):
    main(["--scaled", "--backend", "numpy"])
    assert "16027.59" in capsys.readouterr().out


# -- what the port adds -------------------------------------------------------


def test_no_card_fails_cleanly(capsys, monkeypatch):
    """Without a card, a run that did not ask for the CPU stops with a
    usage error naming ``--device cpu``; the numpy backend needs none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--example"], ["--simulate", "--trials", "2"],
                 ["--example", "--device", "cuda"]):
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert ei.value.code == 2
        assert "--device cpu" in capsys.readouterr().err
    assert main(["--example", "--backend", "numpy"]) == 0


def test_backend_jax_reads_as_torch(capsys):
    assert main(["--example", "--backend", "jax", "--verbose", *CPU]) == 0
    assert "backend=torch device=cpu" in capsys.readouterr().out


def test_observability_outputs(capsys, tmp_path):
    prom, spans = tmp_path / "m.prom", tmp_path / "s.jsonl"
    path = save(tmp_path, "r.npy", R=10, E=8, liars=3, na_frac=0.0)
    assert main(["--file", path, "--stream", "--panel-events", "4",
                 "--metrics-out", str(prom), "--trace-out", str(spans),
                 "--obs-report", *CPU]) == 0
    out = capsys.readouterr().out
    assert "Span tree" in out
    assert "pyconsensus_streaming_panels_total" in prom.read_text()
    assert "streaming.consensus" in spans.read_text()


def test_fault_plan_logs_activations(capsys, tmp_path):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"seed": 0, "rules": [
        {"site": "streaming.panel", "kind": "nan_storm",
         "occurrences": [0], "args": {"fraction": 0.1}}]}))
    path = save(tmp_path, "r.npy", R=10, E=8, liars=3, na_frac=0.0)
    assert main(["--file", path, "--stream", "--panel-events", "4",
                 "--fault-plan", str(plan), *CPU]) == 0
    assert "streaming.panel #0: nan_storm" in capsys.readouterr().out


# -- against the reference CLI ---------------------------------------------


def test_demos_match_reference(capsys):
    argv = ["--example", "--missing", "--scaled", "--iterations", "3"]
    assert ref_main(argv) == 0
    ref = capsys.readouterr().out
    assert main([*argv, *CPU]) == 0
    assert_tables_match(capsys.readouterr().out, ref)


@pytest.mark.parametrize("algorithm", ["sztorc", "k-means"])
def test_file_matches_reference(capsys, tmp_path, algorithm):
    path = save(tmp_path, "r.npy", seed=3)
    argv = ["--file", path, "--algorithm", algorithm]
    assert ref_main(argv) == 0
    ref = capsys.readouterr().out
    assert main([*argv, *CPU]) == 0
    assert_tables_match(capsys.readouterr().out, ref)


@pytest.mark.parametrize("name", ["r.npy", "r.csv"])
def test_stream_matches_reference(capsys, tmp_path, name):
    path = save(tmp_path, name, seed=4, R=20, E=30, liars=5)
    argv = ["--file", path, "--stream", "--panel-events", "7",
            "--iterations", "2"]
    assert ref_main(argv) == 0
    ref = capsys.readouterr().out
    assert main([*argv, *CPU]) == 0
    assert_stream_match(capsys.readouterr().out, ref)


# -- processes ----------------------------------------------------------------


def _port_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def test_module_entry_point():
    run = subprocess.run([sys.executable, "-m", "pyconsensus_tpu_torch",
                          "--example", *CPU], capture_output=True,
                         text=True, env=_port_env(), cwd=REPO, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "Example (dense binary)" in run.stdout


def test_stream_two_processes_equal_one(tmp_path):
    """The same command on two processes (``--host-id`` 0 and 1) joins one
    gloo process group through ``--coordinator``, splits the panels, and
    both print the resolution of a single-host ``--stream`` run: the
    outcome counts exactly, the printed reputations within 1e-5 (the
    processes sum their panels in another order)."""
    path = save(tmp_path, "r.npy", seed=5, R=14, E=21, liars=4)
    cmd = [sys.executable, "-m", "pyconsensus_tpu_torch", "--file", path,
           "--stream", "--panel-events", "6", "--iterations", "2", *CPU]
    port = free_port()
    env = _port_env()
    procs = [subprocess.Popen(
        cmd + ["--coordinator", f"localhost:{port}", "--hosts", "2",
               "--host-id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for i in range(2)]
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=120)
            outs.append(out)
    finally:
        for proc in procs:          # never leave a peer blocked in a
            if proc.poll() is None:  # collective
                proc.kill()
                proc.communicate()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, f"host failed:\n{out}"
    assert "host 0/2" in outs[0] and "host 1/2" in outs[1]
    single = subprocess.run(cmd, capture_output=True, text=True, env=env,
                            cwd=REPO, timeout=120)
    assert single.returncode == 0, single.stdout + single.stderr
    for out in outs:
        assert_stream_match(out, single.stdout, atol=1e-5)
