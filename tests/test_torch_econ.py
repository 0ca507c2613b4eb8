"""The port's adversarial economy (``pyconsensus_tpu_torch.econ``)
against the JAX package's, on the CPU.

- host numpy, bit for bit: ``strategy_rng``, every strategy's plans over
  rounds and observed reputations, ``round_panel`` (binary, scaled
  tails, abstentions), ``split_blocks``, ``build_scenario`` and the
  scenario's JSON round trip equal the reference's;
- one scenario (3 strategies x 4 markets x 3 rounds, mirrors and scaled
  tails included) through the port's ``ConsensusService(device="cpu")``
  and the reference's service, in float64: the same plans every round,
  equal snapped outcomes, reputation trajectories within ``REP_ATOL``
  (the session band of ``tests/test_torch_session.py``) and equal
  integer scoreboard fields. The mechanism digest is NOT compared
  across the packages: it hashes the reputations' float64 bits, which
  come from two different eigensolvers;
- the port's digest is equal across a replay, concurrency 1 against 8,
  a tight queue that sheds, a fleet resumed from its log in process,
  and the command line SIGKILLed mid-economy and run again over its log
  directory;
- the fault sites ``econ.round``, ``econ.panel`` and ``econ.submit``
  fire as the reference's, and the command line's usage errors exit 2.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pyconsensus_tpu.econ import MarketEconomy as RefEconomy
from pyconsensus_tpu.econ import STRATEGIES as REF_STRATEGIES
from pyconsensus_tpu.econ import StrategyContext as RefContext
from pyconsensus_tpu.econ import build_scenario as ref_build_scenario
from pyconsensus_tpu.econ import make_strategy as ref_make_strategy
from pyconsensus_tpu.econ import round_panel as ref_round_panel
from pyconsensus_tpu.econ import split_blocks as ref_split_blocks
from pyconsensus_tpu.econ import strategy_rng as ref_strategy_rng
from pyconsensus_tpu.serve import ConsensusService as RefService
from pyconsensus_tpu.serve import ServeConfig as RefServeConfig
from pyconsensus_tpu_torch import faults, obs
from pyconsensus_tpu_torch.econ import (STRATEGIES, MarketEconomy,
                                        MarketSpec, RoundPlan, Scenario,
                                        StrategyContext, build_scenario,
                                        make_strategy, mechanism_digest,
                                        round_panel, split_blocks,
                                        strategy_rng)
from pyconsensus_tpu_torch.serve import (ConsensusFleet, ConsensusService,
                                         FleetConfig, ServeConfig)
from torch_witness import (  # noqa: F401
    torch_lock_witness, torch_digest_witness)


@pytest.fixture(autouse=True)
def _witnessed(torch_lock_witness, torch_digest_witness):
    """Every test here runs under the port's lock and digest witnesses
    (the counterpart of the reference's test_econ opt-in)."""
    yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: reputations against the reference (float64; the session band)
REP_ATOL = 1e-9


@pytest.fixture(autouse=True)
def _clean_registry():
    """Leave the process registry as found: a fleet's heartbeats add
    worker-labelled series that later tests of the same process do not
    expect."""
    yield
    obs.reset()


@pytest.fixture(autouse=True)
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _rep(R, n_cartel, erosion):
    """A reputation whose cartel share sits at ``stake (1 - erosion)``."""
    stake = n_cartel / R
    share = stake * (1.0 - erosion)
    rep = np.full(R, (1.0 - share) / (R - n_cartel))
    rep[R - n_cartel:] = share / n_cartel
    return rep


def _ctx(cls, strategy, round_idx, R=12, n_cartel=4, erosion=0.0, seed=3):
    return cls(seed=seed, market=f"{strategy}-0001", round_idx=round_idx,
               n_reporters=R, cartel=tuple(range(R - n_cartel, R)),
               reputation=_rep(R, n_cartel, erosion),
               stake=n_cartel / R)


def _plan_dict(plan):
    return dataclasses.asdict(plan)


# -- host numpy, bit for bit -----------------------------------------------


def test_strategy_catalog_and_rng_are_the_references():
    assert sorted(STRATEGIES) == sorted(REF_STRATEGIES)
    for key in [(0, "camouflage", "m", 0, "t"), (7, "econ.panel", "x-1",
                                                  4, "noise")]:
        a = strategy_rng(*key).random(16)
        b = ref_strategy_rng(*key).random(16)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("erosion", [-0.2, 0.0, 0.1, 0.3, 0.6, 0.95])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_plans_equal_the_references(strategy, erosion):
    ours, ref = make_strategy(strategy), ref_make_strategy(strategy)
    for k in range(6):
        for R, c in ((12, 4), (24, 8), (9, 1)):
            got = ours.plan_round(_ctx(StrategyContext, strategy, k, R, c,
                                       erosion))
            want = ref.plan_round(_ctx(RefContext, strategy, k, R, c,
                                       erosion))
            assert _plan_dict(got) == _plan_dict(want)
    custom = {"camouflage": {"base_fraction": 0.4, "backoff": 0.3},
              "sybil_split": {"waves": 2},
              "reporter_churn": {"catch_ratio": 0.9},
              "flash_crowd": {"cooldown": 0.3, "deadline_ms": 500.0},
              "slow_drip": {"blocks": 5, "floor": 0.2}}[strategy]
    assert set(custom) <= set(type(ours).defaults())
    for k in range(4):
        got = make_strategy(strategy, **custom).plan_round(
            _ctx(StrategyContext, strategy, k, erosion=erosion))
        want = ref_make_strategy(strategy, **custom).plan_round(
            _ctx(RefContext, strategy, k, erosion=erosion))
        assert _plan_dict(got) == _plan_dict(want)


def _spec(**kw):
    base = dict(name="mk-0003", strategy="camouflage", n_reporters=12,
                n_cartel=4, n_events=24)
    base.update(kw)
    return base


@pytest.mark.parametrize("spec_kw", [
    {}, {"n_scaled": 6}, {"na_frac": 0.3, "variance": 0.2},
    {"n_reporters": 24, "n_cartel": 8, "n_events": 48, "n_scaled": 12},
    {"n_scaled": 24, "scaled_min": 2.0, "scaled_max": 4.0}])
@pytest.mark.parametrize("plan_kw", [
    {"liars": (), "lie_fraction": 0.0},
    {"liars": (8, 9, 10, 11), "lie_fraction": 0.5},
    {"liars": (9,), "lie_fraction": 1.0, "abstain": (10, 11)},
    {"liars": (8, 11), "lie_fraction": 0.3, "n_blocks": 5}])
def test_round_panels_and_blocks_equal_the_references(spec_kw, plan_kw):
    from pyconsensus_tpu.econ import MarketSpec as RefSpec
    from pyconsensus_tpu.econ import RoundPlan as RefPlan

    for k in (0, 1, 4):
        got = round_panel(9, MarketSpec(**_spec(**spec_kw)), k,
                          RoundPlan(**plan_kw))
        want = ref_round_panel(9, RefSpec(**_spec(**spec_kw)), k,
                               RefPlan(**plan_kw))
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]
        n = plan_kw.get("n_blocks", 1)
        for (gb, gbd), (wb, wbd) in zip(
                split_blocks(got[0], got[3], n),
                ref_split_blocks(want[0], want[3], n)):
            np.testing.assert_array_equal(gb, wb)
            assert gbd == wbd


def test_scenarios_equal_the_references():
    for kw in ({}, {"seed": 5, "rounds": 4, "markets_per_strategy": 6,
                    "strategies": ("slow_drip", "reporter_churn"),
                    "scaled_every": 3, "mirror_every": 2}):
        ours, ref = build_scenario(**kw), ref_build_scenario(**kw)
        assert ours.to_dict() == ref.to_dict()
        assert Scenario.from_dict(ours.to_dict()) == ours
    for bad in ({"strategy": "nope"}, {"n_cartel": 0},
                {"n_scaled": 99}):
        with pytest.raises(Exception, match="strategy|n_cartel|n_scaled"):
            MarketSpec(**_spec(**bad))


# -- one scenario through both services --------------------------------------


def _recorded(cls, service, scenario):
    """Run ``scenario`` and record each market round's plan and result."""
    econ = cls(service, scenario)
    seen = {}
    finish = econ._finish_market

    def record(spec, plan, round_idx, result, lies):
        seen[spec.name, round_idx] = (_plan_dict(plan), result)
        return finish(spec, plan, round_idx, result, lies)

    econ._finish_market = record
    return econ.run(), seen


PARITY = dict(seed=5, rounds=3, markets_per_strategy=4, concurrency=4,
              strategies=("camouflage", "sybil_split", "flash_crowd"))


def test_economy_matches_the_reference_service():
    svc = ConsensusService(ServeConfig(batch_window_ms=1.0, warmup=()),
                           device="cpu").start(warmup=False)
    try:
        got, got_rounds = _recorded(MarketEconomy, svc,
                                    build_scenario(**PARITY))
    finally:
        svc.close(drain=True)
    ref_svc = RefService(RefServeConfig(batch_window_ms=1.0,
                                        warmup=())).start(warmup=False)
    try:
        want, want_rounds = _recorded(RefEconomy, ref_svc,
                                      ref_build_scenario(**PARITY))
    finally:
        ref_svc.close(drain=True)
    assert sorted(got_rounds) == sorted(want_rounds)
    assert len(got_rounds) == 12 * 3
    for key in sorted(got_rounds):
        (gp, g), (wp, w) = got_rounds[key], want_rounds[key]
        assert gp == wp, key                       # the same plan
        for name in ("outcomes_final", "outcomes_adjusted"):
            np.testing.assert_array_equal(np.asarray(g["events"][name]),
                                          np.asarray(w["events"][name]),
                                          err_msg=f"{key} {name}")
        np.testing.assert_allclose(np.asarray(g["agents"]["smooth_rep"]),
                                   np.asarray(w["agents"]["smooth_rep"]),
                                   rtol=0, atol=REP_ATOL, err_msg=str(key))
    for k in ("seed", "rounds", "n_markets", "n_sessions",
              "resumed_markets", "strategies"):
        assert got[k] == want[k], k
    for s in got["strategies"]:
        a, b = got["per_strategy"][s], want["per_strategy"][s]
        for k in ("markets", "caught_fraction", "time_to_catch_rounds"):
            assert a[k] == b[k], (s, k)
        for k in ("cartel_roi", "honest_yield", "final_cartel_share",
                  "stake"):
            assert abs(a[k] - b[k]) <= 1e-6, (s, k)
    for k in ("cartel_share", "cartel_roi", "honest_yield"):
        np.testing.assert_allclose(got["trajectories"][k],
                                   want["trajectories"][k], rtol=0,
                                   atol=REP_ATOL * 10)
    assert got["service"]["mirrors_abandoned"] == 0
    assert len(got["mechanism_digest"]) == 64


# -- the port's digest ----------------------------------------------------


SMALL = dict(strategies=("camouflage", "flash_crowd", "slow_drip"),
             markets_per_strategy=2, rounds=2, concurrency=4)


def _run(scenario, **cfg):
    cfg.setdefault("batch_window_ms", 1.0)
    svc = ConsensusService(ServeConfig(warmup=(), **cfg),
                           device="cpu").start(warmup=False)
    try:
        return MarketEconomy(svc, scenario).run()
    finally:
        svc.close(drain=True)


def _fleet(log_dir, n=2):
    return ConsensusFleet(FleetConfig(
        n_workers=n, log_dir=str(log_dir),
        worker=ServeConfig(batch_window_ms=1.0, warmup=())),
        device="cpu").start(warmup=False)


def test_digest_under_replay_concurrency_and_sheds():
    scenario = build_scenario(seed=13, **SMALL)
    one = _run(scenario)
    assert _run(scenario)["mechanism_digest"] == one["mechanism_digest"]
    for width in (1, 8):
        narrow = Scenario.from_dict({**scenario.to_dict(),
                                     "concurrency": width})
        r = _run(narrow)
        assert r["mechanism_digest"] == one["mechanism_digest"]
        assert r["trajectories"] == one["trajectories"]
    storm = build_scenario(seed=17, rounds=2, strategies=("flash_crowd",),
                           markets_per_strategy=6, concurrency=8)
    tight = _run(storm, max_queue=1, max_batch=1, batch_window_ms=5.0)
    roomy = _run(storm, max_queue=256)
    assert tight["mechanism_digest"] == roomy["mechanism_digest"]
    assert tight["service"]["sheds_observed"] > 0
    assert all(code.startswith("PYC") for code in tight["service"]["errors"])
    assert mechanism_digest({"a": np.ones(3)}) != mechanism_digest(
        {"a": np.ones(3) * (1 + 1e-16 * 4)})


def test_a_column_slice_folds_as_its_replay(tmp_path):
    """``split_blocks`` hands the session column slices, which numpy lays
    out in Fortran order; the replay reads each journaled block back in C
    order. Both must fold to the same bits, or a resumed economy leaves
    the uninterrupted one's digest."""
    from pyconsensus_tpu_torch.serve.failover import (DurableSession,
                                                      replay_session)

    rng = np.random.default_rng(4)
    panel = rng.choice([0.0, 1.0], size=(12, 40))
    panel[rng.random(panel.shape) < 0.05] = np.nan
    first, second = (b for b, _ in split_blocks(panel, None, 2))
    assert first.flags["F_CONTIGUOUS"] and not first.flags["C_CONTIGUOUS"]
    live = DurableSession.create(tmp_path, "m", 12, device="cpu")
    live.append(first)
    live.resolve()
    live.append(second)
    replayed = replay_session(tmp_path, "m", device="cpu")
    a, b = live.resolve(), replayed.resolve()
    for key in ("smooth_rep", "this_rep", "outcomes_final", "certainty"):
        assert np.asarray(a[key]).tobytes() == np.asarray(b[key]).tobytes()


def test_fleet_resumed_from_its_log(tmp_path):
    scenario = build_scenario(seed=23, **SMALL)
    ref = _run(scenario)
    f1 = _fleet(tmp_path / "log")
    try:
        e1 = MarketEconomy(f1, scenario)
        e1.start()
        e1.run_round(0)
    finally:
        f1.close(drain=True)
    f2 = _fleet(tmp_path / "log")
    try:
        resumed = MarketEconomy(f2, scenario).run()
    finally:
        f2.close(drain=True)
    assert resumed["resumed_markets"] == len(scenario.markets)
    assert resumed["mechanism_digest"] == ref["mechanism_digest"]


def test_a_state_read_during_a_migration_is_retried(tmp_path):
    """Over an autoscaled fleet a rebalance may be moving a market while
    the economy reads its state (PYC502): the read is retried as a
    resolution is, and the digest is the uninterrupted one's."""
    from pyconsensus_tpu_torch.faults import FailoverInProgressError

    scenario = build_scenario(seed=23, **SMALL)
    ref = _run(scenario)
    fleet = _fleet(tmp_path / "log")
    real, calls = fleet.session_state, {}

    def moving_now_and_then(name):
        calls[name] = calls.get(name, 0) + 1
        if calls[name] % 3 == 2:
            raise FailoverInProgressError(
                f"session {name!r} is rebalancing", session=name,
                retry_after_s=0.01)
        return real(name)

    fleet.session_state = moving_now_and_then
    try:
        res = MarketEconomy(fleet, scenario).run()
    finally:
        fleet.close(drain=True)
    assert res["mechanism_digest"] == ref["mechanism_digest"]
    assert res["service"]["errors"].get("PYC502", 0) > 0


def _econ_cli(log_dir, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return [sys.executable, "-m", "pyconsensus_tpu_torch.econ", "--device",
            "cpu", "--dtype", "float64", "--seed", "47", "--strategies",
            "camouflage,slow_drip", "--markets-per-strategy", "3",
            "--rounds", "3", "--concurrency", "4", "--fleet-workers", "2",
            "--log-dir", str(log_dir), *extra], env


def _digest(stdout):
    return json.loads(stdout.strip().splitlines()[-1])["mechanism_digest"]


def test_cli_sigkilled_mid_economy_resumes_to_the_same_digest(tmp_path):
    cmd, env = _econ_cli(tmp_path / "whole")
    whole = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=300)
    assert whole.returncode == 0, whole.stderr[-3000:]
    log = tmp_path / "killed"
    cmd, env = _econ_cli(log)
    proc = subprocess.Popen(cmd, env=env, cwd=REPO,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        # round 1's first journaled block: the economy is past round 0
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and proc.poll() is None:
            if any(p.name.startswith("round_000001")
                   for p in log.glob("*/staged/*.npz")):
                break
            time.sleep(0.005)
        assert proc.poll() is None, "the economy ended before the kill"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    resumed = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                             text=True, timeout=300)
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    out = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert out["resumed_markets"] > 0
    assert _digest(resumed.stdout) == _digest(whole.stdout)


# -- fault sites and the command line ---------------------------------------


def _one_market():
    return build_scenario(seed=31, rounds=1, strategies=("camouflage",),
                          markets_per_strategy=1, concurrency=2)


@pytest.mark.parametrize("site", ["econ.round", "econ.submit"])
def test_round_and_submit_sites_raise(site):
    plan = faults.FaultPlan.from_dict({"seed": 0, "rules": [
        {"site": site, "kind": "raise", "occurrences": [0]}]})
    svc = ConsensusService(ServeConfig(warmup=()),
                           device="cpu").start(warmup=False)
    try:
        with faults.armed(plan):
            with pytest.raises(OSError, match="injected fault"):
                MarketEconomy(svc, _one_market()).run()
    finally:
        svc.close(drain=True)
    assert plan.fired == [(site, 0, "raise")]


def test_panel_storm_is_replayable():
    plan = {"seed": 5, "rules": [{"site": "econ.panel",
                                  "kind": "nan_storm", "occurrences": [0],
                                  "args": {"fraction": 0.2}}]}

    def storm():
        with faults.armed(faults.FaultPlan.from_dict(plan)):
            return _run(_one_market())

    a, b = storm(), storm()
    assert a["mechanism_digest"] == b["mechanism_digest"]
    assert a["mechanism_digest"] != _run(_one_market())["mechanism_digest"]


def test_cli_runs_and_refuses(tmp_path, capsys):
    from pyconsensus_tpu_torch.econ.cli import main

    obs.reset()
    out, prom = tmp_path / "econ.json", tmp_path / "econ.prom"
    assert main(["--device", "cpu", "--strategies", "camouflage",
                 "--markets-per-strategy", "1", "--rounds", "1",
                 "--json-out", str(out), "--metrics-out", str(prom)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["mechanism_digest"] == json.loads(
        out.read_text())["mechanism_digest"]
    assert "pyconsensus_econ_rounds_total" in prom.read_text()
    for argv, msg in ((["--fleet-workers", "2"], "log-dir"),
                      (["--autoscale"], "fleet-workers"),
                      (["--refresh-every", "2"], "incremental")):
        assert main(["--device", "cpu", "--rounds", "1", *argv]) == 2
        assert msg in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as ei:
            main(["--rounds", "1"])             # the card by default
        assert ei.value.code == 2


def test_cli_autoscale_over_a_fleet(tmp_path, capsys):
    from pyconsensus_tpu_torch.econ.cli import main

    obs.reset()
    assert main(["--device", "cpu", "--strategies", "flash_crowd",
                 "--markets-per-strategy", "4", "--rounds", "2",
                 "--fleet-workers", "1", "--log-dir", str(tmp_path / "l"),
                 "--autoscale", "--autoscale-max", "2",
                 "--max-queue", "2"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    block = printed["autoscale"]
    assert block["workers_start"] == 1
    assert 1 <= block["workers_end"] <= 2
    assert set(block["decisions"]) == {"scale_up", "scale_down",
                                       "replace", "error"}


def test_console_script_is_declared():
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    assert ('pyconsensus-econ-torch = "pyconsensus_tpu_torch.econ.cli:main"'
            in text)
