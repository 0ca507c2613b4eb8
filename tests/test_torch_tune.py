"""pyconsensus_tpu_torch.tune — the launch-shape autotuner on the CPU,
mirroring ``tests/test_tune.py`` test for test: legal candidates that
hold the built-in choice, deterministic CPU sweeps, atomic persistence
and cache-hit reload, the provider wired into ``ops/cuda_kernels.py``
with garbage values degrading to the built-in, corrupt and foreign cache
files read as empty, the ``tune.cache_write`` fault and the module's
command line. Against the reference: ``shape_class``,
``depth_candidates``, the fallback depth and the roofline arithmetic are
the same, and a file the reference's sweeps wrote gives the port no hit.
On a two-rank gloo mesh the provider is inert.

The card's side (the Python split model against the library's, every
legal shape against the built-in, k-independence under a provider, timed
sweeps) is in ``tests/test_torch_cuda.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import free_port
from pyconsensus_tpu.tune import autotune as ref_autotune
from pyconsensus_tpu.tune import roofline as ref_roofline
from pyconsensus_tpu_torch import obs
from pyconsensus_tpu_torch.faults import plan as fplan
from pyconsensus_tpu_torch.ops import cuda_kernels as ck
from pyconsensus_tpu_torch.tune import (FALLBACK_TABLE, TuneCache,
                                        autotune_cov, autotune_pipeline_depth,
                                        autotune_resolve, cache_path,
                                        default_provider, depth_candidates,
                                        roofline, shape_class, split_class,
                                        tuned_pipeline_depth)
from pyconsensus_tpu_torch.tune import autotune
from pyconsensus_tpu_torch.tune.autotune import _entry_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("row_tile_splits", "col_tile_splits")
#: (R, E) of the candidate grids: ragged and round, the main path's
SHAPES = [(1, 1), (24, 96), (517, 2048), (1000, 4099), (10_000, 100_000)]


@pytest.fixture(autouse=True)
def _restore_provider():
    """Every test leaves the kernel module's provider state as it found
    it (other suites must keep seeing the built-in shapes)."""
    prev = (ck._TUNE_PROVIDER, ck._TUNE_AUTOLOAD)
    yield
    ck._TUNE_PROVIDER, ck._TUNE_AUTOLOAD = prev


def _builtin(kind, R, E, itemsize, n_sm=ck.NOMINAL_SMS):
    model = ck.row_tile_splits if kind == "row_tile_splits" \
        else ck.col_tile_splits
    return model(R, E, itemsize, n_sm)


class TestCandidates:
    def test_resolve_candidates_legal(self):
        for R in (64, 1000, 10_000, 114_048):
            for itemsize in (1, 2, 4):
                for c in ck.resolve_block_candidates(R, itemsize):
                    assert c in ck._RES_COLS
                    assert ck.resolve_block_fits(R, c, itemsize)
                    assert ck.resolve_smem_bytes(R, c, itemsize) <= \
                        ck.SMEM_PER_BLOCK

    def test_resolve_candidates_cover_builtin(self):
        assert ck.resolve_block_candidates(10_000, 1) == [1, 2, 4, 8, 16]
        for R in (24, 1000, 10_000, 57_024):
            for itemsize in (1, 2, 4):
                cands = ck.resolve_block_candidates(R, itemsize)
                if not ck.resolve_kernel_fits(R, itemsize):
                    assert cands == []
                    continue
                assert ck.resolve_block_cols(R, itemsize) == max(cands)

    def test_split_candidates_legal_and_cover_builtin(self):
        for R, E in SHAPES:
            for itemsize in (1, 2, 4):
                for kind in KINDS:
                    cands = ck.split_candidates(kind, R, E, itemsize)
                    chunks = (-(-E // (512 // itemsize))
                              if kind == "row_tile_splits" else -(-R // 64))
                    assert cands == list(range(1, min(16, chunks) + 1))
                    for n_sm in (1, 7, 114, 132):
                        assert _builtin(kind, R, E, itemsize, n_sm) in cands

    @pytest.mark.parametrize("kind", KINDS)
    def test_split_candidates_all_pass_fit_model(self, kind):
        """Every candidate satisfies the launch's own legality check, and
        nothing outside the set does."""
        for R, E in SHAPES:
            for itemsize in (1, 2, 4):
                cands = ck.split_candidates(kind, R, E, itemsize)
                for s in cands:
                    assert ck.split_fits(kind, s, R, E, itemsize)
                for s in (0, -1, cands[-1] + 1):
                    assert not ck.split_fits(kind, s, R, E, itemsize)

    def test_no_fit_no_candidates(self):
        # past the resolve gate: no panel width at all
        assert ck.resolve_block_candidates(60_000, 4) == []
        assert ck.resolve_block_candidates(228_097, 1) == []
        assert ck.resolve_block_cols(60_000, 4) is None

    def test_builtin_shapes_of_the_main_path(self):
        """The library's comments: 10,000 x 100,000 int8 on 132 SMs takes
        157 row tiles x 5 E ranges and 196 column tiles x 4 row ranges;
        resolve 16 columns; the fill statistics 64 chunks of 157 rows."""
        assert ck.row_tile_splits(10_000, 100_000, 1, 132) == 5
        assert ck.col_tile_splits(10_000, 100_000, 1, 132) == 4
        assert ck.resolve_block_cols(10_000, 1) == 16
        assert ck.fill_stats_chunk_rows(10_000) == 157
        assert ck.fill_stats_kernel_fits(100_000, 1)
        assert ck.fill_stats_kernel_fits(100_000, 4)
        assert not ck.fill_stats_kernel_fits(100_000, 2)

    def test_wave_splits_fills_the_last_wave(self):
        # one tile on one slot: every split count fills it; the fewest win
        assert ck.wave_splits(1, 16, 1) == 1
        # 66 tiles on 132 slots: two ranges fill the wave exactly
        assert ck.wave_splits(66, 16, 132) == 2
        # never more ranges than chunks
        assert ck.wave_splits(10, 2, 1000) == 2
        # one tile on two slots: two ranges fill them, three leave a gap
        assert ck.wave_splits(1, 3, 2) == 2


class TestProviderWiring:
    def test_split_override_and_validation(self):
        R, E = 1000, 4099
        for kind, fn in (("row_tile_splits", ck.row_splits),
                         ("col_tile_splits", ck.col_splits)):
            default = fn(R, E, 1, 132)
            assert default == _builtin(kind, R, E, 1, 132)
            ck.set_tune_provider(
                lambda k, _kind=kind, **ctx: 3 if k == _kind else None)
            assert fn(R, E, 1, 132) == 3
            # an ILLEGAL provider value is ignored, never trusted
            ck.set_tune_provider(lambda k, **ctx: 17)
            assert fn(R, E, 1, 132) == default
            ck.set_tune_provider(lambda k, **ctx: 1 << 20)
            assert fn(R, E, 1, 132) == default
            ck.set_tune_provider(None)
            assert fn(R, E, 1, 132) == default
        ck.set_tune_provider(lambda k, **ctx: 4)
        assert ck.resolve_cols(10_000, 1) == 4
        ck.set_tune_provider(lambda k, **ctx: 32)     # does not fit R
        assert ck.resolve_cols(10_000, 1) == 16
        ck.set_tune_provider(lambda k, **ctx: 3)      # not instantiated
        assert ck.resolve_cols(10_000, 1) == 16

    def test_garbage_provider_values_degrade_to_builtin(self):
        """A hand-edited cache can put ANY JSON behind "value": a provider
        returning a string, float, bool, a negative, or raising yields the
        built-in, never a failed launch."""
        default = ck.row_splits(1000, 4099, 1, 132)
        for bad in ("fast", 2.5, True, -2, 0, None, [3], {"v": 3}):
            ck.set_tune_provider(lambda kind, _b=bad, **ctx: _b)
            assert ck.row_splits(1000, 4099, 1, 132) == default, bad
            assert ck.resolve_cols(10_000, 1) == 16, bad

        def boom(kind, **ctx):
            raise RuntimeError("corrupt provider")

        ck.set_tune_provider(boom)
        assert ck.row_splits(1000, 4099, 1, 132) == default
        # end to end: a resolve under the garbage provider
        ck.set_tune_provider(lambda kind, **ctx: "fast")
        x = torch.tensor(np.random.default_rng(0).choice(
            [0.0, 1.0], size=(16, 64)), dtype=torch.float32)
        rep = torch.full((16,), 1 / 16)
        out = ck.resolve_certainty_fused(x, rep, torch.full((64,), 0.5),
                                         rep.sum(), 0.1)
        assert torch.isfinite(out[0]).all()
        # an integral float IS accepted (JSON can round-trip 3 as 3.0)
        ck.set_tune_provider(lambda kind, **ctx: 3.0)
        assert ck.row_splits(1000, 4099, 1, 132) == 3

    def test_resolve_width_override_changes_nothing_numeric(self, rng):
        """An explicit panel width or split count changes the launch, not
        the results; an illegal one is refused on every device."""
        x = torch.tensor(rng.choice([0.0, 0.5, 1.0, np.nan],
                                    size=(16, 300)), dtype=torch.float32)
        rep = torch.full((16,), 1 / 16)
        fill = torch.full((300,), 0.5)
        outs = {C: ck.resolve_certainty_fused(x, rep, fill, rep.sum(), 0.1,
                                              block_cols=C)
                for C in ck.resolve_block_candidates(16, 4)}
        base = outs[ck.resolve_block_cols(16, 4)]
        for got in outs.values():
            for a, b in zip(base, got):
                assert torch.equal(a, b)
        with pytest.raises(ValueError, match="resolve_block_cols=3"):
            ck.resolve_certainty_fused(x, rep, fill, rep.sum(), 0.1,
                                       block_cols=3)
        # 300 float32 columns are 3 chunks of 128, 16 rows one of 64
        with pytest.raises(ValueError, match="row_tile_splits=4"):
            ck.resolve_certainty_fused(x, rep, fill, rep.sum(), 0.1,
                                       row_splits=4)
        with pytest.raises(ValueError, match="col_tile_splits=2"):
            ck.apply_weighted_cov(x, torch.zeros(300), rep, torch.ones(300),
                                  fill, col_splits=2)

    def test_default_provider_serves_persisted_winner(self, tmp_path):
        """An entry persisted under this device's generation is served by
        the default provider; absent entries fall through to the fallback
        chain (None = the built-in)."""
        path = tmp_path / "cache.json"
        cache = TuneCache(path)
        cache.put(_entry_key("row_tile_splits", "cpu", 1,
                             split_class(1000, 4099)), {"value": 3})
        cache.put(_entry_key("resolve_block_cols", "cpu", 1,
                             shape_class(10_000)), {"value": 8})
        provider = default_provider(path, device="cpu")
        assert provider("row_tile_splits", n_reporters=1000, n_events=4099,
                        itemsize=1) == 3
        # another class, kind or storage: the fallback
        assert provider("row_tile_splits", n_reporters=1000,
                        n_events=65_536, itemsize=1) is None
        assert provider("col_tile_splits", n_reporters=1000, n_events=4099,
                        itemsize=1) is None
        assert provider("row_tile_splits", n_reporters=1000, n_events=4099,
                        itemsize=2) is None
        assert provider("pipeline_depth", n_events=4099) is None
        # end to end: the launch-shape lookups pick the persisted winners
        ck.set_tune_provider(provider)
        assert ck.row_splits(1000, 4099, 1, 132) == 3
        assert ck.resolve_cols(10_000, 1) == 8

    def test_the_lookup_follows_the_installed_provider(self):
        """The launch remembers a provider's answer per shape, never
        across providers: a newly installed (or directly assigned)
        provider is asked again."""
        calls = []

        def make(v):
            def provider(kind, **ctx):
                calls.append(v)
                return v
            return provider

        with ck.tuned_shapes(make(3)):
            assert ck.row_splits(1000, 4099, 1, 132) == 3
            assert ck.row_splits(1000, 4099, 1, 132) == 3
        assert calls == [3]
        with ck.tuned_shapes(make(2)):
            assert ck.row_splits(1000, 4099, 1, 132) == 2
        ck._TUNE_PROVIDER = make(4)
        assert ck.row_splits(1000, 4099, 1, 132) == 4
        assert calls == [3, 2, 4]

    def test_no_autoload_off_the_card(self):
        """Only a launch on a card loads the default provider; the shape
        lookups of the CPU leave the autoload armed."""
        ck._TUNE_PROVIDER, ck._TUNE_AUTOLOAD = None, True
        ck.row_splits(1000, 4099, 1, 132)
        ck.storage_matvec(torch.zeros((4, 8)), torch.ones(8))
        assert ck._TUNE_PROVIDER is None and ck._TUNE_AUTOLOAD


class TestSweeps:
    def test_deterministic_sweep_persisted(self, tmp_path):
        path = tmp_path / "cache.json"
        obs.reset()
        e1 = autotune_resolve(64, n_events=96, device="cpu", path=path)
        assert e1["mode"] == "deterministic"
        assert e1["value"] == ck.resolve_block_cols(64, 4) == e1["builtin"]
        assert e1["value"] in e1["candidates"]
        assert "timings_ms" not in e1
        assert obs.value("pyconsensus_autotune_sweeps_total",
                         kind="resolve_block_cols") == 1
        assert obs.value("pyconsensus_autotune_configs_total",
                         kind="resolve_block_cols") == len(e1["candidates"])
        raw = json.loads(path.read_text())
        assert raw["version"] == 1
        assert any(v["value"] == e1["value"]
                   for v in raw["entries"].values())
        # second call: served from the cache, no sweep, same winner
        e2 = autotune_resolve(64, n_events=96, device="cpu", path=path)
        assert e2 == e1
        assert obs.value("pyconsensus_autotune_sweeps_total",
                         kind="resolve_block_cols") == 1
        assert obs.value("pyconsensus_autotune_cache_hits_total",
                         kind="resolve_block_cols") == 1
        # force re-sweeps and lands the same deterministic winner
        e3 = autotune_resolve(64, n_events=96, device="cpu", path=path,
                              force=True)
        assert e3["value"] == e1["value"]
        assert obs.value("pyconsensus_autotune_sweeps_total",
                         kind="resolve_block_cols") == 2

    def test_cov_sweep_deterministic_and_persisted(self, tmp_path):
        path = tmp_path / "cache.json"
        obs.reset()
        e1 = autotune_cov(256, n_reporters=24, device="cpu", path=path)
        e2 = autotune_cov(256, n_reporters=24, device="cpu", path=path)
        assert e1 == e2
        assert set(e1) == set(KINDS)
        for kind in KINDS:
            assert e1[kind]["value"] == _builtin(kind, 24, 256, 4)
            assert e1[kind]["value"] in e1[kind]["candidates"]
            assert e1[kind]["probe_shape"] == [24, 256]
            assert obs.value("pyconsensus_autotune_sweeps_total",
                             kind=kind) == 1
            assert obs.value("pyconsensus_autotune_cache_hits_total",
                             kind=kind) == 1
        assert len(json.loads(path.read_text())["entries"]) == 2

    def test_cov_sweep_preserves_provider_autoload(self, tmp_path):
        """The sweeps force their candidates through the wrappers'
        explicit overrides and leave the provider state alone: a fresh
        process that tunes and then launches picks its own winner up."""
        ck._TUNE_PROVIDER, ck._TUNE_AUTOLOAD = None, True
        autotune_cov(256, n_reporters=24, device="cpu",
                     path=tmp_path / "cache.json")
        autotune_resolve(24, n_events=256, device="cpu",
                         path=tmp_path / "cache.json")
        assert ck._TUNE_PROVIDER is None
        assert ck._TUNE_AUTOLOAD is True

    def test_storage_dtypes_key_separately(self, tmp_path):
        path = tmp_path / "cache.json"
        autotune_resolve(64, n_events=96, storage_dtype="int8",
                         device="cpu", path=path)
        autotune_resolve(64, n_events=96, storage_dtype="", device="cpu",
                         path=path)
        autotune_cov(96, n_reporters=64, storage_dtype="bfloat16",
                     device="cpu", path=path)
        raw = json.loads(path.read_text())
        assert len(raw["entries"]) == 4
        assert sorted({k.split("/")[2] for k in raw["entries"]}) == \
            ["i1", "i2", "i4"]

    def test_unfittable_shape_raises(self, tmp_path):
        with pytest.raises(ValueError, match="no legal resolve panel"):
            autotune_resolve(60_000, storage_dtype="float32", device="cpu",
                             path=tmp_path / "cache.json")

    def test_a_disagreeing_candidate_is_refused(self, tmp_path, monkeypatch):
        """A candidate whose outputs leave the band fails the sweep and
        persists nothing."""
        real = ck.apply_weighted_cov

        def skewed(*a, row_splits=None, **kw):
            y = real(*a, **kw)
            return y + 1.0 if row_splits == 1 else y

        monkeypatch.setattr(ck, "apply_weighted_cov", skewed)
        path = tmp_path / "cache.json"
        with pytest.raises(AssertionError, match="candidate 1 output 0 "
                           "disagrees with the built-in 2"):
            autotune_cov(256, n_reporters=24, device="cpu", path=path)
        assert not path.exists()

    def test_a_winner_within_the_noise_keeps_the_builtin(self):
        """A candidate replaces the built-in only when its interquartile
        range of the rounds lies wholly below the built-in's; the entry
        records every candidate's median and quartiles and the fastest
        median, persisted or not."""
        noisy = {1: [1.00, 1.10, 0.95, 1.05, 1.02],
                 2: [1.01, 1.08, 0.97, 1.06, 1.03],
                 3: [0.97, 1.04, 0.94, 1.02, 0.99]}
        pick, timings = autotune._decide(noisy, 2)
        assert pick == 2 and min(timings, key=lambda c: timings[c][0]) == 3
        clear = {**noisy, 4: [0.80, 0.82, 0.79, 0.81, 0.80],
                 5: [0.60, 1.10, 0.65, 1.05, 0.70]}
        pick, timings = autotune._decide(clear, 2)
        assert pick == 4                    # 5's third quartile is 1.05
        assert timings[5][0] < timings[4][0]
        entry = autotune._entry("col_tile_splits", pick, [1, 2, 3, 4, 5], 2,
                                torch.device("cuda"), (8, 8), timings)
        assert entry["value"] == 4 and entry["fastest"] == 5
        assert entry["iqr_ms"]["4"] == [round(timings[4][1], 4),
                                        round(timings[4][2], 4)]
        assert autotune._decide({2: [1.0], 3: [0.5]}, 2)[0] == 3

    def test_pipeline_depth_sweep_and_the_batcher(self, tmp_path,
                                                  monkeypatch):
        """The depth sweep serves its requests through a service at every
        depth, all of them on the padded ``bucket`` ring route that the
        depth paces (the same bits at each), and persists the fallback on
        the CPU; a service with
        ``pipeline_depth=0`` takes the persisted depth of its ladder's top
        event class, 2 without one."""
        from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig

        path = tmp_path / "cache.json"
        n0 = obs.value("pyconsensus_serve_requests_total", path="bucket",
                       outcome="ok") or 0
        e = autotune_pipeline_depth(8, 16, device="cpu", path=path,
                                    dispatches=3)
        assert e["value"] == 2 and e["candidates"] == [1, 2, 3, 4]
        assert e["route"] == "bucket" and e["requests"] == 24
        assert obs.value("pyconsensus_serve_requests_total", path="bucket",
                         outcome="ok") - n0 == 4 * 24
        assert tuned_pipeline_depth(16, path=path, device="cpu") == 2
        cfg = ServeConfig(pipeline_depth=0)
        monkeypatch.setattr(autotune, "_CACHE_PATH_ENV", str(path))
        with ConsensusService(cfg, device="cpu") as svc:
            assert svc.pipeline_depth == 2
        TuneCache(path).put(
            _entry_key("pipeline_depth", "cpu", autotune._default_itemsize(),
                       shape_class(cfg.event_buckets[-1])), {"value": 3})
        with ConsensusService(cfg, device="cpu") as svc:
            assert svc.pipeline_depth == 3
        with ConsensusService(ServeConfig(pipeline_depth=1),
                              device="cpu") as svc:
            assert svc.pipeline_depth == 1


class TestCacheDurability:
    def test_corrupt_cache_treated_as_empty(self, tmp_path, capsys):
        path = tmp_path / "cache.json"
        path.write_text("{torn")
        assert TuneCache(path).entries == {}
        assert "unreadable" in capsys.readouterr().err
        # a sweep then rewrites a clean file
        autotune_resolve(64, n_events=96, device="cpu", path=path)
        assert json.loads(path.read_text())["version"] == 1

    def test_foreign_version_ignored(self, tmp_path, capsys):
        path = tmp_path / "cache.json"
        path.write_text(json.dumps({"version": 99, "entries": {"k": 1}}))
        assert TuneCache(path).entries == {}
        assert "version" in capsys.readouterr().err
        path.write_text(json.dumps([1, 2]))
        assert TuneCache(path).entries == {}

    def test_atomic_write_fault_site(self, tmp_path):
        """A seeded raise at ``tune.cache_write`` surfaces, and the file
        keeps its previous content (``atomic_write`` never tears)."""
        path = tmp_path / "cache.json"
        cache = TuneCache(path)
        cache.put("a", {"value": 1})
        before = path.read_bytes()
        plan = fplan.FaultPlan(
            seed=3, rules=[fplan.FaultRule("tune.cache_write", "raise")])
        with fplan.armed(plan):
            with pytest.raises(Exception):
                cache.put("b", {"value": 2})
        # a sweep's winner goes through the same site
        with fplan.armed(fplan.FaultPlan(
                seed=3, rules=[fplan.FaultRule("tune.cache_write",
                                               "raise")])):
            with pytest.raises(Exception):
                autotune_resolve(64, n_events=96, device="cpu", path=path)
        assert path.read_bytes() == before
        assert json.loads(path.read_text())["entries"] == {"a": {"value": 1}}

    def test_a_file_the_reference_wrote_gives_no_hit(self, tmp_path,
                                                     monkeypatch):
        """The reference's sweeps key their entries by its generation
        (``"interpret"`` off the TPU): neither the port's provider nor its
        sweeps take them, and the two default files differ."""
        path = tmp_path / "ref.json"
        ref_autotune.autotune_resolve(64, n_events=96, interpret=True,
                                      path=path)
        ref_autotune.autotune_cov(256, n_reporters=24, interpret=True,
                                  path=path)
        ref_autotune.autotune_pipeline_depth(8, 16, deterministic=True,
                                             path=path, dispatches=2)
        n_ref = len(json.loads(path.read_text())["entries"])
        provider = default_provider(path, device="cpu")
        assert provider("resolve_block_cols", n_reporters=64,
                        itemsize=4) is None
        assert provider("row_tile_splits", n_reporters=24, n_events=256,
                        itemsize=4) is None
        assert tuned_pipeline_depth(16, path=path, device="cpu") == 2
        obs.reset()
        autotune_resolve(64, n_events=96, device="cpu", path=path)
        assert obs.value("pyconsensus_autotune_sweeps_total",
                         kind="resolve_block_cols") == 1
        assert obs.value("pyconsensus_autotune_cache_hits_total",
                         kind="resolve_block_cols") is None
        # the port adds its own entry beside the reference's
        assert len(json.loads(path.read_text())["entries"]) == n_ref + 1
        monkeypatch.setattr(autotune, "_CACHE_PATH_ENV", "")
        monkeypatch.setattr(ref_autotune, "_CACHE_PATH_ENV", "")
        assert cache_path() != ref_autotune.cache_path()


class TestCLI:
    def test_module_cli_json_line(self, tmp_path, capsys):
        from pyconsensus_tpu_torch.tune.__main__ import main

        main(["--reporters", "64", "--events", "128", "--device", "cpu",
              "--cache", str(tmp_path / "c.json")])
        captured = capsys.readouterr()
        out = captured.out.strip().splitlines()
        assert len(out) == 1
        d = json.loads(out[0])
        assert set(d) == {"cache", "col_tile_splits", "resolve_block_cols",
                          "row_tile_splits"}
        for kind in ("col_tile_splits", "resolve_block_cols",
                     "row_tile_splits"):
            assert d[kind]["value"] in d[kind]["candidates"]
        assert "autotune: sweeps" in captured.err

    def test_module_cli_prints_the_same_bytes_twice(self, tmp_path):
        """Two runs over one cache: the first sweeps, the second hits every
        kind, and both print the same line."""
        env = {k: v for k, v in os.environ.items()
               if k != "PYCONSENSUS_AUTOTUNE_CACHE"}
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        cmd = [sys.executable, "-m", "pyconsensus_tpu_torch.tune",
               "--device", "cpu", "--cache", str(tmp_path / "c.json"),
               "--events", "4096", "--reporters", "512"]
        runs = [subprocess.run(cmd, capture_output=True, text=True, env=env,
                               cwd=REPO, timeout=300) for _ in range(2)]
        for run in runs:
            assert run.returncode == 0, run.stdout + run.stderr
            assert len(run.stdout.splitlines()) == 1
        assert runs[0].stdout == runs[1].stdout
        assert "sweeps 3, cache hits 0" in runs[0].stderr
        assert "sweeps 0, cache hits 3" in runs[1].stderr
        line = json.loads(runs[0].stdout)
        assert list(line) == sorted(line)
        assert line["row_tile_splits"]["probe_shape"] == [512, 4096]


class TestAgainstTheReference:
    def test_shape_class_matches_reference(self):
        for n in (0, 1, 2, 3, 7, 8, 9, 100, 4096, 4097, 100_000, 114_048):
            assert shape_class(n) == ref_autotune.shape_class(n)
        assert split_class(10_000, 100_000) == "p16384xp131072"

    def test_depths_and_fallback_match_reference(self, tmp_path):
        for m in range(0, 7):
            assert depth_candidates(m) == ref_autotune.depth_candidates(m)
        assert FALLBACK_TABLE[("pipeline_depth", "*")] == \
            ref_autotune.FALLBACK_TABLE[("pipeline_depth", "*")] == 2
        assert tuned_pipeline_depth(256, path=tmp_path / "a.json",
                                    device="cpu") == \
            ref_autotune.tuned_pipeline_depth(256,
                                              path=tmp_path / "b.json") == 2

    def test_roofline_arithmetic_matches_reference(self):
        for R, E, item, sweeps, iters in ((10_000, 100_000, 1, 3, 1),
                                          (1024, 4096, 4, 8, 3),
                                          (7, 5, 2, 0, 0)):
            t = roofline.resolution_traffic_bytes(R, E, item, sweeps, iters)
            assert t == ref_roofline.resolution_traffic_bytes(
                R, E, item, sweeps, iters)
            for bw in (3.35e12, 1.0):
                b = roofline.bound_resolutions_per_sec(bw, t)
                assert b == ref_roofline.bound_resolutions_per_sec(bw, t)
                for achieved in (0.0, b / 3, b):
                    assert roofline.classify_regime(achieved, b) == \
                        ref_roofline.classify_regime(achieved, b)
        assert roofline.classify_regime(1.0, 0.0) == "unknown"

    def test_stream_bandwidth_on_the_cpu(self):
        bw = roofline.stream_bandwidth_bytes_per_s(mbytes=4, repeats=3,
                                                   device="cpu")
        assert np.isfinite(bw) and bw > 0


_RANK = r"""
import json, sys
import torch.distributed as dist
rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
from pyconsensus_tpu_torch.tune import default_provider, tuned_pipeline_depth
p = default_provider(path, device="cpu")
out = {"splits": p("row_tile_splits", n_reporters=512, n_events=4096,
                   itemsize=1),
       "depth": tuned_pipeline_depth(256, path=path, device="cpu")}
dist.barrier()
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_provider_is_inert_on_a_two_rank_mesh(tmp_path):
    """Per-host cache files must not launch different shapes on the ranks
    of one program: on a gloo mesh of two the provider and the tuned depth
    take the fallback, where one process takes the persisted entries."""
    from pyconsensus_tpu_torch.tune.autotune import _default_itemsize

    path = tmp_path / "cache.json"
    cache = TuneCache(path)
    cache.put(_entry_key("row_tile_splits", "cpu", 1, split_class(512, 4096)),
              {"value": 3})
    cache.put(_entry_key("pipeline_depth", "cpu", _default_itemsize(),
                         shape_class(256)), {"value": 3})
    assert default_provider(path, device="cpu")(
        "row_tile_splits", n_reporters=512, n_events=4096, itemsize=1) == 3
    assert tuned_pipeline_depth(256, path=path, device="cpu") == 3
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), "2", port,
                               str(path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=REPO) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
        assert json.loads(out.strip().splitlines()[-1]) == \
            {"splits": None, "depth": 2}
