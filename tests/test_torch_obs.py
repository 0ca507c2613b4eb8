"""The port's observability (``pyconsensus_tpu_torch.obs``): the JAX
package's ``tests/test_obs.py`` suites (``TestTracer``, ``TestMetrics``,
``TestSinks``, ``TestPipelineEmission``) on the port's modules, the
torch form of the tracer's device wait (one ``torch.cuda.synchronize``
for each distinct CUDA device among the observed values, none when
nothing was observed), the process index from ``torch.distributed``, and
the emission sites against the reference's: the same span names, metric
names and labels for the same resolution, with the port's label values
where one names an implementation.

Compile observability (``instrument_jit``) has no port yet
(``ROADMAP.md`` §A.11); the hybrid clustering spans are held in
``tests/test_torch_clustering.py``.
"""

import json
import threading

import numpy as np
import pytest
import torch

from pyconsensus_tpu import Oracle as RefOracle
from pyconsensus_tpu import obs as ref_obs
from pyconsensus_tpu_torch import Oracle, ShardedOracle, obs
from pyconsensus_tpu_torch.obs import MetricsRegistry, Tracer


@pytest.fixture
def registry():
    return MetricsRegistry()


@pytest.fixture
def tracer(registry):
    return Tracer(registry=registry)


@pytest.fixture
def ref_sinks(monkeypatch):
    """A fresh registry and tracer for the reference package, so that
    nothing else emitted in this process enters the comparison."""
    registry = ref_obs.MetricsRegistry()
    monkeypatch.setattr(ref_obs, "REGISTRY", registry)
    monkeypatch.setattr(ref_obs, "TRACER", ref_obs.Tracer(registry=registry))
    return registry


@pytest.fixture
def _float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


class _OnCard:
    """Stands for a tensor on a CUDA device, where no card is present."""

    def __init__(self, index=0):
        self.device = torch.device("cuda", index)


@pytest.fixture
def synced(monkeypatch):
    """Records each ``torch.cuda.synchronize`` the tracer makes."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    return calls


# ------------------------------------------------------------- tracer


class TestTracer:
    def test_nesting_and_parent_ids(self, tracer):
        with tracer.span("root") as root:
            with tracer.span("child") as child:
                with tracer.span("grandchild") as grand:
                    assert tracer.current() is grand
                assert tracer.current() is child
        assert child.parent_id == root.span_id
        assert grand.parent_id == child.span_id
        assert root.parent_id == 0
        assert (root.depth, child.depth, grand.depth) == (0, 1, 2)
        # finish order: children before parents
        assert [s.name for s in tracer.spans()] == ["grandchild", "child",
                                                    "root"]

    def test_exception_safety(self, tracer):
        with pytest.raises(ValueError, match="boom"):
            with tracer.span("outer"):
                with tracer.span("failing"):
                    raise ValueError("boom")
        spans = {s.name: s for s in tracer.spans()}
        assert spans["failing"].status == "error"
        assert "boom" in spans["failing"].error
        assert spans["outer"].status == "error"   # propagated through
        assert tracer.current() is None           # stack fully unwound
        with tracer.span("after"):
            pass
        assert tracer.spans()[-1].status == "ok"

    def test_observe_syncs_each_card_once(self, tracer, synced):
        """Every observed value is waited on: one synchronize for each
        distinct CUDA device among them, nested containers walked."""
        with tracer.span("s") as sp:
            sp.observe(_OnCard(0))
            sp.observe({"a": _OnCard(0), "b": [_OnCard(1), (_OnCard(0),)]})
        assert synced == [torch.device("cuda", 0), torch.device("cuda", 1)]

    def test_host_values_need_no_sync(self, tracer, synced):
        with tracer.span("s") as sp:
            sp.observe(np.ones(3))
            sp.observe(torch.ones(3))
            sp.observe({"x": 1.0, "y": [torch.zeros(2)]})
        assert synced == []

    def test_span_without_observe_never_syncs(self, tracer, synced):
        """A span adds no wait for the card unless a value was observed
        into it (a clean resolution pays no extra sync)."""
        with tracer.span("outer"):
            with tracer.span("inner"):
                pass
        assert synced == []

    def test_observe_without_span_passes_through(self, tracer):
        x = object()
        assert tracer.observe(x) is x

    def test_durations_feed_registry(self, tracer, registry):
        with tracer.span("timed"):
            pass
        hist = registry.get("pyconsensus_phase_seconds")
        assert hist.value(phase="timed")["count"] == 1

    def test_threads_get_independent_stacks(self, tracer):
        def worker():
            with tracer.span("worker_root"):
                pass

        with tracer.span("main_root"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
        spans = {s.name: s for s in tracer.spans()}
        assert spans["worker_root"].parent_id == 0

    def test_report_tree_indents_children(self, tracer):
        with tracer.span("root"):
            with tracer.span("leaf"):
                pass
        rep = tracer.report()
        root_line = [ln for ln in rep.splitlines() if "root" in ln][0]
        leaf_line = [ln for ln in rep.splitlines() if "leaf" in ln][0]
        assert not root_line.startswith(" ")
        assert leaf_line.startswith("  ")

    def test_span_cap_drops_oldest(self, registry):
        t = Tracer(registry=registry, max_spans=5)
        for i in range(8):
            with t.span(f"s{i}"):
                pass
        assert len(t.spans()) == 5
        assert t.dropped() == 3
        assert t.spans()[0].name == "s3"

    def test_report_promotes_orphaned_children(self, tracer):
        with tracer.span("still_open"):
            with tracer.span("orphan_child"):
                pass
            rep = tracer.report()     # parent not finished yet
        assert "orphan_child" in rep, rep

    def test_process_index_is_the_distributed_rank(self, tracer,
                                                   monkeypatch):
        with tracer.span("alone") as sp:
            pass
        assert sp.process_index == 0
        dist = torch.distributed
        monkeypatch.setattr(dist, "is_available", lambda: True)
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_rank", lambda group=None: 3)
        with tracer.span("rank3") as sp:
            pass
        assert sp.process_index == 3
        assert tracer.events()[-1]["process_index"] == 3

    def test_trace_root_propagates_trace_id(self, tracer):
        with tracer.trace_root("req", "key-7"):
            with tracer.span("child") as child:
                pass
        assert child.trace_id == "key-7"
        forest = obs.trace_forest(tracer.events())
        assert list(forest) == ["key-7"]
        assert [c["name"] for c in forest["key-7"][0]["children"]] == [
            "child"]


# ------------------------------------------------------------ metrics


class TestMetrics:
    def test_counter_accumulates_per_label(self, registry):
        c = registry.counter("t_total", "help", labels=("k",))
        c.inc(k="a")
        c.inc(2.5, k="a")
        c.inc(k="b")
        assert c.value(k="a") == 3.5
        assert c.value(k="b") == 1.0
        assert c.value(k="never") == 0.0

    def test_counter_rejects_decrease_and_label_typos(self, registry):
        c = registry.counter("t_total", labels=("k",))
        with pytest.raises(ValueError, match="decrease"):
            c.inc(-1, k="a")
        with pytest.raises(ValueError, match="labels"):
            c.inc(wrong="a")

    def test_gauge_last_write_wins(self, registry):
        g = registry.gauge("g")
        assert g.value() is None
        g.set(3)
        g.set(7)
        assert g.value() == 7.0

    def test_histogram_bucket_edges_inclusive_upper(self, registry):
        h = registry.histogram("h", buckets=(1.0, 2.0, 5.0))
        for v in (0.5, 1.0, 1.0001, 2.0, 5.0, 99.0):
            h.observe(v)
        text = registry.render_prom()
        assert 'h_bucket{le="1"} 2' in text
        assert 'h_bucket{le="2"} 4' in text
        assert 'h_bucket{le="5"} 5' in text
        assert 'h_bucket{le="+Inf"} 6' in text
        assert "h_count 6" in text
        assert f"h_sum {0.5 + 1.0 + 1.0001 + 2.0 + 5.0 + 99.0!r}" in text

    def test_histogram_rejects_unsorted_buckets(self, registry):
        with pytest.raises(ValueError, match="ascending"):
            registry.histogram("h", buckets=(2.0, 1.0))

    def test_reregistration_returns_same_metric(self, registry):
        a = registry.counter("x_total", labels=("k",))
        b = registry.counter("x_total", labels=("k",))
        assert a is b
        with pytest.raises(ValueError, match="conflicting"):
            registry.gauge("x_total")
        with pytest.raises(ValueError, match="conflicting"):
            registry.counter("x_total", labels=("other",))

    def test_histogram_bucket_conflict_raises(self, registry):
        h = registry.histogram("h", buckets=(1.0, 2.0))
        assert registry.histogram("h", buckets=(1.0, 2.0)) is h
        with pytest.raises(ValueError, match="buckets"):
            registry.histogram("h", buckets=(5.0, 10.0))

    def test_invalid_names_rejected(self, registry):
        with pytest.raises(ValueError, match="metric name"):
            registry.counter("bad-name")
        with pytest.raises(ValueError, match="label name"):
            registry.counter("ok", labels=("bad-label",))

    def test_value_lookup_fails_soft(self, registry):
        assert registry.value("never_registered") is None
        registry.counter("c_total", labels=("k",))
        assert registry.value("c_total", wrong_label="x") is None

    def test_thread_safety_under_contention(self, registry):
        c = registry.counter("n_total")
        h = registry.histogram("d", buckets=(0.5,))

        def hammer():
            for _ in range(1000):
                c.inc()
                h.observe(0.25)

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert c.value() == 8000
        assert h.value()["count"] == 8000

    def test_buckets_are_the_references(self):
        assert obs.DURATION_BUCKETS == ref_obs.DURATION_BUCKETS
        assert obs.ITERATION_BUCKETS == ref_obs.ITERATION_BUCKETS
        assert obs.MAGNITUDE_BUCKETS == ref_obs.MAGNITUDE_BUCKETS

    def test_snapshot_matches_the_references(self, registry):
        """The same emissions render and snapshot identically in both
        packages."""
        ref = ref_obs.MetricsRegistry()
        for reg in (registry, ref):
            reg.counter("a_total", "a", labels=("k",)).inc(2, k="x")
            reg.gauge("g", "g").set(1.5)
            reg.histogram("h_seconds", "h", labels=("p",),
                          buckets=obs.DURATION_BUCKETS).observe(0.003,
                                                                p="q")
        assert registry.render_prom() == ref.render_prom()
        assert registry.snapshot() == ref.snapshot()


# -------------------------------------------------------------- sinks


class TestSinks:
    def test_prometheus_exposition_golden(self, registry):
        registry.counter("req_total", "requests served",
                         labels=("path",)).inc(3, path='a"b\\c\nd')
        registry.gauge("temp", "temperature").set(1.5)
        registry.histogram("lat_seconds", "latency", buckets=(0.1, 1.0)
                           ).observe(0.05)
        got = registry.render_prom()
        expected = (
            "# HELP lat_seconds latency\n"
            "# TYPE lat_seconds histogram\n"
            'lat_seconds_bucket{le="0.1"} 1\n'
            'lat_seconds_bucket{le="1"} 1\n'
            'lat_seconds_bucket{le="+Inf"} 1\n'
            "lat_seconds_sum 0.05\n"
            "lat_seconds_count 1\n"
            "# HELP req_total requests served\n"
            "# TYPE req_total counter\n"
            'req_total{path="a\\"b\\\\c\\nd"} 3\n'
            "# HELP temp temperature\n"
            "# TYPE temp gauge\n"
            "temp 1.5\n"
        )
        assert got == expected

    def test_empty_registry_renders_empty(self, registry):
        assert registry.render_prom() == ""
        registry.counter("silent_total", labels=("k",))
        assert registry.render_prom() == ""

    def test_jsonl_round_trip_and_tree(self, tracer, tmp_path):
        with tracer.span("root", algorithm="sztorc"):
            with tracer.span("fill"):
                pass
            with tracer.span("iterate", n=3):
                with tracer.span("scores"):
                    pass
        path = tmp_path / "trace.jsonl"
        n = obs.write_jsonl(path, tracer.events(), meta={"run": "test"})
        back = obs.read_jsonl(path)
        assert n == len(back) == 5                # meta + 4 spans
        assert back[0]["type"] == "meta" and back[0]["run"] == "test"
        for line in path.read_text().splitlines():
            json.loads(line)
        tree = obs.span_tree(back)
        assert len(tree) == 1
        root = tree[0]
        assert root["name"] == "root"
        assert root["attrs"]["algorithm"] == "sztorc"
        assert [c["name"] for c in root["children"]] == ["fill", "iterate"]
        assert [c["name"] for c in root["children"][1]["children"]] == [
            "scores"]
        assert root["children"][1]["attrs"]["n"] == 3

    def test_span_tree_keys_per_process(self):
        merged = []
        for proc in (0, 1):
            merged += [
                {"type": "span", "name": f"root_p{proc}", "span_id": 1,
                 "parent_id": 0, "process_index": proc, "start_s": 1.0},
                {"type": "span", "name": f"child_p{proc}", "span_id": 2,
                 "parent_id": 1, "process_index": proc, "start_s": 2.0},
            ]
        tree = obs.span_tree(merged)
        assert sorted(t["name"] for t in tree) == ["root_p0", "root_p1"]
        for root in tree:
            proc = root["process_index"]
            assert [c["name"] for c in root["children"]] == [
                f"child_p{proc}"]

    def test_async_failure_at_sync_marks_span_error(self, tracer,
                                                    monkeypatch):
        """A launch that fails ASYNCHRONOUSLY (raises at the span's
        synchronize) must not leave a green span for the phase that
        crashed."""

        def fail(device=None):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(torch.cuda, "synchronize", fail)
        with pytest.raises(RuntimeError, match="illegal memory"):
            with tracer.span("crashing") as sp:
                sp.observe(_OnCard())
        recorded = tracer.spans()[-1]
        assert recorded.status == "error"
        assert "illegal memory" in recorded.error
        assert recorded.duration_s is not None
        assert tracer.current() is None

    def test_span_tree_orphans_become_roots(self):
        events = [
            {"type": "span", "name": "orphan", "span_id": 7,
             "parent_id": 99, "start_s": 1.0},
            {"type": "meta"},
        ]
        tree = obs.span_tree(events)
        assert [t["name"] for t in tree] == ["orphan"]

    def test_write_prom_writes_file(self, registry, tmp_path):
        registry.counter("c_total").inc()
        text = obs.write_prom(tmp_path / "sub" / "m.prom", registry)
        assert (tmp_path / "sub" / "m.prom").read_text() == text
        assert "c_total 1" in text


# -------------------------------------------- pipeline emission contract


REPORTS = np.array([
    [1.0, 1.0, 0.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [1.0, 1.0, 0.0, 0.0],
    [1.0, 1.0, 1.0, 0.0],
    [0.0, 0.0, 1.0, 1.0],
    [np.nan, 0.0, 1.0, 1.0],
])


def _span_names(tracer):
    return [s.name for s in tracer.spans()]


@pytest.mark.usefixtures("_float64")
class TestPipelineEmission:
    def test_oracle_consensus_emits_convergence_metrics(self):
        obs.reset()
        r = Oracle(reports=REPORTS, backend="numpy",
                   max_iterations=7).consensus()
        conv = str(bool(r["convergence"])).lower()
        assert obs.value("pyconsensus_consensus_total", algorithm="sztorc",
                         backend="numpy", converged=conv) == 1
        iters = obs.value("pyconsensus_consensus_iterations",
                          algorithm="sztorc", backend="numpy")
        assert iters["count"] == 1
        assert iters["sum"] == r["iterations"]
        res = obs.value("pyconsensus_convergence_residual",
                        backend="numpy")
        assert res["count"] == r["iterations"]
        mass = obs.REGISTRY.get("pyconsensus_redistribution_mass")
        for kind in ("raw", "smooth"):
            v = mass.value(kind=kind)
            assert v["count"] == 1
            assert 0.0 <= v["sum"] <= 1.0
        assert obs.value("pyconsensus_na_fills_total",
                         backend="numpy") == 1
        names = _span_names(obs.TRACER)
        assert "oracle.consensus" in names
        assert {"np.fill", "np.iterate", "np.resolve", "np.scores"} <= set(
            names)

    @pytest.mark.parametrize("algorithm", ["sztorc", "fixed-variance"])
    def test_numpy_backend_emits_as_the_reference(self, algorithm,
                                                  ref_sinks):
        """The same numpy resolution emits the same spans (names, nesting,
        attributes) and the same metric series in both packages."""
        obs.reset()
        kw = dict(reports=REPORTS, backend="numpy", max_iterations=3,
                  algorithm=algorithm)
        Oracle(**kw).consensus()
        RefOracle(**kw).consensus()

        def shape(events):
            return [(e["name"], e["depth"], sorted(e["attrs"].items()))
                    for e in events]

        assert shape(obs.events()) == shape(ref_obs.events())
        got, want = obs.REGISTRY.snapshot(), ref_obs.REGISTRY.snapshot()
        want.pop("pyconsensus_phase_seconds")
        got.pop("pyconsensus_phase_seconds")
        assert got == want

    def test_torch_backend_emits_with_the_port_labels(self, ref_sinks):
        """The torch backend emits what the reference's jit path emits:
        ``oracle.consensus`` over a dispatch-only ``pipeline.dispatch``
        (path ``plain`` where the reference's reads ``jit``) and the
        host-side result metrics, under backend ``torch``."""
        obs.reset()
        Oracle(reports=REPORTS, device="cpu", max_iterations=3).consensus()
        Oracle(reports=REPORTS, device="cpu", max_iterations=3).consensus()
        RefOracle(reports=REPORTS, backend="jax",
                  max_iterations=3).consensus()
        assert obs.value("pyconsensus_consensus_total", algorithm="sztorc",
                         backend="torch", converged="false") == 2
        assert obs.value("pyconsensus_consensus_total", algorithm="sztorc",
                         backend="torch", converged="false") == 2 * \
            ref_obs.value("pyconsensus_consensus_total", algorithm="sztorc",
                          backend="jax", converged="false")
        tree = obs.span_tree(obs.events())
        assert [t["name"] for t in tree] == ["oracle.consensus"] * 2
        assert [c["name"] for c in tree[0]["children"]] == [
            "pipeline.dispatch"]
        assert tree[0]["children"][0]["attrs"] == {"algorithm": "sztorc",
                                                   "path": "plain"}
        ref_tree = ref_obs.span_tree(ref_obs.events())
        ref_top = [t for t in ref_tree if t["name"] == "oracle.consensus"]
        assert [c["name"] for c in ref_top[0]["children"]] == [
            "pipeline.dispatch"]
        assert ref_top[0]["children"][0]["attrs"]["path"] == "jit"
        assert set(tree[0]["attrs"]) == set(ref_top[0]["attrs"])

    def test_sharded_consensus_counts_paths(self):
        from pyconsensus_tpu_torch import sharded_consensus
        from pyconsensus_tpu_torch.models.pipeline import ConsensusParams
        from pyconsensus_tpu_torch.parallel import make_mesh

        obs.reset()
        out = sharded_consensus(REPORTS, device="cpu")
        np.asarray(out["outcomes_adjusted"])
        snap = obs.REGISTRY.snapshot()[
            "pyconsensus_sharded_resolutions_total"]["series"]
        assert sum(snap.values()) == 1
        assert snap == {json.dumps({"algorithm": "sztorc", "path": "plain",
                                    "storage": "full"},
                                   sort_keys=True): 1.0}
        assert obs.value("pyconsensus_kernel_path_total",
                         path="plain") == 1
        assert obs.value("pyconsensus_mesh_event_shards") == 1
        p = ConsensusParams(pca_method="power", storage_dtype="int8")
        sharded_consensus(REPORTS, params=p, device="cpu")
        sharded_consensus(REPORTS, params=p,
                          mesh=make_mesh(devices=["cpu"] * 2))
        assert obs.value("pyconsensus_sharded_resolutions_total",
                         path="fused", algorithm="sztorc",
                         storage="int8") == 1
        assert obs.value("pyconsensus_sharded_resolutions_total",
                         path="fused_sharded", algorithm="sztorc",
                         storage="int8") == 1
        assert obs.value("pyconsensus_kernel_path_total", path="cuda") == 2
        assert obs.value("pyconsensus_mesh_event_shards") == 2
        names = _span_names(obs.TRACER)
        assert names.count("pipeline.dispatch") == 2
        assert names.count("fused_sharded.dispatch") == 1

    def test_a_rejected_call_counts_nothing(self):
        from pyconsensus_tpu_torch import sharded_consensus
        from pyconsensus_tpu_torch.faults import InputError

        obs.reset()
        with pytest.raises(InputError):
            sharded_consensus(REPORTS, reputation=np.ones(5), device="cpu")
        assert obs.value("pyconsensus_sharded_resolutions_total",
                         path="plain", algorithm="sztorc",
                         storage="full") is None

    def test_sharded_oracle_span_tree(self):
        """One traced ``ShardedOracle`` resolution: ``oracle.consensus``
        (sharded) over ``pipeline.dispatch`` on one device, over
        ``fused_sharded.dispatch`` on a mesh."""
        from pyconsensus_tpu_torch.parallel import make_mesh

        reports = np.nan_to_num(REPORTS, nan=1.0)
        for kw, child in ((dict(device="cpu"), "pipeline.dispatch"),
                          (dict(mesh=make_mesh(devices=["cpu"] * 2)),
                           "fused_sharded.dispatch")):
            obs.reset()
            ShardedOracle(reports=reports, pca_method="power",
                          storage_dtype="int8", **kw).consensus()
            tree = obs.span_tree(obs.events())
            assert [t["name"] for t in tree] == ["oracle.consensus"]
            assert tree[0]["attrs"]["sharded"] is True
            assert tree[0]["attrs"]["backend"] == "torch"
            assert [c["name"] for c in tree[0]["children"]] == [child]
            assert obs.value("pyconsensus_consensus_total",
                             algorithm="sztorc", backend="torch",
                             converged="false") == 1

    def test_a_traced_resolution_adds_no_sync(self, monkeypatch):
        """The emission sites observe nothing: a traced clean resolution
        (and a recovery) through every front door gives the tracer no
        value to wait for, on the card or anywhere."""
        from pyconsensus_tpu_torch import faults
        from pyconsensus_tpu_torch.obs import tracer as tracer_mod

        observed = []
        real = tracer_mod._block_all
        monkeypatch.setattr(tracer_mod, "_block_all", lambda values: (
            observed.extend(values), real(values)))

        reports = np.nan_to_num(REPORTS, nan=1.0)
        Oracle(reports=REPORTS, device="cpu").consensus()
        Oracle(reports=REPORTS, backend="numpy").consensus()
        ShardedOracle(reports=reports, pca_method="power",
                      storage_dtype="int8", device="cpu").consensus()
        with faults.armed(faults.FaultPlan(seed=0, rules=[
                {"site": "oracle.raw_result", "kind": "nan_storm",
                 "occurrences": [0], "args": {"fraction": 1.0}}])):
            Oracle(reports=REPORTS, device="cpu",
                   pca_method="power").consensus()
        assert observed == []
        assert {"oracle.consensus", "pipeline.dispatch", "np.fill"} <= {
            sp.name for sp in obs.TRACER.spans()}
