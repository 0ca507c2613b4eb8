"""The port's Layer 4 (``pyconsensus_tpu_torch.analysis.concurrency``)
on the CPU: the trigger/no-trigger corpus for CL801-CL805 (the
reference's, plus the port's blocking model: ``torch.cuda.synchronize``,
a CUDA event's ``.synchronize()``, the ``nvcc`` subprocess waits, and
``.item()``/``.cpu()`` left out), the annotation/pragma conventions, the
interprocedural lock flow, the live package-is-clean invariant with the
fleet's declared lock orders, the runtime lock witness (recording, cycle
detection, static-graph consistency, JSON round-trip, the package
prefix), and parity with the reference's analyzer: on every planted
snippet both report the same (rule, line) set."""

import pathlib
import re
import textwrap
import threading
import time

import pytest

from pyconsensus_tpu.analysis.concurrency import \
    analyze_concurrency as ref_analyze_concurrency
from pyconsensus_tpu_torch.analysis import witness as witness_mod
from pyconsensus_tpu_torch.analysis.cli import run as cli_run
from pyconsensus_tpu_torch.analysis.concurrency import (CONCURRENCY_RULES,
                                                        analyze_concurrency,
                                                        lock_order_edges)
from pyconsensus_tpu_torch.analysis.witness import (LockWitness,
                                                    WitnessViolation,
                                                    load_witness,
                                                    static_lock_graph,
                                                    witnessed)
from pyconsensus_tpu_torch.faults import FAULT_SITES

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "pyconsensus_tpu_torch"


def _write(tmp_path, files):
    for name, src in files.items():
        (tmp_path / f"{name}.py").write_text(textwrap.dedent(src))


def _conc(tmp_path, **files):
    """Write ``name -> source`` modules and run Layer 4 over the dir."""
    _write(tmp_path, files)
    return analyze_concurrency(paths=[tmp_path])


def _rules(findings):
    return sorted({f.rule for f in findings})


def _sub(src, old, new):
    """``src`` with ``old`` replaced, which must occur."""
    assert old in src, old
    return src.replace(old, new, 1)


# ------------------------------------------------------------ the corpus

INVERT_A = """
    import threading
    from jmod import Journal

    class Store:
        def __init__(self):
            self._lock = threading.Lock()
            self.j = Journal()

        def alpha(self):
            with self._lock:
                self.j.write()

        def flush(self):
            with self._lock:
                pass
    """
INVERT_B = """
    import threading

    class Journal:
        def __init__(self):
            self._jlock = threading.Lock()

        def write(self):
            with self._jlock:
                pass

        def beta(self, store):
            with self._jlock:
                store.flush()
    """
DECL_BAD = """
    import threading

    # consensus-lint: lock-order Worker.a_lock < Worker.b_lock

    class Worker:
        def __init__(self):
            self.a_lock = threading.Lock()
            self.b_lock = threading.Lock()

        def bad(self):
            with self.b_lock:
                with self.a_lock:
                    pass
    """
MIXED = """
    import threading

    class Counter:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0
            self.mixed = 0

        def inc(self):
            with self._lock:
                self.n += 1

        def inc2(self):
            with self._lock:
                self.n += 2

        def rogue(self):
            self.n = 0

        def m1(self):
            with self._lock:
                self.mixed = 1

        def m2(self):
            other = threading.Lock()
            with other:
                self.mixed = 2
    """

#: case name -> {module name: source}; every case is a test below AND a
#: parity case against the reference's analyzer
CASES = {
    "cross_module_inversion": {"smod": INVERT_A, "jmod": INVERT_B},
    "consistent_order": {"smod": INVERT_A, "jmod": _sub(
        INVERT_B, "with self._jlock:\n                store.flush()",
        "store.flush()")},
    "declared_order_violation": {"decl": DECL_BAD},
    "declared_order_matching": {"decl": """
        import threading

        # consensus-lint: lock-order Worker.a_lock < Worker.b_lock

        class Worker:
            def __init__(self):
                self.a_lock = threading.Lock()
                self.b_lock = threading.Lock()

            def good(self):
                with self.a_lock:
                    with self.b_lock:
                        pass
        """},
    "reentrant_same_lock": {"re": """
        import threading

        class R:
            def __init__(self):
                self._lock = threading.RLock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
        """},
    "suppression_with_rationale": {"decl": _sub(
        DECL_BAD, "with self.a_lock:\n",
        "with self.a_lock:  # consensus-lint: disable=CL801 — drain path:"
        " b is private here\n")},
    "future_result_under_lock": {"disp": """
        import threading

        class Dispatcher:
            def __init__(self):
                self._lock = threading.Lock()

            def flush(self, fut):
                with self._lock:
                    return fut.result()
        """},
    "bounded_timeout": {"disp": """
        import threading

        class Dispatcher:
            def __init__(self):
                self._lock = threading.Lock()

            def flush(self, fut):
                with self._lock:
                    return fut.result(timeout=1.0)
        """},
    "result_outside_lock": {"disp": """
        import threading

        class Dispatcher:
            def __init__(self):
                self._lock = threading.Lock()

            def flush(self, fut):
                with self._lock:
                    pending = fut
                return pending.result()
        """},
    "sleep_and_queue_handle": {"q": """
        import queue
        import threading
        import time

        class Pump:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue()

            def nap(self):
                with self._lock:
                    time.sleep(0.5)

            def drain(self):
                with self._lock:
                    return self._q.get()

            def drain_bounded(self):
                with self._lock:
                    return self._q.get(timeout=0.1)
        """},
    "positional_args_not_timeouts": {"q": """
        import queue
        import threading

        class Pump:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue(maxsize=2)

            def feed(self, item):
                with self._lock:
                    self._q.put(item)

            def poll(self):
                with self._lock:
                    return self._q.get(True)

            def feed_bounded(self, item):
                with self._lock:
                    self._q.put(item, True, 0.5)
        """},
    "wait_for_predicate": {"wf": """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._cond = threading.Condition()

            def bad(self):
                with self._lock:
                    self._cond.wait_for(lambda: True)

            def ok(self):
                with self._lock:
                    self._cond.wait_for(lambda: True, 0.5)
        """},
    "interprocedural_blocking": {"ip": """
        import threading

        class Gate:
            def __init__(self):
                self._lock = threading.Lock()
                self._ev = threading.Event()

            def locked_wait(self):
                with self._lock:
                    self._park()

            def _park(self):
                self._ev.wait()
        """},
    "condition_wait_idiom": {"c": """
        import threading

        class Box:
            def __init__(self):
                self._cond = threading.Condition()

            def take(self):
                with self._cond:
                    while True:
                        self._cond.wait()
        """},
    "lambda_body_lock_flow": {"lam": """
        import threading

        class L:
            def __init__(self):
                self.a_lock = threading.Lock()
                self.b_lock = threading.Lock()

            def one(self):
                with self.a_lock:
                    run = lambda: self.take_b()
                    run()

            def take_b(self):
                with self.b_lock:
                    pass

            def two(self):
                with self.b_lock:
                    self.take_a()

            def take_a(self):
                with self.a_lock:
                    pass
        """},
    "annotated_receiver": {"recv": """
        import threading

        class Worker:
            def __init__(self):
                self.wlock = threading.Lock()

            def back(self, store: "Store"):
                with self.wlock:
                    with store._lock:
                        pass

        class Store:
            def __init__(self):
                self._lock = threading.Lock()

            def forth(self, w: Worker):
                with self._lock:
                    with w.wlock:
                        pass
        """},
    "acquire_release_linear": {"ar": """
        import threading
        import time

        class P:
            def __init__(self):
                self._lock = threading.Lock()

            def work(self):
                self._lock.acquire()
                time.sleep(0.1)
                self._lock.release()
                time.sleep(0.2)
        """},
    "method_receiver_same_site": {"recv": """
        import threading

        class Worker:
            def __init__(self):
                self.declare_lock = threading.Lock()

            def claim_pair(self, other):
                with self.declare_lock:
                    with other.declare_lock:
                        pass
        """},
    "guarded_majority_and_mixed": {"g": MIXED},
    "guarded_consistent": {"g": _sub(_sub(
        MIXED, "def rogue(self):\n            self.n = 0",
        "def rogue(self):\n            pass"),
        "other = threading.Lock()\n            with other:",
        "with self._lock:")},
    "guarded_nested_majority": {"nest": """
        import threading

        class M:
            def __init__(self):
                self.a_outer = threading.Lock()
                self.b_inner = threading.Lock()
                self.x = 0

            def w1(self):
                with self.a_outer:
                    with self.b_inner:
                        self.x = 1
                        self.x = 2
                        self.x = 3

            def w2(self):
                with self.b_inner:
                    self.x = 4
                    self.x = 5
        """},
    "guarded_by_annotation": {"a": """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.state = "idle"   # guarded-by: _lock

            def set(self):
                self.state = "hot"
        """},
    "guarded_by_none": {"a": """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0   # guarded-by: none

            def a(self):
                with self._lock:
                    self.n += 1

            def b(self):
                with self._lock:
                    self.n += 2

            def c(self):
                self.n = 0
        """},
    "guarded_by_unknown_lock": {"a": """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0   # guarded-by: _mutex

            def a(self):
                self.n = 1
        """},
    "init_writes": {"a": """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0
                self.n = 1

            def a(self):
                with self._lock:
                    self.n += 1

            def b(self):
                with self._lock:
                    self.n += 2
        """},
    "unknown_fault_site": {"h": """
        from pyconsensus_tpu_torch import faults

        def touch():
            faults.fire("no.such.site")
        """},
    "cataloged_fault_site": {"h": """
        from pyconsensus_tpu_torch import faults

        def touch(value):
            faults.fire("serve.enqueue")
            return faults.corrupt("oracle.reports", value)
        """},
    "no_hooks_restricted_scan": {"h": """
        def nothing():
            return 1
        """},
    "torn_write_hook_under_lock": {"t": """
        import threading
        from pyconsensus_tpu_torch.faults import plan as _faults

        class Shipper:
            def __init__(self):
                self._lock = threading.Lock()

            def ship(self, path):
                with self._lock:
                    _faults.fire("shipping.append", path=path)

            def ping(self):
                with self._lock:
                    _faults.fire("shipping.append")
        """},
}

#: the port's own blocking model (no reference counterpart: the
#: reference knows block_until_ready, not the card's waits)
PORT_CASES = {
    "cuda_synchronize_under_lock": {"dev": """
        import threading
        import torch

        class Batcher:
            def __init__(self):
                self._lock = threading.Lock()
                self._done = torch.cuda.Event()

            def finish(self):
                with self._lock:
                    torch.cuda.synchronize()

            def wait_event(self):
                with self._lock:
                    self._done.synchronize()

            def outside(self):
                torch.cuda.synchronize()
        """},
    "item_and_cpu_are_left_out": {"dev": """
        import threading

        class Cache:
            def __init__(self):
                self._lock = threading.Lock()

            def read(self, t):
                with self._lock:
                    return t.item(), t.cpu()
        """},
    "nvcc_waits_under_lock": {"nv": """
        import subprocess
        import threading

        _LOCK = threading.RLock()

        def build(cmd):
            with _LOCK:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
                out = proc.communicate()[0]
                proc.wait()
                return out

        def build_bounded(cmd):
            with _LOCK:
                proc = subprocess.Popen(cmd)
                proc.wait(timeout=60)
                proc.communicate(None, 60)
        """},
}


# ------------------------------------------------------------- CL801


class TestLockOrderCycles:
    def test_cross_module_inversion_triggers(self, tmp_path):
        fs = _conc(tmp_path, **CASES["cross_module_inversion"])
        assert _rules(fs) == ["CL801"]
        (f,) = fs
        assert "Store._lock" in f.message and "Journal._jlock" in f.message
        assert "deadlock" in f.message

    def test_consistent_order_is_clean(self, tmp_path):
        # same shape, but beta respects the store-before-journal order
        assert _conc(tmp_path, **CASES["consistent_order"]) == []

    def test_declared_order_violation_without_cycle(self, tmp_path):
        fs = _conc(tmp_path, **CASES["declared_order_violation"])
        assert _rules(fs) == ["CL801"]
        assert "contradicts the declared lock order" in fs[0].message

    def test_declared_order_matching_edge_is_clean(self, tmp_path):
        assert _conc(tmp_path, **CASES["declared_order_matching"]) == []

    def test_reentrant_same_lock_is_not_a_cycle(self, tmp_path):
        assert _conc(tmp_path, **CASES["reentrant_same_lock"]) == []

    def test_suppression_with_rationale(self, tmp_path):
        assert _conc(tmp_path, **CASES["suppression_with_rationale"]) == []


# ------------------------------------------------------------- CL802


class TestBlockingUnderLock:
    def test_future_result_under_lock(self, tmp_path):
        fs = _conc(tmp_path, **CASES["future_result_under_lock"])
        assert _rules(fs) == ["CL802"]
        assert "future" in fs[0].message

    def test_bounded_timeout_is_exempt(self, tmp_path):
        assert _conc(tmp_path, **CASES["bounded_timeout"]) == []

    def test_result_outside_lock_is_clean(self, tmp_path):
        assert _conc(tmp_path, **CASES["result_outside_lock"]) == []

    def test_sleep_and_queue_handle_dataflow(self, tmp_path):
        fs = _conc(tmp_path, **CASES["sleep_and_queue_handle"])
        assert [f.line for f in fs] == [13, 17]
        assert _rules(fs) == ["CL802"]

    def test_positional_args_are_not_timeouts(self, tmp_path):
        # q.put(item) and q.get(True) carry positional args that are
        # NOT timeouts — both block unboundedly; only the methods'
        # actual timeout slots (or timeout=) bound the wait
        fs = _conc(tmp_path, **CASES["positional_args_not_timeouts"])
        assert _rules(fs) == ["CL802"]
        assert [f.line for f in fs] == [12, 16]

    def test_wait_for_predicate_arg_is_not_a_timeout(self, tmp_path):
        fs = _conc(tmp_path, **CASES["wait_for_predicate"])
        assert _rules(fs) == ["CL802"]
        assert [f.line for f in fs] == [11]

    def test_interprocedural_blocking_through_callee(self, tmp_path):
        # the lock is held HERE; the blocking wait lives in the callee —
        # the callee's entry held set carries the caller's lock
        fs = _conc(tmp_path, **CASES["interprocedural_blocking"])
        assert _rules(fs) == ["CL802"]
        assert fs[0].path == "ip.py"

    def test_condition_wait_on_held_condition_is_the_idiom(self, tmp_path):
        assert _conc(tmp_path, **CASES["condition_wait_idiom"]) == []

    def test_lambda_body_lock_flow(self, tmp_path):
        # acquisitions inside a lambda run in the enclosing scope: an
        # inversion seeded through a lambda must still be seen
        fs = _conc(tmp_path, **CASES["lambda_body_lock_flow"])
        assert "CL801" in _rules(fs)

    def test_annotated_receiver_type_lock_flow(self, tmp_path):
        fs = _conc(tmp_path, **CASES["annotated_receiver"])
        assert _rules(fs) == ["CL801"]
        assert "Worker.wlock" in fs[0].message

    def test_acquire_release_linear_tracking(self, tmp_path):
        fs = _conc(tmp_path, **CASES["acquire_release_linear"])
        # only the sleep BETWEEN acquire and release is under the lock
        assert _rules(fs) == ["CL802"]
        assert [f.line for f in fs] == [11]

    def test_method_receiver_lock_flow(self, tmp_path):
        # same site key for both -> identity-equal, no self edge
        assert _conc(tmp_path, **CASES["method_receiver_same_site"]) == []

    def test_torn_write_hook_under_lock(self, tmp_path):
        # the path= form does file I/O under the lock; the raise-only
        # fire(site) form is exempt
        fs = _conc(tmp_path, **CASES["torn_write_hook_under_lock"])
        assert _rules(fs) == ["CL802"]
        assert [f.line for f in fs] == [11]
        assert "torn-write" in fs[0].message

    def test_card_waits_under_lock(self, tmp_path):
        """The port's counterpart of block_until_ready: the whole-card
        wait and a CUDA event's .synchronize() under a lock; outside it
        the same wait is clean."""
        fs = _conc(tmp_path, **PORT_CASES["cuda_synchronize_under_lock"])
        assert _rules(fs) == ["CL802"]
        assert [f.line for f in fs] == [12, 16]
        assert "torch.cuda.synchronize" in fs[0].message
        assert "waits for the card" in fs[1].message

    def test_item_and_cpu_are_not_blocking_calls(self, tmp_path):
        """A receiver's device cannot be typed statically: .item() and
        .cpu() are left out of the model."""
        assert _conc(tmp_path, **PORT_CASES["item_and_cpu_are_left_out"]) \
            == []

    def test_nvcc_subprocess_waits_under_lock(self, tmp_path):
        fs = _conc(tmp_path, **PORT_CASES["nvcc_waits_under_lock"])
        assert _rules(fs) == ["CL802"]
        assert [f.line for f in fs] == [10, 11]
        assert all("process handle" in f.message for f in fs)


# ------------------------------------------------------- CL803 / CL804


class TestGuardedBy:
    def test_majority_guard_and_mixed_sets(self, tmp_path):
        fs = _conc(tmp_path, **CASES["guarded_majority_and_mixed"])
        assert _rules(fs) == ["CL803", "CL804"]
        cl803, = [f for f in fs if f.rule == "CL803"]
        assert "Counter.n" in cl803.message
        assert "majority" in cl803.message
        cl804, = [f for f in fs if f.rule == "CL804"]
        assert "Counter.mixed" in cl804.message

    def test_consistent_locking_is_clean(self, tmp_path):
        assert _conc(tmp_path, **CASES["guarded_consistent"]) == []

    def test_nested_majority_guard_is_the_best_supported_lock(
            self, tmp_path):
        assert _conc(tmp_path, **CASES["guarded_nested_majority"]) == []

    def test_guarded_by_annotation_pins_single_write(self, tmp_path):
        fs = _conc(tmp_path, **CASES["guarded_by_annotation"])
        assert _rules(fs) == ["CL803"]
        assert "annotated" in fs[0].message

    def test_guarded_by_none_opts_out(self, tmp_path):
        assert _conc(tmp_path, **CASES["guarded_by_none"]) == []

    def test_annotation_naming_unknown_lock(self, tmp_path):
        fs = _conc(tmp_path, **CASES["guarded_by_unknown_lock"])
        assert _rules(fs) == ["CL804"]
        assert "_mutex" in fs[0].message

    def test_init_writes_are_construction_time(self, tmp_path):
        assert _conc(tmp_path, **CASES["init_writes"]) == []


# ------------------------------------------------------------- CL805


class TestFaultSiteDrift:
    def test_unknown_site_triggers(self, tmp_path):
        fs = _conc(tmp_path, **CASES["unknown_fault_site"])
        assert _rules(fs) == ["CL805"]
        assert "no.such.site" in fs[0].message

    def test_cataloged_site_is_clean(self, tmp_path):
        assert _conc(tmp_path, **CASES["cataloged_fault_site"]) == []

    def test_catalog_completeness_is_full_scan_only(self, tmp_path):
        # a restricted scan must not demand every cataloged site appear
        assert _conc(tmp_path, **CASES["no_hooks_restricted_scan"]) == []

    def test_every_cataloged_site_has_a_hook_in_the_package(self):
        hook_re = re.compile(r'(?:fire|corrupt)\(\s*"([a-z_.]+)"')
        seen = set()
        for p in PORT.rglob("*.py"):
            seen.update(hook_re.findall(p.read_text(encoding="utf-8")))
        assert set(FAULT_SITES) <= seen, \
            f"cataloged sites without hooks: {set(FAULT_SITES) - seen}"
        assert seen <= set(FAULT_SITES), \
            f"hook sites missing from the catalog: {seen - set(FAULT_SITES)}"
        assert len(FAULT_SITES) == 39


# ----------------------------------------------------- parity with jax


@pytest.mark.parametrize("case", sorted(CASES))
def test_parity_with_the_reference(case, tmp_path):
    """The port's Layer 4 and the reference's report the same (rule,
    file, line) set on every planted snippet."""
    _write(tmp_path, CASES[case])
    ours = {(f.rule, f.path, f.line)
            for f in analyze_concurrency(paths=[tmp_path])}
    theirs = {(f.rule, f.path, f.line)
              for f in ref_analyze_concurrency(paths=[tmp_path])}
    assert ours == theirs


# ------------------------------------------------- live package + CLI


def test_package_is_clean():
    """The shipped-baseline-stays-EMPTY invariant for Layer 4: every
    finding over the port was fixed or carries a rationale directive in
    place."""
    fs = analyze_concurrency()
    assert fs == [], [f.render() for f in fs]


def test_lock_order_edges_shape():
    g = lock_order_edges()
    assert set(g) == {"locks", "edges"}
    key_re = re.compile(r"^[\w/.-]+\.py:\d+$")
    assert g["locks"], "the package defines locks; the table is empty"
    for key in g["locks"]:
        assert key_re.match(key), key
        assert key.startswith("pyconsensus_tpu_torch/"), key
    lock_keys = set(g["locks"])
    for a, b in g["edges"]:
        assert a in lock_keys and b in lock_keys, (a, b)
    names = set(g["locks"].values())
    # the serve tier's identities, and the locks the reference lacks
    assert {"MarketSession._lock", "WorkerBase.declare_lock",
            "build._LOCK", "service._LINALG_LOCK",
            "cuda_kernels._COUNTS_LOCK", "ExecutableCache._lock"} <= names


def test_the_fleet_declares_the_references_lock_orders():
    """The four declared orders of the reference's serve/fleet.py, in
    the port's serve/fleet.py with the port's lock names, each naming a
    lock the static table knows and none contradicted by an edge."""
    from pyconsensus_tpu_torch.analysis.concurrency import (_LOCK_ORDER_RE,
                                                            _Package)
    from pyconsensus_tpu_torch.analysis.rules import scan_targets

    text = (PORT / "serve" / "fleet.py").read_text(encoding="utf-8")
    decls = [m.groups() for m in map(_LOCK_ORDER_RE.search,
                                     text.splitlines()) if m]
    assert decls == [
        ("WorkerBase.declare_lock", "ConsensusFleet._lock"),
        ("ConsensusFleet._lock", "HashRing._lock"),
        ("ConsensusFleet._lock", "ClusterCapacity._lock"),
        ("AutoScaler._lock", "WorkerBase.declare_lock")]
    names = set(lock_order_edges()["locks"].values())
    for a, b in decls:
        assert a in names and b in names
    pkg = _Package(scan_targets())
    assert len([d for d in pkg.order_decls
                if d[2].endswith("serve/fleet.py")]) == 4


def test_cli_select_and_exit_codes(tmp_path, capsys):
    bad = tmp_path / "inv.py"
    bad.write_text(textwrap.dedent("""
        import threading

        class A:
            def __init__(self):
                self.l1 = threading.Lock()
                self.l2 = threading.Lock()

            def one(self):
                with self.l1:
                    with self.l2:
                        pass

            def two(self):
                with self.l2:
                    with self.l1:
                        pass
        """))
    assert cli_run(["--select", "CL801", "--no-baseline", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "CL801" in out
    # --no-concurrency opts the layer out entirely
    assert cli_run(["--select", "CL801", "--no-baseline",
                    "--no-concurrency", str(bad)]) == 0
    # selecting a non-CL80x rule skips the Layer-4 fixpoint's findings
    assert cli_run(["--select", "CL203", "--no-baseline", str(bad)]) == 0


def test_cli_list_rules_shows_layer4(capsys):
    assert cli_run(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "Layer 4 (host concurrency):" in out
    for rid in CONCURRENCY_RULES:
        assert rid in out


# ------------------------------------------------------ runtime witness


@pytest.fixture
def here_witness(monkeypatch):
    """A witness that records locks constructed from THIS test file
    (the package filter is pointed at tests/)."""
    monkeypatch.setattr(witness_mod, "_PKG_DIR",
                        str(pathlib.Path(__file__).resolve().parent))
    w = LockWitness().install()
    yield w
    w.uninstall()


class TestLockWitness:
    def test_records_edges_and_detects_cycle(self, here_witness, tmp_path):
        w = here_witness
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        w.uninstall()
        assert len(w.edges) == 2
        dump = tmp_path / "w" / "witness.json"
        with pytest.raises(WitnessViolation) as ei:
            w.check(dump_path=dump)
        assert ei.value.cycle[0] == ei.value.cycle[-1]
        assert ei.value.dump_path == str(dump)
        # round-trip: the dump carries the full observed relation
        doc = load_witness(dump)
        assert {(e["from"], e["to"]) for e in doc["edges"]} == set(w.edges)
        assert set(doc["locks"]) == set(w.locks)
        for e in doc["edges"]:
            assert e["thread"] == "MainThread"

    def test_union_with_static_graph_detects_contradiction(
            self, here_witness):
        w = here_witness
        a = threading.Lock()
        b = threading.Lock()
        with b:          # observed: B -> A only
            with a:
                pass
        w.uninstall()
        (kb, ka), = list(w.edges)
        # no observed cycle on its own...
        w.check()
        # ...but the static graph documents A < B: the union is cyclic
        static = {"locks": {ka: "T.a", kb: "T.b"}, "edges": [[ka, kb]]}
        with pytest.raises(WitnessViolation) as ei:
            w.check(static=static)
        assert "contradicts the static" in str(ei.value)
        assert "T.a" in str(ei.value) and "T.b" in str(ei.value)

    def test_static_only_cycle_is_not_blamed_on_observation(
            self, here_witness):
        w = here_witness
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        w.uninstall()
        (ka, kb), = list(w.edges)
        static = {"locks": {}, "edges": [["s1", "s2"], ["s2", "s1"],
                                         [ka, kb]]}
        rep = w.check(static=static)
        assert {(e["from"], e["to"]) for e in rep["edges"]} == {(ka, kb)}
        LockWitness().check(static=static)    # zero observed edges

    def test_consistent_run_passes_and_reports(self, here_witness):
        w = here_witness
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        w.uninstall()
        (ka, kb), = list(w.edges)
        rep = w.check(static={"locks": {}, "edges": [[ka, kb]]})
        assert rep["edges"][0]["from"] == ka

    def test_same_creation_site_instances_share_identity(
            self, here_witness):
        w = here_witness

        def make():
            return threading.Lock()

        a, b = make(), make()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        w.uninstall()
        assert w.edges == {}
        w.check()

    def test_condition_wait_releases_held_state(self, here_witness):
        w = here_witness
        cond = threading.Condition()
        other = threading.Lock()
        taken = []

        def waiter():
            with cond:
                cond.wait(timeout=1.0)
            # after the block NOTHING is held: were wait()'s
            # release/re-acquire bookkeeping broken, a leaked cond
            # entry would fabricate a cond -> other edge here
            with other:
                taken.append(True)

        def notifier():
            time.sleep(0.1)
            with cond:
                cond.notify_all()

        t1 = threading.Thread(target=waiter)
        t2 = threading.Thread(target=notifier)
        t1.start(); t2.start(); t1.join(); t2.join()
        w.uninstall()
        assert taken
        assert w.edges == {}
        w.check()

    def test_outside_package_locks_are_untouched(self):
        # default filter: locks built from tests/ are NOT package locks
        w = LockWitness().install()
        try:
            lk = threading.Lock()
            assert not isinstance(lk, witness_mod._WitnessedLock)
        finally:
            w.uninstall()
        assert w.locks == {}

    def test_extension_module_locks_are_not_package_locks(
            self, here_witness):
        """numpy's random generators build a lock of their own with no
        Python frame; it is not charged to the line that called
        default_rng."""
        import numpy as np

        rng = np.random.default_rng(0)
        rng.random()
        lk = threading.Lock()
        # the one lock this file built itself
        assert list(here_witness.locks) == [lk._key]

    def test_install_uninstall_restores_threading(self):
        saved = {k: getattr(threading, k) for k in witness_mod._PATCHED}
        w = LockWitness().install()
        assert threading.Lock is not saved["Lock"]
        w.uninstall()
        for k, v in saved.items():
            assert getattr(threading, k) is v

    def test_witnessed_context_manager_raises_on_cycle(
            self, monkeypatch, tmp_path):
        monkeypatch.setattr(witness_mod, "_PKG_DIR",
                            str(pathlib.Path(__file__).resolve().parent))
        with pytest.raises(WitnessViolation):
            with witnessed(dump_path=tmp_path / "w.json"):
                a = threading.Lock()
                b = threading.Lock()
                with a:
                    with b:
                        pass
                with b:
                    with a:
                        pass
        assert (tmp_path / "w.json").exists()

    def test_witness_proxy_is_a_working_lock(self, here_witness):
        lk = threading.Lock()
        assert isinstance(lk, witness_mod._WitnessedLock)
        assert lk.acquire(timeout=0.5)
        assert lk.locked()
        assert not lk.acquire(blocking=False)
        lk.release()
        assert not lk.locked()
        r = threading.RLock()
        with r:
            with r:      # reentrancy forwards
                pass
        cond = threading.Condition(r)
        with cond:
            assert not cond.wait(timeout=0.05)
        cond2 = threading.Condition(lk)
        with cond2:
            assert not cond2.wait(timeout=0.05)
        assert not lk.locked()

    def test_live_serve_primitives_consistent_with_static_graph(self):
        """The runtime mirror on real port code: the serve queue and
        the fleet's capacity ledger under the witness, checked against
        the static may-hold-before graph."""
        static = static_lock_graph()
        assert static["locks"] and static["edges"]
        with witnessed(static=static) as w:
            from pyconsensus_tpu_torch.serve.admission import \
                ClusterCapacity
            from pyconsensus_tpu_torch.serve.queue import (RequestQueue,
                                                           ResolveRequest)

            q = RequestQueue(max_depth=4)
            q.put(ResolveRequest(reports=[[1.0]]))
            assert q.take(timeout=1.0) is not None
            cap = ClusterCapacity()
            cap.register("w0", queue_slots=4)
            cap.register("w1", queue_slots=4)
            cap.mark_dead("w0")
        assert any(k.startswith("pyconsensus_tpu_torch/serve/queue.py")
                   for k in w.locks)


class TestWitnessPackagePrefix:
    """The reference's prefix (its package directory without a trailing
    separator) also matches ``.../pyconsensus_tpu_torch/...``; the
    port's copy matches its own directory plus the separator."""

    def test_prefix_carries_the_separator(self):
        import os

        assert witness_mod._PKG_DIR == str(PORT.resolve()) + os.sep

    def test_prefix_matches_both_ways(self):
        port_file = str(PORT.resolve() / "serve" / "fleet.py")
        ref_dir = str((REPO / "pyconsensus_tpu").resolve())
        ref_file = str((REPO / "pyconsensus_tpu").resolve() / "serve"
                       / "fleet.py")
        assert witness_mod._in_package(port_file, witness_mod._PKG_DIR)
        assert not witness_mod._in_package(ref_file, witness_mod._PKG_DIR)
        # the reference's directory, as its own witness spells it (no
        # separator), no longer claims the port's files
        assert port_file.startswith(ref_dir)
        assert not witness_mod._in_package(port_file, ref_dir)
        assert witness_mod._in_package(ref_file, ref_dir)

    def test_runtime_records_port_locks_only(self):
        """Under the port's witness a lock the port builds is a proxy,
        and one the reference builds is not."""
        from pyconsensus_tpu.serve.placement import HashRing as RefRing
        from pyconsensus_tpu_torch.serve.placement import HashRing

        w = LockWitness().install()
        try:
            ours = HashRing(["w0", "w1"])
            theirs = RefRing(["w0", "w1"])
        finally:
            w.uninstall()
        assert isinstance(ours._lock, witness_mod._WitnessedLock)
        assert not isinstance(theirs._lock, witness_mod._WitnessedLock)
        assert list(w.locks) == [
            k for k in lock_order_edges()["locks"]
            if k in w.locks and k.startswith(
                "pyconsensus_tpu_torch/serve/placement.py")]
