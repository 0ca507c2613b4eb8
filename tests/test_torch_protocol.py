"""The port's Layer 5 (``pyconsensus_tpu_torch.analysis.protocol``) on
the CPU: the trigger/no-trigger corpus for CL901-CL905 — including the
three real orderings the fleet ships (ack-iff-shipped append,
commit-then-ship resolve, unlink-on-failed-fold) — the pragma
conventions, the live package-is-clean invariant, the static
happens-before export over the port's own classes, the runtime
ProtocolWitness (green over real durable-session operations, a
deliberately reordered mock worker flagged), the repaired handle
surface, the ``--format json`` finding schema, and parity with the
reference's analyzer on every planted snippet."""

import io
import json
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from pyconsensus_tpu.analysis.concurrency import _Package as _RefPackage
from pyconsensus_tpu.analysis.protocol import _analyze as _ref_analyze
from pyconsensus_tpu.analysis.rules import scan_targets as ref_scan_targets
from pyconsensus_tpu_torch.analysis.cli import run as cli_run
from pyconsensus_tpu_torch.analysis.concurrency import _Package
from pyconsensus_tpu_torch.analysis.protocol import (PROTOCOL_RULES,
                                                     _analyze,
                                                     analyze_protocol,
                                                     happens_before)
from pyconsensus_tpu_torch.analysis.protocol_witness import (
    ProtocolWitness, ProtocolWitnessViolation, protocol_witnessed,
    static_protocol_graph)
from pyconsensus_tpu_torch.analysis.rules import scan_targets


@pytest.fixture(autouse=True)
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _write(tmp_path, files):
    for name, src in files.items():
        (tmp_path / f"{name}.py").write_text(textwrap.dedent(src))


def _proto(tmp_path, **files):
    """Write ``name -> source`` modules and run Layer 5 over the dir
    (a path-restricted scan, as the CLI does for explicit targets)."""
    _write(tmp_path, files)
    return analyze_protocol(paths=[tmp_path])


def _proto_full(tmp_path, **files):
    """Same corpus, analyzed as a FULL scan — enables the whole-surface
    directions (dead server entries, handle diff, RETRYABLE coverage,
    package-level idempotency) that a path-restricted run holds back."""
    _write(tmp_path, files)
    pkg = _Package(scan_targets([tmp_path]))
    return _analyze(pkg, None, full_scan=True)


def _rules(findings):
    return sorted({f.rule for f in findings})


# ------------------------------------------------------------ the corpus

SERVER = """
    class Server:
        def handlers(self):
            return {"ping": self.ping}

        def ping(self, params):
            return {}
    """

#: case name -> {module name: source}: path-restricted scans
CASES = {
    "ack_before_journal": {"w": """
        class Worker:
            def handlers(self):
                return {"append": self.append}

            def append(self, params):
                self._fut.set_result(1)
                self._log.journal_block(params["block"])
                return {"total": 1}
        """},
    "reply_before_ship_in_finally": {"w": """
        class Worker:
            def handlers(self):
                return {"append": self.append}

            def append(self, params):
                try:
                    self._log.journal_block(params["block"])
                    return {"total": 1}
                finally:
                    self.shipper.ship_file("s", "r", "p")
        """},
    "ship_before_journal": {"w": """
        class Worker:
            def reordered(self, block):
                self.shipper.ship_file("s", "r", "p")
                self._log.journal_block(block)
        """},
    "swallowing_handler": {"w": """
        class Worker:
            def append(self, block):
                try:
                    self._log.journal_block(block)
                except Exception:
                    pass
        """},
    "ack_iff_shipped_append": {"w": """
        class Worker:
            def handlers(self):
                return {"append": self.append}

            def append(self, params):
                total = self.session.append(
                    params["block"], append_id=params.get("append_id"))
                self._ship_session(params["name"])
                return {"total_events": int(total)}

            def _ship_session(self, name):
                for rel, path in self.pending(name):
                    self.shipper.ship_file(name, rel, path)
        """},
    "commit_then_ship_resolve": {"w": """
        class Worker:
            def handlers(self):
                return {"resolve": self.resolve}

            def resolve(self, params):
                self._log.commit_round(self.ledger)
                self.shipper.ship_file("s", "ledger.npz", "p")
                return {"ok": True}
        """},
    "unlink_on_failed_fold": {"w": """
        class Session:
            def append(self, block, append_id=None):
                rec = self._log.journal_block(block, append_id=append_id)
                try:
                    total = self._fold(block)
                except BaseException:
                    rec.unlink()
                    raise
                return total
        """},
    "fencing_handler": {"w": """
        class Session:
            def resolve(self):
                try:
                    self._log.commit_round(self.ledger)
                except BaseException as exc:
                    self.session.fence(exc)
                    raise
        """},
    "handler_inside_handler": {"w": """
        class Worker:
            def _ship(self, name):
                try:
                    self.shipper.ship_file(name, "r", "p")
                except Exception as exc:
                    try:
                        self.sessions.get(name).fence(exc)
                    except Exception:
                        pass
                    raise
        """},
    "dedupe_fastpath_return": {"w": """
        class Worker:
            def handlers(self):
                return {"append": self.append}

            def append(self, params):
                if params["append_id"] in self._seen:
                    return {"total": self._total, "deduped": True}
                self._log.journal_block(
                    params["block"], append_id=params["append_id"])
                return {"total": 1}
        """},
    "pragma_with_rationale": {"w": """
        class Worker:
            def handlers(self):
                return {"append": self.append}

            def append(self, params):
                self._fut.set_result(1)
                self._log.journal_block(params["block"])  # consensus-lint: disable=CL901 — corpus: deliberate
                return {"total": 1}
        """},
    "client_without_server_entry": {"s": SERVER, "c": """
        class Client:
            def hit(self):
                return self._ctl.call("pong", {})
        """},
    "retry_wrapped_call": {"s": SERVER, "c": """
        class Client:
            def hit(self):
                return retry_call(self._ctl.call, "ping", {},
                                  retries=3, retry_on=(OSError,))
        """},
    "dropped_token": {"w": """
        def append(block, append_id=None):
            return fold(block)
        """},
    "forwarded_token": {"w": """
        def append(log, block, append_id=None):
            return log.journal_block(block, append_id=append_id)

        def wire_forward(ctl, block, append_id=None):
            return ctl.call("append", {"block": block,
                                       "append_id": append_id})
        """},
    "retry_on_taxonomy_error": {"w": """
        class ShedError(RuntimeError):
            error_code = "PYC901"

        def fetch(dial):
            return retry_call(dial, retries=3,
                              retry_on=(OSError, ShedError))
        """},
    "blanket_exception_retry": {"w": """
        def fetch(dial):
            return retry_call(dial, retries=3, retry_on=(Exception,))
        """},
    "transient_oserror_retry": {"w": """
        def fetch(dial):
            return retry_call(dial, retries=3, retry_on=(OSError,))
        """},
    "retry_after_durability": {"w": """
        class Worker:
            def flush(self, block):
                self._log.journal_block(block)
                retry_call(self._send, retries=3, retry_on=(OSError,))
        """},
    "retry_inside_fencing_handler": {"w": """
        class Worker:
            def risky(self, block):
                try:
                    self._log.journal_block(block)
                except Exception as exc:
                    self.session.fence(exc)
                    retry_call(self._send, retry_on=(OSError,))
        """},
}

#: case name -> {module name: source}: whole-package scans
FULL_CASES = {
    "dead_server_entry": {"s": SERVER, "c": """
        class Client:
            def hit(self):
                return self._ctl.call("ping", {})
        """, "s2": """
        class Extra:
            def handlers(self):
                return {"stats": self.stats}

            def stats(self, params):
                return {}
        """},
    "handle_surface_diff": {"h": """
        class WorkerBase:
            def submit(self, req):
                raise NotImplementedError

        class InProc(WorkerBase):
            def submit(self, req):
                return 1

            def drain(self):
                return 0

        class Socket(WorkerBase):
            def submit(self, req):
                return 2
        """},
    "taxonomy_drift": {"e": """
        class ConsensusError(Exception):
            error_code = "PYC000"

            def __init__(self, message="", **context):
                super().__init__(message)
                self.context = context

        class GoodError(ConsensusError):
            error_code = "PYC901"

        class OrphanError(ConsensusError):
            error_code = "PYC902"

        class DupError(ConsensusError):
            error_code = "PYC901"

        class FatError(ConsensusError):
            error_code = "PYC903"

            def __init__(self, message, extra):
                super().__init__(message)
                self.extra = extra

        ERROR_CODES = {cls.error_code: cls for cls in (
            ConsensusError, GoodError, DupError, FatError,
            GhostError)}
        """},
    "retryable_codes": {"e": """
        class ConsensusError(Exception):
            error_code = "PYC000"

            def __init__(self, message="", **context):
                self.context = context

        class ShedError(ConsensusError):
            error_code = "PYC901"

        class QuietError(ConsensusError):
            error_code = "PYC902"

        ERROR_CODES = {cls.error_code: cls for cls in (
            ConsensusError, ShedError, QuietError)}

        RETRYABLE_CODES = ("PYC901", "PYC999")

        def shed():
            raise ShedError("full", retry_after_s=0.5)

        def quiet():
            raise QuietError("odd", retry_after_s=1.0)
        """},
    "missing_dedupe_guard_and_seed": {"w": """
        def append(log, block, append_id=None):
            return log.journal_block(block, append_id=append_id)
        """},
    "guard_and_seed_present": {"w": """
        def append(log, seen, block, append_id=None):
            if append_id is not None and append_id in seen:
                return 0
            rec = log.journal_block(block, append_id=append_id)
            seen.add(append_id)
            return rec
        """},
}


# ------------------------------------------------------------- CL901


class TestDurabilityOrdering:
    def test_ack_before_journal_in_dispatch_handler_triggers(self, tmp_path):
        """A dispatch handler resolves the Future BEFORE the journal
        write. The finding names both events."""
        fs = _proto(tmp_path, **CASES["ack_before_journal"])
        assert "CL901" in _rules(fs)
        f = next(f for f in fs if f.rule == "CL901")
        assert "set_result" in f.message and "journal_block" in f.message

    def test_reply_return_before_ship_in_finally_triggers(self, tmp_path):
        """Returning from a dispatch handler IS the ack — a ship parked
        in a ``finally`` after the return is an ack-before-ship."""
        fs = _proto(tmp_path, **CASES["reply_before_ship_in_finally"])
        assert any(f.rule == "CL901" and "ship" in f.message for f in fs)

    def test_ship_before_journal_triggers(self, tmp_path):
        fs = _proto(tmp_path, **CASES["ship_before_journal"])
        assert any(f.rule == "CL901" and "ship_file" in f.message
                   and "journal_block" in f.message for f in fs)

    def test_swallowing_handler_on_durability_path_triggers(self, tmp_path):
        fs = _proto(tmp_path, **CASES["swallowing_handler"])
        assert any(f.rule == "CL901" and "neither re-raises" in f.message
                   for f in fs)

    def test_real_ordering_ack_iff_shipped_append_is_clean(self, tmp_path):
        assert _proto(tmp_path, **CASES["ack_iff_shipped_append"]) == []

    def test_real_ordering_commit_then_ship_resolve_is_clean(self, tmp_path):
        assert _proto(tmp_path, **CASES["commit_then_ship_resolve"]) == []

    def test_real_ordering_unlink_on_failed_fold_is_clean(self, tmp_path):
        assert _proto(tmp_path, **CASES["unlink_on_failed_fold"]) == []

    def test_fencing_handler_is_clean(self, tmp_path):
        assert _proto(tmp_path, **CASES["fencing_handler"]) == []

    def test_handler_inside_handler_is_exempt(self, tmp_path):
        assert _proto(tmp_path, **CASES["handler_inside_handler"]) == []

    def test_dedupe_fastpath_return_is_clean(self, tmp_path):
        assert _proto(tmp_path, **CASES["dedupe_fastpath_return"]) == []

    def test_pragma_with_rationale_suppresses(self, tmp_path):
        fs = _proto(tmp_path, **CASES["pragma_with_rationale"])
        assert [f for f in fs if f.rule == "CL901"] == []


# ------------------------------------------------------------- CL902


class TestRpcSurfaceDrift:
    def test_client_method_without_server_entry_triggers(self, tmp_path):
        fs = _proto(tmp_path, **CASES["client_without_server_entry"])
        assert any(f.rule == "CL902" and "'pong'" in f.message
                   for f in fs)

    def test_retry_wrapped_call_counts_as_client_use(self, tmp_path):
        fs = _proto(tmp_path, **CASES["retry_wrapped_call"])
        assert [f for f in fs if f.rule == "CL902"] == []

    def test_dead_server_entry_full_scan_only(self, tmp_path):
        fs = _proto_full(tmp_path, **FULL_CASES["dead_server_entry"])
        assert any(f.rule == "CL902" and "'stats'" in f.message
                   and "no client invocation" in f.message for f in fs)

    def test_handle_surface_diff_full_scan_only(self, tmp_path):
        fs = _proto_full(tmp_path, **FULL_CASES["handle_surface_diff"])
        assert any(f.rule == "CL902" and "'drain'" in f.message
                   and "Socket" in f.message for f in fs)

    def test_fleet_worker_mirrors_the_socket_handle_surface(self):
        """The repaired drift: the in-process FleetWorker lacked the
        socket handle's metrics_render; now both transports' handles
        answer it with the same shape."""
        from pyconsensus_tpu_torch.serve import FleetWorker, ServeConfig
        from pyconsensus_tpu_torch.serve.transport.supervisor import \
            SocketWorkerHandle

        assert callable(getattr(FleetWorker, "metrics_render", None))
        assert callable(getattr(SocketWorkerHandle, "metrics_render"))
        w = FleetWorker("w0", ServeConfig(warmup=()), device="cpu")
        out = w.metrics_render()
        assert set(out) == {"worker", "text"} and out["worker"] == "w0"
        assert isinstance(out["text"], str)
        fs = [f for f in analyze_protocol() if f.rule == "CL902"]
        assert fs == [], [f.render() for f in fs]


# ------------------------------------------------------------- CL903


class TestErrorTaxonomy:
    def test_taxonomy_drift_directions(self, tmp_path):
        fs = _proto_full(tmp_path, **FULL_CASES["taxonomy_drift"])
        msgs = [f.message for f in fs if f.rule == "CL903"]
        assert any("OrphanError" in m and "not in the ERROR_CODES" in m
                   for m in msgs)
        assert any("GhostError" in m and "dead registry entry" in m
                   for m in msgs)
        assert any("'PYC901'" in m and "claimed by both" in m
                   for m in msgs)
        assert any("FatError.__init__" in m and "not marshalable" in m
                   for m in msgs)

    def test_retryable_codes_consistency(self, tmp_path):
        fs = _proto_full(tmp_path, **FULL_CASES["retryable_codes"])
        msgs = [f.message for f in fs if f.rule == "CL903"]
        assert any("'PYC999'" in m and "no scanned taxonomy class" in m
                   for m in msgs)
        assert any("PYC902" in m and "not in RETRYABLE_CODES" in m
                   for m in msgs)
        assert not any("'PYC901'" in m for m in msgs)


# ------------------------------------------------------------- CL904


class TestIdempotencyCoverage:
    def test_dropped_token_triggers(self, tmp_path):
        fs = _proto(tmp_path, **CASES["dropped_token"])
        assert any(f.rule == "CL904" and "drops it" in f.message
                   for f in fs)

    def test_forwarded_token_is_clean(self, tmp_path):
        fs = _proto(tmp_path, **CASES["forwarded_token"])
        assert [f for f in fs if f.rule == "CL904"] == []

    def test_missing_dedupe_guard_and_seed_full_scan(self, tmp_path):
        fs = _proto_full(tmp_path,
                         **FULL_CASES["missing_dedupe_guard_and_seed"])
        msgs = [f.message for f in fs if f.rule == "CL904"]
        assert any("membership-tests" in m for m in msgs)
        assert any("seeds a dedupe set" in m for m in msgs)
        assert all(f.path == "protocol:idempotency"
                   for f in fs if f.rule == "CL904")

    def test_guard_and_seed_present_is_clean(self, tmp_path):
        fs = _proto_full(tmp_path, **FULL_CASES["guard_and_seed_present"])
        assert [f for f in fs if f.rule == "CL904"] == []


# ------------------------------------------------------------- CL905


class TestRetryScope:
    def test_retry_on_taxonomy_error_triggers(self, tmp_path):
        fs = _proto(tmp_path, **CASES["retry_on_taxonomy_error"])
        assert any(f.rule == "CL905" and "ShedError" in f.message
                   for f in fs)

    def test_blanket_exception_retry_triggers(self, tmp_path):
        fs = _proto(tmp_path, **CASES["blanket_exception_retry"])
        assert any(f.rule == "CL905" and "Exception" in f.message
                   for f in fs)

    def test_transient_oserror_retry_is_clean(self, tmp_path):
        fs = _proto(tmp_path, **CASES["transient_oserror_retry"])
        assert [f for f in fs if f.rule == "CL905"] == []

    def test_retry_after_durability_point_triggers(self, tmp_path):
        fs = _proto(tmp_path, **CASES["retry_after_durability"])
        assert any(f.rule == "CL905"
                   and "after the durability point" in f.message
                   for f in fs)

    def test_retry_inside_fencing_handler_triggers(self, tmp_path):
        fs = _proto(tmp_path, **CASES["retry_inside_fencing_handler"])
        assert any(f.rule == "CL905" and "fencing handler" in f.message
                   for f in fs)


# ----------------------------------------------------- parity with jax


def _keys(findings):
    return {(f.rule, f.path, f.line) for f in findings}


@pytest.mark.parametrize("case", sorted(CASES))
def test_parity_with_the_reference(case, tmp_path):
    """The port's Layer 5 and the reference's report the same (rule,
    file, line) set on every planted snippet (path-restricted scans)."""
    from pyconsensus_tpu.analysis.protocol import \
        analyze_protocol as ref_analyze_protocol

    _write(tmp_path, CASES[case])
    assert _keys(analyze_protocol(paths=[tmp_path])) == \
        _keys(ref_analyze_protocol(paths=[tmp_path]))


@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_parity_with_the_reference_full_scan(case, tmp_path):
    _write(tmp_path, FULL_CASES[case])
    ours = _analyze(_Package(scan_targets([tmp_path])), None,
                    full_scan=True)
    theirs = _ref_analyze(_RefPackage(ref_scan_targets([tmp_path])), None,
                          full_scan=True)
    assert _keys(ours) == _keys(theirs)


# ---------------------------------------------------- the live package


class TestLivePackage:
    def test_package_is_clean(self):
        """The shipped baseline stays EMPTY: Layer 5 over the port —
        every finding was fixed or carries its rationale in place."""
        fs = analyze_protocol()
        assert fs == [], [f.render() for f in fs]

    def test_rules_registered(self):
        assert set(PROTOCOL_RULES) == {"CL901", "CL902", "CL903",
                                       "CL904", "CL905"}
        assert all(sev == "error" for sev, _ in PROTOCOL_RULES.values())

    def test_happens_before_matches_shipped_orderings(self):
        """The static graph states the real orderings over the port's
        own classes, the reference's orders exactly."""
        ops = happens_before()["ops"]
        assert ops["session.append"]["order"] == ["journal", "ack"]
        assert ops["session.resolve"]["order"] == ["commit", "ack"]
        assert ops["worker.append"]["order"] == ["journal", "ship", "ack"]
        assert ops["worker.submit_session"]["order"] == ["ship", "ack"]
        assert ops["worker.create_session"]["order"] == \
            ["commit", "ship", "ack"]
        for spec in ops.values():
            assert spec["function"].startswith("pyconsensus_tpu_torch/")
            assert ["journal", "ack"] not in [[b, a]
                                              for a, b in spec["edges"]]


# ------------------------------------------------------------ witness


class TestProtocolWitness:
    def _session(self, root, name="pw", n=6):
        from pyconsensus_tpu_torch.serve.failover import DurableSession

        return DurableSession.create(root, name, n, device="cpu")

    def test_green_over_real_session_ops(self, tmp_path):
        """Real DurableSession append + resolve under the witness:
        observed orders consistent with the static graph."""
        rng = np.random.default_rng(0)
        static = static_protocol_graph()
        with protocol_witnessed(static=static,
                                dump_path=tmp_path / "pw.json") as w:
            s = self._session(tmp_path / "log")
            s.append(rng.choice([0.0, 1.0], size=(6, 4)))
            s.resolve()
        kinds = {r["kind"]: r["events"] for r in w.report()["ops"]}
        assert kinds["session.append"] == ["journal", "ack"]
        assert kinds["session.resolve"] == ["commit", "ack"]

    def test_reordered_mock_worker_is_flagged(self, tmp_path):
        """A mock worker that SHIPS before it journals — the witness
        must contradict the static ``journal -> ship`` edge of
        worker.append."""
        from pyconsensus_tpu_torch.serve.transport.shipping import (
            LogShipper, ShippingReceiver)

        from pyconsensus_tpu_torch.tune.fingerprint import \
            runtime_fingerprint

        rng = np.random.default_rng(1)
        static = static_protocol_graph()
        fp = runtime_fingerprint("cpu")
        rcv = ShippingReceiver(tmp_path / "shipped", fingerprint=fp).start()
        try:
            s = self._session(tmp_path / "log", name="re")
            s.append(rng.choice([0.0, 1.0], size=(6, 4)))
            stale = sorted((tmp_path / "log" / "re").rglob("*.npz"))[0]
            w = ProtocolWitness().install()
            try:
                shipper = LogShipper(rcv.host, rcv.port,
                                     expect_fingerprint=fp)
                with w.op("worker.append"):
                    # the reorder: ship a record, THEN journal the next
                    shipper.ship_file("re", stale.name, stale)
                    s.append(rng.choice([0.0, 1.0], size=(6, 4)))
                shipper.close()
            finally:
                w.uninstall()
            with pytest.raises(ProtocolWitnessViolation) as ei:
                w.check(static=static, dump_path=tmp_path / "viol.json")
            assert ei.value.op == "worker.append"
            assert ei.value.edge == ("journal", "ship")
            assert ei.value.events[:2] == ["ship", "journal"]
            dumped = json.loads(
                pathlib.Path(ei.value.dump_path).read_text())
            assert any(r["kind"] == "worker.append"
                       for r in dumped["ops"])
        finally:
            rcv.close()

    def test_failed_op_is_unconstrained(self, tmp_path):
        static = static_protocol_graph()
        w = ProtocolWitness().install()
        try:
            with pytest.raises(RuntimeError):
                with w.op("worker.append"):
                    w._record("ship")     # partial, then death
                    raise RuntimeError("kill -9 stand-in")
        finally:
            w.uninstall()
        rec = w.report()["ops"][0]
        assert rec["ok"] is False and "ack" not in rec["events"]
        w.check(static=static)

    def test_unscoped_events_are_counted_not_judged(self, tmp_path):
        static = static_protocol_graph()
        with protocol_witnessed(static=static) as w:
            self._session(tmp_path / "log", name="gen")
        assert w.report()["unscoped"].get("commit", 0) >= 1

    def test_uninstall_restores_methods(self):
        from pyconsensus_tpu_torch.serve.failover import DurableSession

        real = DurableSession.append
        w = ProtocolWitness().install()
        assert DurableSession.append is not real
        w.uninstall()
        assert DurableSession.append is real


# --------------------------------------------------- --format json


class TestJsonOutput:
    CORPUS = """
        def fetch(dial):
            return retry_call(dial, retries=3, retry_on=(Exception,))
        """

    def _run(self, args):
        buf = io.StringIO()
        code = cli_run(args, stdout=buf)
        return code, buf.getvalue()

    def test_schema_and_exit_code(self, tmp_path):
        target = tmp_path / "m.py"
        target.write_text(textwrap.dedent(self.CORPUS))
        code, out = self._run(["--format", "json", "--no-baseline",
                               "--select", "CL905", str(target)])
        assert code == 1
        payload = json.loads(out)
        assert payload["schema"] == 1
        assert payload["stale_baseline"] == []
        (row,) = payload["findings"]
        assert set(row) == {"rule", "path", "line", "severity",
                            "message", "snippet", "fingerprint", "state"}
        assert row["rule"] == "CL905" and row["state"] == "new"
        assert row["severity"] == "error" and row["line"] > 0
        assert "retry_call" in row["snippet"]
        assert len(payload["new"]) == 1
        assert payload["baselined"] == 0

    def test_baselined_state_and_exit_zero(self, tmp_path):
        target = tmp_path / "m.py"
        target.write_text(textwrap.dedent(self.CORPUS))
        baseline = tmp_path / "baseline.json"
        code, _ = self._run(["--update-baseline", "--baseline",
                             str(baseline), "--select", "CL905",
                             str(target)])
        assert code == 0
        code, out = self._run(["--format", "json", "--baseline",
                               str(baseline), "--select", "CL905",
                               str(target)])
        assert code == 0
        payload = json.loads(out)
        (row,) = payload["findings"]
        assert row["state"] == "baselined"
        assert payload["new"] == [] and payload["baselined"] == 1

    def test_clean_tree_empty_findings(self, tmp_path):
        target = tmp_path / "m.py"
        target.write_text("def ok():\n    return 1\n")
        code, out = self._run(["--format", "json", "--no-baseline",
                               str(target)])
        assert code == 0
        assert json.loads(out)["findings"] == []
