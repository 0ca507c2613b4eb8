"""The port's socket transport (``pyconsensus_tpu_torch.serve.transport``:
``wire``, ``rpc``, ``shipping``, ``worker``, ``supervisor``) against the
JAX package's, on the CPU in float64, mirroring ``tests/test_transport.py``:

- frames: round trips bit for bit under JSON and (where this interpreter
  has it) msgpack, and every refusal (truncation, bit flip, foreign magic
  or version, the oversize edges) with the reference's PYC601 context; a
  ``torch.Tensor`` is refused by the encoder, never stringified;
- across packages: a frame either package's ``send_msg`` writes decodes
  in the other's ``recv_msg`` with the same codec, marshalled errors
  cross both ways with one code, and a port router refuses a reference
  worker's hello with PYC602 naming the first field that differs;
- the handshake (every fingerprint field takes part, the protocol
  version is refused), the RPC layer (pool, bounded reconnect, a refused
  handshake not retried, the latency histogram) and the four fault sites;
- shipping: ship and adopt bit for bit, a bit flip or a path escape
  refused, a torn shipped log refused at adopt, an idempotency token that
  survives the replay, a failed ship that fences its session;
- a socket fleet of two real ``--device cpu`` worker processes (no JAX in
  them): stateless results bit for bit the in-process fleet's and the
  port's direct ``Oracle`` on the direct path, within the serve band of
  the reference's ``Oracle``; session rounds bit for bit the in-process
  fleet's; the merged metric view's per-worker series; the merged trace
  forest; a SIGKILL of a worker process mid-traffic and mid-session, the
  standby adopting the shipped log, nothing abandoned;
- the worker entry point (``READY <port>``, the console script) and the
  refusals: a card worker without a card fails its spawn.
"""

import hashlib
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pyconsensus_tpu import Oracle as RefOracle
from pyconsensus_tpu.faults import ERROR_CODES as REF_ERROR_CODES
from pyconsensus_tpu.serve.transport import wire as ref_wire
from pyconsensus_tpu_torch import Oracle, faults, obs
from pyconsensus_tpu_torch.faults import (ERROR_CODES,
                                          CheckpointCorruptionError,
                                          FailoverInProgressError,
                                          HandshakeError, InputError,
                                          ServiceOverloadError,
                                          TransportError, WorkerLostError)
from pyconsensus_tpu_torch.serve import (ConsensusFleet, DurableSession,
                                         FleetConfig, ServeConfig)
from pyconsensus_tpu_torch.serve.loadgen import RETRYABLE_CODES
from pyconsensus_tpu_torch.serve.transport import (SocketTransport, wire,
                                                   worker)
from pyconsensus_tpu_torch.serve.transport.rpc import RpcClient, RpcServer
from pyconsensus_tpu_torch.serve.transport.shipping import (LogShipper,
                                                            ShippingReceiver,
                                                            adopt_shipped)
from pyconsensus_tpu_torch.serve.transport.supervisor import (
    WorkerProcess, worker_subprocess_env)
from pyconsensus_tpu_torch.tune.fingerprint import runtime_fingerprint
from test_torch_fleet import _assert_parity, _corpus
from torch_witness import torch_protocol_witness  # noqa: F401


@pytest.fixture(autouse=True)
def _witnessed(torch_protocol_witness):
    """Every test here runs under the port's protocol witness (the
    counterpart of the reference's test_transport opt-in)."""
    yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: wait bound of every future in this file
WAIT_S = 120
#: the in-process and socket fleets' worker policy
WORKER_CFG = ServeConfig(warmup=(), batch_window_ms=1.0)
#: a staleness bound no loaded test machine reaches: deaths here are
#: SIGKILLs, which the fleet sees at once
HEARTBEAT_S = 120.0


@pytest.fixture(autouse=True)
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def fp() -> dict:
    """This process's fingerprint on the CPU (float64 under the
    fixture)."""
    return runtime_fingerprint("cpu")


def pair():
    a, b = socket.socketpair()
    a.settimeout(10.0)
    b.settimeout(10.0)
    return a, b


def header(version, codec, length, digest):
    return struct.Struct(">4sBBL32s").pack(wire.MAGIC, version, codec,
                                           length, digest)


def codec_ctx(monkeypatch, codec):
    """Pin both packages' codec: ``json`` drops msgpack from both."""
    if codec == "json":
        monkeypatch.setattr(wire, "_msgpack", None)
        monkeypatch.setattr(ref_wire, "_msgpack", None)
    else:
        pytest.importorskip("msgpack")


def sample_message(seed):
    rng = np.random.default_rng(seed)
    arrays = {
        "f64": rng.random((rng.integers(1, 9), rng.integers(1, 9))),
        "f32": rng.random(5).astype(np.float32),
        "i8": rng.integers(-2, 3, size=(3, 4)).astype(np.int8),
        "i64": rng.integers(0, 100, size=7),
        "bool": rng.random(6) < 0.5,
        "nan": np.array([np.nan, np.inf, -np.inf, -0.0, 0.5]),
    }
    msg = {"arrays": arrays, "n": int(rng.integers(100)),
           "f": float(rng.random()), "s": "héllo",
           "b": bytes(rng.integers(0, 256, size=17, dtype=np.uint8)),
           "none": None, "flag": True,
           "nested": [1, {"deep": arrays["f64"][0]}, "x"]}
    return msg, arrays


def assert_message(out, msg, arrays):
    for key, arr in arrays.items():
        got = out["arrays"][key]
        assert got.dtype == arr.dtype, key
        np.testing.assert_array_equal(got, arr, err_msg=key)
        assert got.tobytes() == arr.tobytes(), key
    assert np.signbit(out["arrays"]["nan"][3])
    assert out["n"] == msg["n"] and out["f"] == msg["f"]
    assert out["s"] == msg["s"] and out["b"] == msg["b"]
    assert out["none"] is None and out["flag"] is True
    np.testing.assert_array_equal(out["nested"][1]["deep"],
                                  arrays["f64"][0])


# -- wire frames -------------------------------------------------------------


class TestWireFrames:
    @pytest.mark.parametrize("codec", ["msgpack", "json"])
    @pytest.mark.parametrize("seed", range(4))
    def test_round_trip_bit_for_bit(self, codec, seed, monkeypatch):
        codec_ctx(monkeypatch, codec)
        msg, arrays = sample_message(seed)
        a, b = pair()
        wire.send_msg(a, msg)
        assert_message(wire.recv_msg(b), msg, arrays)
        assert wire.codec_name() == codec

    def test_clean_close_returns_none(self):
        a, b = pair()
        a.close()
        assert wire.recv_msg(b) is None

    def test_truncated_frame_refused(self):
        a, b = pair()
        payload = b"x" * 100
        a.sendall(header(wire.WIRE_PROTOCOL_VERSION, 0, 200,
                         hashlib.sha256(payload).digest()) + payload)
        a.close()
        with pytest.raises(TransportError) as ei:
            wire.recv_msg(b)
        assert ei.value.error_code == "PYC601"
        assert ei.value.context["reason"] == "truncated"
        assert ei.value.context["got"] == 100

    def test_bit_flipped_frame_refused(self):
        a, b = pair()
        codec, payload = wire._pack({"v": list(range(32))})
        damaged = bytearray(payload)
        damaged[len(damaged) // 2] ^= 0x10
        a.sendall(header(wire.WIRE_PROTOCOL_VERSION, codec, len(damaged),
                         hashlib.sha256(payload).digest()) + bytes(damaged))
        with pytest.raises(TransportError) as ei:
            wire.recv_msg(b)
        assert ei.value.context["reason"] == "digest"

    def test_foreign_magic_refused(self):
        a, b = pair()
        a.sendall(b"HTTP" + b"\x00" * 38)
        with pytest.raises(TransportError) as ei:
            wire.recv_msg(b)
        assert ei.value.context["reason"] == "magic"

    def test_foreign_version_refused(self):
        a, b = pair()
        payload = b"{}"
        a.sendall(header(wire.WIRE_PROTOCOL_VERSION + 9, 0, len(payload),
                         hashlib.sha256(payload).digest()) + payload)
        with pytest.raises(TransportError) as ei:
            wire.recv_msg(b)
        assert ei.value.context["reason"] == "version"
        assert ei.value.context["found"] == wire.WIRE_PROTOCOL_VERSION + 9

    def test_unknown_codec_refused(self):
        a, b = pair()
        payload = b"{}"
        a.sendall(header(wire.WIRE_PROTOCOL_VERSION, 7, len(payload),
                         hashlib.sha256(payload).digest()) + payload)
        with pytest.raises(TransportError) as ei:
            wire.recv_msg(b)
        assert ei.value.context["reason"] == "codec"

    def test_oversized_frame_refused_before_read(self):
        a, b = pair()
        a.sendall(header(wire.WIRE_PROTOCOL_VERSION, 0,
                         wire.MAX_FRAME_BYTES + 1, b"\x00" * 32))
        with pytest.raises(TransportError) as ei:
            wire.recv_msg(b)
        assert ei.value.context["reason"] == "oversized"

    def test_oversized_boundary_exact_at_limit_accepted(self):
        obj = {"k": "v" * 100}
        _, payload = wire._pack(obj)
        a, b = pair()
        wire.send_msg(a, obj)
        assert wire.recv_msg(b, max_bytes=len(payload)) == obj

    def test_oversized_boundary_limit_plus_one_refused_with_context(self):
        obj = {"k": "v" * 100}
        _, payload = wire._pack(obj)
        a, b = pair()
        wire.send_msg(a, obj)
        with pytest.raises(TransportError) as ei:
            wire.recv_msg(b, max_bytes=len(payload) - 1)
        assert ei.value.context["reason"] == "oversized"
        assert ei.value.context["length"] == len(payload)
        assert ei.value.context["limit"] == len(payload) - 1

    def test_a_1024x4096_request_fits_a_json_frame(self, monkeypatch):
        """The chip's request, 32 MiB of float64, is about 43 MiB as a
        JSON frame: inside the bounded read, and bit for bit after it."""
        codec_ctx(monkeypatch, "json")
        x = np.random.default_rng(0).random((1024, 4096))
        codec, payload = wire._pack({"reports": x})
        assert codec == wire._CODEC_JSON
        assert 4 * x.nbytes / 3 < len(payload) < wire.MAX_FRAME_BYTES
        got = wire._unpack(codec, payload)["reports"]
        assert got.tobytes() == x.tobytes()

    def test_refusals_counted(self):
        before = obs.value("pyconsensus_transport_refused_total",
                           reason="magic") or 0
        a, b = pair()
        a.sendall(b"XXXX" + b"\x00" * 38)
        with pytest.raises(TransportError):
            wire.recv_msg(b)
        assert obs.value("pyconsensus_transport_refused_total",
                         reason="magic") == before + 1

    def test_tensor_refused_by_the_encoder(self):
        """A tensor never crosses: the worker fetches it first
        (``worker.host_arrays``); one that reaches the encoder raises,
        and no byte is sent."""
        a, b = pair()
        t = torch.arange(4.0)
        with pytest.raises(TransportError) as ei:
            wire.send_msg(a, {"result": {"x": t}})
        assert ei.value.context["reason"] == "encode"
        a.close()
        assert wire.recv_msg(b) is None
        host = worker.host_arrays({"x": t, "y": [t, 3], "z": "s"})
        assert isinstance(host["x"], np.ndarray)
        assert host["x"].tobytes() == t.numpy().tobytes()
        assert host["y"][1] == 3 and host["z"] == "s"


class TestAcrossPackages:
    @pytest.mark.parametrize("codec", ["msgpack", "json"])
    @pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
    def test_frames_cross_both_ways(self, codec, direction, monkeypatch):
        codec_ctx(monkeypatch, codec)
        msg, arrays = sample_message(11)
        a, b = pair()
        send, recv = ((ref_wire, wire) if direction == "ref_to_port"
                      else (wire, ref_wire))
        send.send_msg(a, msg)
        assert_message(recv.recv_msg(b), msg, arrays)
        # the frame bytes themselves are the same in both packages
        assert wire._pack(msg) == ref_wire._pack(msg)

    @pytest.mark.parametrize("code", sorted(ERROR_CODES))
    def test_marshalled_errors_cross_both_ways(self, code):
        assert code in REF_ERROR_CODES
        exc = ERROR_CODES[code]("the message", worker="w1",
                                retry_after_s=0.5, rows=[1, 2])
        theirs = ref_wire.unmarshal_error(wire.marshal_error(exc))
        assert theirs.error_code == code
        assert type(theirs) is REF_ERROR_CODES[code]
        assert theirs.context["retry_after_s"] == 0.5
        back = wire.unmarshal_error(ref_wire.marshal_error(theirs))
        assert type(back) is ERROR_CODES[code]
        assert back.context == exc.context
        assert "the message" in str(back)

    def test_reference_worker_refused_naming_the_first_field(self):
        """The reference's worker answers with its jax fingerprint; the
        port's router refuses it at connect with PYC602 naming the first
        field, in sorted order, where the two differ."""
        from pyconsensus_tpu.tune.fingerprint import \
            runtime_fingerprint as ref_fingerprint

        mine, theirs = fp(), ref_fingerprint()
        first = next(f for f in sorted(set(mine) | set(theirs))
                     if mine.get(f) != theirs.get(f))
        a, b = pair()
        t = threading.Thread(
            target=lambda: ref_wire.server_handshake(b, "ref-w0"))
        t.start()
        with pytest.raises(HandshakeError) as ei:
            wire.client_hello(a, mine)
        t.join(10)
        assert ei.value.error_code == "PYC602"
        assert ei.value.context["field"] == first


# -- error marshalling -------------------------------------------------------


class TestErrorMarshalling:
    @pytest.mark.parametrize("code", sorted(ERROR_CODES))
    def test_every_taxonomy_code_round_trips(self, code):
        cls = ERROR_CODES[code]
        exc = cls("the message", worker="w1", retry_after_s=0.75,
                  reason="queue_full", rows=[1, 2])
        out = wire.unmarshal_error(wire.marshal_error(exc))
        assert type(out) is cls
        assert out.error_code == code
        assert "the message" in str(out)
        assert out.context["worker"] == "w1"
        assert out.context["retry_after_s"] == 0.75
        assert out.context["rows"] == [1, 2]

    def test_retryable_fleet_errors_cross_intact(self):
        for cls, code in ((WorkerLostError, "PYC501"),
                          (FailoverInProgressError, "PYC502"),
                          (ServiceOverloadError, "PYC401")):
            out = wire.unmarshal_error(wire.marshal_error(
                cls("x", retry_after_s=1.5)))
            assert type(out) is cls and out.error_code == code
            assert out.context["retry_after_s"] == 1.5

    def test_numpy_context_values_sanitized(self):
        exc = InputError("bad", shape=(np.int64(3), np.int64(4)),
                         arr=np.arange(3), weird=object())
        out = wire.unmarshal_error(wire.marshal_error(exc))
        assert out.context["shape"] == [3, 4]
        assert out.context["arr"] == [0, 1, 2]
        assert isinstance(out.context["weird"], str)

    def test_non_taxonomy_error_becomes_pyc601(self):
        out = wire.unmarshal_error(wire.marshal_error(KeyError("missing")))
        assert isinstance(out, TransportError)
        assert out.context["remote_type"] == "KeyError"


# -- handshake ---------------------------------------------------------------


def run_server(sock, fingerprint):
    out = {}

    def serve():
        try:
            out["hello"] = wire.server_handshake(sock, "w0", fingerprint)
        except Exception as exc:    # noqa: BLE001 — the test observes it
            out["error"] = exc
    t = threading.Thread(target=serve)
    t.start()
    return t, out


class TestHandshake:
    def test_matching_fingerprint_accepted(self):
        a, b = pair()
        t, out = run_server(b, fp())
        hello = wire.client_hello(a, fp())
        t.join(5)
        assert "error" not in out
        assert hello["worker"] == "w0"
        assert hello["fingerprint"] == fp()

    def test_fingerprint_names_no_device_count_or_index(self):
        assert set(fp()) == {"package", "torch", "cuda", "platform",
                             "generation", "dtype", "kernels"}
        assert fp()["platform"] == "cpu" and fp()["dtype"] == "float64"

    @pytest.mark.parametrize("field", sorted(
        ["package", "torch", "cuda", "platform", "generation", "dtype",
         "kernels"]))
    def test_every_fingerprint_field_participates(self, field):
        foreign = dict(fp())
        foreign[field] = "flipped"
        a, b = pair()
        t, _ = run_server(b, foreign)
        with pytest.raises(HandshakeError) as ei:
            wire.client_hello(a, fp())
        t.join(5)
        assert ei.value.error_code == "PYC602"
        assert ei.value.context["field"] == field
        assert ei.value.context["found"] == "flipped"

    def test_dtype_follows_the_default(self):
        torch.set_default_dtype(torch.float32)
        assert runtime_fingerprint("cpu")["dtype"] == "float32"

    def test_protocol_version_refused_by_worker(self):
        a, b = pair()
        t, out = run_server(b, fp())
        wire.send_msg(a, {"hello": {
            "protocol": wire.WIRE_PROTOCOL_VERSION + 1,
            "fingerprint": {}}})
        reply = wire.recv_msg(a)
        t.join(5)
        exc = wire.unmarshal_error(reply["error"])
        assert isinstance(exc, HandshakeError)
        assert exc.context["field"] == "protocol"
        assert isinstance(out.get("error"), HandshakeError)


# -- rpc ---------------------------------------------------------------------


@pytest.fixture
def echo_server():
    def boom(params):
        raise ServiceOverloadError("shed", reason="queue_full",
                                   retry_after_s=0.25)

    server = RpcServer({
        "echo": lambda params: params,
        "ping": lambda params: {"ok": True, "queue_depth": 0},
        "boom": boom,
        "tensor": lambda params: {"x": torch.ones(2)},
    }, name="echo", fingerprint=fp()).start()
    yield server
    server.close()


def client(server, **kw):
    kw.setdefault("label", "echo")
    kw.setdefault("expect_fingerprint", fp())
    return RpcClient("127.0.0.1", server.port, **kw)


class TestRpc:
    def test_call_round_trip(self, echo_server):
        c = client(echo_server)
        arr = np.arange(12.0).reshape(3, 4)
        out = c.call("echo", {"x": arr, "k": 5})
        np.testing.assert_array_equal(out["x"], arr)
        assert out["k"] == 5
        c.close()

    def test_taxonomy_error_crosses(self, echo_server):
        c = client(echo_server)
        with pytest.raises(ServiceOverloadError) as ei:
            c.call("boom")
        assert ei.value.context["retry_after_s"] == 0.25
        # the connection survives a marshalled error
        assert c.call("ping")["ok"] is True
        c.close()

    def test_unknown_method_is_pyc601(self, echo_server):
        c = client(echo_server)
        with pytest.raises(TransportError) as ei:
            c.call("no_such")
        assert ei.value.error_code == "PYC601"
        assert ei.value.context["reason"] == "method"
        c.close()

    def test_unencodable_result_crosses_as_an_error(self, echo_server):
        """A handler that returns a tensor answers PYC601, never a
        success, and the connection stays usable."""
        c = client(echo_server)
        with pytest.raises(TransportError) as ei:
            c.call("tensor")
        assert ei.value.context["reason"] == "encode"
        assert c.call("ping")["ok"] is True
        c.close()

    def test_concurrent_calls_use_the_pool(self, echo_server):
        c = client(echo_server, pool=4)
        results = []

        def one(i):
            results.append(c.call("echo", {"i": i})["i"])
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert sorted(results) == list(range(12))
        assert c._n_open <= 4
        c.close()

    def test_connect_bounded_reconnect(self):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        before = obs.value("pyconsensus_retries_total",
                           label="transport.connect:late") or 0
        box = {}

        def start_late():
            time.sleep(0.35)
            box["server"] = RpcServer({"ping": lambda p: {"ok": True}},
                                      name="late", port=port,
                                      fingerprint=fp()).start()
        t = threading.Thread(target=start_late)
        t.start()
        c = RpcClient("127.0.0.1", port, label="late", connect_retries=8,
                      expect_fingerprint=fp())
        assert c.call("ping")["ok"] is True
        t.join(10)
        assert (obs.value("pyconsensus_retries_total",
                          label="transport.connect:late") or 0) > before
        c.close()
        box["server"].close()

    def test_handshake_refusal_not_retried(self, echo_server):
        wrong = dict(fp())
        wrong["torch"] = "elsewhere"
        c = client(echo_server, label="wrongfp", expect_fingerprint=wrong)
        before = obs.value("pyconsensus_retries_total",
                           label="transport.connect:wrongfp") or 0
        with pytest.raises(HandshakeError) as ei:
            c.call("ping")
        assert ei.value.context["field"] == "torch"
        assert (obs.value("pyconsensus_retries_total",
                          label="transport.connect:wrongfp") or 0) == before
        c.close()

    def test_rpc_latency_histogram_observed(self, echo_server):
        c = client(echo_server)
        c.call("ping")
        c.close()
        prom = obs.render_prom()
        assert "pyconsensus_transport_rpc_seconds" in prom
        assert 'method="ping"' in prom

    def test_trace_context_rides_the_envelope(self, echo_server):
        """A call inside a traced span runs its handler under an
        ``rpc.<method>`` span whose parent is the caller's span."""
        seen = {}
        server = RpcServer({"who": lambda p: seen.setdefault(
            "ctx", obs.trace_context())}, name="traced",
            fingerprint=fp()).start()
        c = client(server, label="traced")
        with obs.trace_root("caller", "trace-7") as root:
            c.call("who")
        c.close()
        server.close()
        ctx = seen["ctx"]
        assert ctx["trace_id"] == "trace-7"
        rpc = next(ev for ev in obs.events()
                   if ev["name"] == "rpc.who"
                   and ev.get("trace_id") == "trace-7")
        assert rpc["parent_id"] == root.span_id


# -- fault sites --------------------------------------------------------------


class TestTransportFaultSites:
    def test_sites_cataloged(self):
        for site in ("transport.send", "transport.recv",
                     "transport.connect", "shipping.append"):
            assert site in faults.FAULT_SITES

    def test_send_site_fires(self):
        plan = faults.FaultPlan(seed=1, rules=[
            {"site": "transport.send", "kind": "raise",
             "occurrences": [0]}])
        a, b = pair()
        with faults.armed(plan):
            with pytest.raises(OSError) as ei:
                wire.send_msg(a, {"x": 1})
        assert ("transport.send", 0, "raise") in plan.fired
        # transient-typed: what the bounded reconnect retries
        assert not isinstance(ei.value, faults.ConsensusError)

    def test_recv_site_fires(self):
        plan = faults.FaultPlan(seed=1, rules=[
            {"site": "transport.recv", "kind": "raise",
             "occurrences": [0]}])
        a, b = pair()
        wire.send_msg(a, {"x": 1})
        with faults.armed(plan):
            with pytest.raises(OSError):
                wire.recv_msg(b)
        assert ("transport.recv", 0, "raise") in plan.fired
        # the frame is still there for the next read
        assert wire.recv_msg(b) == {"x": 1}

    def test_connect_site_fires(self, echo_server):
        plan = faults.FaultPlan(seed=1, rules=[
            {"site": "transport.connect", "kind": "raise",
             "args": {"error": "input_error"}}])
        c = client(echo_server)
        with faults.armed(plan):
            with pytest.raises(InputError):
                c.call("ping")
        assert plan.fired and plan.fired[0][0] == "transport.connect"
        c.close()

    def test_shipping_site_fires(self, tmp_path, receiver):
        local = tmp_path / "primary"
        make_log(local)
        plan = faults.FaultPlan(seed=2, rules=[
            {"site": "shipping.append", "kind": "raise",
             "occurrences": [0]}])
        shipper = LogShipper(receiver.host, receiver.port,
                             expect_fingerprint=fp())
        with faults.armed(plan):
            with pytest.raises(OSError):
                shipper.ship_file("m1", "meta.json",
                                  local / "m1" / "meta.json")
            shipper.ship_file("m1", "meta.json", local / "m1" / "meta.json")
        shipper.close()
        assert [f[:2] for f in plan.fired] == [("shipping.append", 0)]
        assert (tmp_path / "shipped" / "m1" / "meta.json").exists()


# -- shipping -----------------------------------------------------------------


@pytest.fixture
def receiver(tmp_path):
    rcv = ShippingReceiver(tmp_path / "shipped", fingerprint=fp()).start()
    yield rcv
    rcv.close()


def make_log(root, name="m1", rounds=1, blocks=2):
    rng = np.random.default_rng(3)
    session = DurableSession.create(root, name, 8, device="cpu")
    for _ in range(rounds):
        for _ in range(blocks):
            session.append(rng.choice([0.0, 1.0], size=(8, 3)))
        session.resolve()
    # one staged block, so mid-round state ships too
    session.append(rng.choice([0.0, 1.0], size=(8, 3)))
    return session


def ship_all(shipper, root, name):
    log_dir = root / name
    for path in sorted(log_dir.rglob("*")):
        if path.is_file():
            rel = str(path.relative_to(log_dir)).replace(os.sep, "/")
            shipper.ship_file(name, rel, path)


def flat(result):
    """The bits of a flat session result."""
    return tuple(np.asarray(result[k]).tobytes()
                 for k in ("smooth_rep", "outcomes_final",
                           "outcomes_adjusted", "old_rep", "iterations"))


class TestShipping:
    def test_ship_and_adopt_bit_for_bit(self, tmp_path, receiver):
        local = tmp_path / "primary"
        session = make_log(local)
        shipper = LogShipper(receiver.host, receiver.port,
                             expect_fingerprint=fp())
        ship_all(shipper, local, "m1")
        shipper.close()
        adopted = adopt_shipped(tmp_path / "shipped", tmp_path / "standby",
                                "m1", device="cpu")
        assert adopted.ledger.round == session.ledger.round
        np.testing.assert_array_equal(adopted.reputation,
                                      session.reputation)
        assert flat(adopted.resolve()) == flat(session.resolve())
        # the standby's own root holds the verified copy
        assert (tmp_path / "standby" / "m1" / "meta.json").exists()
        assert (obs.value("pyconsensus_shipping_records_total",
                          kind="staged") or 0) >= 1

    def test_bit_flip_refused_by_receiver(self, tmp_path, receiver):
        local = tmp_path / "primary"
        make_log(local)
        c = client(receiver, label="ship")
        ledger = (local / "m1" / "ledger.npz").read_bytes()
        damaged = bytearray(ledger)
        damaged[len(damaged) // 2] ^= 1
        with pytest.raises(CheckpointCorruptionError):
            c.call("ship", {"session": "m1", "relpath": "ledger.npz",
                            "data": bytes(damaged),
                            "digest": hashlib.sha256(ledger).hexdigest()})
        c.close()
        assert not (tmp_path / "shipped" / "m1" / "ledger.npz").exists()

    def test_path_escape_refused(self, tmp_path, receiver):
        c = client(receiver, label="ship")
        data = b"owned"
        for sess, rel in (("..", "meta.json"),
                          ("m1", "../evil.json"),
                          ("m1", "staged/../../evil.npz"),
                          ("m1", "/etc/passwd")):
            with pytest.raises(CheckpointCorruptionError):
                c.call("ship", {"session": sess, "relpath": rel,
                                "data": data,
                                "digest": hashlib.sha256(data).hexdigest()})
        c.close()
        assert not (tmp_path / "evil.json").exists()

    def test_torn_shipped_log_refused_at_adopt(self, tmp_path, receiver):
        local = tmp_path / "primary"
        make_log(local)
        shipper = LogShipper(receiver.host, receiver.port,
                             expect_fingerprint=fp())
        ship_all(shipper, local, "m1")
        shipper.close()
        shipped_ledger = tmp_path / "shipped" / "m1" / "ledger.npz"
        shipped_ledger.write_bytes(shipped_ledger.read_bytes()[:40])
        with pytest.raises(CheckpointCorruptionError):
            adopt_shipped(tmp_path / "shipped", tmp_path / "standby2",
                          "m1", device="cpu")
        assert not (tmp_path / "standby2" / "m1").exists()

    def test_append_idempotency_token_survives_replay(self, tmp_path,
                                                      receiver):
        rng = np.random.default_rng(5)
        block = rng.choice([0.0, 1.0], size=(8, 3))
        session = DurableSession.create(tmp_path / "primary", "idem", 8,
                                        device="cpu")
        n1 = session.append(block, append_id="tok-1")
        assert session.append(block, append_id="tok-1") == n1
        assert session.state()["staged_blocks"] == 1
        shipper = LogShipper(receiver.host, receiver.port,
                             expect_fingerprint=fp())
        ship_all(shipper, tmp_path / "primary", "idem")
        shipper.close()
        adopted = adopt_shipped(tmp_path / "shipped",
                                tmp_path / "standby3", "idem",
                                device="cpu")
        assert adopted.append(block, append_id="tok-1") == n1
        assert adopted.state()["staged_blocks"] == 1
        assert flat(adopted.resolve()) == flat(session.resolve())


    def test_ship_failure_fences_the_session(self, tmp_path, receiver):
        """A worker whose ship fails after the local journal write
        refuses the ack with PYC301 and fences the session: memory, the
        local disk and the standby's disk never disagree about an
        acknowledged append."""
        from pyconsensus_tpu_torch.serve import ConsensusService

        svc = ConsensusService(WORKER_CFG, device="cpu")
        shipper = LogShipper(receiver.host, receiver.port,
                             expect_fingerprint=fp())
        proc = worker.FleetWorkerProcess("w9", svc, tmp_path / "local",
                                         shipped_root=tmp_path / "shipped",
                                         shipper=shipper)
        try:
            proc.create_session({"name": "f", "n_reporters": 10})
            proc.append({"session": "f", "block": session_block(0, 0)})
            plan = faults.FaultPlan(seed=3, rules=[
                {"site": "shipping.append", "kind": "raise",
                 "occurrences": [0], "args": {"error": "input_error"}}])
            with faults.armed(plan):
                with pytest.raises(CheckpointCorruptionError) as ei:
                    proc.append({"session": "f",
                                 "block": session_block(0, 1)})
            assert ei.value.context["session"] == "f"
            with pytest.raises(CheckpointCorruptionError):
                proc.append({"session": "f", "block": session_block(0, 2)})
            # the standby holds the first (acknowledged) block only
            shipped = sorted(p.name for p in
                             (tmp_path / "shipped" / "f" / "staged").iterdir())
            assert len(shipped) == 1
        finally:
            shipper.close()
            svc.close(drain=False)


# -- a socket fleet of real worker processes ----------------------------------


def socket_fleet(log_dir, n=2, **kw):
    kw.setdefault("heartbeat_timeout_s", HEARTBEAT_S)
    return ConsensusFleet(FleetConfig(
        n_workers=n, transport="socket", log_dir=str(log_dir),
        worker=WORKER_CFG, **kw), device="cpu")


def inprocess_fleet(log_dir, n=2):
    return ConsensusFleet(FleetConfig(
        n_workers=n, log_dir=str(log_dir), worker=WORKER_CFG),
        device="cpu")


def session_block(round_idx, block_idx, R=10):
    rng = np.random.default_rng([11, round_idx, block_idx])
    block = rng.choice([0.0, 1.0], size=(R, 4))
    block[rng.random(block.shape) < 0.1] = np.nan
    return block


def walk_bits(got, want, path=""):
    """Every leaf of two nested results equal: arrays bit for bit with
    their dtype, a numpy scalar against the Python value it crosses the
    wire as, bit for bit in its dtype."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            walk_bits(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            path
        for i, (a, b) in enumerate(zip(got, want)):
            walk_bits(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) and want.ndim:
        a = np.asarray(got)
        assert a.dtype == want.dtype and a.shape == want.shape, path
        assert a.tobytes() == want.tobytes(), path
    elif want is None or isinstance(want, str):
        assert got == want, path
    else:
        b = np.asarray(want)
        assert np.asarray(got, dtype=b.dtype).tobytes() == b.tobytes(), \
            path


def series_total(snapshot, name, worker_prefix="w"):
    """The sum of ``name``'s series labelled with a worker."""
    total = 0
    for key, v in snapshot.get(name, {}).get("series", {}).items():
        labels = json.loads(key) if key else {}
        if str(labels.get("worker", "")).startswith(worker_prefix):
            total += int(v)
    return total


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """One two-process socket fleet on the CPU in float64 (the worker
    processes are the costly part: boot once, exercise many times)."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    f = socket_fleet(tmp_path_factory.mktemp("socket-fleet"))
    torch.set_default_dtype(prev)
    f.start()
    yield f
    f.close(drain=False, timeout=10.0)


class TestSocketFleet:
    def test_worker_processes_are_real(self, fleet):
        pids = {w.process.proc.pid for w in fleet.workers.values()}
        assert len(pids) == 2 and os.getpid() not in pids
        for name, w in fleet.workers.items():
            assert w.heartbeat()
            st = w.call("stats")
            assert st["worker"] == name and st["pid"] in pids
            assert st["device"] == "cpu" and st["visible_devices"] is None
            assert set(st["launches"]) >= {"apply_weighted_cov",
                                           "scores_dirfix_pass",
                                           "resolve_certainty_fused"}
        assert fleet.transport.wants_monitor and fleet._monitor is not None

    def test_worker_environment_names_no_jax(self, monkeypatch):
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
        monkeypatch.setenv("XLA_FLAGS", "--x")
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
        env = worker_subprocess_env(card=1)
        assert not [k for k in env if k.startswith(("JAX_", "XLA_"))]
        assert env["CUDA_VISIBLE_DEVICES"] == "5"
        assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
        assert worker_subprocess_env(card=2)["CUDA_VISIBLE_DEVICES"] == "2"
        assert "CUDA_VISIBLE_DEVICES" not in worker_subprocess_env()

    @pytest.mark.parametrize("name", ["canonical", "missing", "scaled",
                                      "collusion"])
    def test_stateless_bits_are_the_inprocess_fleets(self, fleet, name,
                                                     tmp_path):
        """The padded-bucket path across the process boundary: bit for
        bit the in-process fleet's result, and within the serve band of
        the reference's and the port's direct ``Oracle``."""
        reports, bounds = _corpus(name)
        futs = [fleet.submit(reports=reports, event_bounds=bounds)
                for _ in range(4)]
        got = [f.result(WAIT_S) for f in futs]
        with inprocess_fleet(tmp_path / "inproc") as local:
            want = local.resolve(reports=reports, event_bounds=bounds,
                                 timeout=WAIT_S)
        ref = RefOracle(reports=reports, event_bounds=bounds,
                        backend="jax", pca_method="power").consensus()
        port = Oracle(reports=reports, event_bounds=bounds, device="cpu",
                      pca_method="power").consensus()
        for g in got:
            walk_bits(g, want)
            _assert_parity(g, ref, bounds, name)
            _assert_parity(g, port, bounds, name)

    def test_direct_path_bits_are_the_direct_oracles(self, fleet):
        """A request the service resolves through the ``Oracle`` itself
        (an algorithm the buckets do not take) is bit for bit the port's
        direct ``Oracle``, after the wire."""
        reports, _ = _corpus("collusion")
        got = fleet.resolve(reports=reports, algorithm="fixed-variance",
                            timeout=WAIT_S)
        want = Oracle(reports=reports, device="cpu",
                      algorithm="fixed-variance").consensus()
        walk_bits(got, want)

    def test_session_rounds_are_the_inprocess_fleets(self, fleet,
                                                     tmp_path):
        local = inprocess_fleet(tmp_path / "inproc").start()
        try:
            for f in (fleet, local):
                f.create_session("parity", n_reporters=10)
            for k in range(2):
                for j in range(2):
                    block = session_block(k, j)
                    assert fleet.append("parity", block) \
                        == local.append("parity", block)
                got = fleet.submit(session="parity").result(WAIT_S)
                want = local.submit(session="parity").result(WAIT_S)
                walk_bits(got, want)
            walk_bits(fleet.session_state("parity"),
                      local.session_state("parity"))
        finally:
            local.close()

    def test_taxonomy_crosses_the_fleet_wire(self, fleet):
        with pytest.raises(InputError) as ei:
            fleet.session_state("no-such-session-anywhere")
        assert ei.value.error_code == "PYC101"

    def test_wrong_fingerprint_client_refused(self, fleet):
        w = fleet.workers["w0"]
        wrong = dict(fp())
        wrong["kernels"] = "0" * 16
        c = RpcClient("127.0.0.1", w.process.port, label="wrong",
                      expect_fingerprint=wrong)
        with pytest.raises(HandshakeError) as ei:
            c.call("ping")
        assert ei.value.context["field"] == "kernels"
        c.close()

    def test_merged_view_labels_each_worker(self, fleet):
        """The merged metric view holds each worker process's own
        registry under its name, and its request total is the sum of the
        workers' own totals."""
        x = np.random.default_rng(2).choice([0.0, 1.0], size=(12, 8))
        for f in [fleet.submit(reports=x, tenant="merged")
                  for _ in range(6)]:
            f.result(WAIT_S)
        fleet.check_workers()
        merged = fleet.merged_snapshot()
        own = sum(series_total(
            w.metrics_snapshot()["metrics"],
            "pyconsensus_serve_requests_total", "") for w in
            fleet.workers.values())
        assert series_total(merged, "pyconsensus_serve_requests_total") \
            == own >= 6
        labels = {json.loads(k).get("worker") for k in merged[
            "pyconsensus_serve_requests_total"]["series"]}
        assert labels >= {"w0", "w1"}
        hb = merged["pyconsensus_fleet_heartbeat_seconds"]["series"]
        assert {json.loads(k)["worker"] for k in hb} >= {"w0", "w1"}
        text = fleet.render_metrics()
        assert 'worker="w0"' in text and 'worker="w1"' in text
        assert w_render_ok(fleet)

    def test_add_and_drain_a_worker_process(self, fleet):
        """``add_worker`` spawns one more process through the same
        supervisor (its placement the next in turn), ``drain_worker``
        migrates its sessions off and stops it."""
        name = fleet.add_worker()
        w = fleet.workers[name]
        assert w.heartbeat() and w.call("stats")["device"] == "cpu"
        fleet.create_session("grown", n_reporters=10)
        fleet.append("grown", session_block(0, 0))
        fleet.migrate_session("grown", name)
        assert fleet.owner_of("grown") == name
        out = fleet.drain_worker(name, timeout=30.0)
        assert out["drained"] and out["sessions_migrated"]
        assert not w.alive and not w.process.running
        assert fleet.owner_of("grown") in ("w0", "w1")
        assert fleet.session_state("grown")["staged_blocks"] == 1

    def test_worker_warm_and_launch_counts(self, fleet, tmp_path):
        """Both transports' handles warm a shape and count their
        launches through one surface: a worker process answers over its
        RPC, an in-process worker's launches are the process's own."""
        for w in fleet.workers.values():
            if not w.alive:
                continue
            assert w.warm([(12, 8)], False) >= 0
            counts = w.launch_counts()
            assert counts == w.call("stats")["launches"]
            assert set(counts) >= {"apply_weighted_cov",
                                   "scores_dirfix_pass",
                                   "resolve_certainty_fused"}
            assert not any(counts.values())     # nothing launches off
        with inprocess_fleet(tmp_path / "inproc") as local:   # the card
            for w in local.workers.values():
                assert w.warm([(12, 8)], False) >= 0
                assert w.launch_counts() == {}

    def test_transport_metrics_flow(self, fleet):
        assert (obs.value("pyconsensus_transport_frames_total",
                          direction="sent") or 0) > 0
        assert (obs.value("pyconsensus_transport_bytes_total",
                          direction="received") or 0) > 0
        assert (obs.value("pyconsensus_transport_rpc_seconds",
                          method="submit") or {}) != {}


def w_render_ok(fleet):
    text = fleet.workers["w0"].metrics_render()["text"]
    return "pyconsensus_serve_requests_total" in text


@pytest.fixture
def router_source():
    old = obs.TRACER.source
    obs.TRACER.source = "router"
    yield
    obs.TRACER.source = old


def test_merged_trace_forest_crosses_into_the_workers(tmp_path,
                                                      router_source):
    """After a graceful close each worker wrote ``trace-<name>.jsonl``;
    merged with the router's spans, every traced request's worker span
    sits under its router parent."""
    log_dir = tmp_path / "fleet"
    f = socket_fleet(log_dir).start()
    try:
        x = np.random.default_rng(7).choice([0.0, 1.0], size=(12, 8))
        for fut in [f.submit(reports=x, tenant="telem") for _ in range(4)]:
            fut.result(WAIT_S)
    finally:
        f.close(drain=True, timeout=60.0)
    files = sorted(str(p) for p in log_dir.glob("*/trace-*.jsonl"))
    assert len(files) == 2
    events = obs.merge_jsonl(files) + list(obs.events())
    forest = obs.trace_forest(events)
    roots = [r for tid, rs in forest.items() if tid.startswith("~telem:")
             for r in rs]
    assert len(roots) == 4

    def walk(node):
        yield node
        for c in node["children"]:
            yield from walk(c)
    for root in roots:
        assert root["name"] == "fleet.submit"
        assert root["source"] == "router"
        spans = list(walk(root))
        assert any(s["name"] == "rpc.submit"
                   and s["source"] in ("w0", "w1") for s in spans)
    # no worker span of these traces is left without its router parent
    worker_roots = [r for tid, rs in forest.items()
                    if tid.startswith("~telem:") for r in rs
                    if r["source"] != "router"]
    assert worker_roots == []


def test_sigkill_mid_traffic_and_mid_session(tmp_path):
    """A SIGKILL of a worker PROCESS: the in-flight requests shed with the
    retryable codes and retry to results bit for bit a never-killed
    in-process fleet's, nothing abandoned; the session it owned is
    adopted from the shipped log by the standby and every later round is
    bit for bit the never-killed session's."""
    f = socket_fleet(tmp_path / "fleet").start()
    try:
        owner = f.create_session("chaos", n_reporters=10)
        for j in range(2):
            f.append("chaos", session_block(0, j))
        rounds = [f.submit(session="chaos").result(WAIT_S)]
        f.append("chaos", session_block(1, 0))

        mats = [np.random.default_rng([3, i]).choice([0.0, 1.0],
                                                     size=(12, 10))
                for i in range(4)]
        results, tally = [None] * 24, {"retried": 0, "abandoned": 0}
        lock = threading.Lock()
        killed = threading.Event()

        def one(i):
            for attempt in range(12):
                try:
                    results[i] = f.submit(reports=mats[i % 4]).result(
                        WAIT_S)
                    return
                except Exception as exc:    # noqa: BLE001 — tallied
                    if getattr(exc, "error_code", None) \
                            not in RETRYABLE_CODES:
                        raise
                    with lock:
                        tally["retried"] += 1
                    time.sleep(0.05)
            with lock:
                tally["abandoned"] += 1

        def client_loop(c):
            for i in range(c, 24, 3):
                one(i)
                if i == 6:
                    # SIGKILL from outside the router: no fence first
                    victim = f.workers[owner].process
                    os.kill(victim.proc.pid, signal.SIGKILL)
                    victim.proc.wait(timeout=30)
                    killed.set()
        threads = [threading.Thread(target=client_loop, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert killed.is_set() and not any(t.is_alive() for t in threads)
        assert tally["abandoned"] == 0

        # the death is seen at routing: the standby adopts the shipped
        # log (round 0 committed, round 1's first block journaled)
        st = f.session_state("chaos")
        assert f.owner_of("chaos") != owner
        assert st["rounds_resolved"] == 1 and st["staged_blocks"] == 1
        f.append("chaos", session_block(1, 1), append_id="chaos-r1b1")
        # the retry of an append that landed folds nothing twice
        assert f.append("chaos", session_block(1, 1),
                        append_id="chaos-r1b1") == 8
        rounds.append(f.submit(session="chaos").result(WAIT_S))
        status = f.status()
    finally:
        f.close(drain=False, timeout=10.0)
    assert not status["workers"][owner]["alive"]
    assert status["sessions_migrated"] >= 1

    with inprocess_fleet(tmp_path / "ref") as local:
        want = [local.resolve(reports=m, timeout=WAIT_S) for m in mats]
        local.create_session("chaos", n_reporters=10)
        want_rounds = []
        for k in range(2):
            for j in range(2):
                local.append("chaos", session_block(k, j))
            want_rounds.append(local.submit(session="chaos").result(WAIT_S))
    for i, got in enumerate(results):
        walk_bits(got, want[i % 4])
    for got, w in zip(rounds, want_rounds):
        walk_bits(got, w)


# -- the worker entry point and the refusals -----------------------------------


def test_worker_module_prints_ready_and_writes_its_trace(tmp_path):
    """``python -m pyconsensus_tpu_torch.serve.transport.worker`` (the
    console script's body) announces ``READY <port>``, answers the
    handshake with its fingerprint, and at SIGTERM drains and writes its
    span log."""
    cmd = [sys.executable, "-m",
           "pyconsensus_tpu_torch.serve.transport.worker", "--name", "solo",
           "--log-root", str(tmp_path), "--device", "cpu",
           "--dtype", "float64"]
    proc = WorkerProcess("solo", cmd, worker_subprocess_env())
    try:
        port = proc.wait_ready(120.0)
        c = RpcClient("127.0.0.1", port, label="solo",
                      expect_fingerprint=fp())
        assert c.call("ping")["worker"] == "solo"
        assert c.call("warm_from_disk") == {"adopted": 0}
        c.close()
    finally:
        proc.terminate(timeout_s=30.0)
    assert proc.proc.returncode == 0
    assert (tmp_path / "trace-solo.jsonl").exists()
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    assert ('pyconsensus-fleet-worker-torch = '
            '"pyconsensus_tpu_torch.serve.transport.worker:main"') in text


def test_worker_and_transport_import_no_jax():
    code = ("import sys; import pyconsensus_tpu_torch.serve.transport."
            "worker, pyconsensus_tpu_torch.serve.transport.supervisor; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pyconsensus_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=worker_subprocess_env(),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_card_worker_without_a_card_fails_its_spawn(tmp_path):
    """No fallback: a worker asked for the card where there is none
    raises before READY, and its spawn fails with PYC601 ``spawn``; a
    router without a card cannot make a card fleet either."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal needs none")
    cmd = [sys.executable, "-m",
           "pyconsensus_tpu_torch.serve.transport.worker", "--name", "wc",
           "--log-root", str(tmp_path)]
    proc = WorkerProcess("wc", cmd, worker_subprocess_env(card=0))
    with pytest.raises(TransportError) as ei:
        proc.wait_ready(120.0)
    assert ei.value.context["reason"] == "spawn"
    assert proc.proc.returncode not in (0, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConsensusFleet(FleetConfig(n_workers=1, transport=SocketTransport(
            devices=[0]), log_dir=str(tmp_path / "f")))
