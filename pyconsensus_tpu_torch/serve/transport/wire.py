"""The fleet wire protocol: length-prefixed, digest-framed messages with
a versioned runtime-fingerprint handshake
(``pyconsensus_tpu/serve/transport/wire.py``; the same frames, so the two
packages' ends read each other).

Everything the out-of-process fleet says on a socket is a **frame**::

    MAGIC(4) | version(1) | codec(1) | length(4, BE) | sha256(32) | payload

- ``MAGIC`` (``b"PYCW"``) and the protocol ``version`` byte make a
  foreign or future peer refuse at the first frame instead of misparsing
  bytes.
- ``length`` is checked against a bounded read limit BEFORE any payload
  byte is read, so a corrupt length field cannot make the receiver
  allocate without bound.
- ``sha256`` is the payload's digest, checked after the bounded read: a
  torn frame and a bit-flipped frame are both refused with
  :class:`~pyconsensus_tpu_torch.faults.TransportError` (PYC601) naming
  the failed check.
- the ``codec`` byte names each frame's encoding: msgpack where the
  interpreter has it, JSON with base64 byte strings otherwise. A receiver
  decodes whatever codec the frame declares, so mixed fleets
  interoperate. Numpy arrays cross with exact dtype, shape and raw
  bytes: a result is bit for bit the same after a round trip. A
  ``torch.Tensor`` never crosses: the worker fetches every tensor of a
  result to its host array first, and one that reaches the encoder
  raises ``TransportError``.

**Handshake** (:func:`client_hello` / :func:`server_handshake`): the
first frame each way. The worker answers with the protocol version and
its :func:`~pyconsensus_tpu_torch.tune.fingerprint.runtime_fingerprint`;
the router compares it field by field with the one it expects and
refuses a mismatch with :class:`~pyconsensus_tpu_torch.faults.HandshakeError`
(PYC602) at connect, naming the first field that differs.

**Error marshalling** (:func:`marshal_error` / :func:`unmarshal_error`):
a taxonomy error raised in a worker crosses as ``(code, message,
context)`` and re-raises in the router as the same class, with its code,
retry hint and context, so client retry policy does not depend on the
transport. Any other remote failure surfaces as PYC601 naming the remote
type.

Fault sites ``transport.send`` / ``transport.recv`` inject a send- or
receive-side failure before any byte moves.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
from typing import Optional

import numpy as np
import torch

from ... import obs
from ...faults import (ERROR_CODES, ConsensusError, HandshakeError,
                       TransportError)
from ...faults import plan as _faults
from ...tune.fingerprint import runtime_fingerprint

try:
    import msgpack as _msgpack
except ImportError:             # an interpreter without msgpack: JSON
    _msgpack = None

__all__ = ["WIRE_PROTOCOL_VERSION", "MAX_FRAME_BYTES",
           "send_msg", "recv_msg", "marshal_error", "unmarshal_error",
           "client_hello", "server_handshake", "codec_name"]

#: bump on any frame-layout or handshake-shape change: a peer speaking
#: another version is refused at the first frame (PYC601 ``version``) or
#: at the handshake (PYC602)
WIRE_PROTOCOL_VERSION = 1

MAGIC = b"PYCW"
_CODEC_JSON = 0
_CODEC_MSGPACK = 1
_HEADER = struct.Struct(">4sBBL32s")

#: bounded-read ceiling: a frame beyond it is refused before any payload
#: byte is read (a 1024 x 4096 float64 request is about 43 MiB as JSON)
MAX_FRAME_BYTES = 64 * 1024 * 1024


def codec_name() -> str:
    """The codec this process's frames take: ``"msgpack"`` or
    ``"json"``."""
    return "msgpack" if _msgpack is not None else "json"


def _frames(direction: str) -> None:
    obs.counter("pyconsensus_transport_frames_total",
                "wire frames moved by the fleet transport",
                labels=("direction",)).inc(direction=direction)


def _bytes(direction: str, n: int) -> None:
    obs.counter("pyconsensus_transport_bytes_total",
                "wire bytes moved by the fleet transport",
                labels=("direction",)).inc(n, direction=direction)


def _refused(reason: str) -> None:
    obs.counter("pyconsensus_transport_refused_total",
                "wire frames refused by validation, by failed check",
                labels=("reason",)).inc(reason=reason)


# -- object <-> bytes ----------------------------------------------------

def _encode_obj(obj, binary: bool):
    """The wire form of ``obj``: ndarrays become tagged dtype/shape/raw
    bytes dicts (a bit-exact round trip), bytes are base64-wrapped under
    the JSON codec, tuples become lists, dict keys are sorted."""
    if isinstance(obj, torch.Tensor):
        raise TransportError(
            f"a torch.Tensor ({obj.dtype}, {tuple(obj.shape)}, on "
            f"{obj.device}) reached the wire encoder: fetch it to a host "
            f"array first", reason="encode", dtype=str(obj.dtype))
    if isinstance(obj, np.ndarray):
        return {"__nd__": 1, "dtype": str(obj.dtype),
                "shape": list(obj.shape),
                "data": _encode_obj(
                    np.ascontiguousarray(obj).tobytes(), binary)}
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if isinstance(obj, (bytes, bytearray)):
        if binary:
            return bytes(obj)
        return {"__b64__": base64.b64encode(bytes(obj)).decode("ascii")}
    if isinstance(obj, dict):
        # sorted: the frame bytes must not depend on the sender's dict
        # insertion history
        return {str(k): _encode_obj(v, binary)
                for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [_encode_obj(v, binary) for v in obj]
    return obj


def _decode_obj(obj):
    if isinstance(obj, dict):
        if "__b64__" in obj and len(obj) == 1:
            return base64.b64decode(obj["__b64__"])
        if obj.get("__nd__") == 1:
            data = _decode_obj(obj["data"])
            return np.frombuffer(data, dtype=np.dtype(obj["dtype"])) \
                .reshape([int(d) for d in obj["shape"]]).copy()
        # sorted: a decode -> re-encode round trip is byte-stable
        return {k: _decode_obj(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_decode_obj(v) for v in obj]
    return obj


def _pack(obj) -> tuple:
    """-> (codec byte, payload bytes): msgpack when available, JSON
    otherwise (sorted keys: two processes packing one message produce
    one byte string)."""
    if _msgpack is not None:
        return _CODEC_MSGPACK, _msgpack.packb(_encode_obj(obj, True),
                                              use_bin_type=True)
    return _CODEC_JSON, json.dumps(_encode_obj(obj, False),
                                   sort_keys=True).encode()


def _unpack(codec: int, payload: bytes):
    if codec == _CODEC_MSGPACK:
        if _msgpack is None:
            _refused("codec")
            raise TransportError(
                "frame declares the msgpack codec but this interpreter "
                "has no msgpack", reason="codec")
        return _decode_obj(_msgpack.unpackb(payload, raw=False))
    if codec == _CODEC_JSON:
        return _decode_obj(json.loads(payload.decode()))
    _refused("codec")
    raise TransportError(f"unknown wire codec byte {codec}",
                         reason="codec", codec=codec)


# -- frames --------------------------------------------------------------

def send_msg(sock, obj) -> None:
    """Frame and send one message. The ``transport.send`` fault site
    fires first, before any byte reaches the socket."""
    _faults.fire("transport.send")
    codec, payload = _pack(obj)
    header = _HEADER.pack(MAGIC, WIRE_PROTOCOL_VERSION, codec,
                          len(payload), hashlib.sha256(payload).digest())
    sock.sendall(header)
    sock.sendall(payload)
    _frames("sent")
    _bytes("sent", len(header) + len(payload))


def _recv_exact(sock, n: int, *, at_start: bool) -> Optional[bytearray]:
    """Read exactly ``n`` bytes into one buffer (a 43 MiB frame is read
    in place, never joined from chunks). A clean EOF before the first
    byte of a frame returns None (the peer closed between frames); an EOF
    mid-read is a torn frame, PYC601."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(1 << 20, n - got))
        if not k:
            if at_start and got == 0:
                return None
            _refused("truncated")
            raise TransportError(
                f"torn frame: peer closed after {got} of {n} bytes",
                reason="truncated", got=got, expected=n)
        got += k
    return buf


def recv_msg(sock, max_bytes: int = MAX_FRAME_BYTES):
    """Receive and check one frame; returns the decoded object, or None
    on a clean close between frames. Every failed check (foreign magic,
    protocol version, oversized length, torn payload, digest) refuses
    with PYC601 naming it; no byte of such a frame is decoded."""
    _faults.fire("transport.recv")
    raw = _recv_exact(sock, _HEADER.size, at_start=True)
    if raw is None:
        return None
    magic, version, codec, length, digest = _HEADER.unpack(raw)
    if magic != MAGIC:
        _refused("magic")
        raise TransportError(
            f"foreign frame magic {magic!r} (want {MAGIC!r})",
            reason="magic")
    if version != WIRE_PROTOCOL_VERSION:
        _refused("version")
        raise TransportError(
            f"wire protocol version {version} (this end speaks "
            f"{WIRE_PROTOCOL_VERSION})", reason="version",
            found=version, expected=WIRE_PROTOCOL_VERSION)
    if length > max_bytes:
        _refused("oversized")
        raise TransportError(
            f"frame length {length} exceeds the bounded-read limit "
            f"{max_bytes}", reason="oversized", length=length,
            limit=max_bytes)
    payload = _recv_exact(sock, length, at_start=False)
    if hashlib.sha256(payload).digest() != digest:
        _refused("digest")
        raise TransportError(
            "frame payload digest mismatch (bit flip or torn write in "
            "transit)", reason="digest")
    _frames("received")
    _bytes("received", _HEADER.size + length)
    return _unpack(codec, payload)


# -- structured-error marshalling ----------------------------------------

def _json_safe(value):
    """Context values reduced to wire-safe primitives (numpy scalars
    unwrapped, arrays listed, anything else named by ``str``)."""
    if isinstance(value, (np.integer, np.floating, np.bool_)):
        return value.item()
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, dict):
        return {str(k): _json_safe(v)
                for k, v in sorted(value.items(), key=lambda kv: str(kv[0]))}
    if isinstance(value, set):
        return [_json_safe(v) for v in sorted(value, key=str)]
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    return str(value)


def marshal_error(exc: BaseException) -> dict:
    """The wire form of a worker-side exception: a taxonomy error keeps
    its ``error_code`` and ``context``; anything else is named and
    crosses as the generic remote failure."""
    if isinstance(exc, ConsensusError):
        message = str(exc.args[0]) if exc.args else ""
        return {"code": exc.error_code, "message": message,
                "context": _json_safe(exc.context)}
    return {"code": None, "type": type(exc).__name__,
            "message": str(exc), "context": {}}


def unmarshal_error(wire: dict) -> ConsensusError:
    """The router-side exception: a known ``error_code`` re-raises as its
    taxonomy class; an unknown or absent one as PYC601 naming the remote
    type."""
    code = wire.get("code")
    cls = ERROR_CODES.get(code) if code else None
    if cls is not None:
        return cls(str(wire.get("message", "")),
                   **dict(wire.get("context") or {}))
    return TransportError(
        f"remote call failed: {wire.get('type', 'Exception')}: "
        f"{wire.get('message', '')}", reason="remote",
        remote_type=wire.get("type"))


# -- the versioned handshake ---------------------------------------------

def client_hello(sock, expect_fingerprint: Optional[dict] = None) -> dict:
    """The router's half: announce ``{protocol, fingerprint}``, then
    check the worker's reply, the protocol version first and then every
    fingerprint field against ``expect_fingerprint`` (None: this
    process's on the card). A mismatch refuses the connection with
    PYC602 naming the first field that differs; returns the worker's
    hello."""
    mine = dict(expect_fingerprint if expect_fingerprint is not None
                else runtime_fingerprint())
    send_msg(sock, {"hello": {"protocol": WIRE_PROTOCOL_VERSION,
                              "fingerprint": mine}})
    reply = recv_msg(sock)
    if reply is None:
        raise TransportError("peer closed during handshake",
                             reason="truncated")
    if "error" in reply:
        raise unmarshal_error(reply["error"])
    hello = reply.get("ok") or {}
    if hello.get("protocol") != WIRE_PROTOCOL_VERSION:
        raise HandshakeError(
            f"worker speaks wire protocol {hello.get('protocol')!r}, "
            f"this router speaks {WIRE_PROTOCOL_VERSION}",
            field="protocol", found=hello.get("protocol"),
            expected=WIRE_PROTOCOL_VERSION)
    theirs = dict(hello.get("fingerprint") or {})
    for field in sorted(set(mine) | set(theirs)):
        if mine.get(field) != theirs.get(field):
            raise HandshakeError(
                f"worker runtime fingerprint mismatch on {field!r}: "
                f"worker has {theirs.get(field)!r}, router has "
                f"{mine.get(field)!r}: a worker of another toolchain is "
                f"refused at connect", field=field,
                found=theirs.get(field), expected=mine.get(field))
    return hello


def server_handshake(sock, worker: str,
                     fingerprint: Optional[dict] = None) -> dict:
    """The worker's half: read the client hello, refuse a foreign
    protocol version (the refusal is sent, so the client sees PYC602, and
    raised here, so the connection closes), and answer with
    ``fingerprint`` (None: this process's on the card); the router
    compares the fields."""
    hello = recv_msg(sock)
    if hello is None:
        raise TransportError("peer closed before hello",
                             reason="truncated")
    ask = (hello.get("hello") or {})
    if ask.get("protocol") != WIRE_PROTOCOL_VERSION:
        exc = HandshakeError(
            f"client speaks wire protocol {ask.get('protocol')!r}, "
            f"worker {worker!r} speaks {WIRE_PROTOCOL_VERSION}",
            field="protocol", found=ask.get("protocol"),
            expected=WIRE_PROTOCOL_VERSION)
        send_msg(sock, {"error": marshal_error(exc)})
        raise exc
    mine = dict(fingerprint if fingerprint is not None
                else runtime_fingerprint())
    send_msg(sock, {"ok": {"protocol": WIRE_PROTOCOL_VERSION,
                           "fingerprint": mine, "worker": str(worker)}})
    return ask
