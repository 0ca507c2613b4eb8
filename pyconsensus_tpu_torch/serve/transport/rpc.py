"""Socket RPC over the fleet wire protocol
(``pyconsensus_tpu/serve/transport/rpc.py``).

One request and one response a frame pair: ``{"id", "method", "params"}``
up, ``{"id", "result"}`` or ``{"id", "error": <marshalled>}`` back. The
semantics live in ``wire.py`` (framing, digests, handshake, error
fidelity); this module adds

- :class:`RpcClient`: a bounded connection pool (a long resolve on one
  connection never blocks a heartbeat on another) with a dial bounded by
  ``retry_call``: an ``OSError`` while dialling is retried with the
  deterministic jitter of ``faults.retry``; a taxonomy error (PYC601/602
  and every marshalled worker error) is never retried. A connection that
  failed mid-call is closed and replaced (counted under
  ``pyconsensus_transport_reconnects_total``), never returned to the
  pool, and the failure reaches the caller: the transport never re-sends
  a request that may not be idempotent.
- :class:`RpcServer`: a listener and one thread a connection, the
  handshake first, then a dispatch loop that marshals handler results
  and exceptions.

The client's per-call latency lands in
``pyconsensus_transport_rpc_seconds{method}``. A call made inside a
traced span carries its trace context in the envelope, and the server
runs the handler under a span parented to it (``rpc.<method>``).
Fault site ``transport.connect`` fires at every dial.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from ... import obs
from ...faults import SimulatedCrash, TransportError
from ...faults import plan as _faults
from ...faults.retry import retry_call
from . import wire

__all__ = ["RpcClient", "RpcServer"]


class RpcClient:
    """Pooled RPC client of one worker endpoint. ``call`` checks a
    connection out of the pool (dialling a new one, up to ``pool``, when
    none is idle), makes exactly one request and response, and returns
    the connection to the pool only on success. ``expect_fingerprint``
    is the fingerprint the peer must answer with (None: this process's
    on the card)."""

    def __init__(self, host: str, port: int, pool: int = 4,
                 timeout_s: float = 60.0, connect_retries: int = 4,
                 label: str = "worker",
                 expect_fingerprint: Optional[dict] = None) -> None:
        self.host, self.port = str(host), int(port)
        self.pool = max(1, int(pool))
        self.timeout_s = float(timeout_s)
        self.connect_retries = int(connect_retries)
        self.label = str(label)
        self.expect_fingerprint = (
            expect_fingerprint if expect_fingerprint is not None
            else wire.runtime_fingerprint())
        self._idle: list = []           # guarded-by: _cond
        self._n_open = 0                # guarded-by: _cond
        self._ever_connected = False    # guarded-by: _cond
        self._closed = False            # guarded-by: _cond
        self._cond = threading.Condition()
        self._seq = 0                   # guarded-by: _cond

    # -- connections ----------------------------------------------------

    def _dial(self, reconnect: bool):
        """One pooled connection: a TCP connect retried on ``OSError``
        (a worker still booting refuses the first attempts), then the
        fingerprint handshake. A handshake refusal (PYC602) propagates at
        once: an identical fingerprint cannot succeed on a retry."""
        _faults.fire("transport.connect")

        def connect():
            return socket.create_connection((self.host, self.port),
                                            timeout=self.timeout_s)

        sock = retry_call(connect, retries=self.connect_retries,
                          base_delay=0.05, max_delay=1.0,
                          retry_on=(OSError,),
                          label=f"transport.connect:{self.label}")
        try:
            sock.settimeout(self.timeout_s)
            wire.client_hello(sock, self.expect_fingerprint)
        except BaseException:
            sock.close()
            raise
        if reconnect:
            obs.counter(
                "pyconsensus_transport_reconnects_total",
                "replacement connections dialed after a transport "
                "failure").inc()
        return sock

    def _checkout(self):
        with self._cond:
            while True:
                if self._closed:
                    raise TransportError(
                        f"rpc client for {self.label!r} is closed",
                        reason="closed")
                if self._idle:
                    return self._idle.pop()
                if self._n_open < self.pool:
                    self._n_open += 1
                    reconnect = self._ever_connected
                    break
                self._cond.wait(timeout=self.timeout_s)
        # dial outside the condition (no socket I/O under a lock); on a
        # failure the reserved slot is released
        try:
            sock = self._dial(reconnect)
        except BaseException:
            with self._cond:
                self._n_open -= 1
                self._cond.notify()
            raise
        with self._cond:
            self._ever_connected = True
        return sock

    def _checkin(self, sock) -> None:
        with self._cond:
            closed = self._closed
            if closed:
                self._n_open -= 1
            else:
                self._idle.append(sock)
            self._cond.notify()
        if closed:
            sock.close()

    def _discard(self, sock) -> None:
        with self._cond:
            self._n_open -= 1
            self._cond.notify()
        try:
            sock.close()
        except OSError:
            pass

    # -- the call -------------------------------------------------------

    def call(self, method: str, params: Optional[dict] = None,
             timeout_s: Optional[float] = None,
             trace: Optional[dict] = None):
        """One RPC. Raises the unmarshalled taxonomy error the worker
        raised, ``TransportError`` on a damaged frame, or ``OSError`` on a
        dead socket (the fleet's handle turns those into worker loss).
        ``trace`` overrides the calling thread's trace context: a caller
        that hops threads between its span and the wire captures it on
        the submitting thread."""
        sock = self._checkout()
        with self._cond:
            self._seq += 1
            rid = self._seq
        start = time.monotonic()
        env = {"id": rid, "method": str(method),
               "params": dict(params or {})}
        tctx = trace if trace is not None else obs.trace_context()
        if tctx is not None:
            env["trace"] = dict(tctx)
        try:
            if timeout_s is not None:
                sock.settimeout(float(timeout_s))
            wire.send_msg(sock, env)
            reply = wire.recv_msg(sock)
        except BaseException:
            # the stream position is unknown: never reused, never
            # re-sent
            self._discard(sock)
            raise
        finally:
            if timeout_s is not None:
                try:
                    sock.settimeout(self.timeout_s)
                except OSError:
                    pass
        if reply is None:
            self._discard(sock)
            raise TransportError(
                f"worker {self.label!r} closed the connection "
                f"mid-call ({method})", reason="closed", method=method)
        self._checkin(sock)
        obs.histogram(
            "pyconsensus_transport_rpc_seconds",
            "client-observed RPC round-trip latency by method",
            labels=("method",)).observe(
                time.monotonic() - start, method=str(method))
        if "error" in reply:
            raise wire.unmarshal_error(reply["error"])
        return reply.get("result")

    def ping(self, timeout_s: float = 1.0):
        return self.call("ping", timeout_s=timeout_s)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            idle, self._idle = self._idle, []
            self._n_open -= len(idle)
            self._cond.notify_all()
        for sock in idle:
            try:
                sock.close()
            except OSError:
                pass


class RpcServer:
    """Serve ``{method: callable(params) -> result}`` on a listening
    socket, one thread a connection; the handshake (answering with
    ``fingerprint``, None: this process's on the card) runs before any
    call is dispatched."""

    def __init__(self, handlers: dict, name: str = "worker",
                 host: str = "127.0.0.1", port: int = 0,
                 fingerprint: Optional[dict] = None) -> None:
        self.handlers = dict(handlers)
        self.name = str(name)
        self.fingerprint = (fingerprint if fingerprint is not None
                            else wire.runtime_fingerprint())
        self._listener = socket.create_server((host, int(port)))
        self.host, self.port = self._listener.getsockname()[:2]
        self._conns: list = []      # guarded-by: _lock
        self._lock = threading.Lock()
        #: monotonic flag; a racy read delays the loop's exit by one
        #: accept at most
        self._stopping = False      # guarded-by: none
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> "RpcServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"pyconsensus-rpc-{self.name}", daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return              # the listener closed: shutdown
            with self._lock:
                if self._stopping:
                    conn.close()
                    return
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn) -> None:
        try:
            wire.server_handshake(conn, self.name, self.fingerprint)
            while True:
                msg = wire.recv_msg(conn)
                if msg is None:
                    return          # clean close between frames
                self._dispatch(conn, msg)
        except (OSError, TransportError, SimulatedCrash):
            return                  # connection-scoped: drop the peer
        finally:
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, conn, msg: dict) -> None:
        rid = msg.get("id")
        method = msg.get("method")
        handler = self.handlers.get(method)
        tctx = msg.get("trace")
        try:
            if handler is None:
                raise TransportError(f"unknown rpc method {method!r}",
                                     reason="method", method=method)
            if tctx:
                # the dispatch runs under a span parented to the wire
                # context, so the merged forest crosses the hop
                with obs.span_under(f"rpc.{method}", dict(tctx),
                                    method=str(method)):
                    result = handler(dict(msg.get("params") or {}))
            else:
                result = handler(dict(msg.get("params") or {}))
        except Exception as exc:    # noqa: BLE001 — every handler error
            # crosses as a marshalled frame; only a BaseException (the
            # injected SimulatedCrash) tears the connection as a kill does
            wire.send_msg(conn, {"id": rid,
                                 "error": wire.marshal_error(exc)})
            return
        try:
            wire.send_msg(conn, {"id": rid, "result": result})
        except TransportError as exc:
            # a result the encoder refused sent no byte: the refusal
            # crosses instead, never a success
            if exc.context.get("reason") != "encode":
                raise
            wire.send_msg(conn, {"id": rid,
                                 "error": wire.marshal_error(exc)})

    def close(self) -> None:
        self._stopping = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
