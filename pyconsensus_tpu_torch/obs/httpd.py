"""Stdlib ``/metrics`` exposition endpoint (``pyconsensus_tpu/obs/
httpd.py``).

A thread-backed ``http.server`` serving the Prometheus text exposition
on ``GET /metrics`` — on ``pyconsensus-serve-torch --metrics-port`` it serves
the *merged cluster view* (every fleet worker's registry labeled
``worker=<name>`` plus the router's own, re-rendered per scrape), so one
scrape sees the whole fleet. Zero dependencies, like every obs sink.

``render_fn`` is called per request; exceptions become a 500 with the
error text (a scrape must never hang on a half-dead fleet)."""

from __future__ import annotations

import http.server
import threading
from typing import Callable, Optional

__all__ = ["MetricsServer", "start_metrics_server"]


class MetricsServer:
    """Owns the listening socket + serve thread; ``close()`` is
    idempotent. ``port`` reports the bound port (useful with port 0)."""

    def __init__(self, port: int, render_fn: Callable[[], str],
                 host: str = "127.0.0.1") -> None:
        render = render_fn

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):               # noqa: N802 — http.server API
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404, "only /metrics is served")
                    return
                try:
                    body = render().encode("utf-8")
                    status, ctype = 200, \
                        "text/plain; version=0.0.4; charset=utf-8"
                except Exception as exc:    # noqa: BLE001 — scrape must
                    body = f"# render failed: {exc!r}\n".encode("utf-8")
                    status, ctype = 500, "text/plain; charset=utf-8"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # scrapes are not stderr news
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-httpd",
            daemon=True)
        self._thread.start()
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def start_metrics_server(port: int, render_fn: Callable[[], str],
                         host: str = "127.0.0.1"
                         ) -> Optional[MetricsServer]:
    """Start the endpoint; returns ``None`` (with a warning on stderr)
    when the port cannot be bound — an unscrapable endpoint must not
    take the serve run down."""
    import sys

    try:
        return MetricsServer(port, render_fn, host=host)
    except OSError as exc:
        print(f"WARNING: metrics endpoint on port {port} unavailable: "
              f"{exc}", file=sys.stderr)
        return None
