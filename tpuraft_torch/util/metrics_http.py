"""Shared stdlib /metrics HTTP listener.

One implementation serving Prometheus text on a daemon thread, used by
both the store engine (``StoreEngineOptions.metrics_port``) and the
placement driver (``PlacementDriverOptions.metrics_port``) — the
listener only calls the ``render`` callable per GET and never mutates
component state (best-effort consistency by design; renders that only
read counters are safe from this thread)."""

from __future__ import annotations

import http.server
import logging
import threading
from typing import Callable

LOG = logging.getLogger(__name__)


# concurrency contract (graftcheck-reviewed, deliberately NOT
# loop-confined): the handler runs on ThreadingHTTPServer daemon
# threads.  Every attribute below is published BEFORE the serving
# thread starts and never rebound afterwards (immutable-after-publish);
# the render callable itself must only read counters or snapshot
# copies — the contract each metrics_text() implementation documents
class MetricsHttpServer:
    """GET /metrics (or /) -> ``render()`` as Prometheus text.

    ``port=0`` binds ephemerally; the bound port is in :attr:`port`.
    """

    def __init__(self, host: str, port: int, render: Callable[[], str],
                 name: str = "metrics-http"):
        srv = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib handler contract
                if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = srv._render().encode()
                except Exception as e:  # noqa: BLE001 — racing a split
                    self.send_error(500, str(e)[:100])
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet: scrapes aren't news
                pass

        self._render = render
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._httpd.daemon_threads = True
        self.port: int = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=name, daemon=True)
        self._thread.start()
        LOG.info("%s serving /metrics on %s:%d", name, host, self.port)

    def shutdown_blocking(self) -> None:
        """Stop serving; blocks up to the poll interval — call it off
        the event loop (run_in_executor)."""
        self._httpd.shutdown()
        self._httpd.server_close()
