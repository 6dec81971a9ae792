"""Background HTTP thread serving ``/metrics`` and ``/healthz``.

Port copy of ``repro.obs.http``.  :class:`MetricsServer` wraps a
:class:`~http.server.ThreadingHTTPServer` in a daemon thread: ``/metrics``
serves the registry's Prometheus text exposition, ``/healthz`` answers
``ok`` while the server is up (and ``503`` once a liveness callback says
otherwise).  Port 0 binds an ephemeral port — read :attr:`port` after
:meth:`start`.  Intended for the serve CLI (``python -m
repro_torch.launch.serve --mode samples --metrics-port ...``) and tests;
the server never blocks the sampling path (scrapes render under the
registry locks only).
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .metrics import MetricsRegistry, get_registry

__all__ = ["MetricsServer", "PROMETHEUS_CONTENT_TYPE"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-obs/1"

    def _send(self, code: int, body: str,
              ctype: str = "text/plain; charset=utf-8") -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            try:
                body = self.server.registry.render()
            except Exception as e:                  # scrape must not 500 raw
                self._send(500, f"metrics render failed: {e}\n")
                return
            self._send(200, body, PROMETHEUS_CONTENT_TYPE)
        elif path == "/healthz":
            alive = self.server.health_fn()
            self._send(200 if alive else 503, "ok\n" if alive else "down\n")
        else:
            self._send(404, "not found (try /metrics or /healthz)\n")

    def log_message(self, fmt, *args):
        pass                                        # keep scrapes silent


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    registry: MetricsRegistry
    health_fn: Callable[[], bool]


class MetricsServer:
    """Daemon-thread HTTP server for ``/metrics`` + ``/healthz``."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 health_fn: Optional[Callable[[], bool]] = None):
        self.registry = registry if registry is not None else get_registry()
        self.host = host
        self.requested_port = int(port)
        self.health_fn = health_fn or (lambda: True)
        self._httpd: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        """Bound port (valid after :meth:`start`)."""
        if self._httpd is None:
            return self.requested_port
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        httpd = _Server((self.host, self.requested_port), _Handler)
        httpd.registry = self.registry
        httpd.health_fn = self.health_fn
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        name="obs-metrics-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
