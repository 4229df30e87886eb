"""Standard-library HTTP endpoint: ``/metrics`` and ``/healthz`` (the
counterpart of ``paddle_tpu/observability/server.py``).

A ``ThreadingHTTPServer`` on a daemon thread, bound to localhost by
default:

 - ``/metrics``  the registry's Prometheus text;
 - ``/healthz``  a JSON liveness summary (503 when it says not ok).

Nothing runs until :meth:`MetricsServer.start` (or
:func:`start_http_server`, or ``PT_METRICS_PORT``): importing binds no
socket and starts no thread.  ``port=0`` binds an ephemeral port, read
back from ``server.port``.
"""
from __future__ import annotations

import json
import threading

from .logs import get_logger
from .metrics import get_registry

__all__ = ["MetricsServer", "start_http_server", "CONTENT_TYPE_METRICS"]

logger = get_logger(__name__)

CONTENT_TYPE_METRICS = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    def __init__(self, registry=None, health_cb=None, host="127.0.0.1",
                 port=0, metrics_cb=None):
        """``metrics_cb`` (no arguments, returns exposition text) takes
        the place of the registry's text."""
        self._registry = registry if registry is not None \
            else get_registry()
        self._metrics_cb = metrics_cb
        self._health_cb = health_cb
        self._host = host
        self._requested_port = int(port)
        self._httpd = None
        self._thread = None
        self.port = None

    @property
    def host(self):
        return self._host

    def start(self):
        """Bind and serve on a daemon thread.  Idempotent."""
        if self._httpd is not None:
            return self
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registry = self._registry
        metrics_cb = (self._metrics_cb if self._metrics_cb is not None
                      else registry.prometheus_text)
        health_cb = self._health_cb

        class _Handler(BaseHTTPRequestHandler):
            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = metrics_cb().encode("utf-8")
                        self._send(200, CONTENT_TYPE_METRICS, body)
                    elif path == "/healthz":
                        health = (health_cb() if health_cb is not None
                                  else {"ok": True})
                        code = 200 if health.get("ok", True) else 503
                        self._send(code, "application/json",
                                   (json.dumps(health) + "\n").encode())
                    else:
                        self._send(404, "text/plain; charset=utf-8",
                                   b"not found; try /metrics /healthz\n")
                except Exception as e:
                    logger.warning("metrics endpoint error on %s: %s",
                                   path, e)
                    try:
                        self._send(500, "text/plain; charset=utf-8",
                                   f"error: {e}\n".encode())
                    except OSError:
                        pass  # the client went away mid-reply

            def log_message(self, fmt, *args):
                logger.debug("metrics-server: " + fmt, *args)

        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pt-metrics-server",
            daemon=True)
        self._thread.start()
        logger.info("metrics endpoint on http://%s:%d (/metrics, "
                    "/healthz)", self._host, self.port)
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.port = None


def start_http_server(port=0, registry=None, health_cb=None,
                      host="127.0.0.1"):
    """Start an endpoint in one call; returns the server (its bound
    port is ``.port``)."""
    return MetricsServer(registry=registry, health_cb=health_cb,
                         host=host, port=port).start()
