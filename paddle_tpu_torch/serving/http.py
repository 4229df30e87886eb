"""Stdlib HTTP front end for the serving engine.

The counterpart of ``paddle_tpu/serving/http.py`` (a daemon
``ThreadingHTTPServer``, ephemeral ``port=0`` by default, no socket
bound at import):

 - ``GET  /healthz``      engine + scheduler health; 503 once the hang
                          watchdog fired, the page pool is inconsistent,
                          a compile was seen after warm-up, or the
                          engine is draining
 - ``GET  /metrics``      the telemetry registry's Prometheus text (the
                          ``pt_serve_*`` series and the rest; empty
                          while telemetry is off)
 - ``POST /v1/generate``  ``{"tokens": [...], "max_new_tokens": N,
                          "deadline_ms": D}`` -> ``{"tokens": [...]}``;
                          429 + ``Retry-After`` on saturation/shed,
                          503 while draining, 504 on a missed
                          deadline/timeout, 499 when the request was
                          cancelled, 400 on bad input
 - ``POST /v1/cancel``    ``{"request_id": N}`` -> evicts the request
                          at the next step boundary (pages released)
 - ``POST /v1/reload``    swaps in the newest weight generation of the
                          engine's checkpoint manager, if newer ->
                          ``{"reloaded": bool, "weights_step": N}``

With ``reload_interval`` (seconds) a background thread polls the
manager and swaps in newer generations as they land: serving N while
loading N+1.

Handler threads only submit numpy work to the scheduler and wait; all
device work happens on the scheduler's step loop.  While waiting they
watch the client socket: a disconnected caller's request is cancelled
(``cause="disconnect"``) instead of decoding for nobody.

SIGTERM lifecycle (:func:`install_drain_handler`): stop admission,
finish in-flight decodes within the drain budget, cancel the rest, exit
**143**.
"""
from __future__ import annotations

import json
import logging
import os
import select
import socket
import threading
import time
from typing import Optional

from ..observability.metrics import get_registry
from ..observability.telemetry import get_telemetry

logger = logging.getLogger("paddle_tpu_torch.serving")

__all__ = ["ServeHTTPServer", "install_drain_handler", "DRAIN_EXIT_CODE"]

_CTYPE_JSON = "application/json"
_CTYPE_METRICS = "text/plain; version=0.0.4; charset=utf-8"

# 128 + SIGTERM: the exit status a supervisor reads as "asked to stop,
# stopped cleanly" after a graceful drain
from ..distributed.exit_codes import EXIT_DRAIN as DRAIN_EXIT_CODE  # noqa: E402


def _client_gone(sock) -> bool:
    """True when the peer has closed its end (EOF readable) — the
    waiting handler should cancel the request rather than decode for a
    caller that left."""
    try:
        r, _, _ = select.select([sock], [], [], 0)
        if not r:
            return False
        return sock.recv(1, socket.MSG_PEEK) == b""
    except (OSError, ValueError):
        return True


class ServeHTTPServer:
    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 request_timeout: float = 120.0,
                 reload_interval: Optional[float] = None):
        self.engine = engine
        self._host = host
        self._requested_port = int(port)
        self._request_timeout = request_timeout
        self._reload_interval = reload_interval
        self._httpd = None
        self._thread = None
        self._reload_thread = None
        self._stop = threading.Event()
        self.port = None

    @property
    def host(self) -> str:
        return self._host

    def start(self) -> "ServeHTTPServer":
        """Bind + serve on daemon threads; starts the scheduler loop.
        Idempotent."""
        if self._httpd is not None:
            return self
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        engine = self.engine
        timeout = self._request_timeout
        engine.scheduler.start()

        class _Handler(BaseHTTPRequestHandler):
            def _send(self, code, ctype, body, headers=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code, obj, headers=()):
                self._send(code, _CTYPE_JSON,
                           (json.dumps(obj) + "\n").encode(), headers)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(200, _CTYPE_METRICS,
                                   get_registry().prometheus_text()
                                   .encode("utf-8"))
                    elif path == "/healthz":
                        health = engine.healthz()
                        self._send_json(200 if health.get("ok") else 503,
                                        health)
                    else:
                        self._send(404, "text/plain; charset=utf-8",
                                   b"not found; try /healthz /metrics "
                                   b"/v1/generate\n")
                except Exception as e:
                    logger.warning("serve endpoint error on %s: %s",
                                   path, e)
                    try:
                        self._send_json(500, {"error": str(e)})
                    except OSError:
                        pass

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(n) if n else b"{}"
                    if path == "/v1/generate":
                        self._generate(raw)
                    elif path == "/v1/cancel":
                        self._cancel(raw)
                    elif path == "/v1/reload":
                        step = engine.maybe_reload()
                        self._send_json(200, {
                            "reloaded": step is not None,
                            "weights_step": engine.weights_step})
                    else:
                        self._send_json(404, {"error": "unknown route"})
                except Exception as e:
                    logger.warning("serve endpoint error on %s: %s",
                                   path, e)
                    try:
                        self._send_json(500, {"error": str(e)})
                    except OSError:
                        pass

            def _cancel(self, raw):
                try:
                    body = json.loads(raw.decode("utf-8"))
                    rid = int(body["request_id"])
                except (ValueError, KeyError, TypeError) as e:
                    self._send_json(400, {"error": f"bad request: {e}"})
                    return
                ok = engine.scheduler.cancel(rid, cause="client")
                self._send_json(200, {"request_id": rid,
                                      "cancelled": bool(ok)})

            def _generate(self, raw):
                from .scheduler import (DeadlineExceeded, EngineSaturated,
                                        RequestCancelled, RequestShed)
                t0 = time.monotonic()
                try:
                    body = json.loads(raw.decode("utf-8"))
                    tokens = body["tokens"]
                    max_new = body.get("max_new_tokens")
                    deadline_ms = body.get("deadline_ms")
                except (ValueError, KeyError, TypeError) as e:
                    self._send_json(400, {"error": f"bad request: {e}"})
                    return
                try:
                    stream = engine.scheduler.submit(
                        tokens, max_new_tokens=max_new,
                        deadline_ms=deadline_ms)
                except RequestShed as e:
                    if e.reason == "draining":
                        self._send_json(503, {"error": str(e),
                                              "reason": e.reason})
                    else:
                        retry = max(1, int(float(e.retry_after or 1)
                                           + 0.999))
                        self._send_json(
                            429, {"error": str(e), "reason": e.reason},
                            headers=(("Retry-After", str(retry)),))
                    return
                except EngineSaturated as e:
                    self._send_json(429, {"error": str(e)},
                                    headers=(("Retry-After", "1"),))
                    return
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                    return
                # wait, watching the wall clock AND the client socket:
                # an abandoned request is cancelled, never left decoding
                wall_deadline = t0 + timeout
                while not stream._done.wait(0.05):
                    if time.monotonic() >= wall_deadline:
                        stream.cancel(cause="timeout")
                        self._send_json(504, {
                            "error": f"request {stream.request_id} did "
                                     f"not finish in {timeout}s",
                            "request_id": stream.request_id})
                        return
                    if _client_gone(self.connection):
                        engine.scheduler.cancel(stream.request_id,
                                                cause="disconnect")
                        return  # nobody is listening
                err = stream._error
                if err is None:
                    wall = time.monotonic() - t0
                    _book_http_latency(wall)
                    self._send_json(200, {
                        "tokens": [int(t) for t in stream.tokens],
                        "request_id": stream.request_id,
                        "latency_ms": wall * 1e3,
                        "weights_step": engine.weights_step,
                    })
                elif isinstance(err, DeadlineExceeded):
                    self._send_json(504, {"error": str(err),
                                          "reason": "deadline",
                                          "request_id": stream.request_id})
                elif isinstance(err, RequestCancelled):
                    # nginx-style 499 "client closed request" for client
                    # cancels; 503 when the drain cut the request short
                    code = 503 if err.cause == "drain" else 499
                    self._send_json(code, {"error": str(err),
                                           "cause": err.cause,
                                           "request_id": stream.request_id})
                else:
                    self._send_json(500, {"error": str(err),
                                          "request_id": stream.request_id})

            def log_message(self, fmt, *args):
                logger.debug("serve-http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pt-serve-http",
            daemon=True)
        self._thread.start()
        if self._reload_interval:
            self._stop.clear()
            self._reload_thread = threading.Thread(
                target=self._reload_loop, name="pt-serve-reload",
                daemon=True)
            self._reload_thread.start()
        logger.info("serve endpoint on http://%s:%d (/v1/generate, "
                    "/v1/cancel, /v1/reload, /healthz, /metrics)",
                    self._host, self.port)
        return self

    def _reload_loop(self):
        """Poll the checkpoint manager and swap in newer generations."""
        while not self._stop.wait(self._reload_interval):
            try:
                step = self.engine.maybe_reload()
                if step is not None:
                    logger.info("background weight swap -> step %s", step)
            except Exception:
                logger.exception("background weight reload failed")

    def drain(self, budget_s: Optional[float] = None,
              settle_s: float = 1.0) -> bool:
        """Graceful-drain lifecycle: close admission (healthz degrades),
        finish in-flight decodes within the budget, cancel the rest,
        give handler threads a moment to flush their responses, and
        stop.  Returns True when every in-flight
        request completed inside the budget."""
        clean = self.engine.scheduler.drain_gracefully(budget_s)
        # the scheduler resolved every stream; handler threads still
        # need a beat to write the queued responses before shutdown
        time.sleep(max(0.0, settle_s))
        self.stop()
        return clean

    def stop(self):
        self._stop.set()
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._reload_thread is not None:
            self._reload_thread.join(timeout=5.0)
            self._reload_thread = None
        self.engine.scheduler.stop()
        self.port = None


def _book_http_latency(seconds: float) -> None:
    """The wall time of one ``/v1/generate`` (queueing included);
    nothing while telemetry is off."""
    if not get_telemetry().enabled:
        return
    get_registry().histogram(
        "pt_serve_http_request_seconds",
        "Wall time of /v1/generate requests").observe(seconds)


def install_drain_handler(server: ServeHTTPServer, *,
                          budget_s: Optional[float] = None,
                          exit_code: int = DRAIN_EXIT_CODE):
    """SIGTERM → graceful drain → ``exit(143)``.

    Call from the main thread (signal module requirement).  The handler
    only sets a flag and hands off to a drain thread — nothing
    drain-sized runs in signal context.  ``/healthz`` reports 503 ``draining`` for the whole window, so a
    load balancer watching health stops routing before the listener
    goes away."""
    import signal

    fired = threading.Event()

    def _drain_and_exit():
        try:
            server.drain(budget_s)
        except Exception:
            logger.exception("graceful drain failed; exiting anyway")
        finally:
            os._exit(exit_code)

    def _on_term(signum, frame):
        if fired.is_set():  # second SIGTERM: stop waiting, just go
            os._exit(exit_code)
        fired.set()
        logger.info("SIGTERM: starting graceful drain (budget %s)",
                    budget_s if budget_s is not None else "config")
        threading.Thread(target=_drain_and_exit, name="pt-serve-drain",
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _on_term)
