"""``python -m paddle_tpu_torch.serving --model DIR`` (a served-model
directory of either package) or ``--spec '{...}'`` (random weights):
serve a decoder over HTTP, with the drain/deadline/watchdog lifecycle.

Builds the engine on the card (``--device cpu`` runs the plain PyTorch
path), binds the stdlib front end, publishes the bound endpoint to
``--port-file`` (atomic write), installs the SIGTERM graceful-drain
handler (exit 143), and serves until told to stop.  Serve settings come
from the ``PT_SERVE_*`` environment (:class:`.engine.ServeConfig`), over
the directory's ``serve_config.json`` with ``--model``.  A directory's
server reloads newer weight generations on ``POST /v1/reload``.
Telemetry is on unless ``--no-telemetry``: ``GET /metrics`` serves the
``pt_serve_*`` series.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving",
        description="serve a decoder over HTTP with drain/deadline/"
                    "watchdog resilience")
    ap.add_argument("--model", default=None,
                    help="served-model dir (save_served_model or "
                         "save_quantized_model output, either package's)")
    ap.add_argument("--spec", default=None,
                    help="ModelSpec JSON, e.g. '{\"vocab_size\": 50304, "
                         "\"hidden\": 1024, \"layers\": 24, \"heads\": 16, "
                         "\"max_seq_len\": 2048}'; mutually exclusive "
                         "with --model")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a GPU)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (published via --port-file)")
    ap.add_argument("--port-file", default=None,
                    help="publish host:port here once bound")
    ap.add_argument("--request-timeout", type=float, default=120.0)
    ap.add_argument("--drain-budget", type=float, default=None,
                    help="SIGTERM drain budget; default "
                         "ServeConfig.drain_s / PT_SERVE_DRAIN_S")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="skip enabling metrics/compile-watch")
    return ap.parse_args(argv)


def _publish_endpoint(path, host, port):
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="ascii") as f:
        f.write(f"{host}:{port}")
    os.replace(tmp, path)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if bool(args.model) == bool(args.spec):
        print("exactly one of --model / --spec is required",
              file=sys.stderr)
        return 2

    if not args.no_telemetry:
        from ..observability.telemetry import get_telemetry
        get_telemetry().enable()

    from . import (ModelSpec, ServeConfig, ServingEngine, init_params,
                   load_engine)
    from .http import ServeHTTPServer, install_drain_handler

    if args.model:
        engine = load_engine(args.model, device=args.device)
    else:
        spec = ModelSpec.from_dict(json.loads(args.spec))
        engine = ServingEngine(spec,
                               init_params(spec, args.seed, args.device),
                               ServeConfig.from_env(), device=args.device)
    server = ServeHTTPServer(engine, host=args.host, port=args.port,
                             request_timeout=args.request_timeout).start()
    install_drain_handler(server, budget_s=args.drain_budget)
    if args.port_file:
        _publish_endpoint(args.port_file, server.host, server.port)
    logging.getLogger("paddle_tpu_torch.serving").info(
        "serving pid=%d on http://%s:%d", os.getpid(), server.host,
        server.port)

    # hold until a signal takes us down: SIGTERM drains (exit 143)
    hold = threading.Event()
    try:
        while not hold.wait(1.0):
            pass
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
