"""Runtime observability: metrics, step telemetry, events and health (the
counterpart of ``paddle_tpu/observability/``'s core):

 - :mod:`.metrics`    a thread-safe, label-aware registry of counters,
                      gauges and histograms; Prometheus text and JSON
                      snapshots
 - :mod:`.telemetry`  ``TrainingTelemetry``: step wall time and
                      throughput, device-memory gauges, compile counts
                      and the recompile sentinel, and the hooks of the
                      collectives, the data loader, the checkpoints,
                      the captured step and the fusion pass
 - :mod:`.events`     a size-rotated JSONL event stream a process
 - :mod:`.server`     a standard-library HTTP endpoint: ``/metrics`` and
                      ``/healthz``
 - :mod:`.logs`       the package's logger

Nothing starts until asked: importing this package makes no thread, opens
no file and creates no CUDA context; with telemetry off (the default)
every hook on a hot path is one attribute check and the registry stays
empty.  On in a process::

    from paddle_tpu_torch.observability import configure
    configure(enabled=True, jsonl_dir="/tmp/tele", http_port=9400)

or by the environment: ``PT_TELEMETRY=1`` (with ``PT_TELEMETRY_DIR``,
``PT_METRICS_PORT``, ``PT_RECOMPILE_THRESHOLD``, ``PT_LOG_LEVEL``).

The JAX package's trace, goodput, numerics, sdc, memory, aggregator and
merge modules are ROADMAP Queue 1 item 5's next slice: their names raise
``AttributeError`` here, naming it.
"""
from __future__ import annotations

from .events import EventSink
from .logs import get_logger
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, log_buckets, reset_registry)
from .server import MetricsServer, start_http_server
from .telemetry import (CompileWatcher, RecompileSentinel, StepTimer,
                        TrainingTelemetry, configure, get_telemetry, reset)

# the JAX package's lazy names of the modules not ported yet
_NOT_PORTED = (
    "ClusterAggregator", "MergeConflict", "parse_prometheus_text",
    "merge_scrapes", "render_exposition", "cluster_snapshot",
    "Tracer", "Span", "PHASES", "PEAK_FLOPS", "peak_flops",
    "program_flops", "get_tracer", "current_tracer", "reset_tracer",
    "NumericsMonitor", "NumericsHaltError", "health_outputs",
    "get_monitor", "current_monitor", "reset_monitor",
    "GoodputLedger", "decompose_spans", "get_goodput",
    "current_ledger", "reset_goodput",
    "SdcMonitor", "SdcHaltError", "fingerprint_outputs",
    "store_exchange",
    "MemoryMonitor", "device_memory_stats", "device_memory_stat",
    "program_memory_analysis", "is_oom_error", "oom_postmortem",
    "get_memory_monitor", "current_memory_monitor",
    "reset_memory_monitor",
)


def __getattr__(name):
    if name in _NOT_PORTED:
        raise AttributeError(
            f"{__name__}.{name} is not ported yet: the trace, goodput, "
            f"numerics, sdc, memory, aggregator and merge modules are "
            f"ROADMAP Queue 1 item 5's next slice")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "get_logger",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "reset_registry", "log_buckets",
    "EventSink",
    "TrainingTelemetry", "StepTimer", "CompileWatcher",
    "RecompileSentinel", "get_telemetry", "configure", "reset",
    "MetricsServer", "start_http_server",
]
