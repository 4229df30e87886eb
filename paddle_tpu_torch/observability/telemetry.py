"""Step telemetry: wall time, throughput, device memory, compiles (the
counterpart of ``paddle_tpu/observability/telemetry.py``).

``TrainingTelemetry`` is the process's hub that every instrumented path
calls: hapi's ``Model`` loops, ``auto_parallel.Engine.fit``, the
``CheckpointManager``, the collectives, the ``DataLoader``, the
captured step, the fusion pass and the serving engine.  Its rules:

1. **Nothing while off.**  Every hook starts with one attribute check
   (``if not self.enabled: return``); no metric exists, and no file,
   socket or thread is made.  Importing the package starts nothing.
2. **No host sync.**  Step times are the host's clock around the step
   call; a collective's bytes come from the tensors' shapes and dtypes;
   device memory is read from the caching allocator's counters, only
   once CUDA is initialised (:meth:`TrainingTelemetry.device_memory`).
   No hook runs inside a CUDA graph's replay: a graph replays no Python.
3. **Never take the run down.**  A failed write to the event sink is
   counted and dropped.

Compiles.  The JAX package reads each XLA compile from jax's compile
log.  The port compiles what it records itself, and reports each through
:meth:`TrainingTelemetry.record_compile`: a CUDA-graph recording of
``capture_step``, a serving bucket's warm-up and graph (``aot-build``),
and a kernel library that ``ops/_build.py`` compiles with ``nvcc``.
:class:`CompileWatcher` keeps its name and methods and hooks no logger:
``installed`` is true while telemetry is on.  :class:`RecompileSentinel`
trips on the JAX package's counts: ``threshold`` compiles of one
callable with ``threshold`` distinct signatures.

On with ``configure(enabled=True, ...)`` or the environment:
``PT_TELEMETRY=1`` (with ``PT_TELEMETRY_DIR``, ``PT_METRICS_PORT``),
read once, on the first :func:`get_telemetry` call.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque

from .events import EventSink
from .logs import get_logger
from .metrics import get_registry, log_buckets

__all__ = [
    "TrainingTelemetry", "StepTimer", "CompileWatcher",
    "RecompileSentinel", "get_telemetry", "configure", "reset",
]

logger = get_logger(__name__)

_TRUTHY = {"1", "true", "yes", "on"}


def _env_flag(name):
    return os.environ.get(name, "").strip().lower() in _TRUTHY


def _resolve_identity():
    """(process_index, run_id) of this process: ``PT_PROCESS_INDEX``, else
    the launcher's ``PADDLE_TRAINER_ID``, else 0; ``PT_RUN_ID``, else
    ``"local"``.  Pids are not part of it: they change on a restart."""
    raw = (os.environ.get("PT_PROCESS_INDEX")
           or os.environ.get("PADDLE_TRAINER_ID") or "").strip()
    try:
        idx = int(raw) if raw else 0
    except ValueError:
        idx = 0
    run_id = (os.environ.get("PT_RUN_ID") or "").strip() or "local"
    return idx, run_id


class RecompileSentinel:
    """Detects recompile storms and names the callable: it trips when one
    callable has been compiled ``threshold`` times with ``threshold``
    distinct signatures (inputs whose shapes change every call)."""

    def __init__(self, threshold=5, keep_recent=4):
        self.threshold = max(2, int(threshold))
        self._keep_recent = keep_recent
        self._lock = threading.Lock()
        self._state: dict = {}
        self._tripped: dict = {}

    def observe(self, name, signature=""):
        """Record one compile; the trip info the first time ``name``
        crosses the threshold, else None."""
        with self._lock:
            st = self._state.get(name)
            if st is None:
                st = self._state[name] = {
                    "count": 0, "sig_hashes": set(),
                    "recent": deque(maxlen=self._keep_recent)}
            st["count"] += 1
            if len(st["sig_hashes"]) < 4096:
                st["sig_hashes"].add(hash(signature))
            if signature:
                st["recent"].append(str(signature)[:400])
            if (name not in self._tripped
                    and st["count"] >= self.threshold
                    and len(st["sig_hashes"]) >= self.threshold):
                info = {"callable": name,
                        "compiles": st["count"],
                        "distinct_signatures": len(st["sig_hashes"]),
                        "recent_signatures": list(st["recent"])}
                self._tripped[name] = info
                return info
        return None

    def compile_counts(self):
        with self._lock:
            return {n: st["count"] for n, st in self._state.items()}

    def tripped(self):
        """{callable: trip info} for every storm so far."""
        with self._lock:
            return dict(self._tripped)


class CompileWatcher:
    """The JAX package's compile-log watcher, kept by name: the port has
    no compile log, since every compile it makes reports through
    :meth:`TrainingTelemetry.record_compile`.  ``installed`` says whether
    compiles are being watched (true while telemetry is on)."""

    def __init__(self, telemetry):
        self._tel = telemetry
        self.installed = False

    def install(self):
        self.installed = True
        return True

    def uninstall(self):
        self.installed = False


class StepTimer:
    """``with tel.step(batch_size=..., mode=...):`` around one step."""

    __slots__ = ("_tel", "_mode", "_batch_size", "_token")

    def __init__(self, telemetry, mode="train", batch_size=None):
        self._tel = telemetry
        self._mode = mode
        self._batch_size = batch_size
        self._token = None

    def __enter__(self):
        self._token = self._tel.step_start()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._tel.step_end(self._token, batch_size=self._batch_size,
                               mode=self._mode)
        return False


def _cuda_memory():
    """The caching allocator's counters summed over the cards this
    process has allocated on, under the JAX package's names; {} before
    CUDA is initialised (this never initialises it) or on the CPU."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats.get("reserved_bytes.all.current"):
            continue                  # no allocation there: no context read
        got = {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
               "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
               "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
               "bytes_limit": torch.cuda.mem_get_info(i)[1]}
        for k, v in got.items():
            out[k] = out.get(k, 0) + int(v)
    return out


class TrainingTelemetry:
    """The process's telemetry hub (the module docstring's rules)."""

    def __init__(self):
        self.enabled = False
        self.process_index, self.run_id = _resolve_identity()
        self._lock = threading.RLock()
        self.sentinel = RecompileSentinel(
            threshold=int(os.environ.get("PT_RECOMPILE_THRESHOLD") or 5))
        self._watcher = CompileWatcher(self)
        self.sink = None
        self.server = None
        self._metrics_made = False
        self._start_ts = time.time()
        self._steps = 0
        self._step_times = deque(maxlen=512)
        self._last_step_ts = None
        self._last_ckpt_step = None
        self._capture_hits = 0
        self._capture_misses: dict = {}
        self._fusion_rewrites: dict = {}
        self._fusion_fallbacks: dict = {}
        self._compile_listeners: list = []
        # the device-memory gauges are read every this many steps
        self._mem_every = 32

    # -- lifecycle ----------------------------------------------------------

    @property
    def registry(self):
        return get_registry()

    def enable(self, jsonl_dir=None, http_port=None, compile_watch=True,
               process_index=None, run_id=None):
        """Turn telemetry on (idempotent; each facility made at most
        once).  ``http_port=0`` binds an ephemeral port, None none.
        ``process_index`` / ``run_id`` override the identity stamped on
        every series and record.  Returns self."""
        with self._lock:
            if process_index is not None:
                self.process_index = int(process_index)
            if run_id is not None:
                self.run_id = str(run_id)
            if not self.enabled:
                self.enabled = True
                self._make_metrics()
            self.registry.set_const_labels(
                process_index=self.process_index, run_id=self.run_id)
            if compile_watch:
                self._watcher.install()
            if jsonl_dir is not None and self.sink is None:
                self.sink = EventSink(str(jsonl_dir),
                                      run_id=self.run_id,
                                      process_index=self.process_index)
            if http_port is not None and self.server is None:
                from .server import MetricsServer
                self.server = MetricsServer(self.registry,
                                            health_cb=self.healthz,
                                            port=int(http_port))
                self.server.start()
        return self

    def disable(self):
        with self._lock:
            self.enabled = False
            self._watcher.uninstall()
            if self.server is not None:
                self.server.stop()
                self.server = None
            if self.sink is not None:
                self.sink.close()
                self.sink = None
        return self

    def _make_metrics(self):
        if self._metrics_made:
            return
        self._metrics_made = True
        r = self.registry
        self._m_steps = r.counter(
            "pt_steps_total", "training/eval steps completed", ("mode",))
        self._m_step_time = r.histogram(
            "pt_step_time_seconds", "per-step wall time", ("mode",))
        self._m_throughput = r.gauge(
            "pt_throughput_samples_per_second",
            "samples/sec of the most recent step", ("mode",))
        self._m_last_step_ts = r.gauge(
            "pt_last_step_timestamp_seconds",
            "unix time the last step finished")
        self._m_compiles = r.counter(
            "pt_compiles_total", "XLA compilations observed", ("fn",))
        self._m_storms = r.counter(
            "pt_recompile_storms_total",
            "callables that tripped the recompile sentinel")
        self._m_data_wait = r.histogram(
            "pt_data_wait_seconds",
            "time the training loop waited for the next batch")
        self._m_batches = r.counter(
            "pt_data_batches_total", "batches produced by DataLoader")
        self._m_coll_ops = r.counter(
            "pt_collective_ops_total", "collective op invocations",
            ("op",))
        self._m_coll_bytes = r.counter(
            "pt_collective_bytes_total",
            "input bytes entering collectives (metadata-derived)",
            ("op",))
        self._m_coll_bytes_hist = r.histogram(
            "pt_collective_bytes",
            "per-invocation input bytes of collectives "
            "(metadata-derived distribution; the ROADMAP 'time + "
            "bytes' pair with pt_collective_time_seconds)", ("op",),
            buckets=log_buckets(1e2, 1e9, per_decade=1))
        self._m_coll_time = r.histogram(
            "pt_collective_time_seconds",
            "host-boundary wall time of eagerly dispatched collectives "
            "(not recorded inside traces)", ("op",))
        self._m_grad_buckets = r.counter(
            "pt_grad_buckets_total",
            "gradient-reduction buckets built by train-step tracing, "
            "by reduction kind (all_reduce = fused dp pmean; "
            "reduce_scatter = planned ZeRO hierarchical schedule)",
            ("kind",))
        self._m_grad_bucket_bytes = r.histogram(
            "pt_grad_bucket_bytes",
            "flat-concatenated payload bytes of each gradient bucket "
            "(the fused all-reduce granularity, vs the per-parameter "
            "sizes it replaced)",
            buckets=log_buckets(1e2, 1e9, per_decade=1))
        self._m_ckpt_ops = r.counter(
            "pt_checkpoint_ops_total", "checkpoint operations",
            ("op", "status"))
        self._m_ckpt_save_s = r.histogram(
            "pt_checkpoint_save_seconds", "checkpoint commit duration")
        self._m_ckpt_restore_s = r.histogram(
            "pt_checkpoint_restore_seconds",
            "checkpoint restore duration")
        self._m_ckpt_latest = r.gauge(
            "pt_checkpoint_latest_step",
            "newest committed checkpoint step")
        self._m_ckpt_gc = r.counter(
            "pt_checkpoint_gc_deleted_total",
            "checkpoint directories removed by retention GC")
        self._m_ckpt_barrier_s = r.histogram(
            "pt_checkpoint_barrier_wait_seconds",
            "time spent in the multi-host commit barrier", ("status",))
        self._m_ckpt_swept = r.counter(
            "pt_checkpoint_staging_orphans_swept_total",
            "orphaned staging/partial-commit dirs removed by the "
            "startup janitor")
        self._m_mem = r.gauge(
            "pt_device_memory_bytes",
            "allocator stats summed over local devices", ("stat",))
        self._m_capture_hits = r.counter(
            "pt_capture_cache_hits_total",
            "captured-step signature-cache hits (replays with no retrace)")
        self._m_capture_misses = r.counter(
            "pt_capture_cache_misses_total",
            "captured-step cache misses", ("reason",))
        self._m_fusion_rewrites = r.counter(
            "pt_fusion_rewrites_total",
            "fusion-pass clusters rewritten to block-fused kernels",
            ("pattern",))
        self._m_fusion_fallbacks = r.counter(
            "pt_fusion_fallbacks_total",
            "fusion-pass clusters dispatched to the XLA fallback",
            ("pattern", "reason"))

    # -- step timing --------------------------------------------------------

    def step(self, mode="train", batch_size=None):
        return StepTimer(self, mode=mode, batch_size=batch_size)

    def step_start(self):
        """A token for :meth:`step_end` (None while off: both hooks do
        nothing then)."""
        if not self.enabled:
            return None
        return time.perf_counter()

    def step_end(self, token, batch_size=None, mode="train"):
        if token is None or not self.enabled:
            return
        dt = time.perf_counter() - token
        self.observe_step(dt, mode=mode, batch_size=batch_size)

    def observe_step(self, seconds, mode="train", batch_size=None):
        """Record one finished step of ``seconds`` wall time."""
        if not self.enabled:
            return
        now = time.time()
        self._m_steps.inc(mode=mode)
        self._m_step_time.observe(seconds, mode=mode)
        self._m_last_step_ts.set(now)
        throughput = None
        if batch_size and seconds > 0:
            throughput = batch_size / seconds
            self._m_throughput.set(throughput, mode=mode)
        with self._lock:
            self._steps += 1
            steps = self._steps
            self._last_step_ts = now
            self._step_times.append(float(seconds))
        if steps % self._mem_every == 0:
            self._update_memory_gauges()
        if self.sink is not None:
            self.sink.emit("step", step=steps, mode=mode,
                           duration_sec=round(float(seconds), 6),
                           batch_size=batch_size,
                           throughput=(round(throughput, 2)
                                       if throughput else None))

    # -- data / collectives -------------------------------------------------

    def data_wait(self, seconds):
        if not self.enabled:
            return
        self._m_data_wait.observe(seconds)
        self._m_batches.inc()

    def collective_op(self, op, nbytes=0):
        if not self.enabled:
            return
        self._m_coll_ops.inc(op=op)
        if nbytes:
            self._m_coll_bytes.inc(nbytes, op=op)
            self._m_coll_bytes_hist.observe(nbytes, op=op)

    def collective_time(self, op, seconds):
        """Host wall time around one eager collective (the caller makes
        sure no CUDA graph is recording: ``distributed.collective``)."""
        if not self.enabled:
            return
        self._m_coll_time.observe(float(seconds), op=op)

    def grad_bucket(self, nbytes, kind="all_reduce"):
        """One gradient bucket of a reduction plan, booked once when the
        plan is built; ``nbytes`` its flat payload, ``kind`` its
        reduction."""
        if not self.enabled:
            return
        self._m_grad_buckets.inc(kind=kind)
        self._m_grad_bucket_bytes.observe(float(nbytes))

    # -- checkpoints ----------------------------------------------------------

    def record_checkpoint_save(self, seconds, step=None, mode="sync",
                               ok=True):
        if not self.enabled:
            return
        self._m_ckpt_ops.inc(op="save",
                             status="ok" if ok else f"{mode}_error")
        self._m_ckpt_save_s.observe(seconds)
        if ok and step is not None:
            with self._lock:
                self._last_ckpt_step = int(step)
            self._m_ckpt_latest.set(int(step))
        if self.sink is not None:
            self.sink.emit("checkpoint_save", step=step, mode=mode,
                           ok=ok, duration_sec=round(float(seconds), 6))

    def record_checkpoint_restore(self, seconds, step=None, ok=True):
        if not self.enabled:
            return
        self._m_ckpt_ops.inc(op="restore", status="ok" if ok else "error")
        self._m_ckpt_restore_s.observe(seconds)
        if ok and step is not None:
            with self._lock:
                self._last_ckpt_step = int(step)
            self._m_ckpt_latest.set(int(step))
        if self.sink is not None:
            self.sink.emit("checkpoint_restore", step=step, ok=ok,
                           duration_sec=round(float(seconds), 6))

    def record_checkpoint_gc(self, deleted):
        if not self.enabled or not deleted:
            return
        self._m_ckpt_gc.inc(deleted)

    def record_barrier_wait(self, seconds, ok=True):
        """Seconds this process spent in a checkpoint's commit barrier."""
        if not self.enabled:
            return
        self._m_ckpt_barrier_s.observe(seconds,
                                       status="ok" if ok else "timeout")
        if not ok and self.sink is not None:
            self.sink.emit("checkpoint_barrier_timeout",
                           duration_sec=round(float(seconds), 6))

    def record_staging_sweep(self, n):
        """The startup janitor removed ``n`` orphaned staging or partly
        committed directories."""
        if not self.enabled or not n:
            return
        self._m_ckpt_swept.inc(n)
        if self.sink is not None:
            self.sink.emit("checkpoint_staging_swept", count=int(n))

    def record_async_save_failure(self, step, error):
        """A background save failed (the manager raises it on its next
        call; the metric and the record show it now)."""
        if not self.enabled:
            return
        self._m_ckpt_ops.inc(op="save", status="async_error")
        if self.sink is not None:
            self.sink.emit("checkpoint_async_save_failed", step=step,
                           error=str(error)[:400])

    # -- capture cache (jit.capture_step) -----------------------------------

    def capture_cache_hit(self):
        """One captured-step call replayed from the signature cache."""
        self._capture_hits += 1  # the host-side count snapshot() reads
        if self.enabled:
            self._m_capture_hits.inc()

    def capture_cache_miss(self, reason):
        """One captured-step call that could not replay: ``reason`` is
        first_trace, signature_change, capture_unsafe or
        unsupported_args."""
        reason = str(reason)
        self._capture_misses[reason] = \
            self._capture_misses.get(reason, 0) + 1
        if self.enabled:
            self._m_capture_misses.inc(reason=reason)

    # -- the fusion pass (ops.fusion_pass) ----------------------------------

    def fusion_rewrite(self, pattern):
        """One traced cluster rewritten to a block kernel's call."""
        pattern = str(pattern)
        self._fusion_rewrites[pattern] = \
            self._fusion_rewrites.get(pattern, 0) + 1
        if self.enabled:
            self._m_fusion_rewrites.inc(pattern=pattern)

    def fusion_fallback(self, pattern, reason):
        """One rewritten cluster sent to a fallback (the port has no
        such route; kept for the JAX package's series)."""
        pattern, reason = str(pattern), str(reason)
        key = f"{pattern}:{reason}"
        self._fusion_fallbacks[key] = \
            self._fusion_fallbacks.get(key, 0) + 1
        if self.enabled:
            self._m_fusion_fallbacks.inc(pattern=pattern, reason=reason)

    # -- compiles -------------------------------------------------------------

    def record_compile(self, name, signature=""):
        """One compile the port made (a graph recorded, a serving bucket
        built, a kernel library compiled): the listeners, the metric and
        the sentinel."""
        self._on_compile(name, signature)

    def ensure_compile_watch(self):
        """Watch compiles without turning the rest of telemetry on: the
        listeners and the sentinel see them; metrics need ``enabled``."""
        return self._watcher.install()

    def add_compile_listener(self, fn):
        """Call ``fn(name, signature)`` on every compile; its exceptions
        are swallowed (an observer must not break a compile)."""
        with self._lock:
            if fn not in self._compile_listeners:
                self._compile_listeners.append(fn)

    def remove_compile_listener(self, fn):
        with self._lock:
            try:
                self._compile_listeners.remove(fn)
            except ValueError:
                pass

    def _on_compile(self, name, signature=""):
        for fn in list(self._compile_listeners):
            try:
                fn(name, signature)
            except Exception:
                pass
        if self.enabled:
            self._m_compiles.inc(fn=name)
        if self.sink is not None:
            self.sink.emit("compile", fn=name,
                           signature=signature[:400] or None)
        trip = self.sentinel.observe(name, signature)
        if trip is not None:
            if self.enabled:
                self._m_storms.inc()
            logger.warning(
                "recompile storm: %s compiled %d times with %d distinct "
                "signatures: the inputs' shapes change; pad them to fixed "
                "shapes", name, trip["compiles"], trip["distinct_signatures"])
            if self.sink is not None:
                self.sink.emit("recompile_storm", **trip)

    # -- device memory ------------------------------------------------------

    def device_memory(self):
        """The caching allocator's ``bytes_in_use``, ``peak_bytes_in_use``,
        ``bytes_reserved`` and ``bytes_limit`` summed over the cards this
        process allocated on (``torch.cuda.memory_stats`` and
        ``mem_get_info``); {} on the CPU or before CUDA is initialised,
        which this never does."""
        return _cuda_memory()

    def _update_memory_gauges(self):
        mem = self.device_memory()
        if not mem:
            return
        for k, v in mem.items():
            self._m_mem.set(v, stat=k)

    # -- snapshots / health -------------------------------------------------

    def step_percentiles_ms(self):
        """p50 / p95 over the last 512 steps, exact, on the host."""
        with self._lock:
            times = sorted(self._step_times)
        if not times:
            return {"p50": None, "p95": None}

        def pick(q):
            i = min(len(times) - 1, int(q * (len(times) - 1) + 0.5))
            return round(times[i] * 1000, 3)
        return {"p50": pick(0.50), "p95": pick(0.95)}

    def snapshot(self):
        """A compact JSON-able summary (the whole registry is
        ``registry.snapshot()``).  The trace, numerics, goodput and memory
        blocks are None: those monitors wait for ROADMAP Queue 1 item 5's
        next slice."""
        compile_counts = self.sentinel.compile_counts()
        top = sorted(compile_counts.items(), key=lambda kv: -kv[1])[:8]
        pct = self.step_percentiles_ms()
        with self._lock:
            steps = self._steps
            last_ckpt = self._last_ckpt_step
        mem = self.device_memory()
        return {
            "enabled": self.enabled,
            "pid": os.getpid(),
            "process_index": self.process_index,
            "run_id": self.run_id,
            "steps": steps,
            "step_ms_p50": pct["p50"],
            "step_ms_p95": pct["p95"],
            "compiles": sum(compile_counts.values()),
            "compiles_by_fn": dict(top),
            "recompile_storms": sorted(self.sentinel.tripped()),
            "capture": {"hits": self._capture_hits,
                        "misses": dict(self._capture_misses)},
            "fusion": {"rewrites": dict(self._fusion_rewrites),
                       "fallbacks": dict(self._fusion_fallbacks)},
            "peak_device_memory_bytes": mem.get("peak_bytes_in_use"),
            "device_memory_bytes": mem.get("bytes_in_use"),
            "last_checkpoint_step": last_ckpt,
            "events_dropped": self.sink.dropped if self.sink else 0,
            "numerics": None,
            "goodput": None,
            "memory": None,
        }

    def healthz(self):
        """The liveness summary ``/healthz`` serves.  The JAX package's
        ``ok`` turns False on an expired heartbeat lease or an
        unavailable store: the port books neither until the elastic
        manager and the resilient store are ported (ROADMAP Queue 1 item
        6), so its ``elastic`` and ``store`` blocks are None, as the JAX
        package's are in a run without them, and so is the flight
        recorder's path (the tracer, item 5)."""
        now = time.time()
        with self._lock:
            last_step_ts = self._last_step_ts
            steps = self._steps
            last_ckpt = self._last_ckpt_step
        return {
            "ok": True,
            "pid": os.getpid(),
            "process_index": self.process_index,
            "run_id": self.run_id,
            "uptime_sec": round(now - self._start_ts, 1),
            "steps": steps,
            "last_step_age_sec": (round(now - last_step_ts, 3)
                                  if last_step_ts is not None else None),
            "last_checkpoint_step": last_ckpt,
            "elastic": None,
            "store": None,
            "recompile_storms": len(self.sentinel.tripped()),
            "flight_recorder": None,
        }


# -- the process's hub ------------------------------------------------------

_telemetry = None
_telemetry_lock = threading.Lock()


def get_telemetry() -> TrainingTelemetry:
    """The process's telemetry hub, made (off) on the first call and
    turned on there when ``PT_TELEMETRY`` is set: the environment is
    read lazily, so an import does nothing."""
    global _telemetry
    if _telemetry is None:
        with _telemetry_lock:
            if _telemetry is None:
                t = TrainingTelemetry()
                if _env_flag("PT_TELEMETRY"):
                    port = os.environ.get("PT_METRICS_PORT", "").strip()
                    t.enable(
                        jsonl_dir=(os.environ.get("PT_TELEMETRY_DIR")
                                   or None),
                        http_port=int(port) if port else None)
                _telemetry = t
    return _telemetry


def configure(enabled=True, jsonl_dir=None, http_port=None,
              compile_watch=True) -> TrainingTelemetry:
    """``configure(enabled=True, ...)`` turns the hub on
    (:meth:`TrainingTelemetry.enable`), ``enabled=False`` off."""
    t = get_telemetry()
    if enabled:
        t.enable(jsonl_dir=jsonl_dir, http_port=http_port,
                 compile_watch=compile_watch)
    else:
        t.disable()
    return t


def reset():
    """Tear down the hub and the registry (test isolation)."""
    global _telemetry
    with _telemetry_lock:
        t, _telemetry = _telemetry, None
    if t is not None:
        t.disable()
    from .metrics import reset_registry
    reset_registry()
