"""Serving engine: bucketed prefill/decode over a paged KV pool.

The counterpart of ``paddle_tpu/serving/engine.py``, which compiles one
executable per prefill bucket and one per decode bucket at load.  Here,
on the card, each bucket is one CUDA graph (:mod:`..jit.capture`),
captured at construction (:meth:`ServingEngine._warmup`): the bucket's
step runs once eagerly (building the kernels, giving cuBLAS its handles)
and is then recorded over the bucket's static token, position,
page-table and length buffers.  A request's step fills those buffers
from pinned host staging, replays the graph and copies the next tokens
out before any other bucket replays.  All the graphs share one memory
pool.  ``PT_CAPTURE=0`` (or a CPU device) runs the steps eagerly.  The
bucket ladder stays: it fixes the padded shapes, and so the
matrix-product algorithm of each bucket, which the continuous-batching
bit-identity contract needs.

KV state is updated in place: the steps write the pool tensors, which
the engine never rebinds; nor does it rebind a weight tensor
(:meth:`ServingEngine.install_weights` copies into them), since the
graphs read them where they were captured.

Served-model directories (the JAX package's format, so either package
serves the other's): :func:`save_served_model` writes
``serve_config.json`` (architecture and serve shapes) and a
:class:`~..distributed.CheckpointManager` weight tree; :func:`load_engine`
builds an engine from one.  With a manager attached,
:meth:`ServingEngine.maybe_reload` swaps in a newer generation between
scheduler steps: same graphs, weights copied in place, no recapture.

The fp32 path is meant to be fp32: on a CUDA device the engine turns
TF32 off for matrix products and cuDNN.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import weakref
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..jit import CapturedGraph, capture_enabled, capture_stream
from ..observability.metrics import get_registry
from ..observability.telemetry import get_telemetry
from .kv_cache import NULL_PAGE, PagePool, kv_page_budget
from .model import ModelSpec, decode_step, params_from_numpy, prefill_step

PRECISIONS = ("fp32", "bf16", "int8")

logger = logging.getLogger("paddle_tpu_torch.serving")

__all__ = ["ServeConfig", "ServingEngine", "PRECISIONS",
           "save_served_model", "is_served_model_dir", "load_engine",
           "SERVE_CONFIG_NAME"]

SERVE_CONFIG_NAME = "serve_config.json"

# above 0 while an engine in the process is inside its build: an armed
# engine ignores those compiles (a second engine coming up is not a
# request-path compile)
_AOT_BUILD_DEPTH = 0
_AOT_BUILD_LOCK = threading.Lock()


@contextlib.contextmanager
def aot_build_phase():
    """Mark the enclosed work as a sanctioned build: engine construction
    runs in one, so its bucket compiles do not count as request-path
    compiles on a live engine."""
    global _AOT_BUILD_DEPTH
    with _AOT_BUILD_LOCK:
        _AOT_BUILD_DEPTH += 1
    try:
        yield
    finally:
        with _AOT_BUILD_LOCK:
            _AOT_BUILD_DEPTH -= 1


def _buckets(v: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in v.replace(";", ",").split(",") if x.strip())


#: each ServeConfig field, the environment variable that overrides it
#: and how the variable's value is read
_ENV_VARS = (("decode_buckets", "PT_SERVE_BUCKETS", _buckets),
             ("prefill_buckets", "PT_SERVE_PREFILL_BUCKETS", _buckets),
             ("kv_pages", "PT_SERVE_KV_PAGES", int),
             ("page_size", "PT_SERVE_PAGE_SIZE", int),
             ("max_inflight", "PT_SERVE_MAX_INFLIGHT", int),
             ("max_new_tokens", "PT_SERVE_MAX_NEW_TOKENS", int),
             ("eos_id", "PT_SERVE_EOS_ID", int),
             ("deadline_ms", "PT_SERVE_DEADLINE_MS", float),
             ("max_queue", "PT_SERVE_MAX_QUEUE", int),
             ("drain_s", "PT_SERVE_DRAIN_S", float),
             ("precision", "PT_SERVE_PRECISION", str))


@dataclass(frozen=True)
class ServeConfig:
    """Engine shape/capacity configuration.

    Every field has an env override (read by :meth:`from_env`):

      PT_SERVE_BUCKETS          decode batch ladder, e.g. "2,4,8,16"
      PT_SERVE_PREFILL_BUCKETS  prompt seq ladder, e.g. "16,32,64"
      PT_SERVE_KV_PAGES         total pool pages (incl. null page)
      PT_SERVE_PAGE_SIZE        tokens per page
      PT_SERVE_MAX_INFLIGHT     admission cap (queued + active)
      PT_SERVE_MAX_NEW_TOKENS   default generation length
      PT_SERVE_EOS_ID           stop token (<0: length-bounded only)
      PT_SERVE_DEADLINE_MS      server-default request deadline (0 = none)
      PT_SERVE_MAX_QUEUE        bounded admission queue (0 = unbounded)
      PT_SERVE_DRAIN_S          graceful-drain budget on SIGTERM
      PT_SERVE_PRECISION        serve numerics: fp32 | bf16 | int8

    ``kv_pages`` is denominated in fp32 pages (a byte budget): lower
    precisions get more physical pages for the same spend
    (:func:`.kv_cache.kv_page_budget`).
    """

    decode_buckets: Tuple[int, ...] = (2, 4, 8, 16)
    prefill_buckets: Tuple[int, ...] = (16, 32, 64)
    kv_pages: int = 128
    page_size: int = 16
    max_inflight: int = 64
    max_new_tokens: int = 32
    eos_id: int = -1          # <0: never stops early (length-bounded)
    deadline_ms: float = 0.0  # server default; 0 = no deadline
    max_queue: int = 256      # bounded queue; 0 = unbounded
    drain_s: float = 10.0     # SIGTERM drain budget (seconds)
    precision: str = "fp32"   # fp32 | bf16 | int8

    @staticmethod
    def env_overrides() -> Dict[str, Any]:
        """The fields whose ``PT_SERVE_*`` variable is set (and not
        empty), each read from its variable."""
        return {field: read(os.environ[var])
                for field, var, read in _ENV_VARS if os.environ.get(var)}

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        return cls().replace(**{**cls.env_overrides(), **overrides})

    def replace(self, **kw) -> "ServeConfig":
        d = asdict(self)
        d.update(kw)
        d["decode_buckets"] = tuple(d["decode_buckets"])
        d["prefill_buckets"] = tuple(d["prefill_buckets"])
        return ServeConfig(**d)

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["decode_buckets"] = list(self.decode_buckets)
        d["prefill_buckets"] = list(self.prefill_buckets)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeConfig":
        names = set(cls.__dataclass_fields__)
        kw = {k: v for k, v in d.items() if k in names}
        for key in ("decode_buckets", "prefill_buckets"):
            if key in kw:
                kw[key] = tuple(int(x) for x in kw[key])
        return cls(**kw)

    def normalized(self, spec: ModelSpec) -> "ServeConfig":
        """Clamp the ladders to what the model/pool can serve.

        Decode buckets are clamped to >= 2: a batch-1 matrix product may
        take a matrix-vector path with another reduction order, and the
        bit-identity contract across batch compositions holds only for
        matmul-shaped batches.  A solo sequence decodes in a 2-bucket
        with a null padding row instead.
        """
        dec = sorted({max(2, int(b)) for b in self.decode_buckets})
        pre = sorted({int(s) for s in self.prefill_buckets
                      if int(s) <= spec.max_seq_len})
        if not pre:
            pre = [spec.max_seq_len]
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"precision {self.precision!r} not in {PRECISIONS}")
        return self.replace(decode_buckets=tuple(dec),
                            prefill_buckets=tuple(pre))


_KV_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}


def _shares_storage(t: torch.Tensor, src) -> bool:
    return (isinstance(src, torch.Tensor) and t.device == src.device
            and t.untyped_storage().data_ptr()
            == src.untyped_storage().data_ptr())


class _Bucket:
    """One bucket's captured graph: its static device inputs, filled
    from pinned host staging, and the graph that reads them."""

    __slots__ = ("staging", "inputs", "graph")

    def __init__(self, staging, inputs, graph):
        self.staging, self.inputs, self.graph = staging, inputs, graph

    def run(self, **host) -> torch.Tensor:
        """Stage ``host`` (numpy, by input name), replay; the graph's
        output, valid until its next replay."""
        for name, a in host.items():
            self.staging[name].numpy()[...] = a
            self.inputs[name].copy_(self.staging[name], non_blocking=True)
        self.graph.replay()
        return self.graph.outputs


class ServingEngine:
    """Bucketed steps + paged KV pool + swappable weights.

    ``device`` defaults to ``cuda`` and raises when there is no GPU;
    pass ``device="cpu"`` to run the plain PyTorch path.  The request
    path (scheduler / HTTP) calls :meth:`prefill` and :meth:`decode`
    with numpy inputs.  ``checkpoint_manager`` (a
    :class:`~..distributed.CheckpointManager` over weight generations)
    is what :meth:`maybe_reload` polls.
    """

    def __init__(self, spec: ModelSpec, params, config: ServeConfig = None,
                 *, device=None, weights_step: Optional[int] = None,
                 checkpoint_manager=None):
        with aot_build_phase():
            self._build(spec, params, config, device, weights_step,
                        checkpoint_manager)
        self._arm_sentinel()
        from .scheduler import ContinuousScheduler
        self.scheduler = ContinuousScheduler(self)

    def _build(self, spec, params, config, device, weights_step,
               checkpoint_manager):
        self.spec = spec
        self.checkpoint_manager = checkpoint_manager
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = (config or ServeConfig.from_env()).normalized(spec)
        self.max_pages_per_seq = -(-spec.max_seq_len // self.config.page_size)
        prec = self.config.precision
        self.pool = PagePool(
            layers=spec.layers,
            pages=kv_page_budget(self.config.kv_pages, prec, spec.head_dim),
            page_size=self.config.page_size, heads=spec.heads,
            head_dim=spec.head_dim, dtype=_KV_DTYPE[prec],
            scale_pages=(prec == "int8"), device=self.device)
        # the engine owns its weights: install_weights writes into them
        self._params = {
            name: t.clone() if _shares_storage(t, params.get(name)) else t
            for name, t in self._prepare_params(params).items()}
        self._weights_step = weights_step
        self._weights_lock = threading.Lock()
        # compiles seen after warm-up (a request-path compile: /healthz
        # degrades)
        self.unexpected_compiles = 0
        self.compiled_programs = 0
        #: ("prefill" | "decode", bucket) -> its captured graph
        self._graphs: Dict[Tuple[str, int], _Bucket] = {}
        self.capture_seconds = 0.0
        self._warmup()

    def _prepare_params(self, params):
        """Carry an incoming weight dict onto the device at the engine's
        precision.

        int8: deterministic inline quantization (same weights, same
        bytes); an already-quantized dict passes through.  bf16: every
        float leaf cast.  fp32: as given.  Calibration leaves
        (``act::<site>::scale``) ride along unchanged, as the JAX engine
        carries them.
        """
        prec = self.config.precision
        params = params_from_numpy(
            params, self.device,
            dtype=torch.bfloat16 if prec == "bf16" else None)
        if prec == "int8":
            from . import quant as _quant
            if not _quant.is_quantized_params(params):
                params = _quant.quantize_params(params, self.spec)
        return params

    def _warmup(self) -> None:
        """Run every bucket once, so the kernels are built and loaded and
        the first request pays no lazy initialisation; on the card, then
        capture each bucket's graph.  Warm-up traffic writes only the
        null page."""
        maxp = self.max_pages_per_seq
        graphs = self.device.type == "cuda" and capture_enabled()
        if graphs:
            stream = capture_stream(self.device)
            pool = torch.cuda.graph_pool_handle()
        for s in self.config.prefill_buckets:
            host = {"tokens": np.zeros((s,), np.int32),
                    "length": np.ones((), np.int32),
                    "page_table": np.zeros((maxp,), np.int32)}
            if graphs:
                self._capture("prefill", s, host, self._prefill_on,
                              stream, pool)
            else:
                self._prefill_padded(host["tokens"], 1, host["page_table"])
            self._account_compile(f"serve_prefill_s{s}{self._suffix()}")
        for b in self.config.decode_buckets:
            host = {"tokens": np.zeros((b,), np.int32),
                    "positions": np.zeros((b,), np.int32),
                    "page_tables": np.zeros((b, maxp), np.int32)}
            if graphs:
                self._capture("decode", b, host, self._decode_on,
                              stream, pool)
            else:
                self._decode_padded(host["tokens"], host["positions"],
                                    host["page_tables"])
            self._account_compile(f"serve_decode_b{b}{self._suffix()}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.compiled_programs = (len(self.config.prefill_buckets)
                                  + len(self.config.decode_buckets))
        logger.info("serve buckets warmed: prefill %s, decode %s, %d graphs",
                    list(self.config.prefill_buckets),
                    list(self.config.decode_buckets), len(self._graphs))

    def _suffix(self) -> str:
        prec = self.config.precision
        return "" if prec == "fp32" else f"_{prec}"

    @staticmethod
    def _account_compile(name: str) -> None:
        """A bucket built (its warm-up and, on the card, its graph): one
        compile, the JAX engine's ahead-of-time build of the bucket."""
        get_telemetry().record_compile(name, signature="aot-build")

    def _arm_sentinel(self) -> None:
        """From here on (after the warm-up), a compile anywhere in the
        process is a request-path compile: counted and /healthz degraded.
        The listener holds the engine weakly (an engine nobody closes is
        still freed) and leaves once it is."""
        tel = get_telemetry()
        tel.ensure_compile_watch()
        ref = weakref.ref(self)

        def listener(name, signature=""):
            engine = ref()
            if engine is None:
                tel.remove_compile_listener(listener)
            else:
                engine._on_compile_event(name, signature)
        self._compile_listener = listener
        tel.add_compile_listener(listener)

    def _on_compile_event(self, name: str, signature: str = "") -> None:
        if _AOT_BUILD_DEPTH > 0:
            return
        self.unexpected_compiles += 1
        logger.warning(
            "unexpected request-path compile: %s; the serve ladder should "
            "cover every shape; /healthz now degraded", name)
        if get_telemetry().enabled:
            get_registry().counter(
                "pt_serve_unexpected_compiles_total",
                "Compiles observed after serve warmup (SLO alarm)",
                labelnames=("fn",)).inc(fn=name)

    def _capture(self, kind, size, host, fn, stream, pool) -> None:
        """Warm up and capture one bucket over static buffers made from
        ``host`` (numpy), staged through pinned host memory."""
        staging = {k: torch.from_numpy(a).pin_memory()
                   for k, a in host.items()}
        inputs = {k: t.to(self.device) for k, t in staging.items()}
        CapturedGraph.warm_up(fn, (inputs,), {}, stream=stream)
        graph = CapturedGraph.capture(fn, (inputs,), {}, stream=stream,
                                      pool=pool)
        self._graphs[(kind, size)] = _Bucket(staging, inputs, graph)
        self.capture_seconds += graph.capture_s

    def _prefill_on(self, buf):
        """The prefill step on device inputs (``buf`` by name): its first
        token.  What a prefill bucket's graph records."""
        *_, nxt, _ = prefill_step(
            self.spec, self._params, self.pool.k_flat, self.pool.v_flat,
            buf["tokens"], buf["length"], buf["page_table"],
            page_size=self.config.page_size, **self._scale_kw())
        return nxt

    def _decode_on(self, buf):
        """The decode step on device inputs (``buf`` by name): the next
        tokens.  What a decode bucket's graph records."""
        *_, nxt, _ = decode_step(
            self.spec, self._params, self.pool.k_flat, self.pool.v_flat,
            buf["tokens"], buf["positions"], buf["page_tables"],
            page_size=self.config.page_size, **self._scale_kw())
        return nxt

    def close(self) -> None:
        """Stop the scheduler's background loop, if one runs, and the
        compile listener."""
        get_telemetry().remove_compile_listener(self._compile_listener)
        self.scheduler.stop()

    # -- request path ---------------------------------------------------------

    def prefill_bucket_for(self, n: int) -> int:
        for s in self.config.prefill_buckets:
            if n <= s:
                return s
        raise ValueError(
            f"prompt length {n} exceeds largest prefill bucket "
            f"{self.config.prefill_buckets[-1]}")

    def decode_bucket_for(self, n: int) -> int:
        for b in self.config.decode_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"{n} active sequences exceed largest decode bucket "
            f"{self.config.decode_buckets[-1]}")

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _prefill_padded(self, padded, n, page_table) -> int:
        """The first generated token of one padded prompt: its bucket's
        graph replayed, or the step run eagerly where there is none."""
        with self._weights_lock:
            bucket = self._graphs.get(("prefill", padded.shape[0]))
            if bucket is not None:
                return int(bucket.run(tokens=padded, length=n,
                                      page_table=page_table))
            return int(self._prefill_on({
                "tokens": self._tensor(padded), "length": n,
                "page_table": self._tensor(page_table)}))

    def _decode_padded(self, tok, pos, pt) -> np.ndarray:
        """The next token of every row of a padded decode batch: its
        bucket's graph replayed, or the step run eagerly where there is
        none."""
        with self._weights_lock:
            bucket = self._graphs.get(("decode", tok.shape[0]))
            if bucket is not None:
                return bucket.run(tokens=tok, positions=pos,
                                  page_tables=pt).cpu().numpy()
            return self._decode_on({
                "tokens": self._tensor(tok), "positions": self._tensor(pos),
                "page_tables": self._tensor(pt)}).cpu().numpy()

    def _scale_kw(self):
        if self.pool.scale_pages:
            return {"k_scale": self.pool.k_scale, "v_scale": self.pool.v_scale}
        return {}

    def prefill(self, tokens: Sequence[int], page_table: np.ndarray) -> int:
        """Run one prompt; returns the first generated token."""
        n = len(tokens)
        s = self.prefill_bucket_for(n)
        padded = np.zeros((s,), np.int32)
        padded[:n] = np.asarray(tokens, np.int32)
        return self._prefill_padded(padded, n,
                                    np.asarray(page_table, np.int32))

    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               page_tables: np.ndarray) -> np.ndarray:
        """One decode step over ``n`` active rows, padded to a bucket.

        Padding rows carry position 0 and the all-null page table, so
        their K/V writes land in the null page.
        """
        n = tokens.shape[0]
        b = self.decode_bucket_for(max(n, 1))
        maxp = self.max_pages_per_seq
        tok = np.zeros((b,), np.int32)
        pos = np.zeros((b,), np.int32)
        pt = np.full((b, maxp), NULL_PAGE, np.int32)
        tok[:n] = tokens
        pos[:n] = positions
        pt[:n] = page_tables
        return self._decode_padded(tok, pos, pt)[:n]

    # -- weights ------------------------------------------------------------

    @property
    def weights_step(self) -> Optional[int]:
        return self._weights_step

    def install_weights(self, params, step: Optional[int] = None) -> None:
        """Swap to a new weight generation between steps.

        The names and shapes must match the served ones (``act::``
        leaves included); incoming weights pass through the engine's
        precision conversion first (int8 quantization included), then
        are copied into the served tensors in place, which the captured
        graphs read.
        """
        params = self._prepare_params(params)
        if set(params) != set(self._params):
            missing = sorted(set(self._params) - set(params))
            extra = sorted(set(params) - set(self._params))
            raise ValueError(f"weight swap changes the parameter names: "
                             f"missing {missing[:4]}, unexpected "
                             f"{extra[:4]}")
        for name, a in self._params.items():
            if a.shape != params[name].shape:
                raise ValueError(f"weight swap changes the shape of {name}: "
                                 f"{tuple(params[name].shape)} vs "
                                 f"{tuple(a.shape)}")
        with self._weights_lock:
            for name, a in self._params.items():
                a.copy_(params[name])
            self._weights_step = step
        logger.info("weights swapped to generation step=%s", step)

    def maybe_reload(self) -> Optional[int]:
        """Swap in a newer weight generation of :attr:`checkpoint_manager`
        if one exists: its newest valid step (falling back past corrupt
        ones), read onto the engine's device in the checkpoint's dtypes,
        then :meth:`install_weights` (precision conversion, int8
        quantization before the copy, the name and shape checks, the
        in-place copy under the weights lock, between scheduler steps).
        No graph is recaptured and no graph input is allocated.  Returns
        the new step, or None when there is nothing newer."""
        mgr = self.checkpoint_manager
        if mgr is None:
            return None
        latest = mgr.latest_step()
        if latest is None or latest == self._weights_step:
            return None
        params, step = mgr.restore_latest(device=self.device)
        if step is None or step == self._weights_step:
            return None
        self.install_weights(params, step)
        return step

    # -- convenience / health ----------------------------------------------

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None) -> List[List[int]]:
        """Synchronous batch generate through the continuous-batching
        scheduler (submits all, drains the loop)."""
        streams = [self.scheduler.submit(p, max_new_tokens=max_new_tokens)
                   for p in prompts]
        self.scheduler.drain()
        # the drain above already emptied the loop; the bound is a
        # backstop so a wedged stream can never hang the caller forever
        return [st.result(timeout=300.0) for st in streams]

    def healthz(self) -> Dict[str, Any]:
        sched = getattr(self, "scheduler", None)
        draining = bool(sched is not None and sched.draining)
        hang = bool(sched is not None and sched.hang_detected)
        try:
            self.pool.check_consistency()
            kv_consistent = True
        except AssertionError:
            kv_consistent = False
        h = {
            # degraded while draining (load balancers must stop routing
            # here), on any request-path compile, a tripped hang
            # watchdog, or a page-pool invariant violation
            "ok": (self.unexpected_compiles == 0 and not draining
                   and not hang and kv_consistent),
            "draining": draining,
            "hang_detected": hang,
            "kv_consistent": kv_consistent,
            "unexpected_compiles": self.unexpected_compiles,
            "compiled_programs": self.compiled_programs,
            "precision": self.config.precision,
            "decode_buckets": list(self.config.decode_buckets),
            "prefill_buckets": list(self.config.prefill_buckets),
            "weights_step": self._weights_step,
            "kv": self.pool.snapshot(),
        }
        if sched is not None:
            h.update(sched.snapshot())
        return h


# -- served-model directory format ------------------------------------------

def save_served_model(path: str, spec: ModelSpec, params,
                      config: Optional[ServeConfig] = None,
                      step: int = 0) -> str:
    """Write a self-describing served-model directory:
    ``serve_config.json`` (architecture and serve shapes) and a
    :class:`~..distributed.CheckpointManager` weight tree under
    ``weights/`` (step ``step``), the unit :func:`load_engine` reads and
    a trainer republishes for a hot reload."""
    from ..distributed.checkpoint_manager import CheckpointManager
    os.makedirs(path, exist_ok=True)
    cfg = config or ServeConfig.from_env()
    with open(os.path.join(path, SERVE_CONFIG_NAME), "w") as f:
        json.dump({"model": spec.to_dict(), "serve": cfg.to_dict()},
                  f, indent=2, sort_keys=True)
    mgr = CheckpointManager(os.path.join(path, "weights"))
    mgr.save(step, dict(params), block=True)
    return path


def is_served_model_dir(path: str) -> bool:
    return os.path.isdir(path) and \
        os.path.exists(os.path.join(path, SERVE_CONFIG_NAME))


def load_engine(path: str, config: Optional[ServeConfig] = None, *,
                device=None, **config_overrides) -> ServingEngine:
    """Build a :class:`ServingEngine` on ``device`` (``cuda`` unless the
    CPU is asked for) from a served-model directory, either package's:
    the newest valid weight generation, read onto the device, the
    directory's manager attached for :meth:`ServingEngine.maybe_reload`.

    Config precedence: ``config`` > the ``PT_SERVE_*`` environment >
    ``serve_config.json``; ``config_overrides`` apply last.  A quantized
    directory (:func:`.quant.save_quantized_model`) carries its int8
    tree and its ``precision`` block; the restored tree must match
    :func:`.quant.quantized_template`'s names and shapes."""
    from ..distributed.checkpoint_manager import CheckpointManager
    dev = resolve_device(device)
    with open(os.path.join(path, SERVE_CONFIG_NAME)) as f:
        meta = json.load(f)
    spec = ModelSpec.from_dict(meta.get("model", {}))
    if config is None:
        config = ServeConfig.from_dict(meta.get("serve", {})).replace(
            **ServeConfig.env_overrides())
    if config_overrides:
        config = config.replace(**config_overrides)
    mgr = CheckpointManager(os.path.join(path, "weights"))
    params, step = mgr.restore_latest(device=dev)
    if step is None:
        raise FileNotFoundError(
            f"no valid weight checkpoint under {path}/weights")
    precision_meta = meta.get("precision") or {}
    if precision_meta.get("mode") == "int8":
        from .quant import quantized_template
        want = {k: (tuple(t.shape), t.dtype) for k, t in quantized_template(
            spec, sorted(precision_meta.get("act_scales", {}))).items()}
        got = {k: (tuple(t.shape), t.dtype) for k, t in params.items()}
        if got != want:
            bad = sorted(k for k in set(want) | set(got)
                         if want.get(k) != got.get(k))
            raise ValueError(f"{path}: the quantized weights do not match "
                             f"its precision block: {bad[:4]}")
    return ServingEngine(spec, params, config, device=dev,
                         checkpoint_manager=mgr, weights_step=step)
