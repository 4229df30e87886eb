"""Whole-step capture: a user's step replayed as one CUDA graph.

The counterpart of ``paddle_tpu/jit/capture.py``.  ``@capture_step``
turns a training step (forward, loss, ``loss.backward()``, the
optimizer's update) into one cached program per call signature: the JAX
package traces it once into one XLA program, the port records it once
into one ``torch.cuda.CUDAGraph`` and replays it.

How a signature is captured: the first call for it runs ``fn`` eagerly
on a side stream (one for the process, :func:`capture_stream`).  That
run is the warm-up (it builds the kernels, traces the fusion pass, makes
cuBLAS's handles on that stream) and its result is returned.  Then one graph of ``fn`` is recorded over static
copies of the tensor arguments; recording runs nothing, so the state
after the first call is the state after one eager step.  Later calls
copy their tensors into the static buffers and replay the graph; the
tensors it returns are cloned, so the next replay does not overwrite a
loss the caller still holds.  All the graphs of one :class:`CapturedStep`
share one memory pool.

What replays correctly: anything whose per-step values live on the
device.  The optimizer's step count is a device tensor
(:mod:`...optimizer`), and so is its learning rate: ``TrainStep`` writes
``get_lr()`` into it before each call, outside the graph, so
``set_lr``, ``set_lr_scheduler`` and ``scheduler.step()`` reach a graph
recorded once (a learning rate passed as a Python float would be a
cache-key leaf: each new value would record a new graph, and one baked
into an operation's arguments would never change).  The clips' norms
and scales are device tensors too.  The CUDA generators the step
reaches are registered with each graph, so every replay draws new
dropout masks, as eager steps do.  Recompute's rerun reads and sets its generator's state
on the host (:func:`...framework.random.replay`); during a capture that
state places the graph's draws, so each replay's rerun draws what its
forward drew.  The kernels' TMA maps hold raw addresses that a graph
bakes in, which is why the step sees static buffers and persistent
parameters, never a tensor made fresh each call.
A parameter rebound to new storage (``p.data = ...``) is not seen by the
graph; in-place updates (``copy_``, ``load_state_dict``) are.

Cache key: the arguments' tree structure, each tensor's shape, dtype,
device and ``requires_grad``, the hashable non-tensor leaves, and the
``training`` flag of every module the callable reaches (its bound
``self`` or a callable object and their attributes, its closure cells,
the globals its code loads; one level into lists, tuples and dicts, the
discovery rule of the JAX package's ``_closure_layer_targets``).  The
same key replays; a new shape or dtype captures exactly one new entry.

Launch counters: each entry notes how much every kernel wrapper's
``launches`` (and ``residual_launches``) rose while it was recorded,
puts the counts back (recording launched nothing), and adds that much
at each replay, so the counters keep meaning "kernels the card ran".

Fallback: code that a graph cannot hold raises at capture ("operation
not permitted when stream is capturing", an illegal host copy such as
``loss.item()``).  The capture is ended, ``stats["fallback"]`` becomes
``"capture_unsafe"``, one warning names the error, and the step runs
eagerly from then on.  CPU tensors have no graph: the step runs as
written with ``stats["fallback"] == "cpu"``.  ``PT_CAPTURE=0`` turns
capture off.

Telemetry (:mod:`..observability`): a replay books
``pt_capture_cache_hits_total``; a call that captures books a miss,
``first_trace`` or ``signature_change``, and one that falls back another,
with its reason (the JAX package's reason strings); each graph recorded
is one compile (``record_compile("captured_step(<fn>)")``), the JAX
package's compile of the step.  The CPU's eager path books nothing.

Collectives: a step whose ``groups`` (the process groups of
:mod:`..distributed.collective` its collectives run on) are NCCL groups
records them into its graph.  gloo's collectives run on the host, which
a graph cannot hold, so :func:`capture_step` refuses a step with a gloo
group (on the CPU too): its caller runs it eagerly, by saying so
(``build_train_step(..., capture=False)``), never by a silent fallback.
"""
from __future__ import annotations

import dis
import functools
import gc
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch

from ..observability.telemetry import get_telemetry
from ..ops import add_launch_counts, launch_counts, set_launch_counts
from ..ops import fusion_pass

__all__ = ["capture_step", "CapturedStep", "CapturedGraph",
           "capture_enabled", "capture_stream"]

logger = logging.getLogger("paddle_tpu_torch.jit")

_FALSY = {"0", "false", "no", "off"}


def capture_enabled() -> bool:
    """False when ``PT_CAPTURE`` is 0, false, no or off."""
    return os.environ.get("PT_CAPTURE", "1").strip().lower() not in _FALSY


_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def capture_stream(device) -> "torch.cuda.Stream":
    """The side stream every warm-up and capture on ``device`` runs on.
    One for the process: cuBLAS keeps a workspace for each stream it
    meets, for good, so a stream per captured step would leave one
    behind for each step (and pin the memory around it)."""
    device = torch.device(device)
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


# -- trees ---------------------------------------------------------------------

def _flatten(obj, leaves: list):
    """The structure of ``obj`` (lists, tuples, dicts nested), hashable;
    its leaves appended to ``leaves``."""
    if isinstance(obj, (list, tuple)):
        return (type(obj), tuple(_flatten(o, leaves) for o in obj))
    if isinstance(obj, dict):
        keys = tuple(obj)
        return (dict, keys, tuple(_flatten(obj[k], leaves) for k in keys))
    leaves.append(obj)
    return None


def _unflatten(struct, leaves):
    it = iter(leaves)

    def build(st):
        if st is None:
            return next(it)
        if st[0] is dict:
            return {k: build(s) for k, s in zip(st[1], st[2])}
        items = [build(s) for s in st[1]]
        kind = st[0]
        if kind in (list, tuple):
            return kind(items)
        return kind(*items)            # a named tuple
    return build(struct)


# -- discovery -----------------------------------------------------------------

@functools.lru_cache(maxsize=512)
def _loaded_global_names(code) -> tuple:
    """Names a code object loads as globals (bytecode is immutable, so
    one disassembly a code object)."""
    return tuple(ins.argval for ins in dis.get_instructions(code)
                 if ins.opname == "LOAD_GLOBAL")


def _reachable(fn) -> List[Any]:
    """The objects ``fn`` reaches: its bound ``self`` (or ``fn`` itself
    when it is a callable object) and their attributes, its closure
    cells and the globals its code loads, each one level into lists,
    tuples and dicts."""
    out, seen = [], set()

    def add(val):
        if id(val) not in seen:
            seen.add(id(val))
            out.append(val)

    def add_container(val):
        add(val)
        if isinstance(val, (list, tuple)):
            for v in val:
                add(v)
        elif isinstance(val, dict):
            for v in val.values():
                add(v)

    obj = getattr(fn, "__self__", None)
    if obj is None and not hasattr(fn, "__code__"):
        obj = fn
    if obj is not None:
        add(obj)
        for v in getattr(obj, "__dict__", {}).values():
            add_container(v)
    raw = getattr(fn, "__func__", fn)
    raw = getattr(raw, "__wrapped__", raw)
    code = getattr(raw, "__code__", None)
    cells = getattr(raw, "__closure__", None) or ()
    names = code.co_freevars if code is not None else ()
    for _, cell in zip(names, cells):
        try:
            add_container(cell.cell_contents)
        except ValueError:
            continue
    if code is not None:
        g = getattr(raw, "__globals__", {})
        for name in dict.fromkeys(_loaded_global_names(code)):
            if name in g:
                add_container(g[name])
    return out


# -- one graph -----------------------------------------------------------------

class CapturedGraph:
    """One CUDA graph of ``fn`` over static tensors.

    :meth:`warm_up` runs ``fn`` eagerly on the capture's stream;
    :meth:`capture` then records the graph over
    ``args`` (tensors that live as long as the graph).  :meth:`replay`
    replays it and adds the recorded kernel launches to the wrappers'
    counters; ``outputs`` are the graph's own output tensors, overwritten
    by each replay."""

    __slots__ = ("graph", "outputs", "launches", "capture_s",
                 "inputs", "out_struct", "_out_leaves")

    @staticmethod
    def warm_up(fn: Callable, args: tuple, kwargs: dict, *,
                stream: torch.cuda.Stream):
        """``fn``'s result."""
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            result = fn(*args, **kwargs)
        cur.wait_stream(stream)
        for t in _leaves(result):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(cur)     # the caller reads it there
        return result

    @classmethod
    def capture(cls, fn: Callable, args: tuple, kwargs: dict, *,
                stream: torch.cuda.Stream, pool,
                generators: Sequence[torch.Generator] = (),
                params: Iterable[torch.Tensor] = ()) -> "CapturedGraph":
        """Record ``fn(*args, **kwargs)``.  Raises what the capture
        raised, after ending it and putting the counters and the
        parameters' gradients back."""
        torch.cuda.synchronize(stream.device)
        self = cls()
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        params = list(params)
        grads = [p.grad for p in params]
        before = launch_counts()
        t0 = time.perf_counter()
        # cyclic garbage is collected first, as torch.cuda.graph does: an
        # old step's autograd graph left in a cycle keeps its gradient
        # accumulators, made on another stream, alive into the backward
        # being recorded, which then fails.  The collector then stays off
        # while the graph records: a graph it frees mid-capture (an old
        # step's or engine's) resets itself, which is not permitted during
        # a capture and invalidates this one
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool)
                try:
                    out = fn(*args, **kwargs)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                graph.capture_end()
        except BaseException:
            for p, g in zip(params, grads):
                p.grad = g
            raise
        finally:
            if collecting:
                gc.enable()
            after = launch_counts()
            set_launch_counts(before)
        self.capture_s = time.perf_counter() - t0
        self.launches = {k: after[k] - before[k] for k in before
                         if after[k] != before[k]}
        self.graph = graph
        self.inputs = [t for t in _leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)]
        self._out_leaves = []
        self.out_struct = _flatten(out, self._out_leaves)
        self.outputs = out
        return self

    def replay(self) -> None:
        self.graph.replay()
        add_launch_counts(self.launches)

    def cloned_outputs(self):
        """The outputs of the last replay, each tensor cloned."""
        return _unflatten(self.out_struct, [
            t.clone() if isinstance(t, torch.Tensor) else t
            for t in self._out_leaves])


def _leaves(obj) -> list:
    leaves = []
    _flatten(obj, leaves)
    return leaves


# -- the step ------------------------------------------------------------------

class CapturedStep:
    """One captured step callable (see the module docstring).

    ``stats``: ``hits`` (replays), ``misses`` (calls that captured),
    ``compiles`` (graphs recorded), ``fallback`` (None, ``"cpu"``,
    ``"capture_unsafe"`` or ``"unsupported_args"``), and
    ``fusion_rewrites`` / ``fusion_patterns``: what the fusion pass
    rewrote in the graphs traced during the warm-ups.
    ``capture_seconds`` sums the time spent recording graphs."""

    def __init__(self, fn: Callable):
        gloo = [g for g in getattr(fn, "groups", ()) or ()
                if g.backend == "gloo"]
        if gloo:
            raise ValueError(
                f"capture_step cannot record a step whose collectives run on "
                f"gloo ({gloo[0]}): gloo's collectives run on the host.  Run "
                f"it eagerly (build_train_step(..., capture=False)), or use "
                f"NCCL")
        self._fn = fn
        self._cache: Dict[tuple, CapturedGraph] = {}
        self._fallback_reason: Optional[str] = None
        self._warned = False
        self._pool = None
        self._stream = None
        self.capture_seconds = 0.0
        self.stats = {"hits": 0, "misses": 0, "compiles": 0,
                      "fallback": None, "fusion_rewrites": 0,
                      "fusion_patterns": {}}
        functools.update_wrapper(self, fn, updated=())

    @property
    def fallback_reason(self) -> Optional[str]:
        return self._fallback_reason

    @property
    def graphs(self) -> List[CapturedGraph]:
        """The captured graphs, one a cache key."""
        return list(self._cache.values())

    def reset(self) -> None:
        """Drop every graph and the memory pool.  Parameters and the
        optimizer's state keep their values."""
        self._cache.clear()
        self._pool = None
        self._stream = None
        self._fallback_reason = None
        self.stats["fallback"] = None

    def __call__(self, *args, **kwargs):
        if not capture_enabled() or (self._fallback_reason is not None
                                     and self._fallback_reason != "cpu"):
            return self._fn(*args, **kwargs)
        leaves: list = []
        struct = _flatten((args, kwargs), leaves)
        found = _reachable(self._fn)
        modules = [o for o in found if isinstance(o, torch.nn.Module)]
        device = _device_of(leaves, modules)
        if device.type != "cuda":
            self._fallback_reason = self.stats["fallback"] = "cpu"
            return self._fn(*args, **kwargs)
        try:
            key = _signature(struct, leaves, modules)
            hash(key)
        except TypeError:
            self._fall_back("unsupported_args", None)
            return self._fn(*args, **kwargs)
        entry = self._cache.get(key)
        tel = get_telemetry()
        if entry is not None:
            self.stats["hits"] += 1
            tel.capture_cache_hit()
            tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
            for buf, x in zip(entry.inputs, tensors):
                buf.copy_(x)
            entry.replay()
            return entry.cloned_outputs()
        self.stats["misses"] += 1
        tel.capture_cache_miss("first_trace" if not self._cache
                               else "signature_change")
        self._fallback_reason = self.stats["fallback"] = None
        return self._capture(key, struct, leaves, args, kwargs, found,
                             modules, device)

    def _capture(self, key, struct, leaves, args, kwargs, found, modules,
                 device):
        if self._stream is None:
            self._stream = capture_stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        static = [x.detach().clone().requires_grad_(x.requires_grad)
                  if isinstance(x, torch.Tensor) else x for x in leaves]
        s_args, s_kwargs = _unflatten(struct, static)
        generators = [o for o in found if isinstance(o, torch.Generator)
                      and o.device.type == "cuda"]
        params = [p for m in modules for p in m.parameters()]
        rewrites = fusion_pass.summary()["rewrites"]
        try:
            result = CapturedGraph.warm_up(self._fn, args, kwargs,
                                           stream=self._stream)
        finally:
            self._count_rewrites(rewrites)
        try:
            entry = CapturedGraph.capture(
                self._fn, s_args, s_kwargs, stream=self._stream,
                pool=self._pool, generators=generators,
                params=params)
        except RuntimeError as e:
            # the warm-up ran the step once: its result stands
            self._fall_back("capture_unsafe", e)
            return result
        self._cache[key] = entry
        self.stats["compiles"] += 1
        self.capture_seconds += entry.capture_s
        # the sentinel's signature: the tensors' shapes and dtypes (what
        # churns in a recompile storm), not the modules' identities
        name = getattr(self._fn, "__name__", type(self._fn).__name__)
        sig = ",".join(f"{tuple(x.shape)}:{x.dtype}" for x in leaves
                       if isinstance(x, torch.Tensor))
        get_telemetry().record_compile(f"captured_step({name})",
                                       f"sig={sig}")
        return result

    def _count_rewrites(self, before: dict) -> None:
        after = fusion_pass.summary()["rewrites"]
        patterns = self.stats["fusion_patterns"]
        for name, n in after.items():
            d = n - before.get(name, 0)
            if d:
                patterns[name] = patterns.get(name, 0) + d
                self.stats["fusion_rewrites"] += d

    def _fall_back(self, reason: str, exc: Optional[BaseException]) -> None:
        self._fallback_reason = self.stats["fallback"] = reason
        get_telemetry().capture_cache_miss(reason)
        if not self._warned:
            self._warned = True
            name = getattr(self._fn, "__qualname__", repr(self._fn))
            logger.warning("capture_step(%s) runs eagerly from now on "
                           "(%s): %s", name, reason,
                           f"{type(exc).__name__}: {exc}" if exc else
                           "an argument cannot key the cache")


def _device_of(leaves, modules) -> torch.device:
    for x in leaves:
        if isinstance(x, torch.Tensor):
            return x.device
    for m in modules:
        for p in m.parameters():
            return p.device
    return torch.device("cpu")


def _signature(struct, leaves, modules) -> tuple:
    key: List[Any] = [struct]
    for x in leaves:
        if isinstance(x, torch.Tensor):
            key.append(("t", tuple(x.shape), x.dtype, x.device,
                        x.requires_grad))
        else:
            key.append(("s", x))
    for m in modules:
        key.append((id(m), tuple(sm.training for sm in m.modules())))
    return tuple(key)


def capture_step(fn: Optional[Callable] = None):
    """Capture ``fn`` (a training step) as CUDA graphs:
    ``capture_step(step)`` or ``@capture_step``.  Returns a
    :class:`CapturedStep`."""
    if fn is None:
        return capture_step
    return CapturedStep(fn)
