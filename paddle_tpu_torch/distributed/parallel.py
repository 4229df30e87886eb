"""The process group and ``DataParallel`` (the counterpart of
``paddle_tpu/distributed/parallel.py``).

:func:`init_parallel_env` joins this process to the world of ranks on
``torch.distributed``, by the launcher's environment
(:mod:`.launch_api`): ``PT_STORE_FILE`` (a file store), else
``MASTER_ADDR`` / ``MASTER_PORT``, else the first of
``PADDLE_TRAINER_ENDPOINTS``; a world of one with none of them gets a
store of its own.  The backend is NCCL for ranks on the card and gloo
on the CPU.  A CUDA run is never put on gloo unless the caller asks for
it (``backend="gloo"``: ranks that share one card; gloo carries CUDA
tensors for ``all_reduce`` and ``broadcast``), and asking for ``cuda``
without a card raises, as every entry point of the port does.  With
NCCL, local rank ``i`` drives card ``i``; NCCL takes one card per rank,
so a world with more ranks than cards raises.

:class:`DataParallel` is the reference's bucketed reducer: each
gradient, once accumulated, is copied into its bucket's flat buffer
(:mod:`.grad_buckets`, reverse parameter order); a bucket that is full
is all-reduced over the data-parallel group at once, asynchronously,
while the backward pass goes on; at the end of the backward pass every
bucket is waited for, divided by the group's size (the JAX package's
``pmean``), and each parameter's ``.grad`` becomes its slice of the
bucket.  On NCCL the whole of it records into a CUDA graph.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from . import collective as _c
from .env import ParallelEnv, get_rank, get_world_size
from .grad_buckets import default_bucket_bytes, partition_buckets

__all__ = ["init_parallel_env", "rank_device", "DataParallel",
           "unwrap_model", "get_rank", "get_world_size", "ParallelEnv"]

_RANK_DEVICE: dict = {}


def _init_method(world: int) -> Optional[str]:
    store = os.environ.get("PT_STORE_FILE")
    if store:
        return f"file://{store}"
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if addr and port:
        return f"tcp://{addr}:{port}"
    eps = [e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                     "").split(",") if e]
    if eps:
        return f"tcp://{eps[0]}"
    if world == 1:
        return None
    raise RuntimeError(f"init_parallel_env: a world of {world} ranks needs "
                       f"PT_STORE_FILE, MASTER_ADDR/MASTER_PORT or "
                       f"PADDLE_TRAINER_ENDPOINTS (spawn sets them)")


def init_parallel_env(backend: Optional[str] = None, *, device=None,
                      timeout: Optional[float] = None) -> ParallelEnv:
    """Join the world's process group (once; later calls return at
    once).  ``device``: ``cuda`` unless the CPU is asked for; ``backend``:
    ``nccl`` on the card, ``gloo`` on the CPU, unless given.  ``timeout``:
    seconds a collective may wait.  Returns the :class:`ParallelEnv`."""
    if _c.is_initialized():
        return ParallelEnv()
    dev = resolve_device(device)
    world = get_world_size()
    rank = get_rank()
    backend = (backend or ("nccl" if dev.type == "cuda" else "gloo")).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    if dev.type == "cuda":
        local = int(os.environ.get("PADDLE_LOCAL_RANK", rank))
        cards = torch.cuda.device_count()
        if backend == "nccl" and local >= cards:
            raise RuntimeError(
                f"NCCL takes one card per rank: local rank {local} with "
                f"{cards} card(s); ranks that share a card need "
                f"backend='gloo'")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    method = _init_method(world)
    if method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=method, rank=rank,
                                world_size=world, **kw)
    _RANK_DEVICE["device"] = dev
    return ParallelEnv()


def rank_device() -> torch.device:
    """The device :func:`init_parallel_env` gave this rank."""
    if "device" not in _RANK_DEVICE or not _c.is_initialized():
        raise RuntimeError("no process group: call init_parallel_env() first")
    return _RANK_DEVICE["device"]


def unwrap_model(model: torch.nn.Module) -> torch.nn.Module:
    """The model inside its :class:`DataParallel` and ``TensorParallel``
    wrappers (``model`` itself when it has none)."""
    while hasattr(model, "_layers"):
        model = model._layers
    return model


class DataParallel(torch.nn.Module):
    """``layers`` with its gradients averaged over ``group`` (the
    ``data x sep`` group of ``fleet``'s topology when fleet is set up,
    the data-parallel group itself at sep 1, else the world) in buckets
    of ``comm_buffer_size`` MB (a ``strategy``'s ``fuse_grad_size_in_MB``
    instead when given;
    ``PT_GRAD_BUCKET_MB`` wins over both).  The parameters are broadcast
    from the group's first rank when it is made.  Each rank feeds its own
    batch.  Parameter names, ``state_dict`` and ``parameters`` are the
    layers' own.  A parameter that gets no gradient on this rank adds
    zeros to its bucket (``find_unused_parameters`` is accepted and not
    needed).  Over a group of one rank there is nothing to reduce: no
    hook is registered and the buffers stay unused."""

    def __init__(self, layers: torch.nn.Module, strategy=None,
                 comm_buffer_size: float = 25, last_comm_buffer_size=1,
                 find_unused_parameters: bool = False, group=None):
        super().__init__()
        self._layers = layers
        if group is None:
            from .fleet.fleet import get_hybrid_communicate_group
            hcg = get_hybrid_communicate_group()
            group = (hcg.get_dp_sep_parallel_group() if hcg is not None
                     else _c.get_group(0))
        self._group = group
        self.find_unused_parameters = find_unused_parameters
        self._grad_sync_enabled = True
        target = default_bucket_bytes(comm_buffer_size)
        if strategy is not None:
            # fuse_all_reduce_ops off: one bucket a parameter
            target = (default_bucket_bytes(strategy.fuse_grad_size_in_MB)
                      if strategy.fuse_all_reduce_ops else 1)
        params = {n: p for n, p in layers.named_parameters()
                  if p.requires_grad}
        self._plan = partition_buckets(params, target)
        self._buffers = [torch.zeros(
            b.numel if group.nranks > 1 else 0, dtype=b.dtype,
            device=params[b.names[0]].device) for b in self._plan.buckets]
        self._where = {}
        for i, b in enumerate(self._plan.buckets):
            off = 0
            for name, size in zip(b.names, b.sizes):
                self._where[name] = (i, off, size)
                off += size
        self._params = params
        self._arrived = [set() for _ in self._plan.buckets]
        self._tasks = [None] * len(self._plan.buckets)
        self._in_backward = False
        if group.nranks > 1:          # one rank's gradient is the mean
            self._plan.record_metrics()
            self._sync_params()
            for name, p in params.items():
                p.register_post_accumulate_grad_hook(self._hook(name))

    @torch.no_grad()
    def _sync_params(self) -> None:
        src = self._group.ranks[0]
        for p in self._params.values():
            _c.broadcast(p.data, src=src, group=self._group)

    def _hook(self, name):
        def hook(p):
            if not self._grad_sync_enabled:
                return
            if not self._in_backward:
                self._in_backward = True
                torch.autograd.Variable._execution_engine.queue_callback(
                    self._finish)
            i, off, size = self._where[name]
            self._buffers[i][off:off + size].copy_(p.grad.reshape(-1))
            self._arrived[i].add(name)
            if len(self._arrived[i]) == len(self._plan.buckets[i].names):
                self._launch(i)
        return hook

    def _launch(self, i: int) -> None:
        self._tasks[i] = _c.all_reduce(self._buffers[i], group=self._group,
                                       sync_op=False)

    @torch.no_grad()
    def _finish(self) -> None:
        """End of the backward pass: reduce what is left, wait, average,
        and point each ``.grad`` at its slice of the bucket."""
        for i, b in enumerate(self._plan.buckets):
            if self._tasks[i] is None:
                for name in b.names:
                    if name not in self._arrived[i]:
                        _, off, size = self._where[name]
                        self._buffers[i][off:off + size].zero_()
                self._launch(i)
        n = self._group.nranks
        for i, b in enumerate(self._plan.buckets):
            self._tasks[i].wait()
            self._buffers[i].div_(n)
            for name in b.names:
                _, off, size = self._where[name]
                p = self._params[name]
                p.grad = self._buffers[i][off:off + size].view_as(p)
            self._arrived[i].clear()
            self._tasks[i] = None
        self._in_backward = False

    @property
    def bucket_plan(self):
        return self._plan

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """The loss as it is: the reduction is a mean."""
        return loss

    @contextlib.contextmanager
    def no_sync(self):
        """Gradients accumulate on this rank alone inside the block; the
        first synced backward after it reduces the accumulated sum."""
        self._grad_sync_enabled = False
        try:
            yield
        finally:
            self._grad_sync_enabled = True

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_dict = set_dict = set_state_dict

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def parameters(self, recurse: bool = True):
        return self._layers.parameters(recurse)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)
