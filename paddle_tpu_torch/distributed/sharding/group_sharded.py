"""ZeRO in the port: the windows, the reduction and the update of a
group-sharded step, one process per rank.

The JAX package shards each optimizer-state leaf (``os``, ``os_g``) or
parameter (``p_g_os``) over the ``sharding`` mesh axis on the dimension
``zero_spec`` / ``place_axis`` picks (``train_step.py:53-67``), and its
compiler runs the update shard-local.  The port keeps exactly those
windows: rank ``r`` of the sharding group holds window ``r`` of that
dimension of each slot and master, the data the JAX package's device at
sharding coordinate ``r`` holds.

 - :func:`zero_dim`: the dimension, read against the global shape and
   the parameter's tensor-parallel entry (``is_shard``'s ``split_axis``),
   None when no free dimension divides.
 - :class:`GradReducer`: after the backward pass, gradients in buckets
   (:func:`..grad_buckets.partition_buckets`, reverse order).  A
   ``reduce_scatter`` bucket (``os_g``, planned by
   :func:`..collective_schedule.plan_grad_reduction`) is packed
   rank-major and reduce-scattered over the sharding group, then
   all-reduced over the data-parallel group: rank ``r`` receives its
   windows and no gradient is held whole.  An ``all_reduce`` bucket is
   all-reduced over sharding, then over dp.  Every sum is divided by
   ``dp * sharding``: the port splits the global batch over both (the
   JAX step replicates it over sharding), so the mean over them is the
   global batch's gradient.  With a sep degree above 1 "dp" is the
   ``data x sep`` group throughout (each sep rank holds its part of
   every sequence, and its loss is the mean over its tokens), and the
   divisor ``dp * sep * sharding``.
 - :class:`ZeroPlan`: the update.  Each rank updates its windows (views
   of its parameters, with window-sized slots and masters), then the
   windows are all-gathered over the sharding group bucket by bucket,
   rank-major, into every rank's parameters (under O2, the bf16 cast of
   the master window the optimizer wrote).  Parameters that no
   dimension lets scatter are reduced, updated and kept whole, on every
   rank.  :meth:`ZeroPlan.step` is the whole update after a backward
   pass, the one body of every step that a plan drives
   (``train.HybridTrainStep``, ``PipelineParallel.train_batch``, or a
   loop of one's own): the reduction, the sum of a tied parameter's
   copies on other pipeline stages, the clip and the update, the
   gather, and the loss averaged over the data ranks.
 - :func:`local_batch`: this data rank's rows of the global batch, and
   this sep rank's positions of each.
 - Stage 3 (``p_g_os``, :func:`shard_parameters`): parameters of at
   least ``min_size`` elements are stored as their windows.  A
   :class:`GatherWindow` gathers one into a whole tensor where it is
   used, and reduce-scatters its gradient back into the window (then
   all-reduces over dp).  Blocks gather their weights at each call, so
   under per-block recompute they are gathered for the forward, freed,
   and gathered again for the rerun in the backward; the other
   parameters are gathered for the whole forward
   (:func:`gathered`).  Tensors are made inside the step, so under a
   CUDA graph they live in its pool and keep their addresses.
"""
from __future__ import annotations

import contextlib
import types
from typing import Dict, Iterable, Optional

import torch

from .. import collective as _c
from ..auto_parallel.spec_layout import place_axis, spec_axes
from ..collective_schedule import plan_grad_reduction
from ..grad_buckets import (default_bucket_bytes, from_rank_major,
                            partition_buckets, to_rank_major)

__all__ = ["LEVELS", "MIN_SIZE", "zero_level", "set_zero_level",
           "param_spec", "global_shape", "zero_spec", "zero_dim", "window",
           "local_batch", "mean_over_data_ranks", "GradReducer", "ZeroPlan",
           "GatherWindow", "shard_parameters", "gathered", "is_window",
           "state_bytes"]

#: the reference's levels: optimizer state; + gradients; + parameters
LEVELS = ("os", "os_g", "p_g_os")
#: stage 3 stores parameters of at least this many elements as windows
#: (``annotate_fsdp_specs``' default)
MIN_SIZE = 1024


def zero_level(optimizer) -> Optional[str]:
    """The level ``group_sharded_parallel``, ``DygraphShardingOptimizer``
    or ``fleet.distributed_optimizer`` set on ``optimizer`` (through its
    wrappers), or None."""
    while optimizer is not None:
        lvl = optimizer.__dict__.get("_group_sharded_level")
        if lvl in LEVELS:
            return lvl
        optimizer = optimizer.__dict__.get("_inner_opt")
    return None


def set_zero_level(optimizer, level: str) -> None:
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
    while "_inner_opt" in optimizer.__dict__:
        optimizer = optimizer._inner_opt
    optimizer._group_sharded_level = level


def param_spec(p, annotated: bool = False) -> tuple:
    """``p``'s spec: ``"mp"`` on its tensor-parallel axis, else None.
    ``annotated``: the axis its layer splits at any degree (the JAX
    layer's annotation, which stage 3 places against); otherwise only
    where it is split (the spec resolved against the mesh, which
    ``zero_spec`` reads)."""
    axis = getattr(p, "mp_axis" if annotated else "split_axis", None)
    return tuple("mp" if d == axis else None for d in range(p.dim()))


def global_shape(p, mp: int) -> tuple:
    """The shape of the whole parameter of which ``p`` is one mp rank's
    slice (``p``'s own when it is whole)."""
    shape = list(getattr(p, "zero_full_shape", None) or p.shape)
    axis = getattr(p, "split_axis", None)
    if axis is not None:
        shape[axis] *= mp
    return tuple(shape)


def zero_spec(spec, shape, n: int, axis: str = "sharding") -> tuple:
    """The ZeRO spec of a state leaf: the parameter's spec with ``axis``
    placed by :func:`..auto_parallel.place_axis`."""
    return place_axis(spec, tuple(shape), n, axis)


def zero_dim(p, n: int, mp: int = 1, annotated: bool = False
             ) -> Optional[int]:
    """The dimension of ``p`` that carries its ZeRO window over ``n``
    sharding ranks, or None (no free dimension divides, or ``n`` is 1);
    ``annotated``: placed against the layer's annotation
    (:func:`param_spec`), as stage 3 is."""
    base = param_spec(p, annotated)
    zs = zero_spec(base, global_shape(p, mp), n)
    for d, (z, b) in enumerate(zip(zs, base)):
        if "sharding" in spec_axes(z) and "sharding" not in spec_axes(b):
            return d
    return None


def window(t: torch.Tensor, dim: int, n: int, rank: int) -> torch.Tensor:
    """Window ``rank`` of ``n`` along ``dim``, a view."""
    w = t.shape[dim] // n
    return t.narrow(dim, rank * w, w)


def is_window(p) -> bool:
    """Whether ``p`` is stored as its stage-3 window."""
    return getattr(p, "zero_full_shape", None) is not None


def state_bytes(state: dict, names: Optional[Iterable[str]] = None) -> int:
    """Bytes of the slots and masters of ``state`` (of ``names`` only
    when given)."""
    keep = None if names is None else set(names)
    trees = list(state["slots"].values()) + [state["master"]]
    return sum(t.numel() * t.element_size() for tree in trees
               for n, t in tree.items() if keep is None or n in keep)


def local_batch(batch, hcg):
    """This data rank's rows of the global ``batch`` (a tensor, or a
    list, tuple or dict of them): data rank ``r = dp_rank * sharding +
    sharding_rank`` of ``n = dp * sharding`` takes rows ``[r * B/n, (r +
    1) * B/n)`` of the first axis, and with a sep degree ``m`` above 1
    sep rank ``s`` positions ``[s * S/m, (s + 1) * S/m)`` of the second
    (the JAX step's data spec ``P("dp", "sep")``).  The JAX step
    replicates the batch over sharding; the update is the same (module
    docstring)."""
    if isinstance(batch, dict):
        return {k: local_batch(v, hcg) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(local_batch(v, hcg) for v in batch)
    sh = hcg.get_sharding_parallel_world_size()
    n = hcg.get_data_parallel_world_size() * sh
    if batch.shape[0] % n:
        raise ValueError(f"a batch of {batch.shape[0]} does not split over "
                         f"{n} data ranks (dp x sharding)")
    per = batch.shape[0] // n
    r = hcg.get_data_parallel_rank() * sh + hcg.get_sharding_parallel_rank()
    batch = batch.narrow(0, r * per, per)
    sep = hcg.get_sep_parallel_world_size()
    if sep > 1:
        if batch.dim() < 2 or batch.shape[1] % sep:
            raise ValueError(f"a batch of shape {tuple(batch.shape)} does not "
                             f"split its sequence over {sep} sep ranks")
        sl = batch.shape[1] // sep
        batch = batch.narrow(1, hcg.get_sep_parallel_rank() * sl, sl)
    return batch


def mean_over_data_ranks(loss: torch.Tensor, hcg) -> torch.Tensor:
    """``loss`` (a copy) averaged over the sharding and the ``data x
    sep`` groups: the global batch's loss on every data rank."""
    loss = loss.detach().clone()
    for g in (hcg.get_sharding_parallel_group(),
              hcg.get_dp_sep_parallel_group()):
        if g.nranks > 1:
            _c.all_reduce(loss, op=_c.ReduceOp.AVG, group=g)
    return loss


def _stacked_dim(p, n: int, mp: int, pp: int, v: int) -> Optional[int]:
    """Where the JAX package's ZeRO spec puts the sharding axis on an
    interleaved pipeline's stacked leaf ``[v, pp * Lv, *block]`` (spec
    ``(None, "pp", *block spec)``): 0 for the virtual stages, ``d + 2``
    for the block's dimension ``d``, None when nothing divides.  ``Lv``
    does not change the choice (that dimension is taken by pp)."""
    base = (None, "pp") + param_spec(p)
    zs = zero_spec(base, (v, pp) + global_shape(p, mp), n)
    for d, (z, b) in enumerate(zip(zs, base)):
        if "sharding" in spec_axes(z) and "sharding" not in spec_axes(b):
            return d
    return None


class GradReducer:
    """The bucketed gradient reduction over data parallelism and
    sharding (module docstring).  ``scatter_dims``: each parameter's
    window dimension where its gradient is reduce-scattered (``os_g``),
    else absent."""

    def __init__(self, params: Dict[str, torch.Tensor], hcg,
                 scatter_dims: Optional[Dict[str, int]] = None):
        self.sh = hcg.get_sharding_parallel_group()
        self.dp = hcg.get_dp_sep_parallel_group()
        self.n = self.sh.nranks
        self.world = self.n * self.dp.nranks
        self.params = params
        self.plan = partition_buckets(params, default_bucket_bytes(),
                                      scatter_dims=scatter_dims or {})
        if self.world > 1:
            self.plan.record_metrics()

    def _grad(self, name, grads):
        g = grads.get(name)
        return torch.zeros_like(self.params[name]) if g is None else g

    @torch.no_grad()
    def reduce(self, grads: Dict[str, Optional[torch.Tensor]]
               ) -> Dict[str, torch.Tensor]:
        """The mean gradient over the data ranks: a window (its shape)
        for a ``reduce_scatter`` member, whole for the others."""
        out: Dict[str, torch.Tensor] = {}
        if self.world == 1:
            return {k: self._grad(k, grads) for k in self.params}
        first, pending = [], []
        for b in self.plan.buckets:
            if b.kind == "reduce_scatter":
                block = torch.cat([to_rank_major(self._grad(k, grads), d,
                                                 self.n)
                                   for k, d in zip(b.names, b.dims)], dim=1)
                buf = torch.empty_like(block[0])
                task = _c.reduce_scatter(buf, list(block.unbind(0)),
                                         group=self.sh, sync_op=False)
                rest = [self.dp] if self.dp.nranks > 1 else []
            else:
                buf = torch.cat([self._grad(k, grads).reshape(-1)
                                 for k in b.names])
                groups = [g for g in (self.sh, self.dp) if g.nranks > 1]
                task = _c.all_reduce(buf, group=groups[0], sync_op=False)
                rest = groups[1:]
            first.append(task)
            pending.append((b, buf, rest))
        for task, (b, buf, rest) in zip(first, pending):
            task.wait()
            for g in rest:
                _c.all_reduce(buf, group=g)
            buf.div_(self.world)
            off = 0
            for k, size, d in zip(b.names, b.sizes, b.dims):
                shape = list(self.params[k].shape)
                if d is not None:          # this rank's window of it
                    shape[d] //= self.n
                    size //= self.n
                out[k] = buf[off:off + size].view(shape)
                off += size
        return out


class ZeroPlan:
    """One rank's ZeRO: which parameters' state is a window, the
    gradient reduction and the update (module docstring).

    ``params``: this rank's parameters by name; ``level``: ``os``,
    ``os_g``, ``p_g_os`` or None (a sharding group without ZeRO: whole
    state, gradients all-reduced over sharding and dp).

    ``chunks`` ({name: g}, with ``virtual_stages = v > 1``): the block
    parameters of an interleaved pipeline stage and the virtual-stage
    group ``g`` each belongs to.  The JAX package stacks them as ``[v,
    pp * Lv, *block]`` and places the ZeRO axis on that shape, so a
    block parameter that has no free dimension of its own that divides
    (an mp-split bias) is windowed over ``v``: sharding rank ``r`` holds
    the state of groups ``[r v / n, (r + 1) v / n)``.  The port does the
    same: such a parameter is updated on the rank that owns its group
    (:attr:`owner`) and broadcast from it.

    ``tied`` ({name: (group, counted)}): a parameter with copies on other
    pipeline stages (the tied word embedding, a ``SharedLayerDesc``
    layer).  :meth:`step` sums its gradient over ``group`` (its stages)
    in f32 before the update, so every copy takes the same update, and
    the clip counts it where ``counted`` (on one stage only).

    :attr:`kinds` ({name: (mp_shard, window, counted)}) tell
    ``HybridParallelClipGrad`` what each gradient is, so that every
    element of the model counts once in the global norm."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], hcg,
                 level: Optional[str], *,
                 chunks: Optional[Dict[str, int]] = None,
                 virtual_stages: int = 1,
                 tied: Optional[Dict[str, tuple]] = None):
        if level is not None and level not in LEVELS:
            raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
        self.level = level
        self.hcg = hcg
        self.sh = hcg.get_sharding_parallel_group()
        self.n, self.rank = self.sh.nranks, self.sh.rank
        mp = hcg.get_model_parallel_world_size()
        pp = hcg.get_pipe_parallel_world_size()
        self.params = params
        self.stage3 = {k for k, p in params.items() if is_window(p)}
        # whose state is a window: every parameter with a window dimension
        # at os / os_g (zero_spec has no size floor), the stored windows
        # at p_g_os; owner: the sharding rank that updates a parameter
        # windowed over the virtual stages
        self.dims: Dict[str, int] = {}
        self.owner: Dict[str, int] = {}
        chunks = chunks or {}
        v = int(virtual_stages)
        if level in ("os", "os_g"):
            for k, p in params.items():
                if k in chunks and v > 1:
                    d = _stacked_dim(p, self.n, mp, pp, v)
                    if d == 0:
                        self.owner[k] = chunks[k] * self.n // v
                    elif d is not None:
                        self.dims[k] = d - 2
                    continue
                d = zero_dim(p, self.n, mp)
                if d is not None:
                    self.dims[k] = d
        zero = {"os": "os", "os_g": "os_g"}.get(level)
        self.schedule = plan_grad_reduction(
            {"dp": hcg.get_dp_sep_parallel_world_size(), "sharding": self.n},
            zero)
        scatter = self.dims if (level == "os_g" and self.schedule is not
                                None and self.schedule.scatters) else {}
        self.reducer = GradReducer(
            {k: p for k, p in params.items() if k not in self.stage3}, hcg,
            scatter_dims=scatter)
        self.reducer.plan.schedule = self.schedule
        self.gather_plan = partition_buckets(
            {k: params[k] for k in params if k in self.dims},
            default_bucket_bytes(), scatter_dims=self.dims)
        # the tensors the optimizer updates: windows of the parameters
        # (views) for the scattered ones, the parameters otherwise, and
        # not those another rank owns
        self.views = {k: (window(p.data, self.dims[k], self.n, self.rank)
                          if k in self.dims else p)
                      for k, p in params.items()
                      if self.owner.get(k, self.rank) == self.rank}
        tied = {k: t for k, t in (tied or {}).items() if k in params}
        self.tied = {k: group for k, (group, _) in tied.items()}
        self.kinds = {k: (getattr(p, "split_axis", None) is not None,
                          self.windowed(k), tied.get(k, (None, True))[1])
                      for k, p in params.items()}

    def windowed(self, name: str) -> bool:
        """Whether ``name``'s gradient and state are a window (of the
        tensor, or of the virtual stages)."""
        return name in self.dims or name in self.stage3 or name in self.owner

    def init_state(self, optimizer) -> dict:
        """The optimizer's state tree over :attr:`views` (window-sized
        slots and masters for the scattered parameters)."""
        return optimizer.init_state_tree(self.views)

    def reduce(self, grads: Dict[str, Optional[torch.Tensor]]
               ) -> Dict[str, Optional[torch.Tensor]]:
        """Gradients of the step, reduced: the stored windows' are
        reduced already (:class:`GatherWindow`); the others go through
        :attr:`reducer`, and a scattered parameter's gradient is cut to
        its window when the reduction left it whole (``os``, or the
        planner off)."""
        out = self.reducer.reduce(
            {k: g for k, g in grads.items() if k not in self.stage3})
        for k in self.stage3:
            out[k] = grads.get(k)
        for k, d in self.dims.items():
            g = out.get(k)
            if g is not None and g.shape == self.params[k].shape:
                out[k] = window(g, d, self.n, self.rank)
        return out

    def step(self, optimizer, state: dict,
             loss: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """The update after the backward pass: the parameters' gradients
        reduced (:meth:`reduce`), each tied parameter's summed over its
        copies in f32, the clip and the update of this rank's windows
        (``optimizer``: fleet's ``HybridParallelOptimizer``, told
        :attr:`kinds`; ``state``: :meth:`init_state`'s), the windows
        gathered (:meth:`gather`); the gradients are dropped.  Returns
        ``loss`` averaged over the data ranks
        (:func:`mean_over_data_ranks`) when given."""
        grads = self.reduce({k: p.grad for k, p in self.params.items()})
        for k, group in self.tied.items():
            g = grads[k].float()
            _c.all_reduce(g, group=group)
            grads[k] = g
        optimizer.apply_gradients_tree(self.views, grads, state,
                                       kinds=self.kinds)
        self.gather()
        for p in self.params.values():
            p.grad = None
        return None if loss is None else mean_over_data_ranks(loss,
                                                              self.hcg)

    @torch.no_grad()
    def gather(self) -> None:
        """Every rank's updated windows into every rank's parameters,
        bucket by bucket (rank-major rows, one all-gather a bucket), and
        the parameters windowed over the virtual stages from their
        owners."""
        if self.n == 1:
            return
        for k, r in self.owner.items():
            _c.broadcast(self.params[k].data, src=self.sh.ranks[r],
                         group=self.sh)
        for b in self.gather_plan.buckets:
            row = torch.cat([self.views[k].reshape(-1) for k in b.names])
            rows: list = []
            _c.all_gather(rows, row, group=self.sh)
            block = torch.stack(rows)
            off = 0
            for k, size, d in zip(b.names, b.sizes, b.dims):
                w = size // self.n
                p = self.params[k]
                p.data.copy_(from_rank_major(block[:, off:off + w],
                                             tuple(p.shape), d, self.n))
                off += w


# -- stage 3 --------------------------------------------------------------------

class GatherWindow(torch.autograd.Function):
    """``window`` (rank ``r``'s window along ``dim`` of a tensor of
    ``full_shape``) -> the whole tensor, all-gathered over the sharding
    group; the backward reduce-scatters the whole gradient back into the
    window, all-reduces it over dp (``data x sep``) and divides by ``dp *
    sharding``."""

    @staticmethod
    def forward(ctx, win, dim, full_shape, sh, dp):
        ctx.dim, ctx.full_shape, ctx.sh, ctx.dp = dim, full_shape, sh, dp
        n = sh.nranks
        rows: list = []
        _c.all_gather(rows, win.detach().reshape(-1), group=sh)
        return from_rank_major(torch.stack(rows), full_shape, dim, n)

    @staticmethod
    def backward(ctx, grad):
        sh, dp, n = ctx.sh, ctx.dp, ctx.sh.nranks
        block = to_rank_major(grad.contiguous(), ctx.dim, n)
        out = torch.empty_like(block[0])
        _c.reduce_scatter(out, list(block.unbind(0)), group=sh)
        if dp.nranks > 1:
            _c.all_reduce(out, group=dp)
        out.div_(n * dp.nranks)
        shape = list(ctx.full_shape)
        shape[ctx.dim] //= n
        return out.view(shape), None, None, None, None


def _gather(p, hcg):
    return GatherWindow.apply(p, p.zero_dim, p.zero_full_shape,
                              hcg.get_sharding_parallel_group(),
                              hcg.get_dp_sep_parallel_group())


@contextlib.contextmanager
def _swapped(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]):
    """``module``'s parameters named in ``tensors`` replaced by those
    tensors while the block runs."""
    saved = []
    try:
        for name, t in tensors.items():
            owner, _, attr = name.rpartition(".")
            sub = module.get_submodule(owner) if owner else module
            saved.append((sub, attr, sub._parameters.pop(attr)))
            setattr(sub, attr, t)
        yield
    finally:
        for sub, attr, p in reversed(saved):
            delattr(sub, attr)
            sub._parameters[attr] = p


@contextlib.contextmanager
def gathered(model: torch.nn.Module):
    """While it is open, ``model``'s stored windows outside its blocks
    are whole tensors (gathered once; the gradients reduce-scattered in
    the backward)."""
    info = getattr(model, "_zero3", None)
    if info is None:
        yield
        return
    hcg, rest = info
    named = dict(model.named_parameters())
    with _swapped(model, {n: _gather(named[n], hcg) for n in rest}):
        yield


def _gathering_forward(block: torch.nn.Module, names, hcg):
    cls_forward = type(block).forward

    def forward(self, *args, **kwargs):
        named = dict(self.named_parameters())
        with _swapped(self, {n: _gather(named[n], hcg) for n in names}):
            return cls_forward(self, *args, **kwargs)

    return types.MethodType(forward, block)


def shard_parameters(model: torch.nn.Module, hcg, *,
                     min_size: int = MIN_SIZE) -> Dict[str, int]:
    """Stage 3: store each parameter of ``model`` of at least
    ``min_size`` elements (whole, over every mp rank) that has a window
    dimension as its window (``zero_full_shape``, ``zero_dim`` mark it),
    in place.  The blocks of ``model.pipeline_blocks()`` gather their
    windows at each call; the rest are gathered by :func:`gathered`.
    Returns {name: window dimension}."""
    sh = hcg.get_sharding_parallel_group()
    n, r = sh.nranks, sh.rank
    mp = hcg.get_model_parallel_world_size()
    dims = {}
    for name, p in model.named_parameters():
        full = 1
        for s in global_shape(p, mp):
            full *= s
        d = zero_dim(p, n, mp, annotated=True)
        if n > 1 and full >= min_size and d is not None:
            dims[name] = d
    blocks = []
    if hasattr(model, "pipeline_blocks"):
        prefixes, _ = model.pipeline_blocks()
        blocks = [p for p in prefixes
                  if any(k.startswith(p) for k in dims)]
    named = dict(model.named_parameters())
    for name, d in dims.items():
        p = named[name]
        p.zero_full_shape = tuple(p.shape)
        p.zero_dim = d
        p.data = window(p.data, d, n, r).clone()
    for prefix in blocks:
        block = model.get_submodule(prefix.rstrip("."))
        local = [k[len(prefix):] for k in dims if k.startswith(prefix)]
        block.forward = _gathering_forward(block, local, hcg)
    rest = [k for k in dims if not any(k.startswith(p) for p in blocks)]
    model._zero3 = (hcg, rest)
    return dims
