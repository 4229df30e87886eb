"""Tensor-parallel communication operators (the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/mp_ops.py``).

Each is a ``torch.autograd.Function`` over the model-parallel group
(Megatron's f and g operators and the split and concat of the last
axis), the math of the JAX package's manual-SPMD branches
(``mp_ops.py:49-131`` there):

 - :func:`_c_identity`: identity forward, all-reduce (sum) backward;
 - :func:`_mp_allreduce`: all-reduce (sum) forward, identity backward;
 - :func:`_c_split`: this rank's chunk of the last axis forward, the
   gradient all-gathered backward;
 - :func:`_c_concat`: all-gather of the last axis forward, this rank's
   slice of the gradient backward.

With no group (a model built without fleet) each is the identity.  A
group of one rank still runs its collective (a copy), so a degree-1
model goes through the same operations as a sharded one.
"""
from __future__ import annotations

import torch

from ... import collective as _c

__all__ = ["_c_identity", "_mp_allreduce", "_c_split", "_c_concat",
           "split"]


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _c.all_reduce(g, group=ctx.group)
        return g, None


class _MpAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        _c.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _chunk(x, group):
    n = x.shape[-1] // group.nranks
    return x.narrow(-1, group.rank * n, n).contiguous()


def _gather_last(x, group):
    x = x.contiguous()
    parts = []
    _c.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        if x.shape[-1] % group.nranks:
            raise ValueError(f"_c_split: last axis {x.shape[-1]} does not "
                             f"split into {group.nranks}")
        return _chunk(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group), None


def _c_identity(x, group=None):
    """Identity forward, all-reduce backward (Megatron's f)."""
    return x if group is None else _CIdentity.apply(x, group)


def _mp_allreduce(x, group=None):
    """All-reduce forward, identity backward (Megatron's g)."""
    return x if group is None else _MpAllreduce.apply(x, group)


def _c_split(x, group=None):
    """This rank's chunk of the last axis; backward all-gathers."""
    return x if group is None else _CSplit.apply(x, group)


def _c_concat(x, group=None):
    """The ranks' chunks concatenated on the last axis; backward keeps
    this rank's slice."""
    return x if group is None else _CConcat.apply(x, group)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None, *, generator):
    """``paddle.distributed.split``: build a model-parallel linear
    (``axis`` 0: row-parallel, 1: column-parallel) or vocabulary-parallel
    embedding of ``size`` over fleet's model-parallel group, its weight
    drawn by ``weight_attr`` from ``generator``, and apply it to ``x``."""
    from ....nn.initializer import XavierNormal
    from .parallel_layers.mp_layers import (ColumnParallelLinear,
                                            RowParallelLinear,
                                            VocabParallelEmbedding)
    init = weight_attr or XavierNormal()
    if operation == "linear":
        if axis == 0:
            layer = RowParallelLinear(size[0], size[1], init,
                                      generator=generator,
                                      has_bias=bias_attr is not False,
                                      input_is_parallel=False)
        else:
            layer = ColumnParallelLinear(size[0], size[1], init,
                                         generator=generator,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out)
        return layer(x)
    if operation == "embedding":
        return VocabParallelEmbedding(size[0], size[1], init,
                                      generator=generator)(x)
    raise ValueError(f"unsupported split operation {operation!r}")
