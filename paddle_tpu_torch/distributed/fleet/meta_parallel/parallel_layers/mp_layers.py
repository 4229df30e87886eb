"""Tensor-parallel layers (the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/mp_layers.py``).

The JAX package holds each weight whole and lets its compiler partition
it; its manual-SPMD branches spell out the per-rank math
(``mp_layers.py:89-107, 140-152, 187-199, 222-244`` there).  The port
runs one process per rank, so each rank holds its own slice and the
layers run that math with the explicit operators of :mod:`..mp_ops`:

 - :class:`VocabParallelEmbedding`: rows ``[r * V/n, (r + 1) * V/n)`` of
   the table; ids outside them give 0, then :func:`_mp_allreduce`.  The
   backward is ``F.embedding``'s fixed-order one on the local block.
 - :class:`ColumnParallelLinear`: columns ``[r * N/n, ...)`` of the
   ``(in, out)`` weight and of the bias; :func:`_c_identity` on the
   input; with ``gather_output`` the outputs concatenated.
 - :class:`RowParallelLinear`: rows ``[r * K/n, ...)`` of the weight;
   the input split unless ``input_is_parallel``; the partial products
   all-reduced, then the whole bias added.
 - :class:`ParallelCrossEntropy`: over vocabulary-local logits, the max
   and the sum of exponentials all-reduced over the group and the target
   logit taken by a masked all-reduce.  Without a group it is the
   unsharded loss, in the logits' dtype, as the JAX package computes it.

``mp_group`` is a :class:`...collective.Group`; None means fleet's
model-parallel group when ``fleet.init`` has run, else no split (degree
1, no collective).  Parameters keep the JAX names and ``(in, out)``
layouts at each rank's slice.  A layer draws its whole weight from the
generator, as the unsharded layer would, and keeps its slice, so the
generator ends where the unsharded model's does, and every rank's slice
is cut from the same draws.  A parameter that is a slice (the group
has more than one rank) carries ``split_axis``, the axis it was cut
along; :func:`is_shard` reads it.  Every parameter a layer splits
carries ``mp_axis``, that axis at any degree (the JAX layer's spec
annotation, which stage-3 placement reads).  Paddle's ``is_distributed`` flag is
not set: on a torch tensor that name is a method.
"""
from __future__ import annotations

import torch

from .....nn import functional as F
from .....nn.initializer import Constant, XavierNormal
from .... import collective as _c
from .. import mp_ops

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "mp_group_of",
           "is_shard"]


def mp_group_of(mp_group=None):
    """``mp_group``, or fleet's model-parallel group when fleet is set up
    and none is given, else None."""
    if mp_group is not None:
        return mp_group
    from ...fleet import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    return None if hcg is None else hcg.get_model_parallel_group()


def is_shard(p) -> bool:
    """Whether ``p`` is one rank's slice of a parameter split over more
    than one model-parallel rank."""
    return getattr(p, "split_axis", None) is not None


def _degree(group) -> int:
    return 1 if group is None else group.nranks


def _local(group) -> int:
    return 0 if group is None else group.rank


def _sliced(init, shape, axis, group, generator):
    """The whole ``shape`` drawn by ``init``, this rank's slice of
    ``axis`` kept, as a parameter tagged with ``split_axis`` when it is
    a slice."""
    n = _degree(group)
    if shape[axis] % n:
        raise ValueError(f"dimension {shape[axis]} of {tuple(shape)} does "
                         f"not split into {n} model-parallel ranks")
    full = init(shape, generator)
    per = shape[axis] // n
    p = torch.nn.Parameter(full.narrow(axis, _local(group) * per,
                                       per).contiguous())
    p.mp_axis = axis          # the layer's split axis, at any degree
    if n > 1:
        p.split_axis = axis
    return p


class VocabParallelEmbedding(torch.nn.Module):
    """An embedding with the vocabulary split over the group."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None, *,
                 generator, mp_group=None, name=None):
        super().__init__()
        self.mp_group = mp_group_of(mp_group)
        self.world_size = _degree(self.mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = _sliced(weight_attr or XavierNormal(),
                              (num_embeddings, embedding_dim), 0,
                              self.mp_group, generator)

    def forward(self, x):
        per = self.weight.shape[0]
        start = _local(self.mp_group) * per
        inside = (x >= start) & (x < start + per)
        ids = torch.where(inside, x - start, torch.zeros_like(x))
        out = F.embedding(ids, self.weight)
        out = out.masked_fill(~inside.unsqueeze(-1), 0)
        return mp_ops._mp_allreduce(out, self.mp_group)


class ColumnParallelLinear(torch.nn.Module):
    """A linear layer with its output columns split over the group."""

    def __init__(self, in_features, out_features, weight_attr=None, *,
                 generator, has_bias=True, gather_output=True,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.mp_group = mp_group_of(mp_group)
        self.world_size = _degree(self.mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self.weight = _sliced(weight_attr or XavierNormal(),
                              (in_features, out_features), 1, self.mp_group,
                              generator)
        self.bias = _sliced(Constant(0.0), (out_features,), 0,
                            self.mp_group, generator) if has_bias else None

    def forward(self, x):
        x = mp_ops._c_identity(x, self.mp_group)
        out = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = mp_ops._c_concat(out, self.mp_group)
        return out


class RowParallelLinear(torch.nn.Module):
    """A linear layer with its input rows split over the group; the bias
    is whole and added after the reduce."""

    def __init__(self, in_features, out_features, weight_attr=None, *,
                 generator, has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.mp_group = mp_group_of(mp_group)
        self.world_size = _degree(self.mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.weight = _sliced(weight_attr or XavierNormal(),
                              (in_features, out_features), 0, self.mp_group,
                              generator)
        self.bias = torch.nn.Parameter(Constant(0.0)(
            (out_features,), generator)) if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = mp_ops._c_split(x, self.mp_group)
        out = mp_ops._mp_allreduce(torch.matmul(x, self.weight),
                                   self.mp_group)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class ParallelCrossEntropy(torch.nn.Module):
    """Softmax cross-entropy per token, ``(..., V)`` logits (``V / n``
    vocabulary-local ones on a group of ``n``) against ``(...)`` or
    ``(..., 1)`` labels; returns ``(..., 1)``.  Tokens labelled
    ``ignore_index`` get 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group = mp_group_of(mp_group)
        self.world_size = _degree(self.mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        valid = label != self.ignore_index
        safe = torch.where(valid, label, torch.zeros_like(label)).long()
        zero = torch.zeros((), dtype=input.dtype, device=input.device)
        if self.mp_group is None:
            shifted = input - input.amax(dim=-1, keepdim=True).detach()
            lse = torch.log(torch.exp(shifted).sum(dim=-1))
            tgt = shifted.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
            return torch.where(valid, lse - tgt, zero).unsqueeze(-1)
        group = self.mp_group
        n_local = input.shape[-1]
        start = group.rank * n_local
        m = input.amax(dim=-1).detach()
        _c.all_reduce(m, op=_c.ReduceOp.MAX, group=group)
        shifted = input - m.unsqueeze(-1)
        sumexp = mp_ops._mp_allreduce(torch.exp(shifted).sum(dim=-1), group)
        inside = (safe >= start) & (safe < start + n_local)
        local = torch.where(inside, safe - start, torch.zeros_like(safe))
        tgt = shifted.gather(-1, local.unsqueeze(-1)).squeeze(-1)
        tgt = mp_ops._mp_allreduce(torch.where(inside, tgt, zero), group)
        return torch.where(valid, torch.log(sumexp) - tgt, zero).unsqueeze(-1)
