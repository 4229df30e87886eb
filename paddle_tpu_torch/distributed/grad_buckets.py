"""Gradient buckets of the data-parallel reduction (the counterpart of
the pure-Python part of ``paddle_tpu/distributed/grad_buckets.py``).

Gradients are grouped into size-targeted buckets in reverse parameter
order, the order the backward pass produces them, so that a bucket fills
early and its one fused all-reduce can start while the backward pass
goes on (the reference's ``EagerReducer`` and ``fuse_grad_size_in_MB``).
:func:`partition_buckets` makes the plan; :class:`..parallel.DataParallel`
copies each gradient into its bucket's flat buffer and all-reduces a
bucket as soon as its last gradient is in.

ZeRO's buckets (``scatter_dims``: each member's ``zero_spec`` dimension)
are packed rank-major (:func:`to_rank_major`): a bucket of ``n``
sharding ranks is an ``(n, W)`` block whose row ``r`` is the ravel of
every member's ``r``-th window along its dimension, so one
reduce-scatter of the block hands rank ``r`` exactly its windows
(:class:`.sharding.GradReducer`).  A member that no dimension lets
scatter rides an all-reduce bucket.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Bucket", "BucketPlan", "partition_buckets",
           "default_bucket_bytes", "to_rank_major", "from_rank_major"]

# the reference DistributedStrategy's default fuse_grad_size_in_MB
_DEFAULT_BUCKET_MB = 32.0


def default_bucket_bytes(strategy_mb=None) -> int:
    """The bucket size target in bytes: ``PT_GRAD_BUCKET_MB`` wins, then
    the strategy's ``fuse_grad_size_in_MB``, then 32 MB."""
    mb = os.environ.get("PT_GRAD_BUCKET_MB")
    if mb is None:
        mb = strategy_mb if strategy_mb else _DEFAULT_BUCKET_MB
    return int(float(mb) * 1024 * 1024)


@dataclass
class Bucket:
    """One bucket: parameter names (reverse backward order), their flat
    sizes, one dtype, the payload's bytes.  ``kind`` is the reduction
    (``all_reduce``; ``reduce_scatter`` for a member of ``scatter_dims``,
    ``dims`` its scatter dimension, parallel to ``names``)."""
    names: list = field(default_factory=list)
    sizes: list = field(default_factory=list)
    dtype: object = None
    nbytes: int = 0
    kind: str = "all_reduce"
    dims: list = field(default_factory=list)

    @property
    def numel(self) -> int:
        return int(sum(self.sizes))


@dataclass
class BucketPlan:
    """The buckets, and the :class:`..collective_schedule.CollectiveSchedule`
    that ``reduce_scatter`` buckets run (None for a plain data-parallel
    plan)."""
    buckets: list = field(default_factory=list)
    target_bytes: int = 0
    schedule: object = None

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def record_metrics(self) -> None:
        """``pt_grad_buckets_total{kind}`` and ``pt_grad_bucket_bytes``,
        once for each plan built (what each step then reduces)."""
        from ..observability.telemetry import get_telemetry
        tel = get_telemetry()
        for b in self.buckets:
            tel.grad_bucket(b.nbytes, kind=b.kind)


def _size_and_itemsize(p):
    shape = tuple(p.shape)
    size = int(np.prod(shape)) if shape else 1
    item = p.element_size() if hasattr(p, "element_size") else \
        np.dtype(p.dtype).itemsize
    return size, item


def partition_buckets(params, bucket_bytes, order=None, scatter_dims=None):
    """Greedy size-targeted partition of ``params`` ({name: tensor or
    array}) into :class:`Bucket` groups, in reverse order (``order``
    overrides).  A bucket closes when the next parameter would take it
    past ``bucket_bytes`` (a parameter larger than that gets a bucket of
    its own), when the dtype changes (a bucket is one flat buffer) or
    when the reduction kind changes."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    names = list(order) if order is not None else list(reversed(params))
    scatter_dims = scatter_dims or {}
    plan = BucketPlan(target_bytes=int(bucket_bytes))
    cur = None
    for k in names:
        p = params[k]
        size, item = _size_and_itemsize(p)
        nb = size * item
        dim = scatter_dims.get(k)
        kind = "all_reduce" if dim is None else "reduce_scatter"
        if (cur is None or cur.dtype != p.dtype or cur.kind != kind
                or (cur.nbytes and cur.nbytes + nb > plan.target_bytes)):
            cur = Bucket(dtype=p.dtype, kind=kind)
            plan.buckets.append(cur)
        cur.names.append(k)
        cur.sizes.append(size)
        cur.dims.append(dim)
        cur.nbytes += nb
    return plan


def _pre_blk_post(shape, dim: int, n: int) -> tuple:
    pre = int(np.prod(shape[:dim])) if dim else 1
    post = int(np.prod(shape[dim + 1:])) if dim + 1 < len(shape) else 1
    return pre, shape[dim] // n, post


def to_rank_major(t, dim: int, n: int):
    """``t`` as ``(n, numel / n)``: row ``r`` is the ravel of its
    ``r``-th window along ``dim`` (the JAX package's ``_to_rank_major``).
    A copy unless ``dim`` is 0."""
    pre, blk, post = _pre_blk_post(tuple(t.shape), dim, n)
    return t.reshape(pre, n, blk, post).transpose(0, 1).reshape(
        n, pre * blk * post)


def from_rank_major(x, shape, dim: int, n: int):
    """The inverse of :func:`to_rank_major`: ``(n, W)`` rows back to a
    tensor of ``shape``."""
    pre, blk, post = _pre_blk_post(tuple(shape), dim, n)
    return x.reshape(n, pre, blk, post).transpose(0, 1).reshape(shape)
