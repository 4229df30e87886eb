"""Distributed helpers (the counterpart of
``paddle_tpu/distributed/utils/__init__.py``).

``global_scatter`` / ``global_gather`` are MoE's dispatch primitives in
the reference; here, as in the JAX package, both are the even
all-to-all of :func:`..collective.alltoall_single` and do not read
``local_count`` / ``global_count`` (upstream Paddle's sends each expert
its counted rows: ROADMAP hazards).
"""
from __future__ import annotations

__all__ = ["global_scatter", "global_gather"]


def global_scatter(x, local_count, global_count, group=None):
    """``x``'s first axis split evenly among the group's ranks and
    exchanged (``alltoall_single``); the counts are not read."""
    from ..collective import alltoall_single
    return alltoall_single(x, group=group)


def global_gather(x, local_count, global_count, group=None):
    """The inverse exchange of :func:`global_scatter` (the same even
    all-to-all); the counts are not read."""
    from ..collective import alltoall_single
    return alltoall_single(x, group=group)
