"""Group sharding (ZeRO) in the port (the counterpart of
``paddle_tpu/distributed/sharding/__init__.py``).

``group_sharded_parallel(model, optimizer, level)`` with ``os`` (stage
1: optimizer state), ``os_g`` (stage 2: and gradients) or ``p_g_os``
(stage 3: and parameters).  As in the JAX package the level rides on
the optimizer (``_group_sharded_level``), which comes back wrapped as
``fleet.distributed_optimizer`` wraps it (its clip's norm counts each
window once).  At ``os`` and ``os_g`` an update that a
:class:`.group_sharded.ZeroPlan` drives shards the state over fleet's
sharding group (``ZeroPlan.step``: ``train.build_train_step``'s step,
``PipelineParallel.train_batch``, or a loop of one's own); a plain tree
update raises there.  At ``p_g_os`` the model comes back as a
``ShardingParallel``: its large parameters stored as their windows
(:func:`.group_sharded.shard_parameters`), the other gradients averaged
over the data ranks after each backward pass, so any tree update of its
parameters is stage 3.  Without ``fleet.init`` the world is the
sharding group.  ``offload``, ``sync_buffers``, ``buffer_max_size``,
``segment_size``, ``sync_comm`` and ``exclude_layer`` are accepted and
not read.
"""
from __future__ import annotations

import os

import torch

from .group_sharded import (LEVELS, MIN_SIZE, GatherWindow, GradReducer,
                            ZeroPlan, gathered, is_window, local_batch,
                            mean_over_data_ranks, set_zero_level,
                            shard_parameters, state_bytes, window,
                            zero_dim, zero_level, zero_spec)

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "full_parameters", "LEVELS", "MIN_SIZE", "GatherWindow",
           "GradReducer", "ZeroPlan", "gathered", "is_window",
           "local_batch", "mean_over_data_ranks", "set_zero_level",
           "shard_parameters", "state_bytes", "window", "zero_dim",
           "zero_level", "zero_spec"]


def _hcg():
    from ..fleet import fleet, get_hybrid_communicate_group
    from ..env import get_world_size
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        from ..fleet import DistributedStrategy
        s = DistributedStrategy()
        s.hybrid_configs = {"sharding_degree": get_world_size()}
        fleet.init(is_collective=True, strategy=s)
        hcg = get_hybrid_communicate_group()
    return hcg


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """Returns ``(model, optimizer, scaler)`` as the reference does: the
    level set on ``optimizer``, which comes back as a
    ``HybridParallelOptimizer``, and at ``p_g_os`` ``model`` as a
    ``ShardingParallel`` (module docstring)."""
    from ..fleet.meta_optimizers import HybridParallelOptimizer
    from ..fleet.meta_parallel import ShardingParallel
    if level not in LEVELS:
        raise ValueError(f"level must be os|os_g|p_g_os, got {level!r}")
    hcg = _hcg()
    if level == "p_g_os":
        model = ShardingParallel(model, hcg)
    set_zero_level(optimizer, level)
    if not isinstance(optimizer, HybridParallelOptimizer):
        optimizer = HybridParallelOptimizer(optimizer, hcg)
    return model, optimizer, scaler


@torch.no_grad()
def full_parameters(model) -> dict:
    """``model``'s parameters by name, stage-3 windows all-gathered whole
    (a collective: every rank of the sharding group calls it)."""
    from .group_sharded import _gather
    from ..parallel import unwrap_model
    model = unwrap_model(model)
    hcg = _hcg()
    return {n: (_gather(p, hcg) if is_window(p) else p).detach()
            for n, p in model.named_parameters()}


def save_group_sharded_model(model, output, optimizer=None):
    """Save ``model``'s whole parameters to ``output/model.pdparams`` and
    ``optimizer.state_dict()`` to ``output/model.pdopt`` (``paddle.save``
    files), from the first rank of the sharding group; every rank of the
    group calls it."""
    from ...framework.io_state import save
    full = full_parameters(model)
    if _hcg().get_sharding_parallel_group().rank != 0:
        return
    os.makedirs(output, exist_ok=True)
    save(full, os.path.join(output, "model.pdparams"))
    if optimizer is not None and hasattr(optimizer, "state_dict"):
        save(optimizer.state_dict(), os.path.join(output, "model.pdopt"))
