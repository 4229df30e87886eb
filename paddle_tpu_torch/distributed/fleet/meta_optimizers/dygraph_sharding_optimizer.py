"""``DygraphShardingOptimizer``: ZeRO stage 1 (the counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/dygraph_sharding_optimizer.py``).

The reference gives each sharding rank a greedy, size-balanced share of
the parameter list (:meth:`_partition_parameters`, kept with the same
mapping).  The port, like the JAX package, shards each state tensor
over the group instead (the same windows on every rank,
:class:`...sharding.ZeroPlan`): this class sets level ``os`` on the
inner optimizer and delegates everything else to it.
"""
from __future__ import annotations

import numpy as np

from ...sharding.group_sharded import set_zero_level

__all__ = ["DygraphShardingOptimizer"]


class DygraphShardingOptimizer:
    def __init__(self, optimizer=None, hcg=None, user_defined_strategy=None,
                 params=None, inner_optimizer_class=None, **inner_kw):
        if optimizer is not None and inner_optimizer_class is None:
            self._inner_opt = optimizer
            self._parameter_list = list(optimizer._parameter_list)
        else:
            self._parameter_list = list(params)
            self._inner_opt = inner_optimizer_class(
                parameters=self._parameter_list, **inner_kw)
        self._hcg = hcg
        n = hcg.get_sharding_parallel_world_size() if hcg is not None else 1
        self._rank2params = self._partition_parameters(max(n, 1))
        set_zero_level(self._inner_opt, "os")

    def _partition_parameters(self, n: int) -> dict:
        """{rank: [parameters]}: largest first, each to the rank with the
        fewest elements so far (the first of equals)."""
        mapping = {i: [] for i in range(n)}
        sizes = [0.0] * n
        for p in sorted(self._parameter_list, key=lambda p: -p.numel()):
            i = int(np.argmin(sizes))
            mapping[i].append(p)
            sizes[i] += p.numel()
        return mapping

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)
