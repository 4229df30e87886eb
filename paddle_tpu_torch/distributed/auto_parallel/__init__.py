"""``paddle_tpu_torch.distributed.auto_parallel``: the annotations
(``ProcessMesh``, ``shard_tensor``, ``reshard``, ..., from
:mod:`..auto_parallel_api`), the strategy-driven :class:`Engine`
(:mod:`.engine`), the cluster model (:mod:`.cluster`) and the ZeRO /
fsdp placement rule (:mod:`.spec_layout`)."""
from ..auto_parallel_api import (Partial, ProcessMesh, Replicate, Shard,
                                 dtensor_from_fn, reshard, shard_layer,
                                 shard_tensor)
from .cluster import Cluster
from .engine import Engine, to_static
from .spec_layout import place_axis, spec_axes

__all__ = ["Cluster", "ProcessMesh", "Shard", "Replicate", "Partial",
           "shard_tensor", "shard_layer", "dtensor_from_fn", "reshard",
           "Engine", "to_static", "place_axis", "spec_axes"]
