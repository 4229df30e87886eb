"""Fleet: the hybrid-parallel facade (``fleet.init``, the topology,
``distributed_model`` and ``distributed_optimizer``), the strategy, the
tensor-parallel layers, the pipeline and stage-3 sharding
(:mod:`.meta_parallel`), the optimizer wrappers
(:mod:`.meta_optimizers`), per-block recompute (:mod:`.recompute`), the
role makers that read the launcher's environment (:mod:`.role_maker`),
the job helpers (:mod:`.util`), the file systems (:mod:`.utils`) and the
MultiSlot data generators (:mod:`.data_generator`; their datasets are
:mod:`.dataset`'s)."""
from . import meta_optimizers, meta_parallel, role_maker, util, utils
from .base.distributed_strategy import DistributedStrategy
from .fleet import (Fleet, barrier_worker, distributed_model,
                    distributed_optimizer, fleet, get_hybrid_communicate_group,
                    hybrid_degrees, init, is_first_worker, worker_endpoints,
                    worker_index, worker_num)
from .data_generator import (DataGenerator, MultiSlotDataGenerator,
                             MultiSlotStringDataGenerator)
from .recompute import recompute, recompute_sequential
from .role_maker import PaddleCloudRoleMaker, Role, UserDefinedRoleMaker
from .util import UtilBase
from ..topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["DistributedStrategy", "Fleet", "fleet", "init",
           "get_hybrid_communicate_group", "distributed_model",
           "distributed_optimizer", "worker_num", "worker_index",
           "is_first_worker", "worker_endpoints", "barrier_worker",
           "hybrid_degrees", "recompute", "recompute_sequential",
           "CommunicateTopology",
           "HybridCommunicateGroup", "meta_parallel", "meta_optimizers",
           "role_maker", "util", "PaddleCloudRoleMaker", "Role",
           "UserDefinedRoleMaker", "UtilBase", "utils", "DataGenerator",
           "MultiSlotDataGenerator", "MultiSlotStringDataGenerator"]
