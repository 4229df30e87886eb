"""The port's distributed layer, on ``torch.distributed`` with one
process per rank: the environment (:mod:`.env`), process groups and the
collectives (:mod:`.collective`, :mod:`.communication.stream`), the
process group and ``DataParallel`` (:mod:`.parallel`), ``spawn``
(:mod:`.launch_api`), the rank mesh and the hybrid topology
(:mod:`.mesh`, :mod:`.topology`), gradient buckets
(:mod:`.grad_buckets`) and their collective schedule
(:mod:`.collective_schedule`), the ZeRO placement rule
(:mod:`.auto_parallel`), group sharding (:mod:`.sharding`), ``fleet``
with the tensor-parallel layers and the pipeline (:mod:`.fleet`), a CPU
rendezvous (:mod:`.parallel_with_gloo`),
process-level contracts and the crash-consistent checkpoint
(:mod:`.checkpoint`, :mod:`.checkpoint_manager`), whose directories both
packages read; the launcher (``python -m
paddle_tpu_torch.distributed.launch``, :mod:`.launch`), the auto-parallel
annotations and ``Engine`` (:mod:`.auto_parallel_api`,
:mod:`.auto_parallel`), ``rpc`` (:mod:`.rpc`), the sharded embedding in
place of a parameter server (:mod:`.ps`) and its entry attributes
(:mod:`.entry_attr`), the parallel-configuration tuner
(:mod:`.auto_tuner`), the MultiSlot file datasets
(:mod:`.fleet.dataset`) and ``global_scatter`` / ``global_gather``
(:mod:`.utils`)."""
from . import (auto_parallel, auto_tuner, collective_schedule,
               communication, fleet, launch, ps, rpc, sharding, utils)
from .auto_parallel import Engine, to_static
from .auto_parallel_api import (Partial, ProcessMesh, Replicate, Shard,
                                dtensor_from_fn, reshard, shard_layer,
                                shard_tensor)
from .checkpoint import (CheckpointCorruptError, HostLocalShard,
                         ReshardError, is_committed, load_sharded,
                         load_state, read_leaf, save_sharded, save_state,
                         verify_checkpoint)
from .checkpoint_manager import CheckpointManager, latest_checkpoint
from .collective import (P2POp, ReduceOp, Group, all_gather,
                         all_gather_object, all_reduce, all_to_all, alltoall,
                         alltoall_single, barrier, batch_isend_irecv,
                         broadcast, broadcast_object_list,
                         destroy_process_group, gather, get_backend,
                         get_group, host_staged, irecv, is_available,
                         is_initialized,
                         isend, new_group, recv, reduce, reduce_scatter,
                         scatter, scatter_object_list, send, wait)
from .communication import stream
from .env import ParallelEnv, get_rank, get_world_size
from .fleet.dataset import InMemoryDataset, QueueDataset
from .fleet.meta_parallel.mp_ops import split
from .entry_attr import CountFilterEntry, ProbabilityEntry, ShowClickEntry
from .launch_api import spawn
from .mesh import (HYBRID_AXES, build_mesh, get_mesh, init_mesh,
                   mesh_axis_size, set_mesh)
from .parallel import (DataParallel, init_parallel_env, rank_device,
                       unwrap_model)
from .parallel_with_gloo import (gloo_barrier, gloo_init_parallel_env,
                                 gloo_release)
from .sharding import group_sharded_parallel, save_group_sharded_model
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       ParallelMode)

__all__ = [
    "CheckpointCorruptError", "HostLocalShard", "ReshardError",
    "is_committed", "load_sharded", "load_state", "read_leaf",
    "save_sharded", "save_state", "verify_checkpoint", "CheckpointManager",
    "latest_checkpoint", "P2POp", "ReduceOp", "Group", "all_gather",
    "all_gather_object", "all_reduce", "all_to_all", "alltoall",
    "alltoall_single", "barrier", "batch_isend_irecv", "broadcast",
    "broadcast_object_list", "destroy_process_group", "gather",
    "get_backend", "get_group", "host_staged", "irecv", "is_available",
    "is_initialized",
    "isend", "new_group", "recv", "reduce", "reduce_scatter", "scatter",
    "scatter_object_list", "send", "wait", "stream", "communication",
    "ParallelEnv", "get_rank", "get_world_size", "split", "spawn",
    "HYBRID_AXES", "build_mesh", "get_mesh", "init_mesh", "mesh_axis_size",
    "set_mesh", "DataParallel", "init_parallel_env", "rank_device",
    "unwrap_model",
    "gloo_barrier", "gloo_init_parallel_env", "gloo_release",
    "CommunicateTopology", "HybridCommunicateGroup", "ParallelMode", "fleet",
    "auto_parallel", "collective_schedule", "sharding",
    "group_sharded_parallel", "save_group_sharded_model",
    "ProcessMesh", "Shard", "Replicate", "Partial", "shard_tensor",
    "shard_layer", "dtensor_from_fn", "reshard", "Engine", "to_static",
    "launch", "rpc", "ps", "CountFilterEntry", "ProbabilityEntry",
    "ShowClickEntry", "auto_tuner", "utils", "InMemoryDataset",
    "QueueDataset",
]
