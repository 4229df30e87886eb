"""Fleet's parallel layers and wrappers: tensor parallelism (the mp
layers and operators, the dropout streams, ``TensorParallel``), the
pipeline (``LayerDesc``, ``SharedLayerDesc``, ``PipelineLayer``,
``PipelineParallel`` and its schedules, ``pp_utils``), stage-3
sharding (``ShardingParallel``) and sequence parallelism (ring and
Ulysses attention)."""
from . import mp_ops, pp_utils
from .mp_ops import split
from .parallel_layers.mp_layers import (ColumnParallelLinear,
                                        ParallelCrossEntropy,
                                        RowParallelLinear,
                                        VocabParallelEmbedding, is_shard)
from .parallel_layers.pp_layers import (LayerDesc, PipelineLayer,
                                        SharedLayerDesc)
from .pipeline_parallel import (PipelineEngine, PipelineParallel,
                                microbatch_utilization, schedule_orders,
                                schedule_table)
from .random import (RNGStatesTracker, get_rng_state_tracker,
                     model_parallel_random_seed)
from .sequence_parallel import (RingFlashAttention, gather_sequence,
                                ring_attention, split_sequence,
                                ulysses_attention)
from .sharding_parallel import ShardingParallel, annotate_fsdp_specs
from .tensor_parallel import TensorParallel

__all__ = ["mp_ops", "pp_utils", "split", "ColumnParallelLinear",
           "ParallelCrossEntropy", "RowParallelLinear",
           "VocabParallelEmbedding", "is_shard", "LayerDesc",
           "PipelineLayer", "SharedLayerDesc", "PipelineEngine",
           "PipelineParallel", "microbatch_utilization", "schedule_orders",
           "schedule_table", "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "ShardingParallel",
           "annotate_fsdp_specs", "TensorParallel", "ring_attention",
           "ulysses_attention", "split_sequence", "gather_sequence",
           "RingFlashAttention"]
