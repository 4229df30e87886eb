"""Tensor parallelism: the mp layers and operators, the dropout streams
and ``TensorParallel``."""
from . import mp_ops
from .mp_ops import split
from .parallel_layers.mp_layers import (ColumnParallelLinear,
                                        ParallelCrossEntropy,
                                        RowParallelLinear,
                                        VocabParallelEmbedding, is_shard)
from .random import (RNGStatesTracker, get_rng_state_tracker,
                     model_parallel_random_seed)
from .tensor_parallel import TensorParallel

__all__ = ["mp_ops", "split", "ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding", "is_shard",
           "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed",
           "TensorParallel"]
