"""Fleet's optimizer wrappers (:mod:`.hybrid_parallel_optimizer`,
:mod:`.dygraph_sharding_optimizer`)."""
from .dygraph_sharding_optimizer import DygraphShardingOptimizer
from .hybrid_parallel_optimizer import (HybridParallelClipGrad,
                                        HybridParallelOptimizer)

__all__ = ["DygraphShardingOptimizer", "HybridParallelClipGrad",
           "HybridParallelOptimizer"]
