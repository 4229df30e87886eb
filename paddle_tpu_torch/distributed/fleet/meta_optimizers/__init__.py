"""Fleet's optimizer wrappers (:mod:`.hybrid_parallel_optimizer`)."""
from .hybrid_parallel_optimizer import (HybridParallelClipGrad,
                                        HybridParallelOptimizer)

__all__ = ["HybridParallelClipGrad", "HybridParallelOptimizer"]
