"""Fleet pieces of the training path: per-block recompute
(:mod:`.recompute`) and the unsharded ``ParallelCrossEntropy``
(:mod:`.meta_parallel`)."""
from .recompute import recompute

__all__ = ["recompute"]
