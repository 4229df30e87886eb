"""Model-parallel layers; only the unsharded cross-entropy is ported."""
from .parallel_layers.mp_layers import ParallelCrossEntropy

__all__ = ["ParallelCrossEntropy"]
