"""Parameter initializers of the training path (the counterpart of
``paddle_tpu/nn/initializer/``, ``Normal`` and ``Constant``).

An initializer is called with the parameter's shape and the run's
generator and returns an f32 tensor on the generator's device; layers
build their parameters from it, so a model is drawn from one seed.
"""
from __future__ import annotations

import torch

__all__ = ["Normal", "Constant"]


class Normal:
    """Gaussian draws with mean ``mean`` and deviation ``std``."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, shape, generator: torch.Generator) -> torch.Tensor:
        return (torch.randn(tuple(shape), generator=generator,
                            device=generator.device) * self.std + self.mean)


class Constant:
    """Every element ``value``; draws nothing."""

    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def __call__(self, shape, generator: torch.Generator) -> torch.Tensor:
        return torch.full(tuple(shape), self.value, device=generator.device)
