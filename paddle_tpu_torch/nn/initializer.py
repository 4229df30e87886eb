"""Parameter initializers of the training path (the counterpart of
``paddle_tpu/nn/initializer/``: ``Normal``, ``Uniform``, ``XavierNormal``
and ``Constant``).

An initializer is called with the parameter's shape and the run's
generator and returns an f32 tensor on the generator's device; layers
build their parameters from it, so a model is drawn from one seed.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Normal", "Uniform", "XavierNormal", "Constant"]


class Normal:
    """Gaussian draws with mean ``mean`` and deviation ``std``."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, shape, generator: torch.Generator) -> torch.Tensor:
        return (torch.randn(tuple(shape), generator=generator,
                            device=generator.device) * self.std + self.mean)


class Uniform:
    """Uniform draws on ``[low, high)``."""

    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = float(low), float(high)

    def __call__(self, shape, generator: torch.Generator) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=generator,
                       device=generator.device)
        return u * (self.high - self.low) + self.low


class XavierNormal:
    """Gaussian draws with deviation ``sqrt(2 / (fan_in + fan_out))``;
    a 2-D ``(in, out)`` shape has fans ``in`` and ``out``, a 1-D one its
    length for both (the JAX package's ``_fans``)."""

    def __call__(self, shape, generator: torch.Generator) -> torch.Tensor:
        shape = tuple(shape)
        if len(shape) not in (1, 2):
            raise NotImplementedError(f"XavierNormal of a {len(shape)}-D "
                                      f"shape is not ported")
        fan_in, fan_out = shape[0], shape[-1]
        return Normal(std=math.sqrt(2.0 / (fan_in + fan_out)))(shape,
                                                               generator)


class Constant:
    """Every element ``value``; draws nothing."""

    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def __call__(self, shape, generator: torch.Generator) -> torch.Tensor:
        return torch.full(tuple(shape), self.value, device=generator.device)
