"""LayerNorm layer (the counterpart of ``LayerNorm`` in
``paddle_tpu/nn/layer/norm.py``): weight starts at 1, bias at 0."""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Constant

__all__ = ["LayerNorm"]


class LayerNorm(torch.nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes, of ``x`` or
    of ``x + residual``, through the fused LayerNorm kernels."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, generator):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = torch.nn.Parameter(
            Constant(1.0)(self._normalized_shape, generator))
        self.bias = torch.nn.Parameter(
            Constant(0.0)(self._normalized_shape, generator))

    def forward(self, x, residual=None):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon, residual=residual)
