"""Observers: scale statistics of the tensors passing through.

The counterpart of ``paddle_tpu/quantization/observers.py``'s
:class:`AbsmaxObserver` and :class:`PerChannelAbsmaxObserver`, the two
that int8 calibration uses (:mod:`..serving.quant`).  They take tensors
(on any device) or arrays; the maximum runs where the tensor lives, in
f32, and only the result comes to the host.  A maximum is exact in any
order, so the scales equal the JAX package's on the same values.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BaseObserver", "AbsmaxObserver", "PerChannelAbsmaxObserver"]


def _f32(x) -> torch.Tensor:
    t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))
    return t.float()


class BaseObserver:
    """Collects statistics on tensors passing through; yields a scale."""

    def __init__(self, quant_bits=8):
        self.quant_bits = quant_bits
        self._scale = None

    def observe(self, x):
        raise NotImplementedError

    def scales(self):
        return self._scale if self._scale is not None else 1e-9

    def bit_length(self):
        return self.quant_bits

    def quant_axis(self):
        return None


class AbsmaxObserver(BaseObserver):
    """The largest ``|x|`` seen (a float)."""

    def observe(self, x):
        m = float(_f32(x).abs().max())
        self._scale = m if self._scale is None else max(self._scale, m)


class PerChannelAbsmaxObserver(BaseObserver):
    """The largest ``|x|`` seen along every axis but ``quant_axis_``
    (an f32 array of that axis' length)."""

    def __init__(self, quant_bits=8, quant_axis_=0):
        super().__init__(quant_bits)
        self._axis = quant_axis_

    def observe(self, x):
        t = _f32(x)
        axes = tuple(i for i in range(t.dim()) if i != self._axis % t.dim())
        m = (t.abs().amax(dim=axes) if axes else t.abs()).cpu().numpy()
        self._scale = m if self._scale is None else np.maximum(
            self._scale, m)

    def quant_axis(self):
        return self._axis
