"""Linear, embedding and dropout layers (the counterpart of
``paddle_tpu/nn/layer/common.py``), with paddle's parameter names and
layouts: ``Linear.weight`` is ``(in, out)``.

Parameters are drawn at construction from the run's generator, on its
device, in f32; biases start at 0.
"""
from __future__ import annotations

import torch

from .. import functional as F
from ..functional.common import _refuse_sparse
from ..initializer import Constant

__all__ = ["Linear", "Embedding", "Dropout"]


def _param(init, shape, generator):
    return torch.nn.Parameter(init(shape, generator))


class Linear(torch.nn.Module):
    """``y = x @ weight + bias``, weight ``(in, out)`` drawn by
    ``weight_attr``."""

    def __init__(self, in_features, out_features, weight_attr, *, generator):
        super().__init__()
        self.weight = _param(weight_attr, (in_features, out_features),
                             generator)
        self.bias = _param(Constant(0.0), (out_features,), generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(torch.nn.Module):
    """A ``(num_embeddings, embedding_dim)`` table drawn by
    ``weight_attr``; row ``padding_idx`` (negative counts from the end)
    starts at 0, and positions holding it give 0 (:func:`F.embedding`)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr, *,
                 generator, padding_idx=None, sparse=False, name=None):
        super().__init__()
        _refuse_sparse(sparse)
        self.weight = _param(weight_attr, (num_embeddings, embedding_dim),
                             generator)
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self._padding_idx = padding_idx
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(torch.nn.Module):
    """Dropout with rate ``p`` while training; draws from the generator
    passed to :meth:`forward`."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        return F.dropout(x, self.p, training=self.training,
                         generator=generator)
