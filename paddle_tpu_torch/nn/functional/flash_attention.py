"""``paddle.nn.functional.flash_attention`` over the port's flash kernels
(the counterpart of ``flash_attention`` in
``paddle_tpu/nn/functional/flash_attention.py``).

``flash_attn_unpadded`` (packed varlen sequences) waits for the packed
kernels and is not ported.
"""
from __future__ import annotations

import math

import torch

from ...ops import pallas_ops
from .common import scaled_dot_product_attention

__all__ = ["flash_attention"]


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, *, training=True, generator=None):
    """Attention over ``(B, S, H, D)`` q, k and v; returns ``(out,
    softmax)``.  ``softmax`` is None unless ``return_softmax``, which
    takes the plain path of :func:`scaled_dot_product_attention` and
    returns the f32 ``(B, H, S, S)`` probabilities before dropout, as the
    JAX function does.  Dropout in training draws its seed from
    ``generator``."""
    eff = dropout if training else 0.0
    if return_softmax:
        out = scaled_dot_product_attention(
            query, key, value, dropout_p=dropout, is_causal=causal,
            training=training, generator=generator)
        return out, _softmax_probs(query, key, causal)
    return pallas_ops.flash_attention(query, key, value, causal=causal,
                                      dropout_p=eff,
                                      generator=generator), None


def _softmax_probs(query, key, causal):
    q, k = query.transpose(1, 2), key.transpose(1, 2)
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        keep = torch.ones(logits.shape[-2:], dtype=torch.bool,
                          device=logits.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    return torch.softmax(logits.float(), dim=-1)
