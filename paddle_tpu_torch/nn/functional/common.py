"""Linear, dropout, embedding and attention of the training path (the
counterpart of ``paddle_tpu/nn/functional/common.py``).

 - :func:`linear`: ``x @ W + b`` with the weight in ``(in, out)`` layout.
 - :func:`dropout`: ``upscale_in_train``; the mask is drawn from an
   explicit ``torch.Generator`` (:mod:`...framework.random`).
 - :func:`scaled_dot_product_attention`: the JAX package's plain softmax
   attention below ``flash_min_seq`` (512,
   ``paddle_tpu/framework/flags.py``) or with an ``attn_mask``; from 512
   on without a mask the flash kernels
   (:func:`...ops.pallas_ops.flash_attention`), as the JAX package takes
   its Pallas kernels there.
"""
from __future__ import annotations

import math

import torch

from ...ops import pallas_ops

__all__ = ["FLASH_MIN_SEQ", "linear", "dropout", "embedding",
           "scaled_dot_product_attention"]

#: sequence length from which attention belongs to the flash kernels
FLASH_MIN_SEQ = 512


def linear(x, weight, bias=None):
    """``x @ weight + bias``; weight ``(in, out)``."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def dropout(x, p=0.5, training=True, generator=None):
    """Zero each element with probability ``p`` and scale the rest by
    ``1 / (1 - p)``; the identity when not training or ``p == 0``.  The
    mask draws from ``generator``, which training with ``p > 0`` needs."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training needs the run's generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def embedding(x, weight):
    """Rows of ``weight`` at the ids ``x``."""
    return torch.nn.functional.embedding(x, weight)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Softmax attention over ``(B, S, H, D)`` q, k and v (paddle's
    layout), with an optional ``attn_mask`` broadcast against the
    ``(B, H, S, S)`` scores: a bool mask keeps the scores where it is
    True (``-inf`` elsewhere), any other is added in the scores' dtype.

    From ``S >= FLASH_MIN_SEQ`` without a mask, on every device: flash
    attention, whose kernels run on a CUDA tensor and whose plain
    versions run on a CPU tensor (dropout by the coordinate hash, its seed
    drawn from ``generator``).  Otherwise: scores in the input dtype
    scaled by ``1/sqrt(D)``, an upper-triangle ``-inf`` mask when causal,
    then the mask, softmax in f32 cast back to the input dtype, dropout on
    the probabilities, then the product with v.
    """
    if attn_mask is None and query.shape[1] >= FLASH_MIN_SEQ:
        return pallas_ops.flash_attention(
            query, key, value, causal=is_causal,
            dropout_p=dropout_p if training else 0.0, generator=generator)
    scale = 1.0 / math.sqrt(query.shape[-1])
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if is_causal:
        keep = torch.ones(logits.shape[-2:], dtype=torch.bool,
                          device=logits.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(query.dtype)
    probs = dropout(probs, dropout_p, training, generator)
    return torch.matmul(probs, v).transpose(1, 2)
