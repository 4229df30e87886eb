"""Linear, dropout, embedding and attention of the training path (the
counterpart of ``paddle_tpu/nn/functional/common.py``).

 - :func:`linear`: ``x @ W + b`` with the weight in ``(in, out)`` layout.
 - :func:`dropout`: ``upscale_in_train``; the mask is drawn from an
   explicit ``torch.Generator`` (:mod:`...framework.random`).
 - :func:`embedding`: the gather, with ``padding_idx``; its backward sums
   in an order that never changes between runs (:class:`_Embedding`).
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

__all__ = ["FLASH_MIN_SEQ", "ONE_HOT_MAX_ROWS", "linear", "dropout",
           "embedding", "scaled_dot_product_attention"]

#: sequence length from which attention belongs to the flash kernels
FLASH_MIN_SEQ = 512


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias``; weight ``(in, out)``."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


_DROPOUT_MODES = ("upscale_in_train", "downscale_in_infer")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Zero each element with probability ``p``, the reference's
    ``(x, p, axis, training, mode, name)``.  ``mode``
    ``upscale_in_train`` scales the kept elements by ``1 / (1 - p)`` in
    training and is the identity otherwise; ``downscale_in_infer`` keeps
    them as they are in training and scales by ``1 - p`` otherwise.
    ``axis`` (an int or a list): one mask entry is drawn for each index
    of those axes and broadcast over the others.  The mask draws from
    ``generator``, which training with ``0 < p < 1`` needs."""
    if mode not in _DROPOUT_MODES:
        raise ValueError(f"dropout mode {mode!r} is not one of "
                         f"{_DROPOUT_MODES}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training needs the run's generator")
    shape = x.shape
    if axis is not None:
        axes = [a % x.dim() for a in ([axis] if isinstance(axis, int)
                                       else axis)]
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


#: tables of at most this many rows take the one-hot product backward
ONE_HOT_MAX_ROWS = 16


class _Embedding(torch.autograd.Function):
    """The gather and a backward whose sums never change order between
    runs (the library's CUDA backward adds a row's repeats in an order
    that varies).  A table of at most ``ONE_HOT_MAX_ROWS`` rows (BERT's
    token types) takes ``one_hot(ids).T @ grad`` (a cuBLAS product; TF32
    off, PyTorch's default); a larger one a stable sort of the ids, then
    the gradient's rows added in that order into an f32 table, cast to
    the weight's dtype: on the card by ``index_put_(accumulate=True)``,
    a sort-based kernel that adds each id's rows in sequence (its
    ``index_add_`` adds by atomics), on the CPU by ``index_add_``, which
    adds row after row (its ``index_put_`` accumulates in parallel).
    Every shape is fixed by the inputs' shapes, so the backward records
    inside a CUDA graph."""

    @staticmethod
    def forward(ctx, ids, weight, padding_idx):
        flat = ids.reshape(-1)
        out = weight.index_select(0, flat)
        if padding_idx is not None:
            out = out.masked_fill((flat == padding_idx).unsqueeze(-1), 0)
        ctx.save_for_backward(flat)
        ctx.rows, ctx.dtype, ctx.padding_idx = (weight.shape[0], weight.dtype,
                                                padding_idx)
        return out.view(*ids.shape, weight.shape[1])

    @staticmethod
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        g = grad.reshape(flat.numel(), -1)
        if ctx.padding_idx is not None:
            g = g.masked_fill((flat == ctx.padding_idx).unsqueeze(-1), 0)
        rows = ctx.rows
        if rows <= ONE_HOT_MAX_ROWS:
            one_hot = (flat.unsqueeze(-1) == torch.arange(
                rows, device=flat.device)).to(g.dtype)
            return None, (one_hot.t() @ g).to(ctx.dtype), None
        ids, order = torch.sort(flat, stable=True)
        vals = g.index_select(0, order).float()
        gw = torch.zeros(rows, g.shape[1], dtype=torch.float32,
                         device=g.device)
        if gw.is_cuda:
            gw.index_put_((ids,), vals, accumulate=True)
        else:
            gw.index_add_(0, ids, vals)
        return None, gw.to(ctx.dtype), None


def _refuse_sparse(sparse):
    if sparse:
        raise NotImplementedError(
            "embedding(sparse=True): sparse (row-wise) gradients are not "
            "ported; the table's gradient is dense")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``; positions whose id is
    ``padding_idx`` (negative counts from the end) give 0 and send no
    gradient to that row.  The backward's sums are the same bits on
    every run (:class:`_Embedding`).  ``sparse=True`` raises."""
    _refuse_sparse(sparse)
    if padding_idx is not None and padding_idx < 0:
        padding_idx += weight.shape[0]
    return _Embedding.apply(x, weight, padding_idx)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *,
                                 generator=None):
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
    probs = dropout(probs, dropout_p, training=training,
                    generator=generator)
    return torch.matmul(probs, v).transpose(1, 2)
