"""``paddle.nn.functional.flash_attention`` and ``flash_attn_unpadded``
over the port's flash kernels (the counterpart of
``paddle_tpu/nn/functional/flash_attention.py``).

``flash_attn_unpadded`` runs packed ragged sequences through the packed
kernels (:func:`...ops.pallas_ops.mha_packed`).  The JAX package's
``_packed_usable`` canary and ``_padded_fallback`` are not ported: they
keep a jitted TPU step alive when its kernel fails to lower, and here a
kernel that fails raises.  ``check_varlen`` validates a traced ``cu``; the
port is eager, so ``cu_seqlens`` is always validated on the host.
"""
from __future__ import annotations

import math

import torch

from ...ops import pallas_ops
from .common import scaled_dot_product_attention

__all__ = ["flash_attention", "flash_attn_unpadded"]


def _rng(rng_name, generator):
    """``generator``, or the one the model-parallel tracker keeps under
    ``rng_name`` (paddle's named RNG state) when none is given."""
    if generator is not None or not rng_name:
        return generator
    from ...distributed.fleet.meta_parallel.random import \
        get_rng_state_tracker
    gen = get_rng_state_tracker().get(rng_name)
    if gen is None:
        raise KeyError(f"flash_attention(rng_name={rng_name!r}): the RNG "
                       f"state tracker has no generator of that name")
    return gen


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, *, fixed_seed_offset=None,
                    rng_name="", training=True, name=None, generator=None):
    """Attention over ``(B, S, H, D)`` q, k and v; returns ``(out,
    softmax)``.  ``softmax`` is None unless ``return_softmax``, which
    takes the plain path of :func:`scaled_dot_product_attention` and
    returns the f32 ``(B, H, S, S)`` probabilities before dropout, as the
    JAX function does.  Dropout in training hashes with a seed drawn
    from ``generator`` (by default the tracker's generator named
    ``rng_name``), or with ``fixed_seed_offset`` when given: an int, or
    a tensor whose first element is the seed (paddle's ``(seed,
    offset)`` pair; the hash has no offset, so the second is not read)."""
    eff = dropout if training else 0.0
    generator = _rng(rng_name, generator)
    if return_softmax:
        out = scaled_dot_product_attention(
            query, key, value, dropout_p=dropout, is_causal=causal,
            training=training, generator=generator)
        return out, _softmax_probs(query, key, causal)
    if fixed_seed_offset is not None and eff > 0.0:
        seed = fixed_seed_offset
        if isinstance(seed, torch.Tensor):
            seed = seed.reshape(-1)[0]
        out = pallas_ops.mha(query.transpose(1, 2), key.transpose(1, 2),
                             value.transpose(1, 2), causal=causal,
                             dropout_p=eff, seed=seed)
        return out.transpose(1, 2), None
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


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None, *, generator=None):
    """Packed ragged varlen attention: ``query`` is ``(total_q, H, D)``,
    sequence ``i`` on rows ``cu_seqlens_q[i]:cu_seqlens_q[i + 1]`` (key
    and value likewise with ``cu_seqlens_k``); returns ``(out, None)``,
    out ``(total_q, H, D)``, differentiable in query, key and value.

    Cross lengths are allowed; ``causal`` aligns each pair's diagonal
    bottom right, the flash-attn varlen convention.  ``cu_seqlens`` are
    read on the host and validated (raising, as the JAX function does on
    concrete values).  Dropout in training draws its seed from
    ``generator``.  ``return_softmax``, ``fixed_seed_offset``,
    ``rng_name`` and ``name`` are accepted and unused, as in the JAX
    function.
    """
    cu_q = pallas_ops._validate_cu(pallas_ops._host_ints(cu_seqlens_q),
                                   query.shape[0], "cu_seqlens_q",
                                   max_seqlen_q)
    cu_k = pallas_ops._validate_cu(pallas_ops._host_ints(cu_seqlens_k),
                                   key.shape[0], "cu_seqlens_k", max_seqlen_k)
    eff = dropout if training else 0.0
    seed = None
    if eff > 0.0:
        if generator is None:
            raise ValueError("attention dropout needs the run's generator")
        seed = pallas_ops.draw_seed(generator)
    out = pallas_ops.mha_packed(query, key, value, cu_q, cu_k, causal=causal,
                                sm_scale=scale, dropout_p=eff, seed=seed)
    return out, None
