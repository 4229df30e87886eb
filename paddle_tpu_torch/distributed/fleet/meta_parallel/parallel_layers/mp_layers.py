"""``ParallelCrossEntropy`` (the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/mp_layers.py``),
its unsharded branch: the vocabulary is not split over devices.

The loss is computed in the logits' dtype, as the JAX package does: under
AMP O2 the max, ``exp``, sum and ``log`` run on bf16 logits.
"""
from __future__ import annotations

import torch

__all__ = ["ParallelCrossEntropy"]


class ParallelCrossEntropy(torch.nn.Module):
    """Softmax cross-entropy per token, ``(..., V)`` logits against
    ``(...)`` or ``(..., 1)`` labels; returns ``(..., 1)``.  Tokens
    labelled ``ignore_index`` get a loss of 0."""

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        valid = label != self.ignore_index
        safe = torch.where(valid, label, torch.zeros_like(label))
        shifted = input - input.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(shifted).sum(dim=-1))
        tgt = shifted.gather(-1, safe.long().unsqueeze(-1)).squeeze(-1)
        loss = torch.where(valid, lse - tgt, torch.zeros((), dtype=lse.dtype,
                                                         device=lse.device))
        return loss.unsqueeze(-1)
