"""Activations (the counterpart of ``paddle_tpu/nn/functional/activation.py``
for the training path)."""
from __future__ import annotations

import torch

__all__ = ["gelu", "tanh"]


def gelu(x, approximate: bool = False, name=None):
    """GELU: the erf form by default (BERT's), or with
    ``approximate=True`` the tanh form
    ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))`` that GPT's MLP
    uses (``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    """Elementwise tanh (BERT's pooler)."""
    return torch.tanh(x)
