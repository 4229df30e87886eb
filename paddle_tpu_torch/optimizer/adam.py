"""Adam and AdamW (the counterpart of ``paddle_tpu/optimizer/adam.py``)."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    """Adam with bias correction; ``weight_decay`` is L2 on the gradient."""

    _state_slots = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=None, multi_precision=True):
        super().__init__(learning_rate, weight_decay, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, params, grads, slots, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m1, m2 = slots
        # the bias corrections in f32 on the device, as the JAX update
        # computes them from its int32 step
        t = step.clamp(min=1).float()
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        torch._foreach_mul_(m1, b1)
        torch._foreach_add_(m1, grads, alpha=1 - b1)
        torch._foreach_mul_(m2, b2)
        torch._foreach_addcmul_(m2, grads, grads, value=1 - b2)
        denom = torch._foreach_div(m2, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m1, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(params, upd, alpha=-lr)


class AdamW(Adam):
    """Adam with decoupled weight decay, 0.01 by default."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, multi_precision=True):
        super().__init__(learning_rate, beta1, beta2, epsilon, weight_decay,
                         multi_precision)
