"""The Adam family (the counterpart of ``paddle_tpu/optimizer/adam.py``):
Adam (with ``amsgrad``), AdamW, Adamax, Lamb, NAdam and RAdam.

Everything that depends on the step (bias corrections, NAdam's momentum
schedule, RAdam's rectification and its switch, Lamb's trust ratio) is
computed on the device from the int32 step tensor and the parameters,
with no host read and no Python branch on a tensor.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, descend

__all__ = ["Adam", "AdamW", "Adamax", "Lamb", "NAdam", "RAdam"]


def _t(step):
    """The step as f32, at least 1."""
    return step.clamp(min=1).float()


def _denom(m2, bc2, eps):
    """``sqrt(m2 / bc2) + eps`` for each tensor."""
    out = torch._foreach_div(m2, bc2)
    torch._foreach_sqrt_(out)
    torch._foreach_add_(out, eps)
    return out


def _moments(m1, m2, grads, b1, b2):
    torch._foreach_mul_(m1, b1)
    torch._foreach_add_(m1, grads, alpha=1 - b1)
    torch._foreach_mul_(m2, b2)
    torch._foreach_addcmul_(m2, grads, grads, value=1 - b2)


class Adam(Optimizer):
    """Adam with bias correction; ``weight_decay`` is L2 on the gradient.
    ``amsgrad`` keeps the running maximum of the second moment in a third
    slot, ``moment2_max``."""

    _state_slots = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        # dense moments either way (the JAX package's too); the fused
        # foreach update is the multi-tensor path
        self._lazy_mode, self._use_multi_tensor = lazy_mode, use_multi_tensor
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._amsgrad = amsgrad
        if amsgrad:
            # on the instance: the class's slots stay two
            self._state_slots = ("moment1", "moment2", "moment2_max")

    def _update(self, params, grads, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m1, m2 = slots[0], slots[1]
        # the bias corrections in f32 on the device, as the JAX update
        # computes them from its int32 step
        t = _t(step)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        _moments(m1, m2, grads, b1, b2)
        if self._amsgrad:
            torch._foreach_maximum_(slots[2], m2)
            m2 = slots[2]
        upd = torch._foreach_div(m1, bc1)
        torch._foreach_div_(upd, _denom(m2, bc2, self._epsilon))
        descend(params, upd, lr)


class AdamW(Adam):
    """Adam with decoupled weight decay, 0.01 by default."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode,
                         multi_precision, amsgrad=amsgrad, name=name)
        # kept, not read: the tree update decays every parameter and takes
        # one rate, as the JAX package's does
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun


class Adamax(Optimizer):
    """Adam with the infinity norm: ``u = max(beta2 * u, |g|)``."""

    _state_slots = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, params, grads, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m, u = slots
        bc1 = 1 - torch.pow(b1, _t(step))
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(u, b2)
        torch._foreach_maximum_(u, torch._foreach_abs(grads))
        upd = torch._foreach_div(m, torch._foreach_add(u, self._epsilon))
        descend(params, upd, lr / bc1)


class Lamb(Optimizer):
    """Layer-wise adaptive moments: Adam's step plus
    ``lamb_weight_decay * p``, scaled per tensor by the trust ratio
    ``||p|| / ||r||`` (1 where either norm is 0).
    ``exclude_from_weight_decay_fn`` is accepted and, as in the JAX
    package's update, not applied."""

    _state_slots = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update(self, params, grads, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m1, m2 = slots
        t = _t(step)
        _moments(m1, m2, grads, b1, b2)
        r = torch._foreach_div(m1, 1 - torch.pow(b1, t))
        torch._foreach_div_(r, _denom(m2, 1 - torch.pow(b2, t),
                                      self._epsilon))
        torch._foreach_add_(r, params, alpha=self._lamb_wd)
        w_norm = torch.stack(torch._foreach_norm(params))
        r_norm = torch.stack(torch._foreach_norm(r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        descend(params, r, lr * trust)


class NAdam(Optimizer):
    """Adam with Nesterov momentum and the momentum schedule
    ``mu_t = beta1 * (1 - 0.5 * 0.96 ** (t * momentum_decay))``."""

    _state_slots = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _update(self, params, grads, slots, lr, step):
        b1, b2, psi = self._beta1, self._beta2, self._psi
        m1, m2 = slots
        t = _t(step)
        mu_t = b1 * (1 - 0.5 * torch.pow(0.96, t * psi))
        mu_t1 = b1 * (1 - 0.5 * torch.pow(0.96, (t + 1) * psi))
        _moments(m1, m2, grads, b1, b2)
        # mu_t1 * m1 / (1 - mu_t * mu_t1) + (1 - mu_t) * g / (1 - mu_t)
        m1_hat = torch._foreach_mul(m1, mu_t1)
        torch._foreach_div_(m1_hat, 1 - mu_t * mu_t1)
        gt = torch._foreach_mul(grads, 1 - mu_t)
        torch._foreach_div_(gt, 1 - mu_t)
        torch._foreach_add_(m1_hat, gt)
        torch._foreach_div_(m1_hat, _denom(m2, 1 - torch.pow(b2, t),
                                           self._epsilon))
        descend(params, m1_hat, lr)


class RAdam(Optimizer):
    """Rectified Adam: the adaptive step scaled by ``r_t`` once
    ``rho_t > 5``, the bias-corrected momentum alone before."""

    _state_slots = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, params, grads, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m1, m2 = slots
        t = _t(step)
        rho_inf = 2.0 / (1 - b2) - 1
        _moments(m1, m2, grads, b1, b2)
        bc1 = 1 - torch.pow(b1, t)
        bt2 = torch.pow(b2, t)
        bc2 = 1 - bt2
        rho_t = rho_inf - 2 * t * bt2 / bc2
        r = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf) / torch.clamp(
            (rho_inf - 4) * (rho_inf - 2) * rho_t, min=1e-8))
        adaptive = rho_t > 5.0
        # where(adaptive, r * m1_hat / den, m1_hat) for every tensor with
        # 0-d factors: r (1 when not adaptive) on the numerator, and the
        # denominator den * a + (1 - a), exactly den or 1
        a = adaptive.float()
        upd = torch._foreach_div(m1, bc1)
        torch._foreach_mul_(upd, torch.where(adaptive, r, torch.ones_like(r)))
        den = _denom(m2, bc2, self._epsilon)
        torch._foreach_mul_(den, a)
        # a list: _foreach_add_ with one tensor reads it on the host
        torch._foreach_add_(den, [1 - a] * len(den))
        torch._foreach_div_(upd, den)
        descend(params, upd, lr)
