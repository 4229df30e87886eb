"""Gradient clipping (the counterpart of ``paddle_tpu/nn/clip.py``).

Each clip has a tree form, :meth:`ClipGradBase.apply_tensors` over a
list of gradients (``None`` entries kept), which the optimizer runs over
the whole tree before the decay and the update, as the JAX package's
``apply_arrays``; and the eager form over ``(param, grad)`` pairs.  The
arithmetic follows the JAX package's order: squares summed in f32; the
global scale ``clip / max(norm, clip)``, the per-tensor one
``min(clip / max(norm, 1e-12), 1)``; the gradient scaled in f32 and
rounded back to its own dtype (a bf16 gradient stays bf16, as
``astype(g.dtype)`` leaves it).  Norms and scales are 0-d tensors on the
gradients' device: nothing is read on the host, so a captured step
clips on every replay.  Only ``clip_grad_norm_(error_if_nonfinite=True)``
reads the norm on the host: that check is its contract.
"""
from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _scale(grads: List[torch.Tensor], scales) -> List[torch.Tensor]:
    """Each gradient times its scale (one 0-d f32 tensor for all, or one
    each) in f32, rounded back to the gradient's dtype."""
    g32 = [g.float() for g in grads]
    if isinstance(scales, torch.Tensor):
        out = torch._foreach_mul(g32, scales)
    else:
        out = torch._foreach_mul(g32, list(scales))
    return [o.to(g.dtype) for o, g in zip(out, grads)]


def _norms(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient's 2-norm, its squares summed in f32."""
    return list(torch._foreach_norm(grads, 2, dtype=torch.float32))


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as a division (``float / Tensor`` multiplies by the
    reciprocal)."""
    return torch.div(torch.full_like(den, num), den)


class ClipGradBase:
    def __call__(self, params_grads):
        """``[(param, grad or None)]`` -> the same with clipped grads."""
        out = self.apply_tensors([g for _, g in params_grads])
        return [(p, c) for (p, _), c in zip(params_grads, out)]

    def apply_tensors(self, grads: List[Optional[torch.Tensor]]
                      ) -> List[Optional[torch.Tensor]]:
        """The tree form: new gradients, ``None`` where there was none."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each element into ``[min, max]`` (``min`` defaults to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def apply_tensors(self, grads):
        return [None if g is None else torch.clamp(g, self.min, self.max)
                for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each tensor scaled to a 2-norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply_tensors(self, grads):
        live = [g for g in grads if g is not None]
        if not live:
            return list(grads)
        norms = torch.stack(_norms(live))
        scales = _div(self.clip_norm, norms.clamp(min=1e-12)).clamp(max=1.0)
        it = iter(_scale(live, scales.unbind(0)))
        return [None if g is None else next(it) for g in grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """All tensors scaled together to a global 2-norm of at most
    ``clip_norm``.  In the eager form a parameter whose ``need_clip`` is
    false neither counts nor is scaled."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        # the global norm of the last clip, a 0-d f32 tensor written in
        # place (a captured step's replay rewrites it); None before one
        self.last_norm: Optional[torch.Tensor] = None

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The 2-norm of all of ``grads`` together, a 0-d f32 tensor."""
        return torch.linalg.vector_norm(torch.stack(_norms(grads)))

    def _scale_of(self, norm: torch.Tensor) -> torch.Tensor:
        return _div(self.clip_norm, norm.clamp(min=self.clip_norm))

    def clipped(self, grads: List[torch.Tensor],
                norm: torch.Tensor) -> List[torch.Tensor]:
        """``grads`` scaled for their global ``norm``, which is kept in
        :attr:`last_norm`."""
        if self.last_norm is None or self.last_norm.device != norm.device:
            self.last_norm = torch.zeros((), dtype=torch.float32,
                                         device=norm.device)
        self.last_norm.copy_(norm)
        return _scale(grads, self._scale_of(norm))

    def apply_tensors(self, grads):
        live = [g for g in grads if g is not None]
        if not live:
            return list(grads)
        it = iter(self.clipped(live, self.global_norm(live)))
        return [None if g is None else next(it) for g in grads]

    def __call__(self, params_grads):
        mask = [g is not None and getattr(p, "need_clip", True)
                for p, g in params_grads]
        live = [g for (_, g), m in zip(params_grads, mask) if m]
        if not live:
            return list(params_grads)
        it = iter(self.clipped(live, self.global_norm(live)))
        return [(p, next(it) if m else g)
                for (p, g), m in zip(params_grads, mask)]


def _with_grads(parameters):
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    return [p for p in parameters if p.grad is not None]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` in place by ``min(max_norm / (total +
    1e-6), 1)``, ``total`` the ``norm_type``-norm of all of them
    together (f32 sums; the max of ``|g|`` for ``inf``); returns
    ``total``, a 0-d tensor.  ``error_if_nonfinite`` reads it on the
    host and raises when it is not finite."""
    params = _with_grads(parameters)
    if not params:
        return torch.zeros(())
    grads = [p.grad for p in params]
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([
            g.float().abs().pow(norm_type).sum() for g in grads
        ]).sum().pow(1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("non-finite gradient norm")
    scale = _div(float(max_norm), total.float() + 1e-6).clamp(max=1.0)
    for g, s in zip(grads, _scale(grads, scale)):
        g.copy_(s)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every ``p.grad`` into ``[-clip_value, clip_value]``, in
    place."""
    for p in _with_grads(parameters):
        p.grad.clamp_(-clip_value, clip_value)
