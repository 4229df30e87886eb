"""Optimizer base (the counterpart of ``init_state_tree`` and
``apply_gradients_tree`` in ``paddle_tpu/optimizer/optimizer.py``).

The state is a tree of tensors keyed by parameter name:
``{"slots": {slot: {name: t}}, "master": {name: t}, "step": t}``, the
step count a 0-d int32 tensor on the parameters' device, as the JAX
tree holds it.
With ``multi_precision`` a bf16 or fp16 parameter gets an f32 master
copy; the update runs on the master and the parameter receives it cast
back.  Slots are f32 for low-precision parameters.

The JAX package returns a new tree from a pure function; the port
updates parameters, masters and slots in place (no second copy of the
state on the card), with PyTorch's multi-tensor ``_foreach`` operations,
a few launches for the whole tree as the JAX package's one program.
The step count and everything derived from it (Adam's bias
corrections) stay on the device, so the update reads no host value that
changes from step to step and a CUDA graph of it replays correctly
(:mod:`...jit.capture`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["Optimizer"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)


class Optimizer:
    """A constant learning rate and a weight-decay coefficient: L2 added
    to the gradient, or decoupled (``_decoupled_wd``, AdamW)."""

    _state_slots: tuple = ()
    _decoupled_wd = False

    def __init__(self, learning_rate: float = 0.001,
                 weight_decay: Optional[float] = None,
                 multi_precision: bool = True):
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        self._multi_precision = multi_precision

    def init_state_tree(self, params: Dict[str, torch.Tensor]) -> dict:
        """Zero slots (and f32 masters for low-precision parameters)."""
        slots = {s: {} for s in self._state_slots}
        master = {}
        device = next(iter(params.values())).device if params else None
        for name, p in params.items():
            low = p.dtype in _LOW_PRECISION
            for s in self._state_slots:
                slots[s][name] = torch.zeros_like(
                    p, dtype=torch.float32 if low else p.dtype)
            if self._multi_precision and low:
                master[name] = p.detach().float()
        return {"slots": slots, "master": master,
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def apply_gradients_tree(self, params: Dict[str, torch.Tensor],
                             grads: Dict[str, Optional[torch.Tensor]],
                             state: dict) -> dict:
        """One update of every parameter with a gradient, in place (the
        step count too); returns ``state``."""
        lr = self._learning_rate
        step = state["step"]
        step.add_(1)
        master = state["master"]
        names = [n for n in params if grads.get(n) is not None]
        compute = [master.get(n, params[n]) for n in names]
        g = [grads[n].to(c.dtype) for n, c in zip(names, compute)]
        wd = self._weight_decay
        if wd and not self._decoupled_wd:
            g = torch._foreach_add(g, compute, alpha=wd)
        slots = [[state["slots"][s][n] for n in names]
                 for s in self._state_slots]
        if wd and self._decoupled_wd:
            # p - lr * update - lr * wd * p, the decay on the old value
            torch._foreach_mul_(compute, 1.0 - lr * wd)
        self._update(compute, g, slots, lr, step)
        low = [n for n in names if n in master]
        if low:
            torch._foreach_copy_([params[n] for n in low],
                                 [master[n] for n in low])
        return state

    def _update(self, params, grads, slots, lr: float,
                step: torch.Tensor) -> None:
        """``params -= lr * update(grads, slots)`` in place, slots too;
        ``step`` is the 0-d int32 count after this update."""
        raise NotImplementedError
