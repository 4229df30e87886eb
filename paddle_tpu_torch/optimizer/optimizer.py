"""Optimizer base and the SGD family (the counterpart of
``paddle_tpu/optimizer/optimizer.py``: ``init_state_tree``,
``apply_gradients_tree``, ``SGD``, ``Momentum``, ``Adagrad``,
``Adadelta``, ``RMSProp``).

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

The learning rate lives on the device too: a 0-d f32 tensor
(:attr:`Optimizer.lr_tensor`, made by :meth:`Optimizer.init_state_tree`
on the parameters' device), the only learning rate the update reads.
:meth:`Optimizer.write_lr` fills it with :meth:`Optimizer.get_lr` (the
scheduler's current value, or the float) by an asynchronous fill, and
``TrainStep`` calls it before each step, outside the captured graph: the
counterpart of the JAX capture feeding ``get_lr()`` to each replay.
The step count and everything derived from it (bias corrections, NAdam's
momentum schedule, RAdam's rectification, Lamb's trust ratio) stay on the
device, so the update reads no host value that changes from step to step
and a CUDA graph of it replays correctly (:mod:`...jit.capture`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..regularizer import L1Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta", "RMSProp"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)


def descend(params, upd, lr) -> None:
    """``p += u * (-lr)`` for each pair in place, one multiply-add an
    element: the rounding of the update with a float learning rate
    (``add_(u, alpha=-lr)``), from the 0-d ``lr`` on the device (or one
    0-d tensor a pair)."""
    scales = list(torch.neg(lr).unbind(0)) if lr.dim() else \
        [torch.neg(lr)] * len(upd)
    torch._foreach_addcmul_(params, upd, scales)


class Optimizer:
    """A learning rate (a float or an :class:`~.lr.LRScheduler`), weight
    decay (a float: L2; ``L2Decay(c)`` or ``L1Decay(c)``) added to the
    gradient, or decoupled (``_decoupled_wd``, AdamW), and an optional
    ``grad_clip`` run over the whole tree first.

    ``parameters`` (the JAX package's keyword) is kept as
    ``_parameter_list`` and not read by the tree update, which updates
    the parameters it is given.  The moments and masters live in a
    training step's state tree, never in the optimizer, so
    :meth:`state_dict` holds the JAX package's ``global_step`` and
    ``LR_Scheduler`` keys only; the sharded save carries the tree."""

    _state_slots: tuple = ()
    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision: bool = True):
        self._name = name
        self._learning_rate = learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        if isinstance(weight_decay, (int, float)):
            self._weight_decay, self._wd_mode = float(weight_decay), "l2"
        elif weight_decay is not None:
            self._weight_decay = float(getattr(
                weight_decay, "_coeff", getattr(weight_decay, "coeff", 0.0)))
            self._wd_mode = "l1" if isinstance(weight_decay, L1Decay) \
                else "l2"
        else:
            self._weight_decay, self._wd_mode = 0.0, "l2"
        self._lr_tensor: Optional[torch.Tensor] = None
        self._parameter_list = [] if parameters is None else list(parameters)
        self._global_step = 0

    # -- the learning rate ---------------------------------------------------
    def get_lr(self) -> float:
        """The current learning rate, on the host."""
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value) -> None:
        """A new constant learning rate (raises under a scheduler); the
        tensor on the device follows at once."""
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is a scheduler")
        self._learning_rate = float(value)
        self.write_lr()

    def set_lr_scheduler(self, scheduler) -> None:
        self._learning_rate = scheduler
        self.write_lr()

    @property
    def _learning_rate_scheduler(self):
        return self._learning_rate if isinstance(self._learning_rate,
                                                 LRScheduler) else None

    @property
    def lr_tensor(self) -> Optional[torch.Tensor]:
        """The learning rate the update reads: a 0-d f32 tensor on the
        parameters' device (None before :meth:`init_state_tree`)."""
        return self._lr_tensor

    def write_lr(self) -> None:
        """Fill :attr:`lr_tensor` with :meth:`get_lr`: an asynchronous
        fill on the current stream, nothing read back."""
        if self._lr_tensor is not None:
            self._lr_tensor.fill_(self.get_lr())

    def _lr_on(self, device) -> torch.Tensor:
        if self._lr_tensor is None or self._lr_tensor.device != device:
            self._lr_tensor = torch.full((), self.get_lr(),
                                         dtype=torch.float32, device=device)
        return self._lr_tensor

    # -- checkpoints ---------------------------------------------------------
    def state_dict(self) -> dict:
        """``global_step``, and ``LR_Scheduler`` under a schedule: what
        ``hapi.Model.save`` writes to ``.pdopt``, as the JAX package's
        hapi does."""
        out = {"global_step": self._global_step}
        if self._learning_rate_scheduler is not None:
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state) -> None:
        """Restore :meth:`state_dict`'s keys.  Any other key (a moment or
        master that the JAX package's eager ``step()`` saved) raises
        ``ValueError``: the port has nowhere to put it, and resuming from
        zero moments would pass for a resume.  A training step's state
        resumes from the sharded save (``Model.save(sharded=True)``,
        ``train.save_checkpoint``)."""
        state = dict(state)
        sched = state.pop("LR_Scheduler", None)
        self._global_step = int(state.pop("global_step", 0))
        if state:
            raise ValueError(
                f"optimizer state {sorted(state)[:4]} cannot be restored "
                "into the port's optimizer, whose moments and masters live "
                "in the training step's state tree; resume from a sharded "
                "save (Model.save(sharded=True)) or load with "
                "reset_optimizer=True")
        if sched is not None and self._learning_rate_scheduler is not None:
            self._learning_rate.set_state_dict(sched)

    # -- the state tree ------------------------------------------------------
    def _init_slot(self, slot: str, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(
            p, dtype=torch.float32 if p.dtype in _LOW_PRECISION else p.dtype)

    def init_state_tree(self, params: Dict[str, torch.Tensor]) -> dict:
        """Slots (zero, or the optimizer's initial value), f32 masters for
        low-precision parameters, the step count 0, and the learning-rate
        tensor on the parameters' device."""
        slots = {s: {} for s in self._state_slots}
        master = {}
        device = next(iter(params.values())).device if params else None
        for name, p in params.items():
            for s in self._state_slots:
                slots[s][name] = self._init_slot(s, p)
            if self._multi_precision and p.dtype in _LOW_PRECISION:
                master[name] = p.detach().float()
        if device is not None:
            self._lr_on(device)
        return {"slots": slots, "master": master,
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def apply_gradients_tree(self, params: Dict[str, torch.Tensor],
                             grads: Dict[str, Optional[torch.Tensor]],
                             state: dict, lr=None) -> dict:
        """One update of every parameter with a gradient, in place (the
        step count too); returns ``state``.  ``lr``: a float or a 0-d
        tensor; by default :attr:`lr_tensor`, as :meth:`write_lr` left
        it.  The clip runs over the whole tree, then the decay, then the
        update; the gradients passed in are not modified."""
        step = state["step"]
        lr = self._lr_arg(lr, step.device)
        step.add_(1)
        master = state["master"]
        names = [n for n in params if grads.get(n) is not None]
        compute = [master.get(n, params[n]) for n in names]
        g = [grads[n] for n in names]
        if self._grad_clip is not None:
            g = self._grad_clip.apply_tensors(g)
        g = [x.to(c.dtype) for x, c in zip(g, compute)]
        wd = self._weight_decay
        if wd and not self._decoupled_wd:
            decay = (torch._foreach_sign(compute) if self._wd_mode == "l1"
                     else compute)
            g = torch._foreach_add(g, decay, alpha=wd)
        slots = [[state["slots"][s][n] for n in names]
                 for s in self._state_slots]
        if wd and self._decoupled_wd:
            # p - lr * update - lr * wd * p, the decay on the old value;
            # the factor 1 - lr * wd in f64, rounded once
            torch._foreach_mul_(compute, (1.0 - lr.double() * wd).float())
        self._update(compute, g, slots, lr, step)
        low = [n for n in names if n in master]
        if low:
            torch._foreach_copy_([params[n] for n in low],
                                 [master[n] for n in low])
        return state

    def _lr_arg(self, lr, device) -> torch.Tensor:
        if lr is None:
            return self._lr_on(device)
        if isinstance(lr, torch.Tensor):
            return lr.to(device=device, dtype=torch.float32)
        return torch.full((), float(lr), dtype=torch.float32, device=device)

    def _update(self, params, grads, slots, lr: torch.Tensor,
                step: torch.Tensor) -> None:
        """``params -= lr * update(grads, slots)`` in place, slots too;
        ``lr`` a 0-d f32 tensor, ``step`` the 0-d int32 count after this
        update.  ``grads`` are read, never written."""
        raise NotImplementedError


class SGD(Optimizer):
    """``p - lr * g``."""

    _state_slots = ()

    def _update(self, params, grads, slots, lr, step):
        descend(params, grads, lr)


class Momentum(Optimizer):
    """Heavy-ball momentum, or Nesterov's (``use_nesterov``)."""

    _state_slots = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum, self._nesterov = momentum, use_nesterov

    def _update(self, params, grads, slots, lr, step):
        (v,) = slots
        mu = self._momentum
        torch._foreach_mul_(v, mu)
        torch._foreach_add_(v, grads)
        descend(params, torch._foreach_add(grads, v, alpha=mu)
                if self._nesterov else v, lr)


class Adagrad(Optimizer):
    """Adagrad; its accumulator starts at ``initial_accumulator_value``."""

    _state_slots = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._initial_acc = initial_accumulator_value

    def _init_slot(self, slot, p):
        return super()._init_slot(slot, p) + self._initial_acc

    def _update(self, params, grads, slots, lr, step):
        (m,) = slots
        torch._foreach_addcmul_(m, grads, grads)
        denom = torch._foreach_sqrt(m)
        torch._foreach_add_(denom, self._epsilon)
        descend(params, torch._foreach_div(grads, denom), lr)


class Adadelta(Optimizer):
    _state_slots = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon, self._rho = epsilon, rho

    def _update(self, params, grads, slots, lr, step):
        sg, su = slots
        eps, rho = self._epsilon, self._rho
        torch._foreach_mul_(sg, rho)
        torch._foreach_addcmul_(sg, grads, grads, value=1 - rho)
        upd = torch._foreach_add(su, eps)
        torch._foreach_sqrt_(upd)
        den = torch._foreach_add(sg, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, grads)
        torch._foreach_mul_(su, rho)
        torch._foreach_addcmul_(su, upd, upd, value=1 - rho)
        descend(params, upd, lr)


class RMSProp(Optimizer):
    """RMSProp, ``centered`` on the mean gradient, with ``momentum`` on
    the scaled step."""

    _state_slots = ("mean_square", "mean_grad", "momentum_acc")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update(self, params, grads, slots, lr, step):
        ms, mg, mom = slots
        rho = self._rho
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, grads, grads, value=1 - rho)
        if self._centered:
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, grads, alpha=1 - rho)
            denom = torch._foreach_addcmul(ms, mg, mg, value=-1)
            torch._foreach_add_(denom, self._epsilon)
        else:
            denom = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(denom)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_addcmul_(mom, torch._foreach_div(grads, denom),
                                [lr] * len(mom))
        torch._foreach_sub_(params, mom)
