"""Optimizers (the counterpart of ``paddle_tpu/optimizer``): the tree
update of :class:`Optimizer` for every optimizer but ``LBFGS``, whose
closure-driven ``step`` runs eagerly; the learning-rate schedules in
:mod:`.lr`."""
from . import lr
from .adam import Adam, AdamW, Adamax, Lamb, NAdam, RAdam
from .lbfgs import LBFGS
from .optimizer import (SGD, Adadelta, Adagrad, Momentum, Optimizer,
                        RMSProp)

__all__ = ["Adadelta", "Adagrad", "Adam", "AdamW", "Adamax", "LBFGS", "Lamb",
           "Momentum", "NAdam", "Optimizer", "RAdam", "RMSProp", "SGD", "lr"]
