"""Gate networks (the counterpart of
``paddle_tpu/incubate/distributed/models/moe/gate.py``): a gate maps
tokens (T, D) to routing logits (T, E); the routing itself (top-k,
capacity, the auxiliary loss) is :mod:`.functional`'s, chosen by
``top_k``."""
from __future__ import annotations

import torch

from .....nn import Linear
from .....nn.initializer import XavierNormal

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]


class BaseGate(torch.nn.Module):
    def __init__(self, num_expert, world_size=1):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.loss = None

    def forward(self, x):
        raise NotImplementedError

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss


class NaiveGate(BaseGate):
    """A linear gate, top-k chosen by the layer, no noise.  ``generator``
    draws its weight (the port's layers draw from an explicit
    generator)."""

    top_k = 2

    def __init__(self, d_model, num_expert, world_size=1, topk=2, *,
                 generator):
        super().__init__(num_expert, world_size)
        self.gate = Linear(d_model, self.tot_expert, XavierNormal(),
                           generator=generator)
        self.top_k = topk

    def forward(self, inp):
        return self.gate(inp)


class GShardGate(NaiveGate):
    """top-2 with capacity and the load-balancing loss."""

    def __init__(self, d_model, num_expert, world_size=1,
                 capacity=(1.2, 2.4), group=None, *, generator):
        super().__init__(d_model, num_expert, world_size, topk=2,
                         generator=generator)
        self.capacity_factor = capacity[0] if isinstance(
            capacity, (tuple, list)) else capacity


class SwitchGate(NaiveGate):
    """top-1 Switch-transformer gate."""

    def __init__(self, d_model, num_expert, world_size=1,
                 capacity=(1.2, 2.4), group=None, *, generator):
        super().__init__(d_model, num_expert, world_size, topk=1,
                         generator=generator)
        self.capacity_factor = capacity[0] if isinstance(
            capacity, (tuple, list)) else capacity
