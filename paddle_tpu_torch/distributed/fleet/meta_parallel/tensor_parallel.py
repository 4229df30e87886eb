"""``TensorParallel`` (the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py``).

The JAX package places a model's annotated parameters on its mesh.  The
port's ranks each hold their slices, so the wrapper's work is the
reference's: when it is made, every parameter that is not split over
the model-parallel group (not ``is_shard``: LayerNorms, position
embeddings, row-parallel biases) is broadcast from the group's first
rank, so all mp ranks start from the same replicated values.  Names,
``state_dict`` and ``parameters`` are the model's own."""
from __future__ import annotations

import torch

from ... import collective as _c
from .parallel_layers.mp_layers import is_shard

__all__ = ["TensorParallel"]


class TensorParallel(torch.nn.Module):
    def __init__(self, layers: torch.nn.Module, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        if hcg is not None:
            group = hcg.get_model_parallel_group()
            src = hcg.get_model_parallel_group_src_rank()
            with torch.no_grad():
                for p in layers.parameters():
                    if not is_shard(p):
                        _c.broadcast(p.data, src=src, group=group)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict

    def parameters(self, recurse: bool = True):
        return self._layers.parameters(recurse)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)
