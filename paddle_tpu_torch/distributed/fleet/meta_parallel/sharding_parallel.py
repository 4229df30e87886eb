"""``ShardingParallel`` and ``annotate_fsdp_specs`` (the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sharding_parallel.py``).

The JAX package annotates each large parameter with a spec over the
``sharding`` axis and lets its compiler store the shards.  The port
stores them: :func:`annotate_fsdp_specs` keeps each parameter of at
least ``min_size`` elements that has a window dimension as its window
(:func:`...sharding.shard_parameters`, stage 3), and
:class:`ShardingParallel` is ``fleet.distributed_model``'s wrapper in
``sharding_parallel`` mode and ``group_sharded_parallel``'s at
``p_g_os``: it does that, its forward gathers the windows outside the
model's blocks for the call (:func:`...sharding.gathered`), and at the
end of each backward pass it averages the other parameters' gradients
over dp x sharding (the windows' are reduce-scattered in the backward
already).  Each rank feeds its own rows of the global batch
(:func:`...sharding.local_batch`), and a tree update of the model's
parameters (``optimizer.apply_gradients_tree``, each window with its
window of the state) is then the global batch's update.
"""
from __future__ import annotations

import torch

from ...parallel import unwrap_model
from ...sharding.group_sharded import (MIN_SIZE, GradReducer, gathered,
                                       is_window, shard_parameters)

__all__ = ["ShardingParallel", "annotate_fsdp_specs"]


def annotate_fsdp_specs(layer: torch.nn.Module, axis: str = "sharding",
                        min_size: int = MIN_SIZE, hcg=None):
    """Store ``layer``'s parameters of at least ``min_size`` elements as
    their windows over fleet's sharding group (``hcg``, by default
    fleet's).  Returns ``layer``."""
    if axis != "sharding":
        raise ValueError(f"only the sharding axis is ported, got {axis!r}")
    if hcg is None:
        from ..fleet import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_sharding_parallel_world_size() <= 1:
        return layer
    shard_parameters(layer, hcg, min_size=min_size)
    return layer


class ShardingParallel(torch.nn.Module):
    """``layers`` with its large parameters stored as windows and its
    gradients averaged over the data ranks (module docstring)."""

    def __init__(self, layers: torch.nn.Module, hcg=None, strategy=None,
                 min_size: int = MIN_SIZE):
        super().__init__()
        if hcg is None:
            from ..fleet import get_hybrid_communicate_group
            hcg = get_hybrid_communicate_group()
        if hcg is None:
            raise RuntimeError("call fleet.init() first")
        self._layers = layers
        self._hcg = hcg
        inner = unwrap_model(layers)
        if not any(is_window(p) for p in inner.parameters()):
            annotate_fsdp_specs(inner, min_size=min_size, hcg=hcg)
        rest = {n: p for n, p in inner.named_parameters()
                if p.requires_grad and not is_window(p)}
        self._reducer = GradReducer(rest, hcg)
        self._pending = False
        if self._reducer.world > 1:
            for p in rest.values():
                p.register_post_accumulate_grad_hook(self._hook)

    def _hook(self, p):
        if not self._pending:
            self._pending = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)

    @torch.no_grad()
    def _finish(self) -> None:
        """End of the backward pass: the whole parameters' gradients
        averaged over dp x sharding, in buckets."""
        params = self._reducer.params
        out = self._reducer.reduce({n: p.grad for n, p in params.items()})
        for n, p in params.items():
            p.grad = out[n]
        self._pending = False

    def forward(self, *inputs, **kwargs):
        with gathered(unwrap_model(self._layers)):
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
