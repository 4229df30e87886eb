"""``HybridParallelOptimizer`` and ``HybridParallelClipGrad`` (the
counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/hybrid_parallel_optimizer.py``).

The JAX package's clip only delegates: on its one logical mesh every
parameter is whole, so the inner ``ClipGradByGlobalNorm`` already takes
the global norm.  In the port each rank holds its slice of the
tensor-parallel parameters, so the global norm is the reference's
(``HybridParallelClipGrad``): the squares of the mp-sharded gradients
(:func:`is_shard`) summed and all-reduced over the model-parallel group,
plus those of the replicated gradients, counted once.  The gradients
are already averaged over data parallelism, so no reduce over dp is
needed.  The norm is kept in the inner clip's ``last_norm`` (also
:attr:`HybridParallelClipGrad.last_norm`), written in place on the
device, so a captured step's replay updates it.  A per-tensor norm clip
over sharded parameters is not ported (it raises); a clip by value needs
no reduce.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ....nn.clip import ClipGradByGlobalNorm, ClipGradByValue, _norms
from ... import collective as _c
from ..meta_parallel.parallel_layers.mp_layers import is_shard

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad"]


class HybridParallelClipGrad:
    """``clip`` over sharded parameters.  ``distributed``: one flag per
    gradient of the next :meth:`apply_tensors` call, set by
    :class:`HybridParallelOptimizer` from the parameters."""

    def __init__(self, clip, hcg=None):
        self._clip = clip
        self._hcg = hcg
        self.distributed: Optional[List[bool]] = None

    def _mp_group(self):
        return None if self._hcg is None else \
            self._hcg.get_model_parallel_group()

    @property
    def last_norm(self) -> Optional[torch.Tensor]:
        """The global norm of the last clip (a global-norm clip's)."""
        return getattr(self._clip, "last_norm", None)

    def global_norm(self, grads: List[torch.Tensor],
                    flags: List[bool]) -> torch.Tensor:
        """The 2-norm of the whole model's gradient, a 0-d f32 tensor
        (the same on every rank); without shards the inner clip's."""
        norms = _norms(grads)
        sharded = [n for n, d in zip(norms, flags) if d]
        whole = [n for n, d in zip(norms, flags) if not d]
        if not sharded:
            return torch.linalg.vector_norm(torch.stack(whole))
        sq = torch.stack(sharded).square().sum()
        group = self._mp_group()
        if group is not None:
            _c.all_reduce(sq, group=group)
        if whole:
            sq = sq + torch.stack(whole).square().sum()
        return sq.sqrt()

    def apply_tensors(self, grads):
        flags = self.distributed
        if flags is None or len(flags) != len(grads):
            raise RuntimeError("HybridParallelClipGrad needs the parameters' "
                               "flags: run it through HybridParallelOptimizer")
        self.distributed = None
        if not isinstance(self._clip, ClipGradByGlobalNorm):
            if any(flags) and not isinstance(self._clip, ClipGradByValue):
                raise NotImplementedError(
                    f"{type(self._clip).__name__} over tensor-parallel "
                    f"parameters is not ported (only ClipGradByGlobalNorm "
                    f"and ClipGradByValue)")
            return self._clip.apply_tensors(grads)
        live = [(g, d) for g, d in zip(grads, flags) if g is not None]
        if not live:
            return list(grads)
        gs = [g for g, _ in live]
        it = iter(self._clip.clipped(gs, self.global_norm(
            gs, [d for _, d in live])))
        return [None if g is None else next(it) for g in grads]

    def __call__(self, params_grads):
        """The eager form, ``[(param, grad)]``."""
        self.distributed = [is_shard(p) for p, _ in params_grads]
        out = self.apply_tensors([g for _, g in params_grads])
        return [(p, c) for (p, _), c in zip(params_grads, out)]


class HybridParallelOptimizer:
    """``optimizer`` for a hybrid-parallel model: its clip becomes a
    :class:`HybridParallelClipGrad`; everything else is the inner
    optimizer's."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        clip = optimizer._grad_clip
        if clip is not None and not isinstance(clip, HybridParallelClipGrad):
            optimizer._grad_clip = HybridParallelClipGrad(clip, hcg)

    def apply_gradients_tree(self, params, grads, state, lr=None):
        """The inner optimizer's tree update, the clip told which
        gradients are shards."""
        clip = self._inner_opt._grad_clip
        if isinstance(clip, HybridParallelClipGrad):
            clip.distributed = [is_shard(params[n]) for n in params
                                if grads.get(n) is not None]
        return self._inner_opt.apply_gradients_tree(params, grads, state,
                                                    lr=lr)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)
