"""``HybridParallelOptimizer`` and ``HybridParallelClipGrad`` (the
counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/hybrid_parallel_optimizer.py``).

The JAX package's clip only delegates: on its one logical mesh every
parameter is whole, so the inner ``ClipGradByGlobalNorm`` already takes
the global norm.  In the port each rank holds its slice of the
tensor-parallel parameters, so the global norm is the reference's
(``HybridParallelClipGrad``), over each gradient's kind, ``(mp_shard,
window, counted)``: the squares of the mp-sharded gradients
(:func:`is_shard`) summed over the model-parallel group, those of ZeRO
windows over the sharding group (both for a window of an mp slice),
each pipeline stage's total over the pipe group, and a gradient that is
not ``counted`` (the tied embedding's copy on the last stage) left out:
every element of the model counts once.  The gradients are already
averaged over the data ranks (``data x sep``), so no reduce over dp or
sep is needed: a sep rank holds every parameter whole, and summing over
sep would count each gradient once a sep rank; without
shards, windows or stages the norm is the inner clip's own.  The norm
is kept in the inner clip's ``last_norm`` (also
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
from ...sharding.group_sharded import is_window, zero_level
from ..meta_parallel.parallel_layers.mp_layers import is_shard

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad"]


class HybridParallelClipGrad:
    """``clip`` over sharded parameters.  ``kinds``: one ``(mp_shard,
    window, counted)`` a gradient of the next :meth:`apply_tensors` call,
    set by :class:`HybridParallelOptimizer`."""

    def __init__(self, clip, hcg=None):
        self._clip = clip
        self._hcg = hcg
        self.kinds: Optional[List[tuple]] = None

    @property
    def last_norm(self) -> Optional[torch.Tensor]:
        """The global norm of the last clip (a global-norm clip's)."""
        return getattr(self._clip, "last_norm", None)

    def _group(self, name):
        if self._hcg is None:
            return None
        g = getattr(self._hcg, f"get_{name}_parallel_group")()
        return g if g is not None and g.nranks > 1 else None

    def global_norm(self, grads: List[torch.Tensor],
                    kinds: List[tuple]) -> torch.Tensor:
        """The 2-norm of the whole model's gradient, a 0-d f32 tensor (the
        same on every rank; module docstring); without shards, windows or
        stages the inner clip's.  Every rank of a step makes the same
        collectives, whatever it holds."""
        norms = _norms(grads)
        sh, mp, pipe = (self._group("sharding"), self._group("model"),
                        self._group("pipe"))
        if pipe is None and not any(m or w or not c for m, w, c in kinds):
            return torch.linalg.vector_norm(torch.stack(norms))
        sq = torch.stack(norms).square()

        def part(mp_shard, window):
            sel = [i for i, (m, w, c) in enumerate(kinds)
                   if c and m == mp_shard and w == window]
            return sq[sel].sum() if sel else sq.new_zeros(())

        rep, mp_only, win, win_mp = (part(False, False), part(True, False),
                                     part(False, True), part(True, True))
        if sh is not None:
            both = torch.stack([win, win_mp])
            _c.all_reduce(both, group=sh)
            win, win_mp = both.unbind(0)
        if mp is not None:
            both = torch.stack([mp_only, win_mp])
            _c.all_reduce(both, group=mp)
            mp_only, win_mp = both.unbind(0)
        total = rep + mp_only + win + win_mp
        if pipe is not None:
            _c.all_reduce(total, group=pipe)
        return total.sqrt()

    def apply_tensors(self, grads):
        kinds, self.kinds = self.kinds, None
        if kinds is None or len(kinds) != len(grads):
            raise RuntimeError("HybridParallelClipGrad needs the parameters' "
                               "kinds: run it through HybridParallelOptimizer")
        sharded = any(m or w or not c for m, w, c in kinds)
        if not isinstance(self._clip, ClipGradByGlobalNorm):
            if (sharded or self._group("pipe") is not None) and \
                    not isinstance(self._clip, ClipGradByValue):
                raise NotImplementedError(
                    f"{type(self._clip).__name__} over sharded or pipelined "
                    f"parameters is not ported (only ClipGradByGlobalNorm "
                    f"and ClipGradByValue)")
            return self._clip.apply_tensors(grads)
        live = [(g, k) for g, k in zip(grads, kinds) if g is not None]
        if not live:
            return list(grads)
        gs = [g for g, _ in live]
        it = iter(self._clip.clipped(gs, self.global_norm(
            gs, [k for _, k in live])))
        return [None if g is None else next(it) for g in grads]

    def __call__(self, params_grads):
        """The eager form, ``[(param, grad)]``."""
        self.kinds = [_kind(p) for p, _ in params_grads]
        out = self.apply_tensors([g for _, g in params_grads])
        return [(p, c) for (p, _), c in zip(params_grads, out)]


def _kind(p) -> tuple:
    """A whole parameter's gradient kind: an mp slice or not, a stored
    stage-3 window or not, counted."""
    return is_shard(p), is_window(p), True


class HybridParallelOptimizer:
    """``optimizer`` for a hybrid-parallel model: its clip becomes a
    :class:`HybridParallelClipGrad`; everything else is the inner
    optimizer's.  A ZeRO level ``os`` or ``os_g`` on it (``strategy.
    sharding``, ``group_sharded_parallel``) shards the state only in an
    update that a ``...sharding.ZeroPlan`` drives (``ZeroPlan.step``,
    which passes ``kinds``); over a sharding group, a tree update of
    whole parameters without ``kinds`` raises instead of leaving the
    state whole."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        clip = optimizer._grad_clip
        if clip is not None and not isinstance(clip, HybridParallelClipGrad):
            optimizer._grad_clip = HybridParallelClipGrad(clip, hcg)

    def apply_gradients_tree(self, params, grads, state, lr=None,
                             kinds=None):
        """The inner optimizer's tree update, the clip told which
        gradients are shards (``kinds``: {name: (mp_shard, window,
        counted)} over ZeRO windows and pipeline stages; by default each
        parameter's own: an mp slice, a stored stage-3 window)."""
        level = zero_level(self)
        if kinds is None and level in ("os", "os_g") and \
                self._hcg is not None and \
                self._hcg.get_sharding_parallel_world_size() > 1:
            raise NotImplementedError(
                f"ZeRO level {level} shards the optimizer state in an update "
                f"that a ZeroPlan drives (ZeroPlan.step, as "
                f"train.build_train_step's step and PipelineParallel."
                f"train_batch run it); this update of whole parameters would "
                f"keep it whole")
        clip = self._inner_opt._grad_clip
        if isinstance(clip, HybridParallelClipGrad):
            clip.kinds = [kinds[n] if kinds is not None else _kind(params[n])
                          for n in params if grads.get(n) is not None]
        return self._inner_opt.apply_gradients_tree(params, grads, state,
                                                    lr=lr)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)
