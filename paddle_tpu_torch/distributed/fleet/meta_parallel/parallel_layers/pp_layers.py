"""Pipeline layers (the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/pp_layers.py``):
``LayerDesc``, ``SharedLayerDesc`` and ``PipelineLayer``.

The JAX package builds every stage in its one controller; the port runs
one process a stage, as the reference does, so a :class:`PipelineLayer`
built after ``fleet.init`` with a pipe degree above 1 builds only the
layers of this rank's stages (or with ``stage_id``; without either it
builds them all and runs them in order, the JAX package's oracle).
The segmentation is the JAX class's (``segment_parts``,
``get_stage_from_index``): "uniform" by item count, or "layer:Cls" by
the count of that class.  With ``num_virtual_pipeline_stages = v`` the
items are cut into ``pp * v`` virtual stages and rank ``s`` owns
``{g * pp + s}`` (:meth:`PipelineLayer.virtual_stages_of`).  Parameters
keep the JAX names, ``_layer_list.<j>.*`` with ``j`` the index among
the layer items.  A ``SharedLayerDesc`` (a tied embedding) is built on
each stage that uses it, named by its first use;
:meth:`PipelineLayer.shared_weights` gives the group of those stages,
over which a step sums its gradient (``...sharding.ZeroPlan.step``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .... import collective as _c

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    """A layer's constructor and arguments, built where it is owned."""

    def __init__(self, layer_func, *inputs, **kwargs):
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, torch.nn.Module)):
            raise TypeError("LayerDesc expects a torch.nn.Module subclass")
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer used at several places (``key`` names it): one copy a
    stage that uses it, its gradients summed over those stages;
    ``forward_func(layer, x)`` replaces ``layer(x)`` where given."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _is_layer_item(d) -> bool:
    return isinstance(d, (LayerDesc, torch.nn.Module))


class PipelineLayer(torch.nn.Module):
    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None,
                 stage_id: Optional[int] = None):
        super().__init__()
        from ...fleet import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        if num_stages is None:
            num_stages = (topology.get_dim("pipe") if topology is not None
                          else hcg.get_pipe_parallel_world_size()
                          if hcg is not None else 1)
        self._num_stages = max(int(num_stages), 1)
        self._num_virtual = max(int(num_virtual_pipeline_stages or 1), 1)
        self._loss_fn = loss_fn
        self._topo = topology
        self._recompute_interval = recompute_interval
        if stage_id is None and hcg is not None and \
                hcg.get_pipe_parallel_world_size() == self._num_stages > 1:
            stage_id = hcg.get_stage_id()
        self._stage_id = stage_id
        self.descs = list(layers)
        self._segment(seg_method)
        # the layer index of each item (None for a plain callable), and a
        # shared layer's index: that of its first use
        self._item_index: List[Optional[int]] = []
        first_use: Dict[str, int] = {}
        j = 0
        for d in self.descs:
            if not _is_layer_item(d):
                self._item_index.append(None)
                continue
            if isinstance(d, SharedLayerDesc):
                self._item_index.append(first_use.setdefault(d.layer_name, j))
            else:
                self._item_index.append(j)
            j += 1
        owned = set(range(len(self.descs))) if stage_id is None else {
            i for k in self.virtual_stages_of(stage_id)
            for i in range(self.segment_parts[k], self.segment_parts[k + 1])}
        self._layer_list = torch.nn.ModuleDict()
        shared: Dict[str, torch.nn.Module] = {}
        self._items: Dict[int, tuple] = {}
        for i, d in enumerate(self.descs):
            if i not in owned:
                continue
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in shared:
                    shared[d.layer_name] = d.build_layer()
                    self._layer_list[str(self._item_index[i])] = \
                        shared[d.layer_name]
                self._items[i] = (shared[d.layer_name], d.forward_func)
            elif isinstance(d, LayerDesc):
                layer = d.build_layer()
                self._layer_list[str(self._item_index[i])] = layer
                self._items[i] = (layer, None)
            elif isinstance(d, torch.nn.Module):
                self._layer_list[str(self._item_index[i])] = d
                self._items[i] = (d, None)
            elif callable(d):
                self._items[i] = (d, None)
            else:
                raise TypeError(f"cannot build pipeline item {d!r}")
        self.run_function = [self._items[i][0] for i in sorted(self._items)]
        self._shared_groups, self._shared_first = \
            self._make_shared_groups(hcg)

    # -- segmentation (the JAX class's) --------------------------------------
    def _segment(self, seg_method):
        n = len(self.descs)
        parts = self._num_stages * self._num_virtual
        if seg_method.startswith("layer:"):
            cls_name = seg_method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self.descs)
                     if (d.layer_func.__name__ if isinstance(d, LayerDesc)
                         else type(d).__name__) == cls_name]
            if not marks:
                raise ValueError(f"no layer of class {cls_name} found")
            per = math.ceil(len(marks) / parts)
            bounds = [0]
            for s in range(1, parts):
                k = s * per
                bounds.append(marks[k] if k < len(marks) else n)
            bounds.append(n)
        else:
            per = math.ceil(n / parts)
            bounds = [min(i * per, n) for i in range(parts)] + [n]
        self.segment_parts = bounds

    @property
    def num_stages(self) -> int:
        return self._num_stages

    @property
    def num_virtual_stages(self) -> int:
        return self._num_virtual

    def virtual_stages_of(self, stage: int) -> List[int]:
        """The virtual stages rank ``stage`` owns: ``{g * pp + stage}``."""
        return [g * self._num_stages + stage
                for g in range(self._num_virtual)]

    def get_stage_from_index(self, layer_idx: int) -> int:
        """The stage (rank) that owns item ``layer_idx``."""
        parts = self._num_stages * self._num_virtual
        for k in range(parts):
            if self.segment_parts[k] <= layer_idx < \
                    self.segment_parts[k + 1]:
                return k % self._num_stages
        return self._num_stages - 1

    def stage_layers(self, stage_id: int) -> list:
        """The built items of segment ``stage_id``."""
        lo, hi = self.segment_parts[stage_id], \
            self.segment_parts[stage_id + 1]
        return [self._items[i] for i in range(lo, hi) if i in self._items]

    # -- running -------------------------------------------------------------
    def _run(self, lo, hi, x):
        from ...recompute import recompute
        for i in range(lo, hi):
            layer, fwd = self._items[i]
            call = (lambda v, _l=layer, _f=fwd: _f(_l, v)) if fwd is not None \
                else layer
            if self._recompute_interval and \
                    i % self._recompute_interval == 0 and \
                    isinstance(layer, torch.nn.Module):
                x = recompute(lambda v, generator=None, _c=call: _c(v), x)
            else:
                x = call(x)
        return x

    def forward_chunk(self, k: int, x):
        """Virtual stage ``k``'s items on ``x`` (they must be built)."""
        return self._run(self.segment_parts[k], self.segment_parts[k + 1], x)

    def forward(self, x):
        """Every item in order (a layer built whole, or one stage)."""
        missing = [i for i in range(len(self.descs)) if i not in self._items]
        if missing:
            raise RuntimeError(
                f"this PipelineLayer holds stage {self._stage_id} only: run "
                f"it through PipelineParallel.train_batch")
        return self._run(0, len(self.descs), x)

    # -- shared layers -------------------------------------------------------
    def _make_shared_groups(self, hcg):
        """({key: group of the pipe ranks whose stages use the shared
        layer}, {key: the first of those stages}), the groups made on
        every rank in the same order (``new_group``)."""
        if hcg is None or hcg.get_pipe_parallel_world_size() <= 1:
            return {}, {}
        stages: Dict[str, set] = {}
        for i, d in enumerate(self.descs):
            if isinstance(d, SharedLayerDesc):
                stages.setdefault(d.layer_name, set()).add(
                    self.get_stage_from_index(i))
        groups, first = {}, {}
        me = hcg.get_global_rank()
        for key in sorted(stages):
            if len(stages[key]) < 2:
                continue
            first[key] = min(stages[key])
            for ranks in hcg.topology().get_comm_list("pipe"):
                members = [ranks[s] for s in sorted(stages[key])]
                g = _c.new_group(members)
                if me in members:
                    groups[key] = g
        return groups, first

    def shared_weights(self) -> Dict[str, tuple]:
        """{name: (group, counted)} for each parameter on this rank of a
        shared layer used on several stages: ``group`` the pipe ranks of
        those stages, ``counted`` whether this is the first of them (the
        stage whose copy the clip's norm counts)."""
        out = {}
        for i, d in enumerate(self.descs):
            if not isinstance(d, SharedLayerDesc) or i not in self._items \
                    or d.layer_name not in self._shared_groups:
                continue
            key = d.layer_name
            j = self._item_index[i]
            for n, _ in self._layer_list[str(j)].named_parameters():
                out[f"_layer_list.{j}.{n}"] = (
                    self._shared_groups[key],
                    self._stage_id == self._shared_first[key])
        return out
