"""Hybrid-parallel topology (the counterpart of
``paddle_tpu/distributed/topology.py``).

:class:`CommunicateTopology` is the reference's rank arithmetic over the
axes ``data, pipe, sharding, sep, model`` (row-major, ``model``
innermost), copied.  :class:`HybridCommunicateGroup` makes one
:class:`..collective.Group` for each axis's rank lists with
:func:`..collective.new_group`, on every rank and in the same order (as
``torch.distributed.new_group`` requires), keeps the ones this rank
belongs to, and sets the global :mod:`..mesh` to the topology's grid.
With a sep degree above 1 it also makes the groups over ``data x sep``
(one for each combination of the other axes): the ranks that hold the
same parameters and different tokens, over which gradients and the loss
are averaged (:meth:`HybridCommunicateGroup.get_dp_sep_parallel_group`,
the data-parallel group itself at sep 1).
"""
from __future__ import annotations

import itertools

import numpy as np

from . import mesh as _mesh_mod
from .collective import Group, new_group
from .env import get_rank

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "ParallelMode"]


class ParallelMode:
    """Paddle's parallel-mode enum."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class CommunicateTopology:
    """Rank arithmetic over the hybrid axes: rank ``r`` is the row-major
    index of its coordinates in ``dims``."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world_size = int(np.prod(self._dims))
        ranges = [range(d) for d in self._dims]
        all_coords = list(itertools.product(*ranges))
        self._coord2rank = {c: i for i, c in enumerate(all_coords)}
        self._rank2coord = {i: c for c, i in self._coord2rank.items()}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **args):
        coord = tuple(args[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        """All ranks whose coordinate on ``axis_name`` is ``index``."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name):
        """The rank lists that communicate along ``axis_name``: one for
        each combination of the other axes."""
        axis = self._parallel_names.index(axis_name)
        other_ranges = [range(d) for i, d in enumerate(self._dims)
                        if i != axis]
        out = []
        for other in itertools.product(*other_ranges):
            group = []
            for v in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, v)
                group.append(self._coord2rank[tuple(coord)])
            out.append(group)
        return out

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self.get_coord(global_rank))
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return self._coord2rank[tuple(coord)]


# the reference's group names -> the mesh's axis names
_NAME2AXIS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
              "sep": "sep", "model": "mp"}


class HybridCommunicateGroup:
    """This rank's place in ``topology`` and one group per axis."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.global_rank = get_rank()
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep") \
            if "sep" in topology.get_hybrid_group_names() else 1
        self._mp_degree = topology.get_dim("model")
        self.nranks = topology.world_size()
        names = topology.get_hybrid_group_names()
        self.mesh = _mesh_mod.init_mesh(
            {_NAME2AXIS[n]: topology.get_dim(n) for n in names}, self.nranks)

        rank = self.global_rank
        self._coord = dict(zip(names, topology.get_coord(rank % self.nranks)))
        self._groups = {}
        for name in names:
            for ranks in topology.get_comm_list(name):
                g = new_group(ranks)
                if rank in ranks:
                    self._groups[name] = g
        self._dp_sep = self._groups.get("data")
        if self._sep_degree > 1:
            for ranks in self._dp_sep_lists():
                g = new_group(ranks)
                if rank in ranks:
                    self._dp_sep = g
        # the first and the last stage of each pipeline (a tied
        # embedding's two copies): the pipe group itself at pp 2
        self._ends = self._groups.get("pipe")
        if self._pp_degree > 2:
            for ranks in topology.get_comm_list("pipe"):
                g = new_group([ranks[0], ranks[-1]])
                if rank in (ranks[0], ranks[-1]):
                    self._ends = g

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding_parallel"
        if self._mp_degree > 1:
            return "model"
        return "data"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # data parallel
    def get_data_parallel_rank(self):
        return self._coord["data"]

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self) -> Group:
        return self._groups["data"]

    def get_data_parallel_group_src_rank(self):
        return self._groups["data"].ranks[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._coord["model"]

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self) -> Group:
        return self._groups["model"]

    def get_model_parallel_group_src_rank(self):
        return self._groups["model"].ranks[0]

    # pipeline parallel
    def get_stage_id(self):
        return self._coord["pipe"]

    def get_pipe_parallel_rank(self):
        return self._coord["pipe"]

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self) -> Group:
        return self._groups["pipe"]

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_groups(self):
        return None

    def get_pipe_ends_group(self):
        """The group of this pipeline's first and last stage (None on a
        middle stage, or without a pipeline)."""
        if self._pp_degree <= 1 or not (self.is_first_stage()
                                        or self.is_last_stage()):
            return None
        return self._ends

    # sharding
    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self) -> Group:
        return self._groups["sharding"]

    def get_sharding_parallel_group_src_rank(self):
        return self._groups["sharding"].ranks[0]

    # sep (sequence parallel)
    def get_sep_parallel_rank(self):
        return self._coord.get("sep", 0)

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self) -> Group:
        return self._groups.get("sep")

    def _dp_sep_lists(self):
        """The rank lists over ``data x sep``: one for each combination
        of the other axes, in rank order."""
        topo = self._topo
        names = topo.get_hybrid_group_names()
        lists = {}
        for r in range(topo.world_size()):
            c = dict(zip(names, topo.get_coord(r)))
            key = tuple(v for n, v in c.items() if n not in ("data", "sep"))
            lists.setdefault(key, []).append(r)
        return list(lists.values())

    def get_dp_sep_parallel_group(self) -> Group:
        """The group over ``data x sep`` this rank belongs to (the
        data-parallel group when the sep degree is 1)."""
        return self._dp_sep

    def get_dp_sep_parallel_world_size(self):
        return self._dp_degree * self._sep_degree

    def get_check_parallel_group(self):
        return self._groups["model"]

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank_from_stage(self.global_rank,
                                              pipe=stage_id, **kwargs)
