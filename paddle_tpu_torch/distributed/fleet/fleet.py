"""``fleet`` (the counterpart of ``paddle_tpu/distributed/fleet/fleet.py``).

``fleet.init`` joins the process group (:func:`..parallel.init_parallel_env`,
if the caller has not), takes the degrees from the strategy's
``hybrid_configs`` (:func:`hybrid_degrees`: the JAX package's rule,
ranks left over go to dp when dp is left at 1) and builds the
:class:`..topology.HybridCommunicateGroup`.  The degrees must cover the
world exactly.  ``distributed_model`` wraps the model for its mode
(``get_parallel_mode``): a :class:`.meta_parallel.PipelineParallel` over
a ``PipelineLayer`` when pp > 1, :class:`.meta_parallel.ShardingParallel`
(stage 3) when sharding > 1, else :class:`.meta_parallel.TensorParallel`
when mp > 1, then :class:`..parallel.DataParallel` over the data-parallel
group; the strategy's bf16 O2 ``amp`` and ``recompute`` are applied
first.  ``distributed_optimizer`` wraps the optimizer in
:class:`.meta_optimizers.HybridParallelOptimizer`, and with
``strategy.sharding`` sets the ZeRO level from
``sharding_configs["stage"]`` (1: ``os``, 2: ``os_g``).  A sep degree
above 1 splits each sequence over the sep group
(:mod:`.meta_parallel.sequence_parallel`); the ``DataParallel`` wrapper
then averages over ``data x sep`` (``get_dp_sep_parallel_group``).
``save_sharded(state, path)`` and ``load_sharded(path, state)`` save and
load a train step's (or a state dict's) sharded checkpoint, every rank
its windows, at any layout.
"""
from __future__ import annotations

import os
from typing import Optional

from ..env import get_rank, get_world_size
from ..topology import CommunicateTopology, HybridCommunicateGroup
from .base.distributed_strategy import DistributedStrategy

__all__ = ["Fleet", "fleet", "init", "get_hybrid_communicate_group",
           "distributed_model", "distributed_optimizer", "worker_num",
           "worker_index", "is_first_worker", "worker_endpoints",
           "barrier_worker", "hybrid_degrees", "apply_recompute"]

_HCG: Optional[HybridCommunicateGroup] = None
_NAMES = ("data", "pipe", "sharding", "sep", "model")
_KEYS = ("dp_degree", "pp_degree", "sharding_degree", "sep_degree",
         "mp_degree")


def hybrid_degrees(hybrid_configs: dict, world: int) -> tuple:
    """``(dp, pp, sharding, sep, mp)`` from ``hybrid_configs`` for a
    world of ``world`` ranks: when their product falls short of the
    world, divides it, and dp was left at 1, dp takes the rest (the JAX
    package's ``fleet.init``)."""
    dims = [int(hybrid_configs.get(k, 1)) for k in _KEYS]
    prod = 1
    for d in dims:
        prod *= d
    if prod < world and world % prod == 0 and dims[0] == 1:
        dims[0] = world // prod
    return tuple(dims)


def apply_recompute(model) -> None:
    """The strategy's ``recompute``: the model recomputes each block in
    the backward pass (its config's ``use_recompute``, and GPT's live
    flag)."""
    cfg = getattr(model, "config", None)
    if cfg is not None and hasattr(cfg, "use_recompute"):
        cfg.use_recompute = True
        inner = getattr(model, "gpt", None)
        if inner is not None and hasattr(inner, "use_recompute"):
            inner.use_recompute = True


class Fleet:
    def __init__(self):
        self._is_initialized = False
        self._user_defined_strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._role_maker = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        """Join the process group and build the hybrid topology.
        ``role_maker`` (:mod:`.role_maker`'s) must count the world's
        workers and name this rank."""
        global _HCG
        from ..parallel import init_parallel_env
        strategy = strategy or DistributedStrategy()
        world = get_world_size()
        if role_maker is not None:
            if not role_maker.is_worker():
                raise NotImplementedError(
                    "a parameter-server role: the port trains collectively "
                    "(distributed.ps holds a sharded embedding instead)")
            if (role_maker.worker_num(), role_maker.worker_index()) != \
                    (world, get_rank()):
                raise ValueError(
                    f"the role maker names worker {role_maker.worker_index()}"
                    f" of {role_maker.worker_num()}; this process is rank "
                    f"{get_rank()} of {world}")
        self._role_maker = role_maker
        self._user_defined_strategy = strategy
        init_parallel_env()
        world = get_world_size()
        dims = hybrid_degrees(strategy.hybrid_configs, world)
        topo = CommunicateTopology(_NAMES, dims)
        if topo.world_size() != world:
            raise ValueError(f"hybrid degrees {dict(zip(_KEYS, dims))} make "
                             f"{topo.world_size()} ranks; the world has "
                             f"{world}")
        self._hcg = _HCG = HybridCommunicateGroup(topo)
        self._is_initialized = True
        return self

    @property
    def is_initialized(self):
        return self._is_initialized

    def get_hybrid_communicate_group(self):
        return self._hcg

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def is_first_worker(self):
        return get_rank() == 0

    def worker_endpoints(self, to_string=False):
        eps = [e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                         "").split(",") if e]
        return ",".join(eps) if to_string else eps

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def barrier_worker(self):
        from ..collective import barrier
        barrier()

    def distributed_model(self, model):
        """``model`` wrapped for the topology's mode (module docstring)."""
        from ..parallel import DataParallel
        from .meta_parallel import TensorParallel
        hcg = self._hcg
        if hcg is None:
            raise RuntimeError("call fleet.init() first")
        s = self._user_defined_strategy
        if s is not None and s.amp:
            if not s.amp_configs.get("use_bf16", True):
                raise NotImplementedError("fp16 AMP is not ported: only O2 "
                                          "in bf16")
            from ...amp import decorate
            decorate(model, level="O2", dtype="bfloat16")
        if s is not None and s.recompute:
            apply_recompute(model)
        mode = hcg.get_parallel_mode()
        if mode == "pipeline":
            from .meta_parallel import PipelineParallel
            return PipelineParallel(model, hcg, strategy=s)
        if mode == "sharding_parallel":
            from .meta_parallel import ShardingParallel
            return ShardingParallel(model, hcg, strategy=s)
        if mode == "model":
            model = TensorParallel(model, hcg, strategy=s)
        return DataParallel(model, strategy=s,
                            group=hcg.get_dp_sep_parallel_group())

    def distributed_optimizer(self, optimizer, strategy=None):
        from .meta_optimizers import HybridParallelOptimizer
        if strategy is not None:
            self._user_defined_strategy = strategy
        s = self._user_defined_strategy
        if s is not None and s.sharding:
            from ..sharding.group_sharded import set_zero_level
            stage = int(s.sharding_configs.get("stage", 1))
            if stage not in (1, 2):
                raise ValueError(f"sharding_configs stage {stage}: 1 (os) or "
                                 f"2 (os_g); stage 3 is "
                                 f"group_sharded_parallel(level='p_g_os')")
            set_zero_level(optimizer, "os" if stage == 1 else "os_g")
        return HybridParallelOptimizer(optimizer, self._hcg,
                                       self._user_defined_strategy)

    # -- sharded checkpoints ---------------------------------------------------
    def save_sharded(self, state, path):
        """Save ``state`` as a sharded checkpoint at ``path``, every rank
        its part: a train step (its ``checkpoint_tree()``: a hybrid
        step's windows in the JAX package's layout) or a nested dict of
        tensors and windows.  With more than one rank the ranks meet over
        the default process group's store and rank 0 commits."""
        from ..checkpoint import ProcessGroupStore, save_sharded, world_size
        tree = state.checkpoint_tree() if hasattr(state, "checkpoint_tree") \
            else state
        save_sharded(tree, path, store=ProcessGroupStore.default()
                     if world_size() > 1 else None)

    def load_sharded(self, path, state):
        """Load the sharded checkpoint at ``path`` into ``state`` in
        place and return it: a train step (each rank's windows at its
        mesh, from a checkpoint saved at any layout) or a nested dict of
        tensors and windows (``load_state``)."""
        from ..checkpoint import load_sharded, load_state
        if not hasattr(state, "checkpoint_tree"):
            return load_state(path, state)
        template = state.checkpoint_tree()
        tree = load_sharded(path, state.checkpoint_mesh, None, template)
        state.load_checkpoint_tree(tree, template=template)
        return state


fleet = Fleet()


def init(role_maker=None, is_collective=True, strategy=None):
    return fleet.init(role_maker, is_collective, strategy)


def get_hybrid_communicate_group():
    return _HCG


def distributed_model(model):
    return fleet.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)


def worker_num():
    return fleet.worker_num()


def worker_index():
    return fleet.worker_index()


def is_first_worker():
    return fleet.is_first_worker()


def worker_endpoints(to_string=False):
    return fleet.worker_endpoints(to_string)


def barrier_worker():
    return fleet.barrier_worker()
