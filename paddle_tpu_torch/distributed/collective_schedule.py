"""The gradient reduction's collective schedule (the counterpart of
``paddle_tpu/distributed/collective_schedule.py``: the same planner,
pure metadata).

A reduction over a hybrid mesh is composed from per-axis stages, the
fast axis first:

    reduce_scatter(sharding)   # the whole payload, within the group
    all_reduce(dp)             # only 1/n of it crosses data parallelism
    all_gather(sharding)       # the windows put back together

The JAX package runs a plan's stages inside its compiled backward; the
port runs them on process groups (:class:`.sharding.GradReducer`), one
bucket at a time, and at ``os_g`` stops after the ``all_reduce``: the
``all_gather`` is of the updated parameters, after each rank's window
update.  ``PT_COLLECTIVE_SCHEDULE=0`` turns planning off (the plan is
None, and the reduction is an all-reduce of whole gradients).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = ["Stage", "CollectiveSchedule", "schedule_enabled",
           "plan_grad_reduction"]


@dataclasses.dataclass(frozen=True)
class Stage:
    """One collective of a planned reduction: ``op`` over mesh ``axis``
    (``reduce_scatter``, ``all_reduce`` or ``all_gather``), planned for
    an axis of ``size`` ranks."""
    op: str
    axis: str
    size: int = 1


@dataclasses.dataclass(frozen=True)
class CollectiveSchedule:
    """An ordered stage list for one gradient reduction;
    ``shard_axis`` / ``shard_size`` name the axis whose reduce-scatter
    windows are the ZeRO shards (None for a plain all-reduce)."""

    stages: tuple = ()
    shard_axis: Optional[str] = None
    shard_size: int = 1

    @property
    def scatters(self) -> bool:
        return any(s.op == "reduce_scatter" for s in self.stages)

    @property
    def kind(self) -> str:
        return "reduce_scatter" if self.scatters else "all_reduce"

    def describe(self) -> str:
        return " -> ".join(f"{s.op}({s.axis}:{s.size})"
                           for s in self.stages) or "noop"


def schedule_enabled() -> bool:
    """Planning is on unless ``PT_COLLECTIVE_SCHEDULE`` is ``0`` or
    ``false``."""
    return os.environ.get("PT_COLLECTIVE_SCHEDULE", "1") not in (
        "0", "false", "False")


def plan_grad_reduction(axis_sizes, zero=None):
    """The reduction for a mesh of ``axis_sizes`` ({axis: size}) at ZeRO
    level ``zero`` (``os``, ``os_g`` or None); None when planning is off
    or there is nothing to plan:

    - dp only, no ZeRO: ``all_reduce(dp)``;
    - dp x sharding with ZeRO: ``reduce_scatter(sharding) ->
      all_reduce(dp) -> all_gather(sharding)``;
    - sharding only with ZeRO: ``reduce_scatter -> all_gather``.
    """
    if not schedule_enabled():
        return None
    n_dp = int(axis_sizes.get("dp", 1))
    n_sh = int(axis_sizes.get("sharding", 1))
    if zero is not None and n_sh > 1:
        stages = [Stage("reduce_scatter", "sharding", n_sh)]
        if n_dp > 1:
            stages.append(Stage("all_reduce", "dp", n_dp))
        stages.append(Stage("all_gather", "sharding", n_sh))
        return CollectiveSchedule(tuple(stages), shard_axis="sharding",
                                  shard_size=n_sh)
    if n_dp > 1 and n_sh <= 1 and zero is None:
        return CollectiveSchedule((Stage("all_reduce", "dp", n_dp),))
    return None
