"""Rank and world size of this process (the counterpart of
``paddle_tpu/distributed/env.py``).

The port runs one process per rank.  Once ``torch.distributed`` has a
process group (:func:`.parallel.init_parallel_env`), rank and world size
are that group's; before, they come from the launcher's environment, the
reference's contract: ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_LOCAL_RANK`` (:func:`.launch_api.spawn` sets them for each
rank).  Without either, a process is rank 0 of 1.
"""
from __future__ import annotations

import os

import torch.distributed as dist

__all__ = ["get_rank", "get_world_size", "ParallelEnv"]


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (a :class:`.collective.Group`;
    -1 when it is not a member), or in the world."""
    if group is not None:
        return group.rank
    if _group_up():
        return dist.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size(group=None) -> int:
    """The number of ranks in ``group``, or in the world."""
    if group is not None:
        return group.nranks
    if _group_up():
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


class ParallelEnv:
    """The reference's ``ParallelEnv``: rank, world size, the local rank
    (the card a rank drives) and the endpoints, read when it is made."""

    def __init__(self):
        self._rank = get_rank()
        self._world_size = get_world_size()

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("PADDLE_LOCAL_RANK", self._rank))

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def nranks(self) -> int:
        return self._world_size

    @property
    def dev_id(self) -> int:
        return self.local_rank

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self) -> list:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else [self.current_endpoint]
