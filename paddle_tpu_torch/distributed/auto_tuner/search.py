"""Search algorithms (the counterpart of
``paddle_tpu/distributed/auto_tuner/search.py``; the reference's
``GridSearch`` and ``utils.py`` ``search_all``)."""
from __future__ import annotations

import itertools
from abc import ABC, abstractmethod

from .prune import prune_by_rules

__all__ = ["SearchAlgo", "GridSearch"]

# the candidate axes in the reference's fixed order
AXES = ["dp_degree", "mp_degree", "pp_degree", "micro_batch_size",
        "sharding_degree", "sharding_stage", "use_recompute",
        "recompute_granularity"]


def search_all(tuner_cfg):
    """The product of every candidate axis, in :data:`AXES` order."""
    candidates = tuner_cfg.get("candidates", {})
    pools = [candidates.get(a, [None]) for a in AXES]
    return [dict(zip(AXES, combo))
            for combo in itertools.product(*pools)]


class SearchAlgo(ABC):
    def __init__(self, tuner_cfg):
        self.tuner_cfg = tuner_cfg

    @abstractmethod
    def search_once(self, history_cfgs):
        ...

    def prune(self, cur_cfg, history_cfgs):
        return prune_by_rules(self.tuner_cfg, cur_cfg, history_cfgs)


class GridSearch(SearchAlgo):
    def __init__(self, tuner_cfg):
        super().__init__(tuner_cfg)
        self.all_cfgs = search_all(tuner_cfg)
        self.idx = 0

    def search_once(self, history_cfgs):
        """The next candidate no rule prunes, or None at the end."""
        while self.idx < len(self.all_cfgs):
            cfg = self.all_cfgs[self.idx]
            self.idx += 1
            if not self.prune(cfg, history_cfgs):
                return dict(cfg)
        return None
