"""``distributed.auto_tuner``: the search over parallel configurations
(the counterpart of ``paddle_tpu/distributed/auto_tuner/``; the
reference's ``auto_tuner/{tuner,search,prune,recorder}.py``): a grid of
dp / mp / pp / sharding / micro-batch / recompute candidates, the prune
rules, the trial recorder and, given a model, the analytic cost model's
pruning and order."""
from .prune import PRUNE_RULES, prune_by_rules, register_prune
from .recorder import HistoryRecorder
from .search import GridSearch, SearchAlgo
from .tuner import AutoTuner

__all__ = ["AutoTuner", "GridSearch", "SearchAlgo", "register_prune",
           "prune_by_rules", "PRUNE_RULES", "HistoryRecorder"]
