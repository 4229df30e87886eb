"""Fleet's strategy (:mod:`.distributed_strategy`)."""
from .distributed_strategy import DistributedStrategy

__all__ = ["DistributedStrategy"]
