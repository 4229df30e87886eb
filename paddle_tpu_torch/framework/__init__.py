"""Framework pieces of the port: the training step's random state
(:mod:`.random`) and ``save`` / ``load`` (:mod:`.io_state`)."""
from .io_state import load, save

__all__ = ["load", "save"]
