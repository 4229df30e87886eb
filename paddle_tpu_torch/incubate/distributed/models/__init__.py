"""Distributed models of the port: mixture of experts (:mod:`.moe`)."""
from . import moe

__all__ = ["moe"]
