"""Optimizers of the training path (the counterpart of
``paddle_tpu/optimizer``: ``Adam`` and ``AdamW``)."""
from .adam import Adam, AdamW
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW", "Optimizer"]
