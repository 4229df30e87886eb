"""Layers of the training path."""
from .common import Dropout, Embedding, Linear
from .loss import CrossEntropyLoss
from .norm import LayerNorm

__all__ = ["CrossEntropyLoss", "Dropout", "Embedding", "LayerNorm", "Linear"]
