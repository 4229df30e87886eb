"""Layers, functionals and initializers of the training path
(the counterpart of ``paddle_tpu/nn`` for the GPT and BERT steps)."""
from . import functional, initializer
from .layer import Dropout, Embedding, LayerNorm, Linear

__all__ = ["functional", "initializer", "Dropout", "Embedding", "LayerNorm",
           "Linear"]
