"""Layers, functionals, initializers and gradient clips of the training
path (the counterpart of ``paddle_tpu/nn`` for the GPT and BERT steps
and hapi's ``CrossEntropyLoss``)."""
from . import clip, functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import CrossEntropyLoss, Dropout, Embedding, LayerNorm, Linear

__all__ = ["clip", "functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
           "clip_grad_value_", "CrossEntropyLoss", "Dropout", "Embedding",
           "LayerNorm", "Linear"]
