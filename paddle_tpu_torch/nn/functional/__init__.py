"""Functionals of the training path."""
from .activation import gelu, tanh
from .common import (FLASH_MIN_SEQ, dropout, embedding, linear,
                     scaled_dot_product_attention)
from .flash_attention import flash_attention, flash_attn_unpadded
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["FLASH_MIN_SEQ", "cross_entropy", "dropout", "embedding",
           "flash_attention", "flash_attn_unpadded", "gelu", "layer_norm",
           "linear", "scaled_dot_product_attention", "tanh"]
