"""Quantization of the port: the observers that int8 calibration uses
(:mod:`.observers`)."""
from .observers import AbsmaxObserver, PerChannelAbsmaxObserver

__all__ = ["AbsmaxObserver", "PerChannelAbsmaxObserver"]
