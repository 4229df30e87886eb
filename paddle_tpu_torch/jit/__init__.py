"""Whole-step capture (the counterpart of ``paddle_tpu/jit``'s
``capture_step``): a step replayed as CUDA graphs (:mod:`.capture`)."""
from .capture import (CapturedGraph, CapturedStep, capture_enabled,
                      capture_step, capture_stream)

__all__ = ["capture_step", "CapturedStep", "CapturedGraph", "capture_enabled",
           "capture_stream"]
