"""Mixed precision, level O2 (the counterpart of ``decorate`` in
``paddle_tpu/amp/__init__.py``).

O2 casts every floating parameter of the model to bf16 once, LayerNorm's
included; the optimizer keeps f32 master weights
(``multi_precision=True``).  bf16 has f32's exponent range, so there is
no loss scaling.  The O1 ``auto_cast`` lists are not ported.
"""
from __future__ import annotations

import torch

__all__ = ["decorate"]


def decorate(model: torch.nn.Module, level: str = "O2",
             dtype: str = "bfloat16") -> torch.nn.Module:
    """Cast every floating parameter of ``model`` to bf16 in place;
    returns ``model``."""
    if level != "O2" or dtype != "bfloat16":
        raise NotImplementedError(
            f"only level O2 with bfloat16 is ported, got {level} {dtype}")
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(torch.bfloat16)
    return model
