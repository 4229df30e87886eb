"""Mixed precision, level O2 (the counterpart of ``decorate`` in
``paddle_tpu/amp/__init__.py``).

O2 casts every floating parameter of the model to bf16 once, LayerNorm's
included; the optimizer keeps f32 master weights
(``multi_precision=True``).  bf16 has f32's exponent range, so there is
no loss scaling.  The O1 ``auto_cast`` lists are not ported (ROADMAP
Queue 1, item 9).
"""
from __future__ import annotations

import torch

__all__ = ["decorate", "amp_decorate"]


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight=None, save_dtype=None):
    """Cast every floating parameter of ``models`` (a model, or a list or
    tuple of them) to bf16 in place.  Returns ``models``, or ``(models,
    optimizers)`` when ``optimizers`` is given, as the reference does.
    The optimizers keep their f32 masters by ``multi_precision``
    (``master_weight`` is accepted for the reference's signature, as is
    ``save_dtype``); any level or dtype but O2 bf16 raises."""
    if level != "O2" or dtype != "bfloat16":
        raise NotImplementedError(
            f"amp.decorate(level={level!r}, dtype={dtype!r}): only level O2 "
            f"with bfloat16 is ported; O1 and float16 are ROADMAP Queue 1, "
            f"item 9")
    for model in models if isinstance(models, (list, tuple)) else [models]:
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(torch.bfloat16)
    return models if optimizers is None else (models, optimizers)


amp_decorate = decorate
