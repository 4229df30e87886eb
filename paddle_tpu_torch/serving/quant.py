"""Weight quantization for the int8 serve path.

The part of ``paddle_tpu/serving/quant.py`` that the engine calls for
``precision="int8"``: each projection and MLP matrix ``name`` becomes
``name::q`` (int8) + ``name::scale`` (f32 per out channel).  The model's
matrix-product helper dispatches on the ``::q`` key, so one set of step
functions serves every precision.
"""
from __future__ import annotations

from typing import Any, Dict

from ..ops.quant_kernels import quantize_weight
from .model import QUANT_WEIGHT_NAMES, ModelSpec

__all__ = ["quantize_params", "is_quantized_params"]


def is_quantized_params(params) -> bool:
    return any(str(k).endswith("::q") for k in params)


def quantize_params(params, spec: ModelSpec) -> Dict[str, Any]:
    """Rewrite a flat fp32 weight dict into the int8 serve layout.

    Each quantizable matrix is replaced, in place in the key order, by
    ``name::q`` + ``name::scale``; everything else passes through.
    Deterministic: the same weights always give the same bytes.
    """
    if is_quantized_params(params):
        return dict(params)
    targets = set(QUANT_WEIGHT_NAMES(spec))
    out: Dict[str, Any] = {}
    for name, w in params.items():
        if name in targets:
            q, s = quantize_weight(w, axis=1)
            out[name + "::q"] = q
            out[name + "::scale"] = s
        else:
            out[name] = w
    return out
