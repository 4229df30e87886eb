"""Layer norm (the counterpart of ``layer_norm`` in
``paddle_tpu/nn/functional/norm.py``).

Every call goes to :func:`..ops.fused_kernels.fused_layer_norm`: the CUDA
kernel pair on the card, its plain version on the CPU.  The JAX package
takes its Pallas kernel on the TPU and an XLA fallback elsewhere; the
port has no fallback.  Only the affine variant without a residual is
ported: the residual and no-affine variants are reached through the
fusion pass, which is not ported yet.
"""
from __future__ import annotations

import math

from ...ops.fused_kernels import fused_layer_norm

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight, bias, epsilon=1e-5):
    """Normalize over the trailing ``normalized_shape`` axes; f32
    statistics, output in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    if weight is None or bias is None:
        raise NotImplementedError(
            "layer_norm without weight or bias is the fusion pass's "
            "variant, not ported yet")
    d = math.prod(normalized_shape)
    y = fused_layer_norm(x.reshape(-1, d).contiguous(), weight.reshape(d),
                         bias.reshape(d), epsilon)
    return y.reshape(x.shape)
