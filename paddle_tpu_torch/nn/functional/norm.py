"""Layer norm (the counterpart of ``layer_norm`` in
``paddle_tpu/nn/functional/norm.py``).

Every call goes to :func:`..ops.fused_kernels.fused_layer_norm`: the CUDA
kernel pair on the card, its plain version on the CPU.  The JAX package
takes its Pallas kernel on the TPU and an XLA fallback elsewhere; the
port has no fallback.  The affine variant is ported, with and without a
``residual`` added before the statistics: GPT's pre-LN blocks call it
without one, BERT's post-LN blocks (``BertLayer``) with one.  Like the
kernel, and unlike the JAX package's XLA path (which adds the residual
in x's dtype first), the port adds the residual in f32.  ``weight`` and
``bias`` may each be None (no scale, no shift): the kernels' no-affine
variant, which the fusion pass's matches also reach.
"""
from __future__ import annotations

import math

from ...ops.fused_kernels import fused_layer_norm

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               residual=None, name=None):
    """Normalize ``x`` (or ``x + residual``, same shape) over the trailing
    ``normalized_shape`` axes; f32 statistics, output in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    d = math.prod(normalized_shape)
    if residual is not None:
        residual = residual.reshape(-1, d).contiguous()
    y = fused_layer_norm(x.reshape(-1, d).contiguous(),
                         None if weight is None else weight.reshape(d),
                         None if bias is None else bias.reshape(d), epsilon,
                         residual)
    return y.reshape(x.shape)
