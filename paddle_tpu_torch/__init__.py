"""PyTorch/CUDA port of ``paddle_tpu``, for NVIDIA Hopper (H100).

The port grows slice by slice beside the JAX package, which stays the
reference.  It holds the paged-KV serving engine (:mod:`.serving`) with
its three hand-written CUDA kernels (:mod:`.ops.paged_attention`,
:mod:`.ops.quant_kernels`), and the GPT and BERT pretraining steps
(:mod:`.train`, :mod:`.incubate.models`) with their LayerNorm,
cross-entropy (:mod:`.ops.fused_kernels`) and flash-attention
(:mod:`.ops.pallas_ops`) kernels.

Importing the package loads torch, numpy and the standard library only:
no JAX, nothing from ``paddle_tpu``, and no kernel is built until a
CUDA tensor first reaches a kernel wrapper.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
