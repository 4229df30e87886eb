"""Kernels of the port: each a CUDA kernel for Hopper with its plain
PyTorch version beside it (:mod:`.paged_attention`, :mod:`.quant_kernels`,
:mod:`.fused_kernels`, :mod:`.pallas_ops`)."""
from . import fused_kernels as _fused_kernels
from . import paged_attention as _paged_attention
from . import pallas_ops as _pallas_ops
from . import quant_kernels as _quant_kernels

__all__ = ["KERNELS", "reset_launch_counts", "launch_counts",
           "set_launch_counts", "add_launch_counts"]

#: every kernel wrapper of the port, by name
KERNELS = {
    "paged_attention": _paged_attention.paged_attention,
    "paged_attention_int8": _paged_attention.paged_attention_int8,
    "w8a16_matmul": _quant_kernels.w8a16_matmul,
    "layer_norm_fwd": _fused_kernels.layer_norm_fwd,
    "layer_norm_bwd": _fused_kernels.layer_norm_bwd,
    "softmax_xent_fwd": _fused_kernels.softmax_xent_fwd,
    "softmax_xent_bwd": _fused_kernels.softmax_xent_bwd,
    "ln_matmul": _fused_kernels.ln_matmul,
    "matmul_bias_gelu": _fused_kernels.matmul_bias_gelu,
    "flash_fwd": _pallas_ops.flash_fwd,
    "flash_bwd_dq": _pallas_ops.flash_bwd_dq,
    "flash_bwd_dkv": _pallas_ops.flash_bwd_dkv,
    "flash_packed_fwd": _pallas_ops.flash_packed_fwd,
    "flash_packed_bwd_dq": _pallas_ops.flash_packed_bwd_dq,
    "flash_packed_bwd_dkv": _pallas_ops.flash_packed_bwd_dkv,
}


def reset_launch_counts() -> None:
    """Set every wrapper's launch counts to 0 (``launches``, and
    ``residual_launches`` where a wrapper has it)."""
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "residual_launches"):
            fn.residual_launches = 0


def launch_counts() -> dict:
    """Every wrapper's launch counts: ``{(name, attribute): count}`` for
    ``launches`` and, where a wrapper has it, ``residual_launches``."""
    return {(name, attr): getattr(fn, attr)
            for name, fn in KERNELS.items()
            for attr in ("launches", "residual_launches") if hasattr(fn, attr)}


def set_launch_counts(counts: dict) -> None:
    """Set the counts :func:`launch_counts` returned."""
    for (name, attr), n in counts.items():
        setattr(KERNELS[name], attr, n)


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (as :func:`launch_counts` keys it) to the counts: a
    CUDA graph's replay launches what its capture recorded."""
    for (name, attr), n in delta.items():
        fn = KERNELS[name]
        setattr(fn, attr, getattr(fn, attr) + n)
