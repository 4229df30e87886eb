"""int8 pack/unpack helpers and the w8a16 matrix product.

The counterpart of ``paddle_tpu/ops/quant_kernels.py``:

 - :func:`quantize_weight` / :func:`dequantize_weight`: per-out-channel
   symmetric int8 weights with f32 scales.
 - :func:`quantize_kv` / :func:`dequantize_kv`: per-(token, head) int8
   KV values, quantized at write time (a pure per-row function, so a
   row's stored bytes never depend on its batch neighbours).
 - :func:`w8a16_matmul_reference`: widen, one f32 product, scale after
   the sum.
 - :func:`w8a16_split_plan` / :func:`w8a16_split_reference`: the k groups
   the CUDA kernel sums separately (a function of K alone), and a plain
   model of its sum order: each group an f32 chain in ascending k, the
   groups added in order, then the scale.
 - :func:`w8a16_matmul`: the CUDA kernel ``csrc/w8a16.cu`` on CUDA
   tensors, the reference on CPU tensors, and nothing else.

Rounding is half-to-even (``torch.round``, as ``jnp.round``); values
clip to [-127, 127]; an all-zero channel or row gets scale 1.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["quantize_weight", "dequantize_weight", "quantize_kv",
           "dequantize_kv", "w8a16_matmul", "w8a16_matmul_reference",
           "w8a16_split_plan", "w8a16_split_reference", "QMAX"]

# symmetric int8: [-127, 127]; -128 is never produced, so negation is
# exact and the zero point is 0
QMAX = 127.0


def _absmax_scale(absmax):
    return torch.where(absmax > 0, absmax, torch.ones_like(absmax)) / QMAX


def quantize_weight(w, axis: int = -1):
    """Per-out-channel symmetric int8 quantization.

    ``axis`` is the out-channel axis (kept; the absmax reduces over every
    other axis): ``axis=1`` for the serve model's ``(K, N)`` weights,
    giving an ``(N,)`` f32 scale.  Returns ``(q_int8, scale_f32)``.
    """
    w = torch.as_tensor(w).float()
    axis = axis % w.ndim
    red = tuple(i for i in range(w.ndim) if i != axis)
    absmax = w.abs().amax(dim=red) if red else w.abs()
    scale = _absmax_scale(absmax)
    shape = [1] * w.ndim
    shape[axis] = -1
    q = torch.clamp(torch.round(w / scale.reshape(shape)), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_weight(q, scale, axis: int = -1):
    """Inverse of :func:`quantize_weight`, up to rounding."""
    axis = axis % q.ndim
    shape = [1] * q.ndim
    shape[axis] = -1
    return q.float() * scale.reshape(shape)


def quantize_kv(x):
    """Dynamic int8 quantization over the trailing (head_dim) axis:
    ``(..., D)`` gives int8 values and a ``(...,)`` f32 scale."""
    x = x.float()
    scale = _absmax_scale(x.abs().amax(dim=-1))
    q = torch.clamp(torch.round(x / scale[..., None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale):
    """Rehydrate int8 KV values with their per-(token, head) scales."""
    return q.float() * scale[..., None]


def w8a16_matmul_reference(x, w_q, scale):
    """Widen the int8 weight, one f32 product, per-column scale after
    the sum; output in ``x.dtype``."""
    acc = torch.matmul(x.float(), w_q.float())
    return (acc * scale).to(x.dtype)


W8A16_GROUPS = 8   # kGroups in csrc/w8a16.cu: one cluster block each


W8A16_K_STEP = 32  # the kernel's x width: K zero-padded to a multiple


def w8a16_split_plan(k):
    """The ``(start, end)`` k ranges whose f32 sums the kernel keeps
    apart and then adds in this order: ``W8A16_GROUPS`` equal groups of K
    rounded up to a multiple of ``W8A16_K_STEP``, each cut at K (the
    zero padding adds nothing; a group past K sums nothing).  It reads K
    alone (neither N nor the row count enters), so a row's sum order, and
    its bits, never depend on the batch it shares."""
    size = -(-k // W8A16_K_STEP) * W8A16_K_STEP // W8A16_GROUPS
    return tuple((min(g * size, k), min((g + 1) * size, k))
                 for g in range(W8A16_GROUPS))


def w8a16_split_reference(x, w_q, scale):
    """A plain model of the kernel's sum order on ``(M, K)`` x: each
    group of :func:`w8a16_split_plan` one f32 chain in ascending k (each
    step ``x * w + acc`` rounded once, as ``fmaf``; taken through f64 here),
    the group sums added in group order, then the scale; output in
    ``x.dtype``.  Row-wise elementwise work only, so a row's bits never
    depend on M."""
    xd, wd = x.float().double(), w_q.double()   # each product exact
    total = None
    for lo, hi in w8a16_split_plan(xd.shape[-1]):
        acc = torch.zeros(xd.shape[0], wd.shape[1], dtype=torch.float32,
                          device=x.device)
        for k in range(lo, hi):
            acc = (xd[:, k:k + 1] * wd[k] + acc.double()).float()
        total = acc if total is None else total + acc
    return (total * scale).to(x.dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptt_w8a16_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}
_X_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond, msg):
    if not cond:
        raise ValueError(f"w8a16 kernel: {msg}")


def _launch(x2, w_q, scale):
    """Check what the kernel takes, allocate the output, launch on the
    current stream.  Never synchronises.  Any K and N: x's columns are
    zero-padded to the next multiple of ``W8A16_K_STEP`` (a copy of the
    activations, not of the weight), the weight is read whole."""
    dev = x2.device
    _require(dev.type == "cuda", f"x is on {dev}, not a CUDA device")
    for t in (x2, w_q, scale):
        _require(t.device == dev, "all inputs must be on one CUDA device")
        _require(t.is_contiguous(), "inputs must be contiguous")
    _require(x2.dtype in _X_CODE, f"x dtype {x2.dtype} not in "
             "(float32, bfloat16)")
    m, k = x2.shape
    _require(w_q.dtype == torch.int8 and w_q.dim() == 2
             and w_q.shape[0] == k, "w_q must be int8 (K, N)")
    n = w_q.shape[1]
    _require(scale.dtype == torch.float32 and scale.shape == (n,),
             "scale must be float32 (N,)")
    _require(0 < k and 0 < n and m < 2 ** 31 and n < 2 ** 31,
             f"({m}, {k}) @ ({k}, {n}) is out of range")
    kp = -(-k // W8A16_K_STEP) * W8A16_K_STEP
    if kp != k:
        xp = x2.new_zeros((m, kp))
        xp[:, :k] = x2
        x2 = xp
    _require(x2.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0,
             "x and w_q must be 16-byte aligned")
    out = torch.empty((m, n), dtype=x2.dtype, device=dev)
    if m == 0:
        return out
    lib = _build.load("w8a16", _SIGNATURES)
    status = lib.ptt_w8a16_matmul(
        x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, kp, k, n, _X_CODE[x2.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "w8a16_matmul")
    return out


def w8a16_matmul(x, w_q, scale):
    """``x @ dequant(w_q, scale)`` computed as ``(x @ w_q) * scale`` with
    f32 accumulation.

    ``x``: ``(..., K)`` f32 or bf16; ``w_q``: ``(K, N)`` int8;
    ``scale``: ``(N,)`` f32.  Output in ``x.dtype``.  The CUDA kernel for
    CUDA tensors, the plain reference for CPU tensors.
    ``w8a16_matmul.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return w8a16_matmul_reference(x, w_q, scale)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.data_ptr() % 16:   # a view off a 16-byte boundary: copy it
        x2 = x2.clone()
    out = _launch(x2, w_q, scale)
    w8a16_matmul.launches += 1
    return out.reshape(*lead, w_q.shape[1])


w8a16_matmul.launches = 0
