"""Fused LayerNorm: plain PyTorch and a CUDA kernel pair.

The counterpart of the LayerNorm part of ``paddle_tpu/ops/fused_kernels.py``
(``fused_layer_norm``, its custom VJP ``_ln`` and
``layer_norm_reference``), for the variant the training step runs: an
affine ``(x, w, b)`` over a 2-D ``(rows, d)`` view, no residual, with x,
w and b all f32 or all bf16.

Arithmetic of the TPU kernel, kept by both versions here:

 - one-pass statistics in f32: ``var = max(E[x^2] - E[x]^2, 0)``,
   ``rstd = rsqrt(var + eps)``; ``y = (x - mean) * rstd * w + b`` in f32,
   stored in x's dtype; mean and rstd are saved as f32 ``(rows,)``;
 - backward: ``dx = (dy - mean(dy) - xhat * mean(dy * xhat)) * rstd``
   with ``dy = g * w``, stored in x's dtype; ``dw = sum(g * xhat)`` and
   ``db = sum(g)`` over all rows in f32, then cast to w's dtype.

 - :func:`layer_norm_fwd_reference` / :func:`layer_norm_bwd_reference`:
   the plain versions.  Tests and ``chip_smoke.py`` hold the kernels
   against them; no CUDA path calls them.
 - :func:`layer_norm_fwd` / :func:`layer_norm_bwd`: the CUDA kernels of
   ``csrc/layer_norm.cu`` on CUDA tensors, the plain versions on CPU
   tensors, and nothing else.  Each counts its launches in ``.launches``.
 - :func:`fused_layer_norm`: the ``torch.autograd.Function`` that ties
   them: its forward runs :func:`layer_norm_fwd` and saves mean and rstd,
   its backward runs :func:`layer_norm_bwd`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_layer_norm", "layer_norm_fwd", "layer_norm_bwd",
           "layer_norm_fwd_reference", "layer_norm_bwd_reference"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptt_layer_norm_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float,
                           _I, _P),
    "ptt_layer_norm_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _P),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 1024            # four 256-column chunks per warp
_ROWS_PER_BLOCK = 8      # one warp per row
_BWD_MAX_BLOCKS = 256    # partial rows of dw/db, added in a fixed order


def layer_norm_fwd_reference(x, weight, bias, epsilon=1e-5):
    """Plain forward: ``(y, mean, rstd)`` with the kernel's one-pass f32
    statistics; ``y`` in x's dtype, mean and rstd f32 ``(rows,)``."""
    d = x.shape[-1]
    xv = x.float()
    mean = xv.sum(-1, keepdim=True) / d
    var = torch.clamp(torch.square(xv).sum(-1, keepdim=True) / d
                      - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + epsilon)
    y = (xv - mean) * rstd * weight.float() + bias.float()
    return y.to(x.dtype), mean[:, 0], rstd[:, 0]


def layer_norm_bwd_reference(g, x, weight, mean, rstd):
    """Plain backward: ``(dx, dw, db)``; dx in x's dtype, dw and db
    summed over rows in f32 and cast to w's dtype."""
    d = x.shape[-1]
    gv = g.float()
    xhat = (x.float() - mean[:, None]) * rstd[:, None]
    dy = gv * weight.float()
    c1 = dy.sum(-1, keepdim=True) / d
    c2 = (dy * xhat).sum(-1, keepdim=True) / d
    dx = (dy - c1 - xhat * c2) * rstd[:, None]
    dw = (gv * xhat).sum(0)
    db = gv.sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def _require(cond, msg):
    if not cond:
        raise ValueError(f"layer_norm kernel: {msg}")


def _check(x, weight, *same):
    """What both kernels take: CUDA, x, weight and ``same`` of one dtype
    (f32 or bf16), contiguous and 16-byte aligned, x ``(rows, d)`` with
    ``0 < d <= 1024`` and ``d % 8 == 0``, weight ``(d,)``."""
    dev = x.device
    _require(dev.type == "cuda", f"x is on {dev}, not a CUDA device")
    _require(x.dim() == 2, f"x must be 2-D (rows, d), got {tuple(x.shape)}")
    _require(x.dtype in _DTYPE_CODE,
             f"dtype {x.dtype} not in (float32, bfloat16)")
    rows, d = x.shape
    _require(0 < d <= _MAX_D and d % 8 == 0,
             f"d={d} must be a multiple of 8 in (0, {_MAX_D}]")
    _require(weight.shape == (d,), f"weight must be ({d},)")
    for t in (x, weight, *same):
        _require(t.device == dev, "all inputs must be on one CUDA device")
        _require(t.is_contiguous(), "inputs must be contiguous")
        _require(t.dtype == x.dtype, f"{t.dtype} does not match x {x.dtype}")
        _require(t.data_ptr() % 16 == 0, "inputs must be 16-byte aligned")
    return dev, rows, d


def _launch_fwd(x, weight, bias, epsilon):
    dev, rows, d = _check(x, weight, bias)
    _require(bias.shape == (d,), f"bias must be ({d},)")
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=dev)
    rstd = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows == 0:
        return y, mean, rstd
    lib = _build.load("layer_norm", _SIGNATURES)
    status = lib.ptt_layer_norm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), rows, d, float(epsilon),
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "layer_norm_fwd")
    return y, mean, rstd


def _launch_bwd(g, x, weight, mean, rstd):
    dev, rows, d = _check(x, weight, g)
    _require(g.shape == x.shape, "g must have x's shape")
    for t in (mean, rstd):
        _require(t.device == dev and t.is_contiguous()
                 and t.shape == (rows,) and t.dtype == torch.float32,
                 f"mean and rstd must be contiguous float32 ({rows},) on "
                 f"{dev}")
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    db = torch.empty_like(weight)
    if rows == 0:
        return dx, dw.zero_(), db.zero_()
    nparts = min(-(-rows // _ROWS_PER_BLOCK), _BWD_MAX_BLOCKS)
    parts = torch.empty((2, nparts, d), dtype=torch.float32, device=dev)
    lib = _build.load("layer_norm", _SIGNATURES)
    status = lib.ptt_layer_norm_bwd(
        g.data_ptr(), x.data_ptr(), weight.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        parts[0].data_ptr(), parts[1].data_ptr(), rows, d, nparts,
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "layer_norm_bwd")
    return dx, dw, db


def layer_norm_fwd(x, weight, bias, epsilon=1e-5):
    """LayerNorm forward of a ``(rows, d)`` x: ``(y, mean, rstd)``.  The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``layer_norm_fwd.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return layer_norm_fwd_reference(x, weight, bias, epsilon)
    out = _launch_fwd(x, weight, bias, epsilon)
    layer_norm_fwd.launches += 1
    return out


layer_norm_fwd.launches = 0


def layer_norm_bwd(g, x, weight, mean, rstd):
    """LayerNorm backward: ``(dx, dw, db)`` from the output gradient and
    the forward's saved statistics.  The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  ``layer_norm_bwd.launches``
    counts kernel launches."""
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(g, x, weight, mean, rstd)
    out = _launch_bwd(g, x, weight, mean, rstd)
    layer_norm_bwd.launches += 1
    return out


layer_norm_bwd.launches = 0


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, epsilon):
        y, mean, rstd = layer_norm_fwd(x, weight, bias, epsilon)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(g.contiguous(), x, weight, mean, rstd)
        return dx, dw, db, None


def fused_layer_norm(x, weight, bias, epsilon=1e-5):
    """LayerNorm over the last axis of a 2-D ``(rows, d)`` x, with
    gradients for x, weight and bias; output in x's dtype."""
    if x.dim() != 2:
        raise ValueError(f"fused_layer_norm expects 2-D input, got "
                         f"{tuple(x.shape)}")
    return _LayerNorm.apply(x, weight, bias, float(epsilon))
