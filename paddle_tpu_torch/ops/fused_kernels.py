"""Fused LayerNorm and softmax cross-entropy: plain PyTorch and CUDA
kernel pairs.

The counterpart of two parts of ``paddle_tpu/ops/fused_kernels.py``.

**LayerNorm** (``fused_layer_norm``, its custom VJP ``_ln`` and
``layer_norm_reference``): an affine ``(x, w, b)`` over a 2-D
``(rows, d)`` view, with or without a ``residual`` added before the
statistics, x, w and b all f32 or all bf16.  Arithmetic of the TPU
kernel, kept by both versions here:

 - with a residual the kernels normalize ``x + r``, summed in f32 and
   never stored; the backward reads x and r again to rebuild it;
 - one-pass statistics in f32: ``var = max(E[x^2] - E[x]^2, 0)``,
   ``rstd = rsqrt(var + eps)``; ``y = (x - mean) * rstd * w + b`` in f32,
   stored in x's dtype; mean and rstd are saved as f32 ``(rows,)``;
 - backward: ``dx = (dy - mean(dy) - xhat * mean(dy * xhat)) * rstd``
   with ``dy = g * w``, stored in x's dtype; ``dw = sum(g * xhat)`` and
   ``db = sum(g)`` over all rows in f32, then cast to w's dtype; the
   residual's gradient is dx in r's dtype (the same tensor when the
   dtypes agree).

**Softmax cross-entropy** (``fused_softmax_xent``, its custom VJP
``_xent`` and ``softmax_xent_reference``): per-row losses of ``(rows,
V)`` logits (f32 or bf16) against int labels.  Arithmetic of the TPU
kernel, kept by both versions here:

 - ``lse = m + log(l)`` with ``m`` the row's largest logit and ``l =
   sum(exp(x - m))`` (``l = 1`` where it is 0), in f32; labels are
   clipped to ``[0, V - 1]`` to read the target logit ``t``;
 - ``loss = lse - t``, or with smoothing ``ls > 0``
   ``lse - (1 - ls) * t - ls * mean(x)``; 0 where the label is
   ``ignore_index``; f32 ``(rows,)``, and lse is saved;
 - backward, from the saved lse: ``dx = g * (exp(x - lse) - (1 - ls) *
   onehot - ls / V)`` (the last term only when ``ls > 0``), 0 on ignored
   rows, stored in x's dtype.  Labels get no gradient.

For each kernel:

 - ``*_reference``: the plain version.  Tests and ``chip_smoke.py`` hold
   the kernels against it; no CUDA path calls it.
 - :func:`layer_norm_fwd` / :func:`layer_norm_bwd` /
   :func:`softmax_xent_fwd` / :func:`softmax_xent_bwd`: the CUDA kernels
   of ``csrc/layer_norm.cu`` and ``csrc/softmax_xent.cu`` on CUDA
   tensors, the plain versions on CPU tensors, and nothing else.  Each
   counts its launches in ``.launches``; the LayerNorm wrappers count
   their residual launches again in ``.residual_launches``.
 - :func:`fused_layer_norm` / :func:`fused_softmax_xent`: the
   ``torch.autograd.Function``s that tie them: the forward saves the
   statistics (mean and rstd, or lse), the backward runs the backward
   wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_layer_norm", "layer_norm_fwd", "layer_norm_bwd",
           "layer_norm_fwd_reference", "layer_norm_bwd_reference",
           "fused_softmax_xent", "softmax_xent_fwd", "softmax_xent_bwd",
           "softmax_xent_fwd_reference", "softmax_xent_bwd_reference"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptt_layer_norm_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                           ctypes.c_float, _I, _P),
    "ptt_layer_norm_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _I, _I, _P),
}
_XENT_SIGNATURES = {
    "ptt_softmax_xent_fwd": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I,
                             _P),
    "ptt_softmax_xent_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                             ctypes.c_float, _I, _P),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 1024            # four 256-column chunks per warp
_ROWS_PER_BLOCK = 8      # one warp per row
_BWD_MAX_BLOCKS = 256    # partial rows of dw/db, added in a fixed order


def _ln_input(x, residual):
    """x + residual in f32 (x alone without one)."""
    xv = x.float()
    return xv if residual is None else xv + residual.float()


def layer_norm_fwd_reference(x, weight, bias, epsilon=1e-5, residual=None):
    """Plain forward of ``x (+ residual)``: ``(y, mean, rstd)`` with the
    kernel's one-pass f32 statistics; ``y`` in x's dtype, mean and rstd
    f32 ``(rows,)``."""
    d = x.shape[-1]
    xv = _ln_input(x, residual)
    mean = xv.sum(-1, keepdim=True) / d
    var = torch.clamp(torch.square(xv).sum(-1, keepdim=True) / d
                      - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + epsilon)
    y = (xv - mean) * rstd * weight.float() + bias.float()
    return y.to(x.dtype), mean[:, 0], rstd[:, 0]


def layer_norm_bwd_reference(g, x, weight, mean, rstd, residual=None):
    """Plain backward: ``(dx, dw, db)``; dx in x's dtype (it is also the
    residual's gradient), dw and db summed over rows in f32 and cast to
    w's dtype."""
    d = x.shape[-1]
    gv = g.float()
    xhat = (_ln_input(x, residual) - mean[:, None]) * rstd[:, None]
    dy = gv * weight.float()
    c1 = dy.sum(-1, keepdim=True) / d
    c2 = (dy * xhat).sum(-1, keepdim=True) / d
    dx = (dy - c1 - xhat * c2) * rstd[:, None]
    dw = (gv * xhat).sum(0)
    db = gv.sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def _require(cond, msg, kernel="layer_norm"):
    if not cond:
        raise ValueError(f"{kernel} kernel: {msg}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _check(x, weight, *same, residual=None):
    """What both kernels take: CUDA, x, weight, ``same`` (bias, or g) and
    the residual (if any) of one dtype (f32 or bf16), contiguous and
    16-byte aligned, x ``(rows, d)`` with ``0 < d <= 1024`` and
    ``d % 8 == 0``, weight ``(d,)``, the residual of x's shape."""
    dev = x.device
    _require(dev.type == "cuda", f"x is on {dev}, not a CUDA device")
    _require(x.dim() == 2, f"x must be 2-D (rows, d), got {tuple(x.shape)}")
    _require(x.dtype in _DTYPE_CODE,
             f"dtype {x.dtype} not in (float32, bfloat16)")
    rows, d = x.shape
    _require(0 < d <= _MAX_D and d % 8 == 0,
             f"d={d} must be a multiple of 8 in (0, {_MAX_D}]")
    _require(weight.shape == (d,), f"weight must be ({d},)")
    if residual is not None:
        _require(residual.shape == x.shape, f"the residual must have x's "
                 f"shape {tuple(x.shape)}, got {tuple(residual.shape)}")
        same = (*same, residual)
    for t in (x, weight, *same):
        _require(t.device == dev, "all inputs must be on one CUDA device")
        _require(t.is_contiguous(), "inputs must be contiguous")
        _require(t.dtype == x.dtype, f"{t.dtype} does not match x {x.dtype}")
        _require(t.data_ptr() % 16 == 0, "inputs must be 16-byte aligned")
    return dev, rows, d


def _launch_fwd(x, weight, bias, epsilon, residual=None):
    dev, rows, d = _check(x, weight, bias, residual=residual)
    _require(bias.shape == (d,), f"bias must be ({d},)")
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=dev)
    rstd = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows == 0:
        return y, mean, rstd
    lib = _build.load("layer_norm", _SIGNATURES)
    status = lib.ptt_layer_norm_fwd(
        x.data_ptr(), _ptr(residual), weight.data_ptr(), bias.data_ptr(),
        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, d,
        float(epsilon), _DTYPE_CODE[x.dtype], _stream(dev))
    _build.check(lib, status, "layer_norm_fwd")
    return y, mean, rstd


def _launch_bwd(g, x, weight, mean, rstd, residual=None):
    dev, rows, d = _check(x, weight, g, residual=residual)
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
        g.data_ptr(), x.data_ptr(), _ptr(residual), weight.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        db.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), rows, d,
        nparts, _DTYPE_CODE[x.dtype], _stream(dev))
    _build.check(lib, status, "layer_norm_bwd")
    return dx, dw, db


def layer_norm_fwd(x, weight, bias, epsilon=1e-5, residual=None):
    """LayerNorm forward of a ``(rows, d)`` x, or of ``x + residual``:
    ``(y, mean, rstd)``.  The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  ``layer_norm_fwd.launches`` counts kernel
    launches, ``.residual_launches`` those with a residual."""
    if x.device.type == "cpu":
        return layer_norm_fwd_reference(x, weight, bias, epsilon, residual)
    out = _launch_fwd(x, weight, bias, epsilon, residual)
    layer_norm_fwd.launches += 1
    layer_norm_fwd.residual_launches += residual is not None
    return out


layer_norm_fwd.launches = 0
layer_norm_fwd.residual_launches = 0


def layer_norm_bwd(g, x, weight, mean, rstd, residual=None):
    """LayerNorm backward: ``(dx, dw, db)`` from the output gradient and
    the forward's saved statistics (and its residual, if it had one).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``layer_norm_bwd.launches`` counts kernel launches,
    ``.residual_launches`` those with a residual."""
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(g, x, weight, mean, rstd, residual)
    out = _launch_bwd(g, x, weight, mean, rstd, residual)
    layer_norm_bwd.launches += 1
    layer_norm_bwd.residual_launches += residual is not None
    return out


layer_norm_bwd.launches = 0
layer_norm_bwd.residual_launches = 0


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, residual, epsilon):
        y, mean, rstd = layer_norm_fwd(x, weight, bias, epsilon, residual)
        ctx.save_for_backward(x, weight, residual, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, residual, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(g.contiguous(), x, weight, mean, rstd,
                                    residual)
        dr = None if residual is None else dx.to(residual.dtype)
        return dx, dw, db, dr, None


def fused_layer_norm(x, weight, bias, epsilon=1e-5, residual=None):
    """LayerNorm over the last axis of a 2-D ``(rows, d)`` x, or of ``x +
    residual`` (summed in f32, never stored), with gradients for x,
    weight, bias and the residual; output in x's dtype."""
    if x.dim() != 2:
        raise ValueError(f"fused_layer_norm expects 2-D input, got "
                         f"{tuple(x.shape)}")
    return _LayerNorm.apply(x, weight, bias, residual, float(epsilon))


# -- softmax cross-entropy ---------------------------------------------------

def softmax_xent_fwd_reference(logits, labels, ignore_index=-100,
                               label_smoothing=0.0):
    """Plain forward: ``(loss, lse)``, both f32 ``(rows,)``, of ``(rows,
    V)`` logits against int ``(rows,)`` labels."""
    x = logits.float()
    v = x.shape[-1]
    m = x.amax(-1)
    shift = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    l = torch.exp(x - shift[:, None]).sum(-1)
    lse = shift + torch.log(torch.where(l == 0, torch.ones_like(l), l))
    lab = labels.long()
    t = x.gather(-1, lab.clamp(0, v - 1)[:, None])[:, 0]
    if label_smoothing > 0.0:
        loss = (lse - (1.0 - label_smoothing) * t
                - label_smoothing * (x.sum(-1) / v))
    else:
        loss = lse - t
    return torch.where(lab != ignore_index, loss, torch.zeros_like(loss)), lse


def softmax_xent_bwd_reference(g, logits, labels, lse, ignore_index=-100,
                               label_smoothing=0.0):
    """Plain backward: dlogits in the logits' dtype from the f32 ``(rows,)``
    output gradient ``g`` and the forward's lse; 0 on ignored rows."""
    x = logits.float()
    v = x.shape[-1]
    lab = labels.long()
    p = torch.exp(x - lse[:, None])
    onehot = torch.nn.functional.one_hot(lab.clamp(0, v - 1), v).float()
    grad = p - (1.0 - label_smoothing) * onehot
    if label_smoothing > 0.0:
        grad = grad - label_smoothing / v
    valid = (lab != ignore_index)[:, None]
    dx = g.float()[:, None] * torch.where(valid, grad, torch.zeros_like(grad))
    return dx.to(logits.dtype)


def _check_xent(x, labels, *stats):
    """What both kernels take: CUDA, x ``(rows, V)`` f32 or bf16,
    contiguous and 16-byte aligned; int32 labels and each f32 ``stats``
    tensor (lse, g) contiguous ``(rows,)`` on x's device."""
    dev = x.device

    def req(cond, msg):
        _require(cond, msg, "softmax_xent")

    req(dev.type == "cuda", f"x is on {dev}, not a CUDA device")
    req(x.dim() == 2 and x.shape[1] > 0,
        f"x must be 2-D (rows, V) with V > 0, got {tuple(x.shape)}")
    req(x.dtype in _DTYPE_CODE, f"dtype {x.dtype} not in (float32, bfloat16)")
    req(x.is_contiguous() and x.data_ptr() % 16 == 0,
        "x must be contiguous and 16-byte aligned")
    rows, v = x.shape
    req(rows < 2 ** 31 and v < 2 ** 31, f"rows and V must fit in int32")
    for t, dtype, name in ((labels, torch.int32, "labels"),
                           *((s, torch.float32, "lse and g") for s in stats)):
        req(t.device == dev and t.dtype == dtype and t.shape == (rows,)
            and t.is_contiguous(),
            f"{name} must be contiguous {dtype} ({rows},) on {dev}")
    return dev, rows, v


def _launch_xent_fwd(x, labels, ignore_index, label_smoothing):
    dev, rows, v = _check_xent(x, labels)
    loss = torch.empty(rows, dtype=torch.float32, device=dev)
    lse = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows == 0:
        return loss, lse
    lib = _build.load("softmax_xent", _XENT_SIGNATURES)
    status = lib.ptt_softmax_xent_fwd(
        x.data_ptr(), labels.data_ptr(), loss.data_ptr(), lse.data_ptr(),
        rows, v, int(ignore_index), float(label_smoothing),
        _DTYPE_CODE[x.dtype], _stream(dev))
    _build.check(lib, status, "softmax_xent_fwd")
    return loss, lse


def _launch_xent_bwd(g, x, labels, lse, ignore_index, label_smoothing):
    dev, rows, v = _check_xent(x, labels, lse, g)
    dx = torch.empty_like(x)
    if rows == 0:
        return dx
    lib = _build.load("softmax_xent", _XENT_SIGNATURES)
    # 1 - ls and ls / V rounded to f32 once, as the plain version's
    # scalars are
    status = lib.ptt_softmax_xent_bwd(
        x.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dx.data_ptr(), rows, v, int(ignore_index),
        1.0 - label_smoothing, label_smoothing / v, _DTYPE_CODE[x.dtype],
        _stream(dev))
    _build.check(lib, status, "softmax_xent_bwd")
    return dx


def softmax_xent_fwd(logits, labels, ignore_index=-100, label_smoothing=0.0):
    """Softmax cross-entropy forward of ``(rows, V)`` logits: ``(loss,
    lse)``, f32 ``(rows,)``.  The kernel takes int32 labels.  The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors;
    ``softmax_xent_fwd.launches`` counts kernel launches."""
    if logits.device.type == "cpu":
        return softmax_xent_fwd_reference(logits, labels, ignore_index,
                                          label_smoothing)
    out = _launch_xent_fwd(logits, labels, ignore_index, label_smoothing)
    softmax_xent_fwd.launches += 1
    return out


softmax_xent_fwd.launches = 0


def softmax_xent_bwd(g, logits, labels, lse, ignore_index=-100,
                     label_smoothing=0.0):
    """Softmax cross-entropy backward: dlogits in the logits' dtype from
    the f32 ``(rows,)`` output gradient and the forward's lse.  The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors;
    ``softmax_xent_bwd.launches`` counts kernel launches."""
    if logits.device.type == "cpu":
        return softmax_xent_bwd_reference(g, logits, labels, lse,
                                          ignore_index, label_smoothing)
    out = _launch_xent_bwd(g, logits, labels, lse, ignore_index,
                           label_smoothing)
    softmax_xent_bwd.launches += 1
    return out


softmax_xent_bwd.launches = 0


class _SoftmaxXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, ignore_index, label_smoothing):
        loss, lse = softmax_xent_fwd(logits, labels, ignore_index,
                                     label_smoothing)
        ctx.save_for_backward(logits, labels, lse)
        ctx.opts = (ignore_index, label_smoothing)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        dx = softmax_xent_bwd(g.float().contiguous(), logits, labels, lse,
                              *ctx.opts)
        return dx, None, None, None


def fused_softmax_xent(logits, labels, *, ignore_index=-100,
                       label_smoothing=0.0):
    """Per-row softmax cross-entropy of 2-D ``(rows, V)`` logits against
    int ``(rows,)`` labels (int64 or int32, converted to int32 once):
    f32 ``(rows,)``, 0 where the label is ``ignore_index`` (the caller
    owns the mean over valid rows).  Differentiable in the logits."""
    if logits.dim() != 2:
        raise ValueError(f"fused_softmax_xent expects 2-D logits, got "
                         f"{tuple(logits.shape)}")
    labels = labels.reshape(logits.shape[0]).to(torch.int32).contiguous()
    return _SoftmaxXent.apply(logits.contiguous(), labels, int(ignore_index),
                              float(label_smoothing))
