"""Fused LayerNorm, softmax cross-entropy and the fusion pass's block
kernels: plain PyTorch and CUDA kernel pairs.

The counterpart of ``paddle_tpu/ops/fused_kernels.py``.

**LayerNorm** (``fused_layer_norm``, its custom VJP ``_ln`` and
``layer_norm_reference``): ``(x, w, b)`` over a 2-D ``(rows, d)`` view,
with or without a ``residual`` added before the statistics, w and b
each optional (the no-affine variant), all f32 or all bf16.  Arithmetic
of the TPU kernel, kept by both versions here:

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

**LayerNorm + matmul** (``fused_ln_matmul``, the custom VJP ``_lnmm``,
``ln_matmul_reference``): ``LayerNorm(x (+ r)) @ W (+ bias)``, W ``(d,
n)`` read in place by its strides (a Linear's weight, or a table's
transposed view), at any d and n (``_gemm_weight`` says which weights
are copied).  The LayerNorm's arithmetic as above, its output h
**rounded to x's dtype** before the product, f32 sums, the bias added in
f32, the result in x's dtype.  The backward (``_lnmm_bwd``) recomputes
h, mean and rstd with the LayerNorm forward kernel, takes ``dW = h^T g``,
``dh = g W^T`` and the bias's f32 column sum with ``torch.matmul`` and
reductions, and dx, the LayerNorm's dw and db with the LayerNorm
backward kernel; the residual's gradient is dx.

**Matmul + bias + gelu** (``fused_matmul_bias_gelu``, ``_mbg``,
``matmul_bias_gelu_reference``): ``z = x @ W (+ bias)`` summed in f32,
``y = gelu(z)`` on the f32 sum in the tanh or the erf form
(``_gelu_f32``); the kernel stores y and z, both in x's dtype.  The
backward (``_mbg_bwd``) takes gelu' at the saved z in f32, then the
product's gradients with ``torch.matmul``.

For each kernel:

 - ``*_reference``: the plain version.  Tests and ``chip_smoke.py`` hold
   the kernels against it; no CUDA path calls it.
 - :func:`layer_norm_fwd` / :func:`layer_norm_bwd` /
   :func:`softmax_xent_fwd` / :func:`softmax_xent_bwd` /
   :func:`ln_matmul` / :func:`matmul_bias_gelu`: the CUDA kernels of
   ``csrc/layer_norm.cu``, ``csrc/softmax_xent.cu`` and
   ``csrc/block_gemm.cu`` on CUDA tensors, the plain versions on CPU
   tensors, and nothing else.  Each counts its launches in
   ``.launches``; the LayerNorm wrappers count their residual launches
   again in ``.residual_launches``.
 - :func:`fused_layer_norm` / :func:`fused_softmax_xent` /
   :func:`fused_ln_matmul` / :func:`fused_matmul_bias_gelu`: the
   ``torch.autograd.Function``s that tie them: the forward saves what
   the backward reads (the statistics, lse, or the pre-activation z),
   the backward runs the backward wrappers.
 - :func:`fused_attention_block`: the attention cluster as the flash
   kernels (:mod:`.pallas_ops`) at every length.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_layer_norm", "layer_norm_fwd", "layer_norm_bwd",
           "layer_norm_fwd_reference", "layer_norm_bwd_reference",
           "ln_fwd_plan", "layer_norm_fwd_lane_reference",
           "ln_bwd_plan", "layer_norm_bwd_split_reference",
           "fused_softmax_xent", "softmax_xent_fwd", "softmax_xent_bwd",
           "softmax_xent_fwd_reference", "softmax_xent_bwd_reference",
           "fused_ln_matmul", "ln_matmul", "ln_matmul_reference",
           "fused_matmul_bias_gelu", "matmul_bias_gelu",
           "matmul_bias_gelu_reference", "fused_attention_block"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptt_layer_norm_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                           ctypes.c_float, _I, _I, _I, _P),
    "ptt_layer_norm_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _I, _I, _I, _P),
}
_XENT_SIGNATURES = {
    "ptt_softmax_xent_fwd": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I,
                             _P),
    "ptt_softmax_xent_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                             ctypes.c_float, _I, _P),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_PER_BLOCK = 8      # one warp per row
_FWD_BLOCKS = 528        # the forward's most blocks: four on each of 132 SMs
_BWD_MAX_BLOCKS = 256    # the register backward's partial rows of dw/db
_REGISTER_MAX_D = 1024   # the register backward: d <= 1024, d % 8 == 0
_ONE_PASS_PARTS = 128    # the one-pass backward's most partial rows
_REDUCE_SLICES = 8       # ln_bwd_reduce_kernel's row slices (kSlices)


def _ln_input(x, residual):
    """x + residual in f32 (x alone without one)."""
    xv = x.float()
    return xv if residual is None else xv + residual.float()


def _ln_affine(x, weight, bias, epsilon, residual):
    """``(x (+ residual) - mean) * rstd (* weight) (+ bias)`` in f32, with
    the kernel's one-pass f32 statistics: ``(h, mean, rstd)``, mean and
    rstd ``(rows, 1)``."""
    d = x.shape[-1]
    xv = _ln_input(x, residual)
    mean = xv.sum(-1, keepdim=True) / d
    var = torch.clamp(torch.square(xv).sum(-1, keepdim=True) / d
                      - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + epsilon)
    h = (xv - mean) * rstd
    if weight is not None:
        h = h * weight.float()
    if bias is not None:
        h = h + bias.float()
    return h, mean, rstd


def layer_norm_fwd_reference(x, weight, bias, epsilon=1e-5, residual=None):
    """Plain forward of ``x (+ residual)``: ``(y, mean, rstd)`` with the
    kernel's one-pass f32 statistics; ``y`` in x's dtype, mean and rstd
    f32 ``(rows,)``.  ``weight`` and ``bias`` may each be None (no
    scale, no shift)."""
    y, mean, rstd = _ln_affine(x, weight, bias, epsilon, residual)
    return y.to(x.dtype), mean[:, 0], rstd[:, 0]


def layer_norm_bwd_reference(g, x, weight, mean, rstd, residual=None):
    """Plain backward: ``(dx, dw, db)``; dx in x's dtype (it is also the
    residual's gradient), dw and db summed over rows in f32 and cast to
    w's dtype (x's without a weight).  Without a weight ``dy = g`` and
    dw is None; the caller drops db when the forward had no bias."""
    d = x.shape[-1]
    gv = g.float()
    xhat = (_ln_input(x, residual) - mean[:, None]) * rstd[:, None]
    dy = gv if weight is None else gv * weight.float()
    c1 = dy.sum(-1, keepdim=True) / d
    c2 = (dy * xhat).sum(-1, keepdim=True) / d
    dx = (dy - c1 - xhat * c2) * rstd[:, None]
    wdt = x.dtype if weight is None else weight.dtype
    dw = None if weight is None else (gv * xhat).sum(0).to(wdt)
    return dx.to(x.dtype), dw, gv.sum(0).to(wdt)


def layer_norm_fwd_lane_reference(x, weight, bias, epsilon=1e-5,
                                  residual=None):
    """A plain model of the forward kernel's sum order: ``(y, mean,
    rstd)`` as :func:`layer_norm_fwd_reference` returns them.  One warp
    takes a row; lane ``l`` owns the columns ``c * 32 V + l * V + i``
    (``V`` = 8 where ``d % 8 == 0``, else 1) and adds them, chunk ``c`` by
    chunk and ``i`` in order, into its f32 sums of ``x`` and ``x^2``; an
    xor butterfly (offsets 16, 8, 4, 2, 1) adds the 32 lanes' sums.  (The
    card may round ``x * x + s`` once, a fused multiply-add, where this
    rounds twice.)"""
    rows, d = x.shape
    vec = 8 if d % 8 == 0 else 1
    chunk = 32 * vec
    xv = _ln_input(x, residual)
    cols = torch.zeros(rows, -(-d // chunk) * chunk, device=x.device)
    cols[:, :d] = xv           # a zero column adds nothing to either sum
    cols = cols.reshape(rows, -1, 32, vec)
    s1 = torch.zeros(rows, 32, device=x.device)
    s2 = torch.zeros(rows, 32, device=x.device)
    for c in range(cols.shape[1]):
        for i in range(vec):
            s1 = s1 + cols[:, c, :, i]
            s2 = s2 + cols[:, c, :, i] * cols[:, c, :, i]
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        s1 = s1 + s1[:, lanes ^ o]
        s2 = s2 + s2[:, lanes ^ o]
    mean = s1[:, :1] / d
    rstd = torch.rsqrt(torch.clamp(s2[:, :1] / d - mean * mean, min=0.0)
                       + epsilon)
    h = (xv - mean) * rstd
    if weight is not None:
        h = h * weight.float()
    if bias is not None:
        h = h + bias.float()
    return h.to(x.dtype), mean[:, 0], rstd[:, 0]


def ln_fwd_plan(rows):
    """The LayerNorm forward's row partition: ``(nblocks, per)``, block p
    owning rows ``[p * per, min((p + 1) * per, rows))``, at most
    ``_FWD_BLOCKS`` blocks (four an SM of an H100, where the kernel's
    stages let four stay).  A row is one warp's, so its bits never depend
    on the partition; the partition reads the row count alone, so the
    grid does not depend on the card either."""
    per = -(-rows // _FWD_BLOCKS)
    return -(-rows // per), per


def ln_bwd_plan(rows, d):
    """The LayerNorm backward's row partition: ``(nparts, per)``, one f32
    partial row of dw and db per block.  The register kernel (``d <=
    1024``, ``d % 8 == 0``) runs ``nparts = min(ceil(rows / 8), 256)``
    blocks over the rows grid-stride; the one-pass kernel (every other d)
    gives block p the rows ``[p * per, min((p + 1) * per, rows))``, ``per``
    a multiple of 8 (a block's partial row of 8 bytes a column then costs
    at most one eighth of its rows' reads), at most ``_ONE_PASS_PARTS``
    blocks: more cost more partial rows, fewer leave SMs idle.  Both read the
    row count (and d) alone, so dw and db have the same bits on every
    run and every card."""
    if d % 8 == 0 and d <= _REGISTER_MAX_D:
        nparts = min(-(-rows // _ROWS_PER_BLOCK), _BWD_MAX_BLOCKS)
        return nparts, -(-rows // nparts)
    per = -(-rows // _ONE_PASS_PARTS)
    per = -(-per // 8) * 8
    return -(-rows // per), per


def layer_norm_bwd_split_reference(g, x, weight, mean, rstd, residual=None):
    """A plain model of the one-pass backward's sums of dw and db: block p
    of :func:`ln_bwd_plan` adds ``g * xhat`` and ``g`` over its rows in
    order into one f32 partial row; then, per column, slice s (of 8) adds
    the partial rows s, s + 8, ... in order, and the slices are added in
    order (``ln_bwd_reduce_kernel``).  ``(dx, dw, db)`` as
    :func:`layer_norm_bwd_reference` returns them (dx from it)."""
    rows, d = x.shape
    if d % 8 == 0 and d <= _REGISTER_MAX_D:
        raise ValueError(f"d={d} takes the register kernel, not this plan")
    dx, _, _ = layer_norm_bwd_reference(g, x, weight, mean, rstd, residual)
    gv = g.float()
    xhat = (_ln_input(x, residual) - mean[:, None]) * rstd[:, None]
    nparts, per = ln_bwd_plan(rows, d)
    parts_w = torch.zeros(nparts, d, device=x.device)
    parts_b = torch.zeros(nparts, d, device=x.device)
    for p in range(nparts):
        for row in range(p * per, min((p + 1) * per, rows)):
            parts_w[p] = parts_w[p] + gv[row] * xhat[row]
            parts_b[p] = parts_b[p] + gv[row]
    sums = []
    for parts in (parts_w, parts_b):
        total = torch.zeros(d, device=x.device)
        for sl in range(_REDUCE_SLICES):
            acc = torch.zeros(d, device=x.device)
            for p in range(sl, nparts, _REDUCE_SLICES):
                acc = acc + parts[p]
            total = total + acc
        sums.append(total)
    wdt = x.dtype if weight is None else weight.dtype
    dw = None if weight is None else sums[0].to(wdt)
    return dx, dw, sums[1].to(wdt)


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
    16-byte aligned, x ``(rows, d)`` with any ``d > 0``, weight ``(d,)``,
    the residual of x's shape.  A None weight or bias is the no-affine
    variant."""
    dev = x.device
    _require(dev.type == "cuda", f"x is on {dev}, not a CUDA device")
    _require(x.dim() == 2, f"x must be 2-D (rows, d), got {tuple(x.shape)}")
    _require(x.dtype in _DTYPE_CODE,
             f"dtype {x.dtype} not in (float32, bfloat16)")
    rows, d = x.shape
    _require(d > 0, f"d={d} must be positive")
    _require(weight is None or weight.shape == (d,), f"weight must be ({d},)")
    if residual is not None:
        _require(residual.shape == x.shape, f"the residual must have x's "
                 f"shape {tuple(x.shape)}, got {tuple(residual.shape)}")
        same = (*same, residual)
    for t in (x, weight, *same):
        if t is None:
            continue
        _require(t.device == dev, "all inputs must be on one CUDA device")
        _require(t.is_contiguous(), "inputs must be contiguous")
        _require(t.dtype == x.dtype, f"{t.dtype} does not match x {x.dtype}")
        _require(t.data_ptr() % 16 == 0, "inputs must be 16-byte aligned")
    return dev, rows, d


def _launch_fwd(x, weight, bias, epsilon, residual=None):
    dev, rows, d = _check(x, weight, bias, residual=residual)
    _require(bias is None or bias.shape == (d,), f"bias must be ({d},)")
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=dev)
    rstd = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows == 0:
        return y, mean, rstd
    lib = _build.load("layer_norm", _SIGNATURES)
    status = lib.ptt_layer_norm_fwd(
        x.data_ptr(), _ptr(residual), _ptr(weight), _ptr(bias),
        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, d,
        float(epsilon), *ln_fwd_plan(rows), _DTYPE_CODE[x.dtype],
        _stream(dev))
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
    wdt = x.dtype if weight is None else weight.dtype
    dw = None if weight is None else torch.empty(d, dtype=wdt, device=dev)
    db = torch.empty(d, dtype=wdt, device=dev)
    if rows == 0:
        return dx, None if dw is None else dw.zero_(), db.zero_()
    nparts, per = ln_bwd_plan(rows, d)
    parts = torch.empty((2, nparts, d), dtype=torch.float32, device=dev)
    lib = _build.load("layer_norm", _SIGNATURES)
    status = lib.ptt_layer_norm_bwd(
        g.data_ptr(), x.data_ptr(), _ptr(residual), _ptr(weight),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), _ptr(dw),
        db.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), rows, d,
        nparts, per, _DTYPE_CODE[x.dtype], _stream(dev))
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
        return dx, dw, db if ctx.needs_input_grad[2] else None, dr, None


def fused_layer_norm(x, weight=None, bias=None, epsilon=1e-5, residual=None):
    """LayerNorm over the last axis of a 2-D ``(rows, d)`` x, or of ``x +
    residual`` (summed in f32, never stored), with gradients for x,
    weight, bias and the residual; output in x's dtype.  ``weight`` and
    ``bias`` may each be None (the no-affine variant)."""
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


# -- the fusion pass's block kernels -------------------------------------------

_GEMM_SIGNATURES = {
    "ptt_ln_matmul": (_P,) * 7 + (_I, _I, _I, _I, ctypes.c_longlong,
                                  ctypes.c_longlong, ctypes.c_float, _I, _P,
                                  _P),
    "ptt_matmul_bias_gelu": (_P,) * 5 + (_I, _I, _I, ctypes.c_longlong,
                                         ctypes.c_longlong, ctypes.c_longlong,
                                         _I, _I, _P),
}
_SQRT_2_OVER_PI = 0.7978845608028654
_TANH_CUBIC = 0.044715
_SQRT_HALF = 0.7071067811865476


def _gelu_f32(z, approximate):
    """gelu of an f32 tensor, the tanh form or the erf form, as the TPU
    kernel's ``_gelu_f32`` writes them."""
    if approximate:
        inner = _SQRT_2_OVER_PI * (z + _TANH_CUBIC * z * z * z)
        return 0.5 * z * (1.0 + torch.tanh(inner))
    return 0.5 * z * (1.0 + torch.erf(z * _SQRT_HALF))


def ln_matmul_reference(x, weight, ln_weight=None, ln_bias=None, bias=None,
                        residual=None, epsilon=1e-5):
    """Plain ``LayerNorm(x (+ residual)) @ weight (+ bias)`` with the
    kernel's arithmetic: the sum and the one-pass statistics in f32, the
    LayerNorm output h rounded to x's dtype, an f32 product, the bias
    added in f32, the result in x's dtype.  x ``(rows, d)``, weight
    ``(d, n)``."""
    h, _, _ = _ln_affine(x, ln_weight, ln_bias, epsilon, residual)
    acc = torch.matmul(h.to(x.dtype).float(), weight.float())
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(x.dtype)


def matmul_bias_gelu_reference(x, weight, bias=None, approximate=True):
    """Plain ``(gelu(z), z)`` with ``z = x @ weight (+ bias)`` summed in
    f32, gelu taken on the f32 sum; both in x's dtype (z is what the
    backward reads)."""
    z = torch.matmul(x.float(), weight.float())
    if bias is not None:
        z = z + bias.float()
    return _gelu_f32(z, approximate).to(x.dtype), z.to(x.dtype)


def _check_gemm(x, weight, bias, *more, kernel):
    """What the block kernels take: CUDA, x ``(rows, k)`` contiguous, the
    weight ``(k, n)`` with unit stride along n or along k (a transposed
    view is read in place) and its other stride a multiple of 16 bytes,
    the bias ``(n,)`` and ``more`` (the LayerNorm's weight and bias, the
    residual) of one dtype (f32 or bf16), 16-byte aligned; k a multiple
    of 8, any n and any row count below 2^31.  Returns ``(rows, k, n,
    sw_k, sw_n)``."""
    def req(cond, msg):
        _require(cond, msg, kernel)

    dev = x.device
    req(dev.type == "cuda", f"x is on {dev}, not a CUDA device")
    req(x.dim() == 2 and weight.dim() == 2,
        f"x and weight must be 2-D, got {tuple(x.shape)} and "
        f"{tuple(weight.shape)}")
    req(x.dtype in _DTYPE_CODE, f"dtype {x.dtype} not in (float32, bfloat16)")
    rows, k = x.shape
    n = weight.shape[1]
    vec = 16 // x.element_size()
    req(weight.shape[0] == k, f"weight {tuple(weight.shape)} does not take "
        f"x's {k} columns")
    req(k % 8 == 0, f"k={k} must be a multiple of 8")
    req(rows < 2 ** 31 and 0 < k and 0 < n < 2 ** 31,
        f"({rows}, {k}) @ ({k}, {n}) is out of range")
    sw_k, sw_n = weight.stride()
    req((sw_n == 1 and sw_k % vec == 0) or (sw_k == 1 and sw_n % vec == 0),
        f"weight strides {weight.stride()} need unit stride along k or n "
        f"and the other a multiple of {vec} (16-byte aligned rows)")
    req(x.is_contiguous(), "x must be contiguous")
    for t in (x, weight, bias, *more):
        if t is None:
            continue
        req(t.device == dev, "all inputs must be on one CUDA device")
        req(t.dtype == x.dtype, f"{t.dtype} does not match x {x.dtype}")
        req(t.data_ptr() % 16 == 0, "inputs must be 16-byte aligned")
    for t in (bias, *more[:2]):
        if t is not None:
            req(t.is_contiguous() and t.dim() == 1,
                "the biases and LayerNorm weights must be contiguous 1-D")
    req(bias is None or bias.shape == (n,), f"bias must be ({n},)")
    return rows, k, n, sw_k, sw_n


def _aligned(t):
    """``t``, or a copy of it where its start is not 16-byte aligned (as
    the reference pads its inputs)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _pad_k(t, kp, dim):
    """``t`` with zeros after its entries along ``dim`` up to ``kp``, a
    new contiguous tensor (None stays None)."""
    if t is None:
        return None
    shape = list(t.shape)
    shape[dim] = kp
    out = t.new_zeros(shape)
    out[(slice(None),) * dim + (slice(0, t.shape[dim]),)] = t
    return out


def _round_up(n, m):
    return -(-n // m) * m


def _gemm_weight(weight, kd):
    """The ``(kd, n)`` weight as the kernels read it.  In place when it
    has unit stride along n or k and its other stride is a multiple of
    16 bytes (a Linear weight of such a width; the transposed view of an
    embedding table, BERT's tied decoder, at any n).  Otherwise (k off a
    multiple of 8, or a Linear weight whose rows are not 16 bytes apart,
    n off a multiple of 16 bytes) a zero-padded copy, ``(kp, np)`` with
    ``kp`` and ``np`` the next multiples of 8 and 16 bytes, returned as
    its ``(kp, n)`` view: the zero rows add nothing to the products, and
    the kernels read no column past n.  That copy reads and writes the
    weight once a call (``k * n`` elements in, ``kp * np`` out)."""
    if weight.dim() != 2 or weight.shape[0] != kd:
        return weight    # _check_gemm names the fault
    kp = _round_up(kd, 8)
    vec = 16 // weight.element_size()
    sw_k, sw_n = weight.stride()
    if kp == kd and ((sw_n == 1 and sw_k % vec == 0)
                     or (sw_k == 1 and sw_n % vec == 0)):
        return weight
    n = weight.shape[1]
    npad = _round_up(n, vec)
    out = weight.new_zeros((kp, npad))
    out[:kd, :n] = weight
    return out if npad == n else out[:, :n]


def _launch_ln_matmul(x, weight, ln_weight, ln_bias, bias, residual, epsilon):
    kd = x.shape[-1]     # the LayerNorm's width
    for t, what in ((ln_weight, "the LayerNorm weight"),
                    (ln_bias, "the LayerNorm bias")):
        _require(t is None or t.shape == (kd,), f"{what} must be ({kd},)",
                 "ln_matmul")
    _require(residual is None or (residual.shape == x.shape
                                  and residual.is_contiguous()),
             f"the residual must be contiguous {tuple(x.shape)}", "ln_matmul")
    if kd % 8 and x.dim() == 2:
        # any width: zero columns of x, the residual and the LayerNorm's
        # weight and bias, and zero rows of W, up to a multiple of 8 add
        # nothing to the row sums or the products; the kernel divides the
        # statistics by kd
        kp = _round_up(kd, 8)
        x, residual = _pad_k(x, kp, 1), _pad_k(residual, kp, 1)
        ln_weight, ln_bias = _pad_k(ln_weight, kp, 0), _pad_k(ln_bias, kp, 0)
    weight = _gemm_weight(weight, kd)
    x, residual = _aligned(x), _aligned(residual)
    rows, k, n, sw_k, sw_n = _check_gemm(
        x, weight, bias, ln_weight, ln_bias, residual, kernel="ln_matmul")
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if rows == 0:
        return y
    # bf16: the rows' mean and rstd, computed before the product
    stats = (torch.empty((2 * rows,), dtype=torch.float32, device=x.device)
             if x.dtype == torch.bfloat16 else None)
    lib = _build.load("block_gemm", _GEMM_SIGNATURES)
    status = lib.ptt_ln_matmul(
        x.data_ptr(), _ptr(residual), _ptr(ln_weight), _ptr(ln_bias),
        weight.data_ptr(), _ptr(bias), y.data_ptr(), rows, k, kd, n, sw_k,
        sw_n, float(epsilon), _DTYPE_CODE[x.dtype], _ptr(stats),
        _stream(x.device))
    _build.check(lib, status, "ln_matmul")
    return y


def _launch_matmul_bias_gelu(x, weight, bias, approximate):
    k = x.shape[-1]
    if k % 8 and x.dim() == 2:
        # any k: zero columns of x and zero rows of W add nothing
        x = _pad_k(x, _round_up(k, 8), 1)
    weight = _gemm_weight(weight, k)
    x = _aligned(x)
    rows, k, n, sw_k, sw_n = _check_gemm(x, weight, bias,
                                         kernel="matmul_bias_gelu")
    # the TMA store writes rows 16 bytes apart: y and z are allocated at
    # the next multiple of 16 bytes and returned as their (rows, n) views
    ldy = _round_up(n, 16 // x.element_size())
    y = torch.empty((rows, ldy), dtype=x.dtype, device=x.device)
    z = torch.empty_like(y)
    if ldy != n:
        y, z = y[:, :n], z[:, :n]
    if rows == 0:
        return y, z
    lib = _build.load("block_gemm", _GEMM_SIGNATURES)
    status = lib.ptt_matmul_bias_gelu(
        x.data_ptr(), weight.data_ptr(), _ptr(bias), y.data_ptr(),
        z.data_ptr(), rows, k, n, sw_k, sw_n, ldy, int(bool(approximate)),
        _DTYPE_CODE[x.dtype], _stream(x.device))
    _build.check(lib, status, "matmul_bias_gelu")
    return y, z


def ln_matmul(x, weight, ln_weight=None, ln_bias=None, bias=None,
              residual=None, epsilon=1e-5):
    """``LayerNorm(x (+ residual)) @ weight (+ bias)`` of a ``(rows, d)``
    x and a ``(d, n)`` weight: ``(rows, n)`` in x's dtype.  The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors;
    ``ln_matmul.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return ln_matmul_reference(x, weight, ln_weight, ln_bias, bias,
                                   residual, epsilon)
    out = _launch_ln_matmul(x, weight, ln_weight, ln_bias, bias, residual,
                            epsilon)
    ln_matmul.launches += 1
    return out


ln_matmul.launches = 0


def matmul_bias_gelu(x, weight, bias=None, approximate=True):
    """``(gelu(z), z)``, ``z = x @ weight (+ bias)``, of a ``(rows, k)`` x
    and a ``(k, n)`` weight, both in x's dtype (on the card, where n is
    not a multiple of 16 bytes, ``(rows, n)`` views of rows padded to
    one).  The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors;
    ``matmul_bias_gelu.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return matmul_bias_gelu_reference(x, weight, bias, approximate)
    out = _launch_matmul_bias_gelu(x, weight, bias, approximate)
    matmul_bias_gelu.launches += 1
    return out


matmul_bias_gelu.launches = 0


class _LnMatmul(torch.autograd.Function):
    """Forward: the LayerNorm + matmul kernel.  Backward (``_lnmm_bwd``):
    h, mean and rstd recomputed by the LayerNorm forward kernel (no
    ``(rows, d)`` activation kept), the product's gradients by
    ``torch.matmul`` with f32 sums, dx and the LayerNorm's dw, db by the
    LayerNorm backward kernel; the residual's gradient is dx."""

    @staticmethod
    def forward(ctx, x, weight, ln_weight, ln_bias, bias, residual, epsilon):
        y = ln_matmul(x, weight, ln_weight, ln_bias, bias, residual, epsilon)
        ctx.save_for_backward(x, weight, ln_weight, ln_bias, residual)
        ctx.epsilon = epsilon
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, ln_weight, ln_bias, residual = ctx.saved_tensors
        g = g.contiguous()
        h, mean, rstd = layer_norm_fwd(x, ln_weight, ln_bias, ctx.epsilon,
                                       residual)
        dw = torch.matmul(h.t(), g).to(weight.dtype)
        dmb = (None if ctx.bias_dtype is None
               else g.sum(0, dtype=torch.float32).to(ctx.bias_dtype))
        dh = torch.matmul(g, weight.t()).to(x.dtype)
        dx, dlw, dlb = layer_norm_bwd(dh, x, ln_weight, mean, rstd, residual)
        dr = None if residual is None else dx.to(residual.dtype)
        return (dx, dw, dlw, dlb if ln_bias is not None else None, dmb, dr,
                None)


class _MatmulBiasGelu(torch.autograd.Function):
    """Forward: the matmul + bias + gelu kernel, which also stores the
    pre-activation z.  Backward (``_mbg_bwd``): ``dz = g * gelu'(z)`` at the
    saved z, in f32 and rounded once to x's dtype (PyTorch's elementwise
    ``gelu_backward``, one pass), then the product's gradients by
    ``torch.matmul``."""

    @staticmethod
    def forward(ctx, x, weight, bias, approximate):
        y, z = matmul_bias_gelu(x, weight, bias, approximate)
        ctx.save_for_backward(x, weight, z)
        ctx.approximate = approximate
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, z = ctx.saved_tensors
        dz = torch.ops.aten.gelu_backward(
            g.to(z.dtype), z, approximate="tanh" if ctx.approximate else "none")
        dx = torch.matmul(dz, weight.t()).to(x.dtype)
        dw = torch.matmul(x.t(), dz).to(weight.dtype)
        db = (None if ctx.bias_dtype is None
              else dz.sum(0, dtype=torch.float32).to(ctx.bias_dtype))
        return dx, dw, db, None


def fused_ln_matmul(x, weight, ln_weight=None, ln_bias=None, bias=None,
                    residual=None, *, epsilon=1e-5):
    """(residual +) LayerNorm + matmul (+ bias) as one kernel launch,
    with gradients for every tensor: x ``(rows, d)``, weight ``(d, n)``
    (a transposed view is read in place), the rest optional; returns
    ``(rows, n)`` in x's dtype."""
    if x.dim() != 2 or weight.dim() != 2:
        raise ValueError(f"fused_ln_matmul expects 2-D x and weight, got "
                         f"{tuple(x.shape)} @ {tuple(weight.shape)}")
    if residual is not None:
        residual = residual.contiguous()
    return _LnMatmul.apply(x.contiguous(), weight, ln_weight, ln_bias, bias,
                           residual, float(epsilon))


def fused_matmul_bias_gelu(x, weight, bias=None, *, approximate=True):
    """``gelu(x @ weight + bias)`` with the activation on the f32 sum, as
    one kernel launch, with gradients for x, weight and bias: x ``(rows,
    k)``, weight ``(k, n)``; returns ``(rows, n)`` in x's dtype."""
    if x.dim() != 2 or weight.dim() != 2:
        raise ValueError(f"fused_matmul_bias_gelu expects 2-D x and weight, "
                         f"got {tuple(x.shape)} @ {tuple(weight.shape)}")
    return _MatmulBiasGelu.apply(x.contiguous(), weight, bias,
                                 bool(approximate))


def fused_attention_block(q, k, v, *, causal=False):
    """The attention score, softmax and weighted-sum cluster as the flash
    kernels ((B, H, S, D) layout, :func:`.pallas_ops.mha`, scale
    ``1 / sqrt(D)``), at every length."""
    from .pallas_ops import mha
    return mha(q, k, v, causal=causal)
