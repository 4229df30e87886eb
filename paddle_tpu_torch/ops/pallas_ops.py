"""Flash attention: plain PyTorch and a CUDA kernel triple.

The counterpart of the fixed-length part of ``paddle_tpu/ops/pallas_ops.py``
(``_fwd``, ``_bwd``, the custom VJP ``_flash``, ``mha`` and
``flash_attention``) for fixed lengths: ``q_len`` and ``kv_len`` equal or
not, causal or not, attention dropout on or off, any head size up to 128
(the kernels take 32, 64 and 128; the wrappers zero-pad the others up to
the next, as the TPU wrapper pads to 128 lanes, and slice the results
back).  The ``seq_lens``, ``causal_shift`` and lse-cotangent variants
(varlen and ring attention) are not ported.

Arithmetic of the TPU kernels, kept by both versions here:

 - scores ``s = q k^T * scale`` with f32 sums, masked to -1e30 (causal:
   key ``<= query``); ``lse = m + log(l)`` in f32, where ``l`` sums the
   undropped ``p = exp(s - m)`` and a row with ``l == 0`` divides by 1;
 - causal keeps key ``j`` for query ``i`` when ``j <= i + kv_len -
   q_len``: the diagonal aligned to the end (``_key_mask``);
 - dropout keeps an element when a hash of its global ``(bh, q, k)``
   coordinates passes the threshold (:func:`keep_mask`) and scales the
   kept ``p`` by ``1 / (1 - p_drop)`` in the numerator only;
 - ``p``, ``p~`` and ``ds`` are cast to the other operand's dtype before
   their products, which sum in f32;
 - the backward takes ``delta = rowsum(out * do)`` in f32, computed by
   the autograd function with plain torch ops, as the JAX ``_bwd`` does
   with ``jnp``.

 - :func:`mha_reference`, :func:`mha_dq_reference`,
   :func:`mha_dkv_reference` (and :func:`mha_bwd_reference`, which
   composes them): the plain versions on ``(B, H, S, D)``.  Tests and
   ``chip_smoke.py`` hold the kernels against them; no CUDA path calls
   them.
 - :func:`flash_fwd`, :func:`flash_bwd_dq`, :func:`flash_bwd_dkv`: the
   kernels of ``csrc/flash_attention.cu`` on CUDA tensors, the plain
   versions on CPU tensors, and nothing else, on paddle's
   ``(B, S, H, D)``.  Each counts its launches in ``.launches``.
 - :func:`mha` (``(B, H, S, D)``) and :func:`flash_attention`
   (``(B, S, H, D)``): attention with gradients through the autograd
   function ``_Flash``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["keep_mask", "draw_seed", "mha_reference", "mha_dq_reference",
           "mha_dkv_reference", "mha_bwd_reference", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv", "mha", "flash_attention"]

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_TAIL = (_P, _I, _I, _I, _I, _I, _F, _I, _F, _I, _I, _P)
_SIGNATURES = {
    "ptt_flash_fwd": (_P,) * 6 + _TAIL,
    "ptt_flash_bwd_dq": (_P,) * 8 + _TAIL,
    "ptt_flash_bwd_dkv": (_P,) * 9 + _TAIL,
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


# -- the dropout hash ------------------------------------------------------

def _mul32(x, c):
    """``x * c`` modulo 2**32 for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, without leaving int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def keep_mask(seed, bh, rows, cols, p_drop):
    """The keep mask of attention dropout (``_tile_keep_mask``): True
    where element ``(bh, rows, cols)`` survives.

    ``seed`` is an int or an int32 tensor; ``bh`` (the index
    ``b * H + h``), ``rows`` (query positions) and ``cols`` (key
    positions) are ints or integer tensors that broadcast together.  The
    hash runs in int64 masked to 32 bits, so its shifts are logical and
    its products wrap as uint32 arithmetic does.
    """
    as64 = lambda x: torch.as_tensor(x).long() & _M32  # noqa: E731
    rows, cols, bh = as64(rows), as64(cols), as64(bh)
    seed = as64(seed)
    h = (_mul32(rows, 0x0001_93E9) + cols) & _M32
    h = h ^ seed.to(h.device) ^ _mul32(bh.to(h.device), 0x9E37_79B1)
    for mult in (0x85EB_CA6B, 0xC2B2_AE35):
        h = _mul32(h, mult)
        h = h ^ (h >> 15)
    return (h >> 8) >= int(p_drop * (1 << 24))


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """One int32 from ``generator``, as a 0-d tensor on its device: the
    dropout seed of one attention call.  It stays on the device, so
    drawing it never waits for the card."""
    return torch.randint(-(1 << 31), 1 << 31, (), dtype=torch.int32,
                         generator=generator, device=generator.device)


# -- plain versions, (B, H, S, D) ----------------------------------------

def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _valid(sq, sk, causal, device):
    if not causal:
        return None
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return cols <= rows + (sk - sq)


def _keep(q, sk, seed, p_drop):
    b, h, sq = q.shape[:3]
    dev = q.device
    return keep_mask(seed, torch.arange(b * h, device=dev).reshape(b, h, 1, 1),
                     torch.arange(sq, device=dev).reshape(sq, 1),
                     torch.arange(sk, device=dev), p_drop)


def _product(a, b):
    """f32 product of ``a`` and ``b``, both widened from their dtype."""
    return torch.matmul(a.float(), b.float())


def _probs(q, k, lse, causal, scale):
    """``exp(s - lse)``, 0 where masked (the backward's probabilities)."""
    p = torch.exp(_product(q, k.transpose(-1, -2)) * scale - lse[..., None])
    valid = _valid(q.shape[2], k.shape[2], causal, q.device)
    return p if valid is None else torch.where(valid, p, 0.0)


def mha_reference(q, k, v, *, causal=False, sm_scale=None, dropout_p=0.0,
                  seed=None):
    """Plain forward on ``(B, H, S, D)``: ``(out, lse)``, out in q's
    dtype, lse f32 ``(B, H, S)``."""
    scale = _scale(q, sm_scale)
    s = _product(q, k.transpose(-1, -2)) * scale
    valid = _valid(q.shape[2], k.shape[2], causal, q.device)
    if valid is not None:
        s = torch.where(valid, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    lse = (m + torch.log(l_safe))[..., 0]
    if dropout_p > 0.0:
        p = torch.where(_keep(q, k.shape[2], seed, dropout_p),
                        p / (1.0 - dropout_p), 0.0)
    out = _product(p.to(v.dtype), v) / l_safe
    return out.to(q.dtype), lse


def mha_dq_reference(q, k, v, do, lse, delta, *, causal=False,
                     sm_scale=None, dropout_p=0.0, seed=None):
    """Plain dq on ``(B, H, S, D)``, from the forward's lse and
    ``delta = rowsum(out * do)`` (both f32 ``(B, H, S)``)."""
    scale = _scale(q, sm_scale)
    p = _probs(q, k, lse, causal, scale)
    dp = _product(do, v.transpose(-1, -2))
    if dropout_p > 0.0:
        dp = torch.where(_keep(q, k.shape[2], seed, dropout_p),
                         dp / (1.0 - dropout_p), 0.0)
    ds = p * (dp - delta[..., None])
    return (_product(ds.to(k.dtype), k) * scale).to(q.dtype)


def mha_dkv_reference(q, k, v, do, lse, delta, *, causal=False,
                      sm_scale=None, dropout_p=0.0, seed=None):
    """Plain ``(dk, dv)`` on ``(B, H, S, D)``; arguments as
    :func:`mha_dq_reference`."""
    scale = _scale(q, sm_scale)
    p = _probs(q, k, lse, causal, scale)
    dp = _product(do, v.transpose(-1, -2))
    p_tilde = p
    if dropout_p > 0.0:
        keep = _keep(q, k.shape[2], seed, dropout_p)
        inv = 1.0 / (1.0 - dropout_p)
        p_tilde = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = _product(p_tilde.to(do.dtype).transpose(-1, -2), do)
    ds = p * (dp - delta[..., None])
    dk = _product(ds.to(q.dtype).transpose(-1, -2), q) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def mha_bwd_reference(q, k, v, out, lse, do, **kw):
    """Plain ``(dq, dk, dv)`` on ``(B, H, S, D)`` from the forward's
    ``(out, lse)`` and the output gradient ``do``."""
    delta = (out.float() * do.float()).sum(-1)
    return (mha_dq_reference(q, k, v, do, lse, delta, **kw),
            *mha_dkv_reference(q, k, v, do, lse, delta, **kw))


# -- the kernels, (B, S, H, D) -------------------------------------------

def _require(cond, msg):
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def _check(q, k, v, *more):
    """What the kernels take: q, k, v (and ``more``, do) on one CUDA
    device, one dtype (f32 or bf16); q (and do) ``(B, Sq, H, D)``, k and v
    ``(B, Sk, H, D)`` with D in (32, 64, 128), unit stride in D, 16-byte
    aligned rows.  Returns ``(B, Sq, Sk, H, D)`` and the 12 strides (b, s,
    h of q, k, v and the fourth tensor)."""
    dev = q.device
    _require(dev.type == "cuda", f"q is on {dev}, not a CUDA device")
    _require(q.dim() == 4 and k.dim() == 4,
             f"q and k must be (B, S, H, D), got {tuple(q.shape)} and "
             f"{tuple(k.shape)}")
    _require(q.dtype in _DTYPE_CODE,
             f"dtype {q.dtype} not in (float32, bfloat16)")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _require(d in _HEAD_DIMS, f"head dim {d} not in {_HEAD_DIMS}")
    _require(b * h <= 65535, f"B * H = {b * h} > 65535")
    _require(sq > 0 and sk > 0, "q_len and kv_len must be positive")
    vec = 16 // q.element_size()
    for t, want in ((q, q.shape), (k, (b, sk, h, d)), (v, (b, sk, h, d)),
                    *((t, q.shape) for t in more)):
        _require(t.device == dev, "all inputs must be on one CUDA device")
        _require(t.dtype == q.dtype, f"{t.dtype} does not match q {q.dtype}")
        _require(t.shape == want, f"shape {tuple(t.shape)} is not "
                 f"{tuple(want)} (k and v share kv_len, do is q's shape)")
        _require(t.stride(3) == 1, "the head dim must have unit stride")
        _require(t.data_ptr() % 16 == 0 and all(
            st % vec == 0 for st in t.stride()[:3]),
            "rows must be 16-byte aligned")
    strides = [st for t in (q, k, v, *more) for st in t.stride()[:3]]
    strides += [0] * (12 - len(strides))
    return (b, sq, sk, h, d), (ctypes.c_longlong * 12)(*strides)


def _padded(*ts):
    """``ts`` with the head dim zero-padded to the next size the kernels
    take (the reference pads to 128 lanes): zero columns add nothing to
    the scores, and the outputs' extra columns are sliced off.  D > 128
    raises."""
    d = ts[0].shape[-1]
    dp = next((n for n in _HEAD_DIMS if n >= d), None)
    _require(dp is not None, f"head dim {d} > {_HEAD_DIMS[-1]} is not "
             f"supported")
    if dp == d:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, dp - d)) for t in ts)


def _seed_ptr(seed, dropout_p, dev):
    if dropout_p <= 0.0:
        return None
    _require(isinstance(seed, torch.Tensor) and seed.dtype == torch.int32
             and seed.device == dev and seed.numel() == 1,
             "dropout needs the seed as one int32 on the kernel's device")
    return seed.data_ptr()


def _tail(shape, strides, *, causal, sm_scale, dropout_p, dtype, dev):
    """The C entries' shared trailing arguments, from ``strides`` on."""
    b, sq, sk, h, d = shape
    return (strides, b, h, sq, sk, d, float(sm_scale),
            int(dropout_p * (1 << 24)),
            1.0 / (1.0 - dropout_p) if dropout_p < 1.0 else 0.0,
            int(bool(causal)), _DTYPE_CODE[dtype],
            torch.cuda.current_stream(dev).cuda_stream)


def _run(entry, args, tail, what):
    lib = _build.load("flash_attention", _SIGNATURES)
    _build.check(lib, getattr(lib, entry)(*args, *tail), what)


def _launch_fwd(q, k, v, seed, causal, sm_scale, dropout_p):
    d = q.shape[-1]
    q, k, v = _padded(q, k, v)
    shape, strides = _check(q, k, v)
    b, sq, _, h, dp = shape
    out = torch.empty((b, sq, h, dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    sp = _seed_ptr(seed, dropout_p, q.device)
    _run("ptt_flash_fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), sp),
         _tail(shape, strides, causal=causal, sm_scale=sm_scale,
               dropout_p=dropout_p, dtype=q.dtype, dev=q.device),
         "flash_fwd")
    return out[..., :d], lse


def _check_stats(q, *stats):
    b, s, h = q.shape[:3]
    for t in stats:
        _require(t.device == q.device and t.dtype == torch.float32
                 and t.shape == (b, h, s) and t.is_contiguous(),
                 f"lse and delta must be contiguous float32 {(b, h, s)} on "
                 f"{q.device}")


def _launch_dq(q, k, v, do, lse, delta, seed, causal, sm_scale, dropout_p):
    d = q.shape[-1]
    q, k, v, do = _padded(q, k, v, do)
    shape, strides = _check(q, k, v, do)
    _check_stats(q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    sp = _seed_ptr(seed, dropout_p, q.device)
    _run("ptt_flash_bwd_dq", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(), sp),
         _tail(shape, strides, causal=causal, sm_scale=sm_scale,
               dropout_p=dropout_p, dtype=q.dtype, dev=q.device),
         "flash_bwd_dq")
    return dq[..., :d]


def _launch_dkv(q, k, v, do, lse, delta, seed, causal, sm_scale, dropout_p):
    d = q.shape[-1]
    q, k, v, do = _padded(q, k, v, do)
    shape, strides = _check(q, k, v, do)
    _check_stats(q, lse, delta)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    sp = _seed_ptr(seed, dropout_p, q.device)
    _run("ptt_flash_bwd_dkv", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), sp),
         _tail(shape, strides, causal=causal, sm_scale=sm_scale,
               dropout_p=dropout_p, dtype=q.dtype, dev=q.device),
         "flash_bwd_dkv")
    return dk[..., :d], dv[..., :d]


def _bhsd(*ts):
    return [t.transpose(1, 2) for t in ts]


def flash_fwd(q, k, v, seed=None, *, causal=False, sm_scale=None,
              dropout_p=0.0):
    """Attention forward on ``(B, S, H, D)``: ``(out, lse)``, out
    ``(B, S, H, D)`` in q's dtype, lse f32 ``(B, H, S)``.  ``seed`` is the
    int32 dropout seed (:func:`draw_seed`), used when ``dropout_p > 0``.
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    ``flash_fwd.launches`` counts kernel launches."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        out, lse = mha_reference(*_bhsd(q, k, v), causal=causal,
                                 sm_scale=sm_scale, dropout_p=dropout_p,
                                 seed=seed)
        return out.transpose(1, 2), lse
    out = _launch_fwd(q, k, v, seed, causal, sm_scale, dropout_p)
    flash_fwd.launches += 1
    return out


flash_fwd.launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, seed=None, *, causal=False,
                 sm_scale=None, dropout_p=0.0):
    """dq on ``(B, S, H, D)`` from the output gradient ``do``, the
    forward's lse and ``delta = rowsum(out * do)`` (f32 ``(B, H, S)``).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    ``flash_bwd_dq.launches`` counts kernel launches."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return mha_dq_reference(*_bhsd(q, k, v, do), lse, delta,
                                causal=causal, sm_scale=sm_scale,
                                dropout_p=dropout_p, seed=seed
                                ).transpose(1, 2)
    dq = _launch_dq(q, k, v, do, lse, delta, seed, causal, sm_scale,
                    dropout_p)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, seed=None, *, causal=False,
                  sm_scale=None, dropout_p=0.0):
    """``(dk, dv)`` on ``(B, S, H, D)``; arguments as
    :func:`flash_bwd_dq`.  ``flash_bwd_dkv.launches`` counts kernel
    launches."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        dk, dv = mha_dkv_reference(*_bhsd(q, k, v, do), lse, delta,
                                   causal=causal, sm_scale=sm_scale,
                                   dropout_p=dropout_p, seed=seed)
        return dk.transpose(1, 2), dv.transpose(1, 2)
    out = _launch_dkv(q, k, v, do, lse, delta, seed, causal, sm_scale,
                      dropout_p)
    flash_bwd_dkv.launches += 1
    return out


flash_bwd_dkv.launches = 0


class _Flash(torch.autograd.Function):
    """Attention on ``(B, S, H, D)`` with the flash kernels both ways;
    returns ``(out, lse)``, lse without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seed, causal, sm_scale, dropout_p):
        out, lse = flash_fwd(q, k, v, seed, causal=causal, sm_scale=sm_scale,
                             dropout_p=dropout_p)
        ctx.save_for_backward(q, k, v, out, lse, seed)
        ctx.opts = dict(causal=causal, sm_scale=sm_scale, dropout_p=dropout_p)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse, seed = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (out.float() * do.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, seed, **ctx.opts)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, seed, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(query, key, value, *, causal=False, dropout_p=0.0,
                    generator=None):
    """Flash attention on paddle's ``(B, S, H, D)``, differentiable in
    q, k and v.  With ``dropout_p > 0`` the call draws its seed from
    ``generator`` (required then)."""
    seed = None
    if dropout_p > 0.0:
        if generator is None:
            raise ValueError("attention dropout needs the run's generator")
        seed = draw_seed(generator)
    return _Flash.apply(query, key, value, seed, bool(causal),
                        _scale(query, None), float(dropout_p))[0]


def mha(q, k, v, *, causal=False, dropout_p=0.0, seed=None,
        return_lse=False):
    """Flash attention on ``(B, H, S, D)`` with an explicit int32 dropout
    ``seed`` (a tensor on q's device, or an int), differentiable in q, k
    and v; ``return_lse`` adds the f32 ``(B, H, S)`` log-sum-exp."""
    if dropout_p > 0.0 and not isinstance(seed, torch.Tensor):
        seed = torch.tensor(0 if seed is None else seed, dtype=torch.int32,
                            device=q.device)
    out, lse = _Flash.apply(*_bhsd(q, k, v), seed, bool(causal),
                            _scale(q, None), float(dropout_p))
    out = out.transpose(1, 2)
    return (out, lse) if return_lse else out
