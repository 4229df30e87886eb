"""Decode attention over a paged KV pool: plain PyTorch and a CUDA kernel.

The counterpart of ``paddle_tpu/ops/paged_attention.py``.  Shapes (one
layer; the model loops over layers):

  q            (B, H, D)        one query token per sequence
  k/v_pages    (P, ps, H, D)    the whole pool, P pages of ps tokens
  k/v_scale    (P, ps, H)       f32 per-(token, head) scales (int8 pool)
  page_tables  (B, max_pages)   int32 page ids; position t lives in
                                page ``pt[b, t // ps]``, slot ``t % ps``
  lengths      (B,) int32       live positions per row

 - :func:`paged_attention_reference` / :func:`paged_attention_int8_reference`
   gather the page window and run a masked softmax in f32.
 - :func:`paged_attention_split_reference` mirrors the kernel's
   arithmetic: splits of ``SPLIT_TOKENS`` positions (:func:`split_plan`),
   chunks of 32 per warp, exp2 of scores scaled by log2(e), int8 scales
   on the score and the probability, partials merged in a fixed order; a
   row of length 0 gives 0, as the Pallas kernel does.  For the tests and
   ``chip_smoke.py`` only.
 - :func:`paged_attention` / :func:`paged_attention_int8` run the CUDA
   kernels ``csrc/paged_attention.cu`` (a split kernel, then a combine)
   on CUDA tensors and the reference on CPU tensors.  There is no other
   path: a tensor on another device raises, and so does a CUDA input the
   kernel does not take.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_reference",
           "paged_attention_int8", "paged_attention_int8_reference",
           "paged_attention_split_reference", "split_plan", "SPLIT_TOKENS",
           "KERNEL_NAMES"]

# masked-score value of the JAX model (a finite number, so a row whose
# scores are all masked never computes inf - inf)
_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
# positions a block of the split kernel covers (``kSplit`` in the CUDA
# source): a constant, so a row's sums never depend on the batch
SPLIT_TOKENS = 128
_CHUNK = 32          # positions one warp stages and scores
# the CUDA kernels one call launches, as a profiler names them
KERNEL_NAMES = ("paged_split_kernel", "paged_combine_kernel")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptt_paged_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, ctypes.c_float, _I, _I, _P),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _masked_softmax_pv(q, k_ctx, v_ctx, lengths, sm_scale, p_dtype):
    b, h, d = q.shape
    s = torch.einsum("bhd,bchd->bhc", q.float(), k_ctx.float()) * sm_scale
    c = k_ctx.shape[1]
    live = torch.arange(c, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~live[:, None, :], _NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhc,bchd->bhd", w.to(p_dtype).float(), v_ctx.float())
    return o.to(q.dtype)


def paged_attention_reference(q, k_pages, v_pages, page_tables, lengths, *,
                              sm_scale=None):
    """Gather the page window, masked softmax attention.

    f32 scores and accumulation whatever the operand dtype; the softmax
    weights are rounded to the page dtype before the weighted sum, as in
    the JAX reference; output in ``q.dtype``.
    """
    b, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    pt = page_tables.long()
    # (B, max_pages, ps, H, D) -> (B, C, H, D): position t sits at
    # context index t because pages fill in order
    k_ctx = k_pages[pt].reshape(b, -1, h, d)
    v_ctx = v_pages[pt].reshape(b, -1, h, d)
    return _masked_softmax_pv(q, k_ctx, v_ctx, lengths, sm_scale,
                              v_pages.dtype)


def paged_attention_int8_reference(q, k_pages, v_pages, k_scale, v_scale,
                                   page_tables, lengths, *, sm_scale=None):
    """int8 pages: gather values and scales through the page table,
    dequantize, masked softmax attention in f32."""
    b, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    pt = page_tables.long()
    k_ctx = (k_pages[pt].float() * k_scale[pt][..., None]).reshape(b, -1, h, d)
    v_ctx = (v_pages[pt].float() * v_scale[pt][..., None]).reshape(b, -1, h, d)
    return _masked_softmax_pv(q, k_ctx, v_ctx, lengths, sm_scale,
                              torch.float32)


def split_plan(k_pages, page_tables):
    """``(split size, split count)`` of the kernel's grid: positions a
    split covers, and splits per row, from the page size and the table's
    width alone (never the batch, the lengths or the card)."""
    width = page_tables.shape[1] * k_pages.shape[1]
    return SPLIT_TOKENS, -(-width // SPLIT_TOKENS)


def _merge(parts):
    """Partials ``(m, l, acc)`` (scores in log2 units) merged in list
    order: ``M = max m``, ``l`` and ``acc`` weighted by ``exp2(m - M)``."""
    big = parts[0][0]
    for m, _, _ in parts[1:]:
        big = torch.maximum(big, m)
    l_sum = torch.zeros_like(big)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        f = torch.exp2(m - big)
        l_sum = l_sum + l * f
        acc = acc + a * f[:, None]
    return big, l_sum, acc


def paged_attention_split_reference(q, k_pages, v_pages, page_tables,
                                    lengths, *, k_scale=None, v_scale=None,
                                    sm_scale=None):
    """The CUDA kernels' arithmetic in plain PyTorch, one row at a time.

    Each live split of ``SPLIT_TOKENS`` positions is cut into chunks of
    32 (one warp each): scores ``(q * sm_scale * log2 e) . k`` (times the
    int8 ``k_scale``), the chunk's max ``m``, ``p = exp2(s - m)``, ``l =
    sum p`` and ``acc = sum p (* v_scale) v``; the chunks merge in order
    into the split's partial, the splits in order into the row.  A row
    with no live position gives 0.  Rows never mix, so a row's bits do
    not depend on the batch.  Reads ``lengths`` on the host: for the tests
    and ``chip_smoke.py``, never on the card's path.
    """
    b, h, d = q.shape
    n_pages, ps = k_pages.shape[:2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    quant = k_scale is not None
    width = page_tables.shape[1] * ps
    qs = q.float() * (float(sm_scale) * _LOG2E)
    out = torch.zeros(b, h, d, dtype=torch.float32, device=q.device)
    for r in range(b):
        n = max(0, min(int(lengths[r]), width))
        splits = []
        for t0 in range(0, n, SPLIT_TOKENS):
            chunks = []
            for c0 in range(t0, min(n, t0 + SPLIT_TOKENS), _CHUNK):
                pos = torch.arange(c0, min(n, c0 + _CHUNK), device=q.device)
                pages = page_tables[r, pos // ps].long().clamp(0, n_pages - 1)
                slots = pos % ps
                k = k_pages[pages, slots].float()           # (T, H, D)
                v = v_pages[pages, slots].float()
                s = (k * qs[r]).sum(-1)                     # (T, H)
                if quant:
                    s = s * k_scale[pages, slots]
                m = s.amax(0)
                p = torch.exp2(s - m)
                pv = p * v_scale[pages, slots] if quant else p
                chunks.append((m, p.sum(0), (pv[..., None] * v).sum(0)))
            splits.append(_merge(chunks))
        if splits:
            _, l_sum, acc = _merge(splits)
            out[r] = acc / l_sum[:, None]
    return out.to(q.dtype)


def _require(cond, msg):
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def _launch(q, k_pages, v_pages, k_scale, v_scale, page_tables, lengths,
            sm_scale):
    """Check what the kernels take, allocate the output and the splits'
    workspace, launch the split and combine kernels on the current
    stream.  Never synchronises and never reads a tensor's values."""
    dev = q.device
    _require(dev.type == "cuda", f"q is on {dev}, not a CUDA device")
    quant = k_scale is not None
    tensors = [q, k_pages, v_pages, page_tables, lengths]
    if quant:
        tensors += [k_scale, v_scale]
    for t in tensors:
        _require(t.device == dev, "all inputs must be on one CUDA device")
        _require(t.is_contiguous(), "inputs must be contiguous")
    b, h, d = q.shape
    n_pages, ps = k_pages.shape[:2]
    max_pages = page_tables.shape[1]
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"q dtype {q.dtype} not in (float32, bfloat16)")
    _require(k_pages.shape == (n_pages, ps, h, d)
             and v_pages.shape == k_pages.shape, "page shape mismatch")
    _require(k_pages.dtype == v_pages.dtype, "k/v page dtypes differ")
    if quant:
        _require(k_pages.dtype == torch.int8, "scales given for float pages")
        _require(q.dtype == torch.float32, "int8 pages take a float32 q "
                 f"(the int8 serve path's activations), not {q.dtype}")
        _require(k_scale.shape == (n_pages, ps, h)
                 and v_scale.shape == k_scale.shape
                 and k_scale.dtype == torch.float32
                 and v_scale.dtype == torch.float32,
                 "scales must be float32 (P, ps, H)")
    else:
        _require(k_pages.dtype == q.dtype,
                 f"pages {k_pages.dtype} do not match q {q.dtype}")
    _require(page_tables.shape == (b, max_pages)
             and page_tables.dtype == torch.int32, "page_tables must be "
             "int32 (B, max_pages)")
    _require(lengths.shape == (b,) and lengths.dtype == torch.int32,
             "lengths must be int32 (B,)")
    vec = 16 // k_pages.element_size()
    group = d // vec
    _require(d % vec == 0 and 0 < group <= 32 and group & (group - 1) == 0,
             f"head_dim {d} unsupported for {k_pages.dtype} pages")
    for t in (k_pages, v_pages):
        _require(t.data_ptr() % 16 == 0, "pages must be 16-byte aligned")
    _, n_splits = split_plan(k_pages, page_tables)
    _require(b * h * n_splits < 2 ** 31, "B * H * splits must be below 2^31")
    out = torch.empty_like(q)
    if b * h == 0:
        return out
    # each split's partial (m, l, acc); rows with one live split never
    # touch it, and no call reads what another wrote
    ws = torch.empty(b * h * n_splits * (d + 2), dtype=torch.float32,
                     device=dev)
    lib = _build.load("paged_attention", _SIGNATURES)
    status = lib.ptt_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        ws.data_ptr(), b, h, d, ps, max_pages, n_pages, n_splits,
        float(sm_scale) * _LOG2E, _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k_pages.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "paged_attention")
    return out


def paged_attention(q, k_pages, v_pages, page_tables, lengths, *,
                    sm_scale=None):
    """Paged decode attention: the CUDA kernels for CUDA tensors, the
    plain reference for CPU tensors.  ``paged_attention.launches``
    counts calls that launched the kernels (one a call)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_tables,
                                         lengths, sm_scale=sm_scale)
    out = _launch(q, k_pages, v_pages, None, None, page_tables, lengths,
                  sm_scale)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_int8(q, k_pages, v_pages, k_scale, v_scale, page_tables,
                         lengths, *, sm_scale=None):
    """Paged decode attention over int8 pages with per-(token, head)
    scales: the CUDA kernels for CUDA tensors, the plain reference for
    CPU tensors.  ``paged_attention_int8.launches`` counts calls that
    launched the kernels (one a call)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_int8_reference(
            q, k_pages, v_pages, k_scale, v_scale, page_tables, lengths,
            sm_scale=sm_scale)
    _require(k_scale is not None and v_scale is not None,
             "int8 pages need k_scale and v_scale")
    out = _launch(q, k_pages, v_pages, k_scale, v_scale, page_tables,
                  lengths, sm_scale)
    paged_attention_int8.launches += 1
    return out


paged_attention_int8.launches = 0
