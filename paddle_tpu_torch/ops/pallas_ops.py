"""Flash attention: plain PyTorch and a CUDA kernel triple, on fixed
lengths or on packed varlen sequences.

The counterpart of ``paddle_tpu/ops/pallas_ops.py``: ``_fwd``, ``_bwd``,
the custom VJPs ``_flash`` and ``_flash_lse``, ``mha`` and
``flash_attention`` for fixed lengths (``q_len`` and ``kv_len`` equal or
not, causal or not, attention dropout on or off, ``seq_lens``,
``causal_shift``, a differentiable lse), and ``_pk_fwd``, ``_pk_bwd``,
``_pk_flash`` and ``mha_packed`` for packed ragged sequences.  Any head size:
the kernels take 32, 64, 128, 256 and any multiple of 128 above, and the
wrappers zero-pad the others up to the next, as the TPU wrapper pads to
128 lanes, and slice the results back.

Arithmetic of the TPU kernels, kept by both versions here:

 - scores ``s = q k^T * scale`` with f32 sums, masked to -1e30;
   ``lse = m + log(l)`` in f32, where ``l`` sums the undropped ``p = exp(s
   - m)`` and a row with ``l == 0`` divides by 1 (so a row with no key
   gets out 0 and lse -1e30);
 - causal keeps key ``j`` for query ``i`` when ``j <= i + kv_len -
   q_len``: the diagonal aligned to the end (``_key_mask``), per sequence
   pair when packed (bottom right, ``j <= i + len_k - len_q``);
   ``seq_lens`` keeps keys ``< seq_lens[b]`` and measures causal from 0;
   ``causal_shift`` (an int32 on the device) overrides the offset;
 - dropout keeps an element when a hash of its ``(hb, row, col)``
   coordinates passes the threshold (:func:`keep_mask`) and scales the
   kept ``p`` by ``1 / (1 - p_drop)`` in the numerator only.  Fixed
   lengths hash ``(b * H + h, i, j)``, or with a ``hash_base`` ``(row0,
   col0, head0, heads)`` ``(b * heads + head0 + h, row0 + i, col0 + j)``:
   the coordinates of a call that is one block of a larger attention (a
   ring step's rows and keys in the whole sequence, a head shard's heads
   among all of them), so that it draws that attention's mask; packed
   sequences hash the TPU kernel's block-aligned buffer, ``(h, start_q[s]
   + i, start_k[s] + j)`` (:class:`PackedLayout`);
 - ``p``, ``p~`` and ``ds`` are cast to the other operand's dtype before
   their products, which sum in f32;
 - the backward takes ``delta = rowsum(out * do) - dlse`` in f32,
   computed by the autograd functions with plain torch ops, as the JAX
   ``_bwd`` does with ``jnp``.

 - :func:`mha_reference`, :func:`mha_dq_reference`,
   :func:`mha_dkv_reference` (and :func:`mha_bwd_reference`): the plain
   versions on ``(B, H, S, D)``; :func:`mha_packed_reference`,
   :func:`mha_packed_dq_reference`, :func:`mha_packed_dkv_reference` (and
   :func:`mha_packed_bwd_reference`) on packed ``(total, H, D)`` with
   ``cu_q`` and ``cu_k``.  Tests and ``chip_smoke.py`` hold the kernels
   against them; no CUDA path calls them.
 - :func:`flash_fwd`, :func:`flash_bwd_dq`, :func:`flash_bwd_dkv` (on
   paddle's ``(B, S, H, D)``) and :func:`flash_packed_fwd`,
   :func:`flash_packed_bwd_dq`, :func:`flash_packed_bwd_dkv` (packed): the
   kernels of ``csrc/flash_attention.cu`` on CUDA tensors, the plain
   versions on CPU tensors, and nothing else.  Each counts its launches in
   ``.launches``.
 - :func:`mha` (``(B, H, S, D)``), :func:`flash_attention` (``(B, S, H,
   D)``) and :func:`mha_packed` (packed): attention with gradients through
   the autograd functions ``_Flash`` and ``_PackedFlash``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["keep_mask", "draw_seed", "mha_reference", "mha_dq_reference",
           "mha_dkv_reference", "mha_bwd_reference", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv", "mha", "flash_attention",
           "PackedLayout", "mha_packed_reference", "mha_packed_dq_reference",
           "mha_packed_dkv_reference", "mha_packed_bwd_reference",
           "flash_packed_fwd", "flash_packed_bwd_dq", "flash_packed_bwd_dkv",
           "mha_packed"]

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# lens, shift, cu_q, cu_k, hstart, tiles, ntiles, then units, nunits; the
# tail ends with the stream, then the dropout hash's base (four int32 on
# the host)
_MASKS = (_P,) * 6 + (_I,)
_UNITS = (_P, _I)
_TAIL = (_P, _I, _I, _I, _I, _I, _F, _I, _F, _I, _I, _P, _P)
_SIGNATURES = {
    "ptt_flash_fwd": (_P,) * 6 + _MASKS + _UNITS + _TAIL,
    "ptt_flash_bwd_dq": (_P,) * 8 + _MASKS + _UNITS + _TAIL,
    "ptt_flash_bwd_dkv": (_P,) * 9 + _MASKS + _UNITS + _TAIL,
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)   # and above 256, every multiple of 128
_WIDE_STEP = 128
_TILE_ROWS = 64       # rows of a kernel block's own tile (kRows in the .cu)
# the wgmma kernels' tiles: 128 rows a unit tile (kBM, kBN in the .cu),
# 64 q rows a dk/dv step (DkvLayout::kQT)
_UNIT_ROWS, _DKV_Q_ROWS = 128, 64
_PACKED_BLOCK = 512   # the JAX mha_packed's default block_q and block_k


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
    ``b * H + h``, or ``h`` for packed sequences), ``rows`` (query
    positions) and ``cols`` (key positions) are ints or integer tensors
    that broadcast together.  The hash runs in int64 masked to 32 bits, so
    its shifts are logical and its products wrap as uint32 arithmetic
    does.
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


# -- plain versions: the shared arithmetic on (..., S, D) ------------------

def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _valid(sq, sk, causal, device, seq_lens=None, causal_shift=None):
    """The (query, key) pairs kept, broadcastable to ``(..., sq, sk)``, or
    None when all are: keys ``< seq_lens[b]`` (a ``(B,)`` tensor) and, if
    causal, ``key <= query + off``, off ``sk - sq`` (0 with ``seq_lens``)
    or the int32 tensor ``causal_shift``."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    valid = None
    if seq_lens is not None:
        valid = cols < seq_lens.reshape(-1, 1, 1, 1)
    if causal:
        off = sk - sq if seq_lens is None else 0
        if causal_shift is not None:
            off = causal_shift.reshape(())
        below = cols <= rows + off
        valid = below if valid is None else valid & below
    return valid


def _keep(seed, p_drop, bh, row0, col0, sq, sk, device):
    """The keep mask of a ``(…, sq, sk)`` block whose rows hash from
    ``row0`` and columns from ``col0``; ``bh`` broadcasts in front."""
    return keep_mask(seed, bh, row0 + torch.arange(sq, device=device)[:, None],
                     col0 + torch.arange(sk, device=device), p_drop)


def _product(a, b):
    """f32 product of ``a`` and ``b``, both widened from their dtype."""
    return torch.matmul(a.float(), b.float())


def _probs(q, k, lse, valid, scale):
    """``exp(s - lse)``, 0 where masked (the backward's probabilities)."""
    p = torch.exp(_product(q, k.transpose(-1, -2)) * scale - lse[..., None])
    return p if valid is None else torch.where(valid, p, 0.0)


def _fwd_plain(q, k, v, valid, keep, scale, dropout_p):
    s = _product(q, k.transpose(-1, -2)) * scale
    if valid is not None:
        s = torch.where(valid, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    lse = (m + torch.log(l_safe))[..., 0]
    if keep is not None:
        p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    out = _product(p.to(v.dtype), v) / l_safe
    return out.to(q.dtype), lse


def _dq_plain(q, k, v, do, lse, delta, valid, keep, scale, dropout_p):
    p = _probs(q, k, lse, valid, scale)
    dp = _product(do, v.transpose(-1, -2))
    if keep is not None:
        dp = torch.where(keep, dp / (1.0 - dropout_p), 0.0)
    ds = p * (dp - delta[..., None])
    return (_product(ds.to(k.dtype), k) * scale).to(q.dtype)


def _dkv_plain(q, k, v, do, lse, delta, valid, keep, scale, dropout_p):
    p = _probs(q, k, lse, valid, scale)
    dp = _product(do, v.transpose(-1, -2))
    p_tilde = p
    if keep is not None:
        inv = 1.0 / (1.0 - dropout_p)
        p_tilde = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = _product(p_tilde.to(do.dtype).transpose(-1, -2), do)
    ds = p * (dp - delta[..., None])
    dk = _product(ds.to(q.dtype).transpose(-1, -2), q) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# -- plain versions, fixed lengths, (B, H, S, D) ---------------------------

def _hash_base(hash_base, heads):
    """``(row0, col0, head0, heads)`` with a heads count of 0 or None
    read as ``heads``; all zeros (and ``heads``) for None."""
    row0, col0, head0, hh = hash_base or (0, 0, 0, 0)
    return int(row0), int(col0), int(head0), int(hh or heads)


def _fixed_masks(q, k, causal, dropout_p, seed, seq_lens, causal_shift,
                 hash_base=None):
    b, h, sq = q.shape[:3]
    sk, dev = k.shape[2], q.device
    valid = _valid(sq, sk, causal, dev, seq_lens, causal_shift)
    keep = None
    if dropout_p > 0.0:
        row0, col0, head0, hh = _hash_base(hash_base, h)
        bh = (torch.arange(b, device=dev).reshape(b, 1, 1, 1) * hh + head0 +
              torch.arange(h, device=dev).reshape(1, h, 1, 1))
        keep = _keep(seed, dropout_p, bh, row0, col0, sq, sk, dev)
    return valid, keep


def mha_reference(q, k, v, *, causal=False, sm_scale=None, dropout_p=0.0,
                  seed=None, seq_lens=None, causal_shift=None,
                  hash_base=None):
    """Plain forward on ``(B, H, S, D)``: ``(out, lse)``, out in q's
    dtype, lse f32 ``(B, H, S)``.  ``seq_lens`` is a ``(B,)`` int tensor,
    ``causal_shift`` an int32 tensor, both on q's device; ``hash_base``
    ``(row0, col0, head0, heads)`` or None, the dropout hash's
    coordinates (module docstring)."""
    valid, keep = _fixed_masks(q, k, causal, dropout_p, seed, seq_lens,
                               causal_shift, hash_base)
    return _fwd_plain(q, k, v, valid, keep, _scale(q, sm_scale), dropout_p)


def mha_dq_reference(q, k, v, do, lse, delta, *, causal=False,
                     sm_scale=None, dropout_p=0.0, seed=None, seq_lens=None,
                     causal_shift=None, hash_base=None):
    """Plain dq on ``(B, H, S, D)``, from the forward's lse and ``delta =
    rowsum(out * do) - dlse`` (both f32 ``(B, H, S)``)."""
    valid, keep = _fixed_masks(q, k, causal, dropout_p, seed, seq_lens,
                               causal_shift, hash_base)
    return _dq_plain(q, k, v, do, lse, delta, valid, keep,
                     _scale(q, sm_scale), dropout_p)


def mha_dkv_reference(q, k, v, do, lse, delta, *, causal=False,
                      sm_scale=None, dropout_p=0.0, seed=None, seq_lens=None,
                      causal_shift=None, hash_base=None):
    """Plain ``(dk, dv)`` on ``(B, H, S, D)``; arguments as
    :func:`mha_dq_reference`."""
    valid, keep = _fixed_masks(q, k, causal, dropout_p, seed, seq_lens,
                               causal_shift, hash_base)
    return _dkv_plain(q, k, v, do, lse, delta, valid, keep,
                      _scale(q, sm_scale), dropout_p)


def mha_bwd_reference(q, k, v, out, lse, do, *, dlse=None, **kw):
    """Plain ``(dq, dk, dv)`` on ``(B, H, S, D)`` from the forward's
    ``(out, lse)``, the output gradient ``do`` and the lse's, ``dlse``."""
    delta = (out.float() * do.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return (mha_dq_reference(q, k, v, do, lse, delta, **kw),
            *mha_dkv_reference(q, k, v, do, lse, delta, **kw))


# -- packed sequences: the layout and the plain versions, (total, H, D) ----

def _ceil_to(x, m):
    return (x + m - 1) // m * m


def _validate_cu(cu, total, what, max_seqlen=None):
    """Refuse cumulative lengths that do not start at 0, decrease or end
    elsewhere than ``total``, and a ``max_seqlen`` below the longest
    sequence (the JAX functional's check, with its messages)."""
    c = [int(x) for x in cu]
    if (not c or c[0] != 0 or any(b < a for a, b in zip(c, c[1:]))
            or c[-1] != total):
        raise ValueError(
            f"{what} must be nondecreasing, start at 0 and end at the "
            f"packed token count {total}; got {c[:8]}...")
    if max_seqlen is not None and len(c) > 1:
        longest = max(b - a for a, b in zip(c, c[1:]))
        if longest > int(max_seqlen):
            raise ValueError(
                f"max_seqlen for {what} is {int(max_seqlen)} but the "
                f"longest sequence is {longest}")
    return c


def _host_ints(cu):
    if isinstance(cu, torch.Tensor):
        return cu.tolist()      # a card tensor waits for the card here
    return [int(x) for x in cu]


def _starts(cu, block):
    """Exclusive cumsum of the lengths rounded up to ``block``: where each
    sequence begins in the TPU kernel's block-aligned packed buffer."""
    starts, at = [], 0
    for a, b in zip(cu, cu[1:]):
        starts.append(at)
        at += _ceil_to(b - a, block)
    return starts


def _tile_steps(side, len_q, len_k, tile, causal):
    """The other operand's tiles that 128-row tile ``tile`` of one
    sequence walks in the wgmma kernels: for a q tile (the forward and dq,
    ``side`` "q") the 128-key tiles up to its last row's diagonal when
    causal, for a key tile (dk/dv, "k") the 64-row q tiles from its
    diagonal; the diagonal bottom right, ``key <= query + len_k - len_q``
    (the kernels' ``q_item`` and ``item``)."""
    r0, off = tile * _UNIT_ROWS, len_k - len_q
    if side == "q":
        end = min(len_k, r0 + _UNIT_ROWS + off) if causal else len_k
        return -(-end // _UNIT_ROWS) if end > 0 else 0
    first = max(0, r0 - off) if causal else 0
    return (-(-(len_q - first) // _DKV_Q_ROWS)
            if r0 < len_k and first < len_q else 0)


class PackedLayout:
    """The sequences of one packed call, read once on the host.

    ``cu_q`` and ``cu_k`` (``(B + 1,)`` ints: a list, an array or a tensor
    on any device) are checked as the JAX functional checks them and kept
    as Python lists.  The dropout hash coordinates follow the JAX
    ``mha_packed``'s block-aligned buffer: ``bq = min(block_q or 512,
    ceil_to(total_q, 8))``, ``start_q`` the exclusive cumsum of
    ``ceil(len_q / bq) * bq`` (``start_k`` likewise with ``block_k``), so
    an element of sequence ``s`` hashes ``(h, start_q[s] + i, start_k[s] +
    j)`` whatever tile the CUDA kernels use.

    The kernels' tables are built here on the host from that copy (the
    grid size needs their counts on the host in any case) and uploaded
    once per device and mask (:meth:`tables`): each q (k) tile of 64 rows
    of one sequence is one block of the mma.sync forward and dq (dk/dv)
    kernels; the wgmma kernels' units (:meth:`units`) pair 128-row tiles.
    """

    def __init__(self, cu_q, cu_k, total_q, total_k, *, block_q=None,
                 block_k=None):
        self.cu_q = _validate_cu(_host_ints(cu_q), total_q, "cu_seqlens_q")
        self.cu_k = _validate_cu(_host_ints(cu_k), total_k, "cu_seqlens_k")
        if len(self.cu_q) != len(self.cu_k):
            raise ValueError(f"cu_seqlens_q has {len(self.cu_q)} entries, "
                             f"cu_seqlens_k {len(self.cu_k)}")
        self.n = len(self.cu_q) - 1
        self.block_q, self.block_k = block_q, block_k
        bq = min(_PACKED_BLOCK if block_q is None else block_q,
                 _ceil_to(total_q, 8))
        bk = min(_PACKED_BLOCK if block_k is None else block_k,
                 _ceil_to(total_k, 8))
        self.start_q = _starts(self.cu_q, bq)
        self.start_k = _starts(self.cu_k, bk)
        self._tables = {}

    def lens(self, side):
        cu = self.cu_q if side == "q" else self.cu_k
        return [b - a for a, b in zip(cu, cu[1:])]

    def units(self, side, causal):
        """The wgmma kernels' work units over 128-row tiles: q tiles for
        the forward and dq (``side`` "q": the forward walks dq's key
        tiles, so one table serves both), k tiles for dk/dv ("k").  A sequence's ``n``
        tiles pair as ``wg::unit_tile`` pairs them, tile ``n - 1 - p``
        with tile ``p`` (an odd ``n``'s middle tile alone), the one with
        more causal work first; an entry is ``(sequence, first tile,
        second tile or -1)``.  Every tile of a sequence with rows on its
        side is in one entry, also where the other side has none (its
        gradient rows are written as zeros).  The entries are ordered by
        their work (:func:`_tile_steps`), largest first, ties in sequence
        order; the kernel takes unit ``u`` as entry ``u // H`` for head
        ``u % H`` and deals the units to its persistent blocks back and
        forth (``next_unit``), so every head's longest units go first."""
        entries = []
        for s, (lq, lk) in enumerate(zip(self.lens("q"), self.lens("k"))):
            n = -(-(lq if side == "q" else lk) // _UNIT_ROWS)
            for p in range((n + 1) // 2):
                pair = (n - 1 - p, p) if side == "q" else (p, n - 1 - p)
                pair = pair if p != n - 1 - p else (p, -1)
                work = sum(_tile_steps(side, lq, lk, t, causal)
                           for t in pair if t >= 0)
                entries.append((-work, s, pair))
        entries.sort(key=lambda e: e[0])
        return [(s, *pair) for _, s, pair in entries]

    def tables(self, device, causal=False):
        """int32 tensors on ``device``: ``cu_q``, ``cu_k``, ``hstart``
        (start_q then start_k), the ``(n, 2)`` tile tables ``q_tiles``
        and ``k_tiles`` of (sequence, first row) and the ``(n, 3)`` unit
        tables ``dq_units`` and ``dkv_units`` (:meth:`units`; their order
        depends on ``causal``).  One copy from one host buffer, which
        CUDA stages at once, so the host does not wait for the card."""
        key = (str(device), bool(causal))
        if key not in self._tables:
            def tiles(side):
                return [x for s, n in enumerate(self.lens(side))
                        for r in range(0, n, _TILE_ROWS) for x in (s, r)]
            parts = dict(cu_q=self.cu_q, cu_k=self.cu_k,
                         hstart=self.start_q + self.start_k,
                         q_tiles=tiles("q"), k_tiles=tiles("k"),
                         dq_units=[x for e in self.units("q", causal)
                                   for x in e],
                         dkv_units=[x for e in self.units("k", causal)
                                    for x in e])
            flat = torch.tensor([x for p in parts.values() for x in p],
                                dtype=torch.int32).to(device,
                                                      non_blocking=True)
            views, at = {}, 0
            for name, p in parts.items():
                views[name] = flat[at:at + len(p)]
                at += len(p)
            for name, width in (("q_tiles", 2), ("k_tiles", 2),
                                ("dq_units", 3), ("dkv_units", 3)):
                views[name] = views[name].view(-1, width)
            self._tables[key] = views
        return self._tables[key]

    def pairs(self, causal, seed, dropout_p, heads, device):
        """Per sequence with rows on both sides: its q rows, its k rows,
        the kept pairs and the keep mask, for ``(H, len, D)`` slices."""
        for s in range(self.n):
            (q0, q1), (k0, k1) = self.cu_q[s:s + 2], self.cu_k[s:s + 2]
            if q1 == q0 or k1 == k0:
                continue
            keep = None
            if dropout_p > 0.0:
                keep = _keep(seed, dropout_p,
                             torch.arange(heads, device=device).reshape(
                                 heads, 1, 1),
                             self.start_q[s], self.start_k[s], q1 - q0,
                             k1 - k0, device)
            yield (slice(q0, q1), slice(k0, k1),
                   _valid(q1 - q0, k1 - k0, causal, device), keep)


def _heads(x):
    """``(len, H, D)`` -> ``(H, len, D)``."""
    return x.transpose(0, 1)


def mha_packed_reference(q, k, v, cu_q, cu_k, *, causal=False, sm_scale=None,
                         dropout_p=0.0, seed=None, block_q=None,
                         block_k=None):
    """Plain packed forward: q ``(total_q, H, D)``, k and v ``(total_k, H,
    D)``, sequence ``s`` on rows ``cu[s]:cu[s + 1]``; ``(out, lse)``, out
    ``(total_q, H, D)`` in q's dtype, lse f32 ``(H, total_q)``.
    ``block_q``/``block_k`` set the dropout hash's layout
    (:class:`PackedLayout`)."""
    lay = PackedLayout(cu_q, cu_k, q.shape[0], k.shape[0], block_q=block_q,
                       block_k=block_k)
    scale = _scale(q, sm_scale)
    out = torch.zeros_like(q)
    lse = torch.full((q.shape[1], q.shape[0]), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    for rq, rk, valid, keep in lay.pairs(causal, seed, dropout_p, q.shape[1],
                                         q.device):
        o, l = _fwd_plain(_heads(q[rq]), _heads(k[rk]), _heads(v[rk]), valid,
                          keep, scale, dropout_p)
        out[rq] = _heads(o)
        lse[:, rq] = l
    return out, lse


def mha_packed_dq_reference(q, k, v, do, lse, delta, cu_q, cu_k, *,
                            causal=False, sm_scale=None, dropout_p=0.0,
                            seed=None, block_q=None, block_k=None):
    """Plain packed dq from the forward's lse and ``delta = rowsum(out *
    do)`` (both f32 ``(H, total_q)``)."""
    lay = PackedLayout(cu_q, cu_k, q.shape[0], k.shape[0], block_q=block_q,
                       block_k=block_k)
    scale = _scale(q, sm_scale)
    dq = torch.zeros_like(q)
    for rq, rk, valid, keep in lay.pairs(causal, seed, dropout_p, q.shape[1],
                                         q.device):
        dq[rq] = _heads(_dq_plain(
            _heads(q[rq]), _heads(k[rk]), _heads(v[rk]), _heads(do[rq]),
            lse[:, rq], delta[:, rq], valid, keep, scale, dropout_p))
    return dq


def mha_packed_dkv_reference(q, k, v, do, lse, delta, cu_q, cu_k, *,
                             causal=False, sm_scale=None, dropout_p=0.0,
                             seed=None, block_q=None, block_k=None):
    """Plain packed ``(dk, dv)``; arguments as
    :func:`mha_packed_dq_reference`."""
    lay = PackedLayout(cu_q, cu_k, q.shape[0], k.shape[0], block_q=block_q,
                       block_k=block_k)
    scale = _scale(q, sm_scale)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for rq, rk, valid, keep in lay.pairs(causal, seed, dropout_p, q.shape[1],
                                         q.device):
        dks, dvs = _dkv_plain(
            _heads(q[rq]), _heads(k[rk]), _heads(v[rk]), _heads(do[rq]),
            lse[:, rq], delta[:, rq], valid, keep, scale, dropout_p)
        dk[rk], dv[rk] = _heads(dks), _heads(dvs)
    return dk, dv


def mha_packed_bwd_reference(q, k, v, out, lse, do, cu_q, cu_k, **kw):
    """Plain packed ``(dq, dk, dv)`` from the forward's ``(out, lse)`` and
    the output gradient ``do``."""
    delta = (out.float() * do.float()).sum(-1).t()
    return (mha_packed_dq_reference(q, k, v, do, lse, delta, cu_q, cu_k, **kw),
            *mha_packed_dkv_reference(q, k, v, do, lse, delta, cu_q, cu_k,
                                      **kw))


# -- the kernels -----------------------------------------------------------

def _require(cond, msg):
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def _check(q, k, v, *more):
    """What the kernels take: q, k, v (and ``more``, do) on one CUDA
    device, one dtype (f32 or bf16); q (and do) ``(B, Sq, H, D)``, k and v
    ``(B, Sk, H, D)`` with D in (32, 64, 128, 256) or a multiple of 128
    above, unit stride in D,
    16-byte aligned rows (packed tensors come as ``B = 1``).  Returns
    ``(B, Sq, Sk, H, D)`` and the 12 strides (b, s, h of q, k, v and the
    fourth tensor)."""
    dev = q.device
    _require(dev.type == "cuda", f"q is on {dev}, not a CUDA device")
    _require(q.dim() == 4 and k.dim() == 4,
             f"q and k must be (B, S, H, D), got {tuple(q.shape)} and "
             f"{tuple(k.shape)}")
    _require(q.dtype in _DTYPE_CODE,
             f"dtype {q.dtype} not in (float32, bfloat16)")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _require(d == _kernel_head_dim(d), f"head dim {d} is not one the "
             f"kernels take ({_HEAD_DIMS} or a multiple of {_WIDE_STEP})")
    _require(b * h < 2 ** 31, f"B * H = {b * h} is out of range")
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


def _kernel_head_dim(d):
    """The head size the kernels run ``d`` at: the next of
    ``_HEAD_DIMS``, or above 256 the next multiple of 128."""
    if d > _HEAD_DIMS[-1]:
        return -(-d // _WIDE_STEP) * _WIDE_STEP
    return next(n for n in _HEAD_DIMS if n >= d)


def _padded(*ts):
    """``ts`` with the head dim zero-padded to the next size the kernels
    take (the reference pads to 128 lanes): zero columns add nothing to
    the scores, and the outputs' extra columns are sliced off."""
    d = ts[0].shape[-1]
    dp = _kernel_head_dim(d)
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


def _int32_ptr(t, n, what, dev):
    if t is None:
        return None
    _require(isinstance(t, torch.Tensor) and t.dtype == torch.int32
             and t.device == dev and t.numel() == n and t.is_contiguous(),
             f"{what} must be {n} contiguous int32 on the kernel's device")
    return t.data_ptr()


def _hash_arg(hash_base):
    """The C entries' ``hash``: four int32 on the host (a heads count of
    0 is the call's own H)."""
    row0, col0, head0, heads = hash_base or (0, 0, 0, 0)
    for x in (row0, col0, head0, heads or 0):
        _require(0 <= int(x) < 2 ** 31, f"hash_base {hash_base} is out of "
                 f"range")
    return (ctypes.c_int * 4)(int(row0), int(col0), int(head0),
                              int(heads or 0))


def _masks(q, layout, side, causal, seq_lens=None, causal_shift=None):
    """The C entries' mask arguments (lens, shift, cu_q, cu_k, hstart,
    tiles, ntiles, units, nunits) and the batch count they imply: fixed
    lengths with the optional ``seq_lens`` and ``causal_shift`` tensors, or
    packed sequences (``layout``, ``side`` "q" or "k" naming the tile and
    unit tables: q for the forward and dq, k for dk/dv)."""
    if layout is None:
        b = q.shape[0]
        return (_int32_ptr(seq_lens, b, "seq_lens", q.device),
                _int32_ptr(causal_shift, 1, "causal_shift", q.device),
                None, None, None, None, 0, None, 0), b
    t = layout.tables(q.device, causal)
    tiles = t[f"{side}_tiles"]
    units = t["dq_units" if side == "q" else "dkv_units"]
    return (None, None, t["cu_q"].data_ptr(), t["cu_k"].data_ptr(),
            t["hstart"].data_ptr(), tiles.data_ptr(), tiles.shape[0],
            units.data_ptr(), units.shape[0]), layout.n


def _tail(shape, strides, *, causal, sm_scale, dropout_p, dtype, dev,
          hash_base=None):
    """The C entries' shared trailing arguments, from ``strides`` on."""
    b, sq, sk, h, d = shape
    return (strides, b, h, sq, sk, d, float(sm_scale),
            int(dropout_p * (1 << 24)),
            1.0 / (1.0 - dropout_p) if dropout_p < 1.0 else 0.0,
            int(bool(causal)), _DTYPE_CODE[dtype],
            torch.cuda.current_stream(dev).cuda_stream, _hash_arg(hash_base))


def _run(entry, args, tail, what):
    lib = _build.load("flash_attention", _SIGNATURES)
    _build.check(lib, getattr(lib, entry)(*args, *tail), what)


def _as4d(layout, *ts):
    """Packed ``(total, H, D)`` tensors as ``(1, total, H, D)`` views."""
    return ts if layout is None else tuple(t.unsqueeze(0) for t in ts)


def _check_stats(want, dev, *stats):
    for t in stats:
        _require(t.device == dev and t.dtype == torch.float32
                 and tuple(t.shape) == want and t.is_contiguous(),
                 f"lse and delta must be contiguous float32 {want} on {dev}")


def _launch_fwd(q, k, v, seed, causal, sm_scale, dropout_p, layout=None,
                seq_lens=None, causal_shift=None, hash_base=None):
    d = q.shape[-1]
    q, k, v = _padded(q, k, v)
    shape, strides = _check(*_as4d(layout, q, k, v))
    _, sq, _, h, _ = shape
    masks, b = _masks(q, layout, "q", causal, seq_lens, causal_shift)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq) if layout is None else (h, sq), dtype=torch.float32,
                      device=q.device)
    sp = _seed_ptr(seed, dropout_p, q.device)
    _run("ptt_flash_fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), sp, *masks),
         _tail((b, *shape[1:]), strides, causal=causal, sm_scale=sm_scale,
               dropout_p=dropout_p, dtype=q.dtype, dev=q.device,
               hash_base=hash_base),
         "flash_fwd")
    return out[..., :d], lse


def _launch_dq(q, k, v, do, lse, delta, seed, causal, sm_scale, dropout_p,
               layout=None, seq_lens=None, causal_shift=None, hash_base=None):
    d = q.shape[-1]
    q, k, v, do = _padded(q, k, v, do)
    shape, strides = _check(*_as4d(layout, q, k, v, do))
    _, sq, _, h, _ = shape
    masks, b = _masks(q, layout, "q", causal, seq_lens, causal_shift)
    _check_stats((b, h, sq) if layout is None else (h, sq), q.device, lse,
                 delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    sp = _seed_ptr(seed, dropout_p, q.device)
    _run("ptt_flash_bwd_dq", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(), sp, *masks),
         _tail((b, *shape[1:]), strides, causal=causal, sm_scale=sm_scale,
               dropout_p=dropout_p, dtype=q.dtype, dev=q.device,
               hash_base=hash_base),
         "flash_bwd_dq")
    return dq[..., :d]


def _launch_dkv(q, k, v, do, lse, delta, seed, causal, sm_scale, dropout_p,
                layout=None, seq_lens=None, causal_shift=None, hash_base=None):
    d = q.shape[-1]
    q, k, v, do = _padded(q, k, v, do)
    shape, strides = _check(*_as4d(layout, q, k, v, do))
    _, sq, _, h, _ = shape
    masks, b = _masks(q, layout, "k", causal, seq_lens, causal_shift)
    _check_stats((b, h, sq) if layout is None else (h, sq), q.device, lse,
                 delta)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    sp = _seed_ptr(seed, dropout_p, q.device)
    _run("ptt_flash_bwd_dkv", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), sp, *masks),
         _tail((b, *shape[1:]), strides, causal=causal, sm_scale=sm_scale,
               dropout_p=dropout_p, dtype=q.dtype, dev=q.device,
               hash_base=hash_base),
         "flash_bwd_dkv")
    return dk[..., :d], dv[..., :d]


def _bhsd(*ts):
    return [t.transpose(1, 2) for t in ts]


def flash_fwd(q, k, v, seed=None, *, causal=False, sm_scale=None,
              dropout_p=0.0, seq_lens=None, causal_shift=None,
              hash_base=None):
    """Attention forward on ``(B, S, H, D)``: ``(out, lse)``, out
    ``(B, S, H, D)`` in q's dtype, lse f32 ``(B, H, S)``.  ``seed`` is the
    int32 dropout seed (:func:`draw_seed`), used when ``dropout_p > 0``;
    ``seq_lens`` (``(B,)``) and ``causal_shift`` (one) are int32 tensors
    on q's device, or None; ``hash_base`` ``(row0, col0, head0, heads)``
    places the dropout hash (module docstring).  The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; ``flash_fwd.launches``
    counts kernel launches."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        out, lse = mha_reference(*_bhsd(q, k, v), causal=causal,
                                 sm_scale=sm_scale, dropout_p=dropout_p,
                                 seed=seed, seq_lens=seq_lens,
                                 causal_shift=causal_shift,
                                 hash_base=hash_base)
        return out.transpose(1, 2), lse
    out = _launch_fwd(q, k, v, seed, causal, sm_scale, dropout_p, None,
                      seq_lens, causal_shift, hash_base=hash_base)
    flash_fwd.launches += 1
    return out


flash_fwd.launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, seed=None, *, causal=False,
                 sm_scale=None, dropout_p=0.0, seq_lens=None,
                 causal_shift=None, hash_base=None):
    """dq on ``(B, S, H, D)`` from the output gradient ``do``, the
    forward's lse and ``delta = rowsum(out * do) - dlse`` (f32 ``(B, H,
    S)``).  The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; ``flash_bwd_dq.launches`` counts kernel launches."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return mha_dq_reference(*_bhsd(q, k, v, do), lse, delta,
                                causal=causal, sm_scale=sm_scale,
                                dropout_p=dropout_p, seed=seed,
                                seq_lens=seq_lens, causal_shift=causal_shift,
                                hash_base=hash_base).transpose(1, 2)
    dq = _launch_dq(q, k, v, do, lse, delta, seed, causal, sm_scale,
                    dropout_p, None, seq_lens, causal_shift,
                    hash_base=hash_base)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, seed=None, *, causal=False,
                  sm_scale=None, dropout_p=0.0, seq_lens=None,
                  causal_shift=None, hash_base=None):
    """``(dk, dv)`` on ``(B, S, H, D)``; arguments as
    :func:`flash_bwd_dq`.  ``flash_bwd_dkv.launches`` counts kernel
    launches."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        dk, dv = mha_dkv_reference(*_bhsd(q, k, v, do), lse, delta,
                                   causal=causal, sm_scale=sm_scale,
                                   dropout_p=dropout_p, seed=seed,
                                   seq_lens=seq_lens,
                                   causal_shift=causal_shift,
                                   hash_base=hash_base)
        return dk.transpose(1, 2), dv.transpose(1, 2)
    out = _launch_dkv(q, k, v, do, lse, delta, seed, causal, sm_scale,
                      dropout_p, None, seq_lens, causal_shift,
                      hash_base=hash_base)
    flash_bwd_dkv.launches += 1
    return out


flash_bwd_dkv.launches = 0


def _delta(out, do, dlse=None):
    """``rowsum(out * do) - dlse`` in f32, heads first: the backward's
    delta (an lse cotangent folds in, since d lse / d s is p)."""
    delta = (out.float() * do.float()).sum(-1).transpose(-1, -2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


class _Flash(torch.autograd.Function):
    """Attention on ``(B, S, H, D)`` with the flash kernels both ways;
    returns ``(out, lse)``, both differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, seed, seq_lens, causal_shift, causal,
                sm_scale, dropout_p, hash_base=None):
        ctx.opts = dict(causal=causal, sm_scale=sm_scale, dropout_p=dropout_p,
                        seq_lens=seq_lens, causal_shift=causal_shift,
                        hash_base=hash_base)
        out, lse = flash_fwd(q, k, v, seed, **ctx.opts)
        ctx.save_for_backward(q, k, v, out, lse, seed)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse, seed = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        elif do.stride(-1) != 1:
            do = do.contiguous()
        delta = _delta(out, do, dlse)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, seed, **ctx.opts)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, seed, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None, None


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
    return _Flash.apply(query, key, value, seed, None, None, bool(causal),
                        _scale(query, None), float(dropout_p))[0]


def _int32_scalar(value, device):
    """An int as a 0-d int32 tensor on ``device``, by a fill on the device
    (no host-to-device copy, which a CUDA graph's capture refuses); a
    tensor as it is, on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(value), dtype=torch.int32, device=device)


def _seed_tensor(seed, dropout_p, device):
    """The dropout seed as an int32 tensor on ``device``; None without
    dropout."""
    if dropout_p <= 0.0:
        return None
    if not isinstance(seed, torch.Tensor):
        seed = _int32_scalar(0 if seed is None else seed, device)
    return seed


def mha(q, k, v, *, causal=False, sm_scale=None, dropout_p=0.0, seed=None,
        seq_lens=None, causal_shift=None, return_lse=False, hash_base=None):
    """Flash attention on ``(B, H, S, D)`` with an explicit int32 dropout
    ``seed`` (a tensor on q's device, or an int), differentiable in q, k
    and v; ``return_lse`` adds the f32 ``(B, H, S)`` log-sum-exp, itself
    differentiable.  ``seq_lens`` (``(B,)``, self-attention only) keeps
    keys ``< seq_lens[b]`` and measures causal from position 0;
    ``causal_shift`` (an int or an int32 tensor, read on the device,
    ``causal`` only) keeps key ``j`` for query ``i`` when ``j <= i +
    shift``; ``hash_base`` ``(row0, col0, head0, heads)`` places the
    dropout hash (module docstring)."""
    b, _, sq, _ = q.shape
    if seq_lens is not None:
        if sq != k.shape[2]:
            raise ValueError("seq_lens requires self-attention (sq == skv)")
        seq_lens = torch.as_tensor(seq_lens, dtype=torch.int32,
                                   device=q.device).reshape(b).contiguous()
    if causal_shift is not None:
        if not causal:
            raise ValueError("causal_shift requires causal=True")
        causal_shift = _int32_scalar(causal_shift, q.device)
    out, lse = _Flash.apply(*_bhsd(q, k, v),
                            _seed_tensor(seed, dropout_p, q.device), seq_lens,
                            causal_shift, bool(causal), _scale(q, sm_scale),
                            float(dropout_p),
                            None if hash_base is None else tuple(hash_base))
    out = out.transpose(1, 2)
    return (out, lse) if return_lse else out


# -- packed sequences: the wrappers and mha_packed -------------------------

def flash_packed_fwd(q, k, v, layout, seed=None, *, causal=False,
                     sm_scale=None, dropout_p=0.0):
    """Packed attention forward: q ``(total_q, H, D)``, k and v
    ``(total_k, H, D)``, the sequences in ``layout``
    (:class:`PackedLayout`); ``(out, lse)``, out ``(total_q, H, D)``, lse
    f32 ``(H, total_q)``.  The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; ``flash_packed_fwd.launches`` counts kernel
    launches."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return mha_packed_reference(
            q, k, v, layout.cu_q, layout.cu_k, causal=causal,
            sm_scale=sm_scale, dropout_p=dropout_p, seed=seed,
            block_q=layout.block_q, block_k=layout.block_k)
    out = _launch_fwd(q, k, v, seed, causal, sm_scale, dropout_p, layout)
    flash_packed_fwd.launches += 1
    return out


flash_packed_fwd.launches = 0


def flash_packed_bwd_dq(q, k, v, do, lse, delta, layout, seed=None, *,
                        causal=False, sm_scale=None, dropout_p=0.0):
    """Packed dq from ``do``, the forward's lse and ``delta = rowsum(out *
    do)`` (f32 ``(H, total_q)``).  The CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; ``flash_packed_bwd_dq.launches`` counts
    kernel launches."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return mha_packed_dq_reference(
            q, k, v, do, lse, delta, layout.cu_q, layout.cu_k, causal=causal,
            sm_scale=sm_scale, dropout_p=dropout_p, seed=seed,
            block_q=layout.block_q, block_k=layout.block_k)
    dq = _launch_dq(q, k, v, do, lse, delta, seed, causal, sm_scale,
                    dropout_p, layout)
    flash_packed_bwd_dq.launches += 1
    return dq


flash_packed_bwd_dq.launches = 0


def flash_packed_bwd_dkv(q, k, v, do, lse, delta, layout, seed=None, *,
                         causal=False, sm_scale=None, dropout_p=0.0):
    """Packed ``(dk, dv)``; arguments as :func:`flash_packed_bwd_dq`.
    ``flash_packed_bwd_dkv.launches`` counts kernel launches."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return mha_packed_dkv_reference(
            q, k, v, do, lse, delta, layout.cu_q, layout.cu_k, causal=causal,
            sm_scale=sm_scale, dropout_p=dropout_p, seed=seed,
            block_q=layout.block_q, block_k=layout.block_k)
    out = _launch_dkv(q, k, v, do, lse, delta, seed, causal, sm_scale,
                      dropout_p, layout)
    flash_packed_bwd_dkv.launches += 1
    return out


flash_packed_bwd_dkv.launches = 0


class _PackedFlash(torch.autograd.Function):
    """Packed attention with the packed kernels both ways (the JAX
    ``_pk_flash``); differentiable in q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, seed, layout, causal, sm_scale, dropout_p):
        ctx.layout = layout
        ctx.opts = dict(causal=causal, sm_scale=sm_scale, dropout_p=dropout_p)
        out, lse = flash_packed_fwd(q, k, v, layout, seed, **ctx.opts)
        ctx.save_for_backward(q, k, v, out, lse, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, seed = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = _delta(out, do)
        dq = flash_packed_bwd_dq(q, k, v, do, lse, delta, ctx.layout, seed,
                                 **ctx.opts)
        dk, dv = flash_packed_bwd_dkv(q, k, v, do, lse, delta, ctx.layout,
                                      seed, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def mha_packed(q, k, v, cu_q, cu_k, *, causal=False, sm_scale=None,
               dropout_p=0.0, seed=None, block_q=None, block_k=None):
    """Ragged varlen flash attention over packed tokens: q ``(total_q, H,
    D)``, k and v ``(total_k, H, D)``, ``cu_q``/``cu_k`` ``(B + 1,)``
    cumulative lengths (read once on the host).  Cross lengths are
    allowed; ``causal`` aligns each pair's diagonal bottom right (key
    ``j`` kept for query ``i`` when ``j <= i + len_k - len_q``).
    ``seed`` is the int32 dropout seed (a tensor on q's device, or an
    int).  ``block_q``/``block_k`` do not set the CUDA kernels' tiles:
    they set the JAX kernel's packed layout, which the dropout hash reads
    (:class:`PackedLayout`).  Returns out ``(total_q, H, D)``,
    differentiable in q, k and v."""
    layout = PackedLayout(cu_q, cu_k, q.shape[0], k.shape[0],
                          block_q=block_q, block_k=block_k)
    return _PackedFlash.apply(q, k, v, _seed_tensor(seed, dropout_p, q.device),
                              layout, bool(causal), _scale(q, sm_scale),
                              float(dropout_p))
