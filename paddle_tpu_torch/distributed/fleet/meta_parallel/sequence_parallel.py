"""Sequence (context) parallelism (the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sequence_parallel.py``).

The sequence axis is split over fleet's ``sep`` group: rank ``r`` of
``n`` holds positions ``[r S/n, (r + 1) S/n)`` of every sequence, and
attention over the whole sequence is computed two ways, on local
``(B, H, S_local, D)`` shards (paddle's ``(B, S_local, H, D)`` for
:class:`RingFlashAttention`):

 - :func:`ring_attention`: K and V rotate around the group, one
   ``batch_isend_irecv`` a tick (the next block is posted before the
   current one computes); each step is one launch of the flash forward
   on the shard's queries against the block in hand, with the causal
   diagonal shifted by ``(r - src) S_local`` and the dropout hash placed
   at the block's rows and keys in the whole sequence, so a step draws
   the whole attention's mask; the steps' ``(out, lse)`` merge online
   (the JAX ``_merge``).  The backward runs the ring again: the flash dq
   and dk/dv kernels on each block with the merged lse and ``delta =
   rowsum(out * do)``, dq summed in f32 on the rank, dK/dV summed in f32
   as they travel with their block back to its owner.  That is the
   gradient the JAX package's autodiff takes through its checkpointed
   scan, without recomputing the merge.  A causal block whose keys all
   lie after the shard's queries (``src > r``) is skipped: it would add
   an lse of -1e30, whose weight in the merge is exactly 0, and zero
   gradients (``skip_masked=False`` computes it, to the same bits).
 - :func:`ulysses_attention`: an all-to-all trades the sequence shard
   for a head shard, attention runs over the whole sequence on ``H/n``
   heads (the flash kernels from ``FLASH_MIN_SEQ`` on or with dropout,
   whose hash then takes the heads' place among all ``H``; below, the
   plain f32 softmax of the JAX route), and a second all-to-all trades
   back.

``split_sequence`` / ``gather_sequence`` cut a replicated tensor to the
shard and gather the shards back.  On gloo a CUDA tensor crosses through
the host for the point-to-point sends and the all-to-alls
(``collective.host_staged``).
"""
from __future__ import annotations

import torch

from ... import collective as _c
from ....ops import pallas_ops as _po

__all__ = ["ring_attention", "ulysses_attention", "split_sequence",
           "gather_sequence", "RingFlashAttention", "sep_group_of"]


def sep_group_of(group=None):
    """``group``, or fleet's sep group when fleet is set up with a sep
    degree above 1, else None."""
    if group is not None:
        return group
    from ..fleet import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_sep_parallel_world_size() <= 1:
        return None
    return hcg.get_sep_parallel_group()


def _size_rank(group):
    return (1, 0) if group is None else (group.nranks, group.rank)


def _merge(o1, lse1, o2, lse2):
    """Two partial softmax results merged (flash attention's combine): o
    f32 ``(B, S, H, D)``, lse f32 ``(B, H, S)``.  A block with lse -1e30
    has weight exactly 0 beside a finite one, so the result is then the
    other's bits."""
    m = torch.maximum(lse1, lse2)
    w1, w2 = torch.exp(lse1 - m), torch.exp(lse2 - m)
    tot = w1 + w2
    lse = torch.log(tot) + m

    def col(w):
        return w.transpose(1, 2).unsqueeze(-1)

    return (o1 * col(w1) + o2 * col(w2)) / col(tot), lse


class _Ring:
    """One rank's place on the ring: its neighbours' global ranks, and one
    exchange a tick."""

    def __init__(self, group):
        self.group = group
        self.n, self.r = _size_rank(group)
        if group is not None:
            self.nxt = group.ranks[(self.r + 1) % self.n]
            self.prv = group.ranks[(self.r - 1) % self.n]

    def post(self, sends):
        """Send each tensor of ``sends`` to the next rank and receive one
        like it from the previous, all issued together; returns
        ``(tasks, received)``."""
        if not sends:
            return [], []
        sends = [t.contiguous() for t in sends]
        got = [torch.empty_like(t) for t in sends]
        ops = [_c.P2POp(_c.isend, t, self.nxt, self.group) for t in sends]
        ops += [_c.P2POp(_c.irecv, t, self.prv, self.group) for t in got]
        return _c.batch_isend_irecv(ops), got

    @staticmethod
    def wait(tasks):
        for t in tasks:
            t.wait()


def _step_opts(ctx, src, dev):
    """The flash arguments of the ring step on the block of rank
    ``src``: the shifted causal diagonal and the hash base."""
    sl = ctx.sl
    opts = dict(causal=ctx.causal, sm_scale=ctx.scale,
                dropout_p=ctx.dropout_p,
                hash_base=(ctx.r * sl, src * sl, 0, 0))
    if ctx.causal:
        opts["causal_shift"] = _po._int32_scalar((ctx.r - src) * sl, dev)
    return opts


def _masked(ctx, src):
    return ctx.causal and ctx.skip and src > ctx.r


class _RingAttention(torch.autograd.Function):
    """Ring attention on paddle-layout ``(B, S_local, H, D)`` shards
    (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, seed, group, causal, scale, dropout_p, skip):
        ring = _Ring(group)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        ctx.dropout_p, ctx.skip = dropout_p, skip
        ctx.n, ctx.r, ctx.sl = ring.n, ring.r, q.shape[1]
        kk, vv = k.contiguous(), v.contiguous()
        o = lse = None
        for t in range(ring.n):
            src = (ring.r - t) % ring.n
            tasks, got = ring.post([kk, vv] if t < ring.n - 1 else [])
            if not _masked(ctx, src):
                o2, lse2 = _po.flash_fwd(q, kk, vv, seed,
                                         **_step_opts(ctx, src, q.device))
                o2 = o2.float()
                o, lse = (o2, lse2) if o is None else _merge(o, lse, o2,
                                                             lse2)
            ring.wait(tasks)
            if got:
                kk, vv = got
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, seed = ctx.saved_tensors
        ring = _Ring(ctx.group)
        do = do.contiguous()
        delta = _po._delta(out, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kk, vv = k.contiguous(), v.contiguous()
        acc = None          # (dk, dv) of the block in hand, summed so far
        for t in range(ring.n):
            src = (ring.r - t) % ring.n
            sends = [kk, vv] if t < ring.n - 1 else []
            if acc is not None:
                sends += list(acc)
            tasks, got = ring.post(sends)
            if _masked(ctx, src):
                dk = dv = None
            else:
                opts = _step_opts(ctx, src, q.device)
                dq += _po.flash_bwd_dq(q, kk, vv, do, lse, delta, seed,
                                       **opts).float()
                dk, dv = _po.flash_bwd_dkv(q, kk, vv, do, lse, delta, seed,
                                           **opts)
                dk, dv = dk.float(), dv.float()
            ring.wait(tasks)
            if t < ring.n - 1:
                kk, vv = got[:2]
            if t > 0:            # the earlier ranks' sums for this block
                dk_in, dv_in = got[-2:]
                dk = dk_in if dk is None else dk_in + dk
                dv = dv_in if dv is None else dv_in + dv
            elif dk is None:
                dk = torch.zeros(k.shape, dtype=torch.float32,
                                 device=k.device)
                dv = torch.zeros_like(dk)
            acc = (dk, dv)
        if ring.n > 1:           # each block's sums back to its owner
            tasks, acc = ring.post(list(acc))
            ring.wait(tasks)
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype), None,
                None, None, None, None, None)


def _ring_paddle(q, k, v, group, causal, sm_scale, dropout_p, seed, skip):
    """:func:`ring_attention` on paddle-layout shards."""
    scale = _po._scale(q, sm_scale)
    return _RingAttention.apply(q, k, v,
                                _po._seed_tensor(seed, dropout_p, q.device),
                                group, bool(causal), scale, float(dropout_p),
                                bool(skip))


def ring_attention(q, k, v, group=None, causal=False, sm_scale=None,
                   dropout_p=0.0, seed=None, *, skip_masked=True):
    """Exact attention over a sequence split over ``group`` (fleet's sep
    group by default) on local ``(B, H, S_local, D)`` shards; returns the
    local output shard, differentiable in q, k and v (module
    docstring).  ``seed`` is the dropout hash's int32 seed (a tensor on
    q's device, or an int), the same on every rank of the ring: the
    shards then draw the mask of the whole sequence's attention.
    ``skip_masked=False`` launches the fully masked causal blocks too."""
    group = sep_group_of(group)
    out = _ring_paddle(*(t.transpose(1, 2) for t in (q, k, v)), group,
                       causal, sm_scale, dropout_p, seed, skip_masked)
    return out.transpose(1, 2)


class _AllToAll(torch.autograd.Function):
    """``(B, H, S_local, D)`` -> ``(B, H/n, S, D)`` (``to_heads``) or back;
    each is the other's adjoint."""

    @staticmethod
    def forward(ctx, x, group, to_heads):
        ctx.group, ctx.to_heads = group, to_heads
        return _a2a(x, group, to_heads)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, not ctx.to_heads), None, None


def _a2a(x, group, to_heads):
    n = group.nranks
    b, h, s, d = x.shape
    if to_heads:      # head chunk j to rank j; rank i's rows are shard i
        send = x.reshape(b, n, h // n, s, d).permute(1, 0, 2, 3, 4)
        got = _c.alltoall_single(send.contiguous(), group=group)
        return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)
    send = x.reshape(b, h, n, s // n, d).permute(2, 0, 1, 3, 4)
    got = _c.alltoall_single(send.contiguous(), group=group)
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * h, s // n, d)


def _plain_attention(q, k, v, scale, causal):
    """The JAX route below ``flash_min_seq`` (``_partial_attn`` over the
    whole sequence): f32 scores and softmax, out in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.matmul(torch.softmax(s, -1), v.float()).to(q.dtype)


def ulysses_attention(q, k, v, group=None, causal=False, sm_scale=None,
                      dropout_p=0.0, seed=None):
    """DeepSpeed-Ulysses on local ``(B, H, S_local, D)`` shards: an
    all-to-all to ``(B, H/n, S, D)``, attention over the whole sequence,
    an all-to-all back (module docstring).  ``H`` must divide by the
    group's size.  ``seed`` as :func:`ring_attention`'s."""
    from ....nn.functional.common import FLASH_MIN_SEQ
    group = sep_group_of(group)
    n, r = _size_rank(group)
    b, h, sl, d = q.shape
    if h % n:
        raise ValueError(f"heads {h} not divisible by sep degree {n}")
    if n > 1:
        q, k, v = (_AllToAll.apply(t, group, True) for t in (q, k, v))
    scale = _po._scale(q, sm_scale)
    if sl * n >= FLASH_MIN_SEQ or dropout_p > 0.0:
        out = _po.mha(q, k, v, causal=causal, sm_scale=scale,
                      dropout_p=dropout_p, seed=seed,
                      hash_base=(0, 0, r * (h // n), h))
    else:
        out = _plain_attention(q, k, v, scale, causal)
    return _AllToAll.apply(out, group, False) if n > 1 else out


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        parts: list = []
        _c.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, g):
        # all_gather's transpose: every rank's gradient summed, this
        # rank's slice kept (the JAX psum_scatter)
        g = g.contiguous()
        _c.all_reduce(g, group=ctx.group)
        n, r = _size_rank(ctx.group)
        sl = g.shape[ctx.axis] // n
        return g.narrow(ctx.axis, r * sl, sl), None, None


def split_sequence(x, group=None, axis=1):
    """This rank's shard of a replicated tensor's sequence axis."""
    n, r = _size_rank(sep_group_of(group))
    if x.shape[axis] % n:
        raise ValueError(f"a sequence of {x.shape[axis]} does not split "
                         f"over {n} sep ranks")
    sl = x.shape[axis] // n
    return x.narrow(axis, r * sl, sl)


def gather_sequence(x, group=None, axis=1):
    """The whole sequence from every rank's shard (all-gathered along
    ``axis``)."""
    group = sep_group_of(group)
    if group is None or group.nranks == 1:
        return x
    return _GatherSeq.apply(x, group, axis)


class RingFlashAttention:
    """Paddle-layout ``(B, S_local, H, D)`` attention over the sep group:
    :func:`ring_attention` when the group has more than one rank, else
    ``F.scaled_dot_product_attention``.  With dropout in training the
    ring's seed is drawn from ``generator``, which must then give every
    sep rank the same draws."""

    def __init__(self, axis_name="sep", causal=True, group=None):
        self.axis_name = axis_name
        self.causal = causal
        self.group = group

    def __call__(self, q, k, v, *, dropout_p=0.0, training=True,
                 generator=None):
        group = sep_group_of(self.group)
        if group is None or group.nranks == 1:
            from ....nn import functional as F
            return F.scaled_dot_product_attention(
                q, k, v, dropout_p=dropout_p, is_causal=self.causal,
                training=training, generator=generator)
        p = dropout_p if training else 0.0
        seed = None
        if p > 0.0:
            if generator is None:
                raise ValueError("attention dropout needs the run's "
                                 "generator")
            seed = _po.draw_seed(generator)
        return _ring_paddle(q, k, v, group, self.causal, None, p, seed,
                            True)
