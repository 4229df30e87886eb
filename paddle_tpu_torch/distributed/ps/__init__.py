"""A large embedding table sharded over the ranks, in place of a
parameter server (the counterpart of ``paddle_tpu/distributed/ps/``).

The JAX package replaces the reference's asynchronous parameter servers
by a table whose rows its compiler shards over the data axes; the port
runs one process per rank, so it does the exchanges itself:

 - :class:`ShardedEmbedding`: each rank holds ``V / N`` consecutive rows
   of a ``V x D`` table, ``N`` the product of the live mesh axes among
   ``axes`` (``("dp", "sharding", "mp")``: axes of size above 1 whose
   running product divides ``V``, filtered as the JAX package does);
   rank at window ``w`` of those axes (the JAX spec ``((live...), None)``,
   :func:`..checkpoint.spec_window`) holds rows ``[w V/N, (w+1) V/N)``.
   A lookup is an ``autograd.Function``: the ranks' ids are all-gathered,
   each owner looks up the rows it holds for every rank's ids, and an
   all-to-all returns each rank its rows, taken from their owners (no
   sum, so the rows are the table's bits).  The backward is the
   transpose: the gradients are all-gathered and each owner adds the
   rows of its ids, in the ranks' order and each rank's order, so its
   gradient rows are the same bits a world of one gets from
   ``F.embedding`` over the ranks' batches one after another (tables of
   more than ``ONE_HOT_MAX_ROWS`` rows; the sorted sum of its backward).
   The gradient is that sum: a data-parallel update must not average it
   again.  Every rank of the group looks up the same number of ids.  On
   gloo, CUDA tensors cross as the port's collectives carry them.
 - :func:`row_sparse_apply` and :class:`RowSparseAdagrad`: updates that
   read and write only the rows an id touched (``torch.unique``, the
   repeats' gradients added by ``index_add_``), never a dense
   ``V x D`` gradient.

What the reference's parameter servers also do (asynchronous pushes,
staleness control, tables spilled to disk) the JAX package does not
build either.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["ShardedEmbedding", "row_sparse_apply", "RowSparseAdagrad"]


def _live_axes(num_embeddings: int, axes) -> tuple:
    from ..mesh import mesh_axis_size
    live, size = [], 1
    for a in axes:
        n = mesh_axis_size(a)
        if n > 1 and num_embeddings % (size * n) == 0:
            live.append(a)
            size *= n
    return tuple(live)


def _table_group(live: tuple):
    """``(group, windows)``: the group of ranks that share this rank's
    coordinates off the ``live`` axes (sorted global ranks), and each
    member's window index.  Every rank makes every such group, in the
    same order."""
    from .. import collective as _c
    from ..env import get_rank
    from ..mesh import get_mesh
    mesh = get_mesh()
    names = list(mesh.axis_names)
    lead = [names.index(a) for a in names if a not in live]
    tail = [names.index(a) for a in live]
    lines = np.transpose(mesh.ranks, lead + tail).reshape(
        -1, int(np.prod([mesh.ranks.shape[i] for i in tail])))
    me, mine = get_rank(), None
    for line in lines:
        # line[w] holds window w (the live axes row-major, first major)
        ranks = sorted(int(r) for r in line)
        g = _c.new_group(ranks)
        if me in ranks:
            windows = [int(np.where(line == r)[0][0]) for r in ranks]
            mine = (g, windows)
    return mine


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, weight, emb):
        from .. import collective as _c
        g, per = emb._group, weight.shape[0]
        flat = ids.reshape(-1)
        parts: list = []
        _c.all_gather(parts, flat, group=g)
        every = torch.stack(parts)                   # [N, n] group order
        lo = emb.window * per
        owned = (every >= lo) & (every < lo + per)
        local = torch.where(owned, every - lo, torch.zeros_like(every))
        rows = weight.index_select(0, local.reshape(-1)).view(
            every.shape[0], every.shape[1], -1)
        rows = rows * owned.unsqueeze(-1).to(rows.dtype)
        got = _c.alltoall_single(rows.contiguous(), group=g)  # [N, n, D]
        member = emb._member_of[flat // per]         # who owns each id
        out = got[member, torch.arange(flat.numel(), device=flat.device)]
        if emb.padding_idx is not None:
            out = out.masked_fill((flat == emb.padding_idx).unsqueeze(-1),
                                  0)
        ctx.save_for_backward(every)
        ctx.emb, ctx.rows, ctx.dtype = emb, per, weight.dtype
        return out.view(*ids.shape, weight.shape[1])

    @staticmethod
    def backward(ctx, grad):
        from .. import collective as _c
        (every,) = ctx.saved_tensors
        emb, per = ctx.emb, ctx.rows
        g = grad.reshape(every.shape[1], -1).contiguous()
        parts: list = []
        _c.all_gather(parts, g, group=emb._group)
        flat = every.reshape(-1)
        gs = torch.cat(parts)                        # [N n, D] group order
        if emb.padding_idx is not None:
            gs = gs.masked_fill((flat == emb.padding_idx).unsqueeze(-1), 0)
        lo = emb.window * per
        owned = (flat >= lo) & (flat < lo + per)
        ids = flat[owned] - lo
        ids, order = torch.sort(ids, stable=True)
        vals = gs[owned].index_select(0, order).float()
        gw = torch.zeros(per, gs.shape[1], dtype=torch.float32,
                         device=gs.device)
        if gw.is_cuda:
            gw.index_put_((ids,), vals, accumulate=True)
        else:
            gw.index_add_(0, ids, vals)
        return None, gw.to(ctx.dtype), None


class ShardedEmbedding(torch.nn.Module):
    """An embedding whose ``num_embeddings`` rows are sharded over the
    live axes of ``axes`` (module docstring).  The whole table is drawn
    from ``generator`` (``weight_attr``: an initializer of the port's
    ``nn.initializer``, ``XavierNormal`` by default) on every rank, and
    each keeps its rows: ``weight`` is this rank's window, with
    ``global_shape``, ``spec`` (the JAX ``PartitionSpec``, a tuple) and
    ``row_offset``.  ``name`` is accepted."""

    def __init__(self, num_embeddings, embedding_dim,
                 axes=("dp", "sharding", "mp"), padding_idx=None,
                 weight_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from ...nn.initializer import XavierNormal
        if generator is None:
            raise ValueError("ShardedEmbedding draws its table from the "
                             "run's generator: pass generator=")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self.padding_idx = padding_idx
        live = _live_axes(num_embeddings, axes)
        self._shard_axes = live
        full = (weight_attr or XavierNormal())(
            (num_embeddings, embedding_dim), generator)
        self._group, n = None, 1
        self.window = 0
        if live:
            self._group, windows = _table_group(live)
            n = len(windows)
            self.window = windows[self._group.rank]
            member_of = [0] * n
            for m, w in enumerate(windows):
                member_of[w] = m
            self._member_of = torch.tensor(member_of, dtype=torch.long,
                                           device=full.device)
        per = num_embeddings // n
        self.weight = torch.nn.Parameter(
            full[self.window * per:(self.window + 1) * per].clone())
        self.weight.global_shape = (num_embeddings, embedding_dim)
        self.weight.spec = (live if live else None, None)
        self.weight.row_offset = self.window * per

    def forward(self, ids):
        if self._group is None:
            from ...nn.functional import embedding
            return embedding(ids, self.weight, padding_idx=self.padding_idx)
        return _Lookup.apply(ids, self.weight, self)


def _unique_sum(ids: torch.Tensor, row_grads: torch.Tensor):
    """The distinct ids (sorted) and each one's gradient rows summed in
    f32, occurrence by occurrence (``index_add_``)."""
    flat = ids.reshape(-1)
    g = row_grads.reshape(flat.numel(), -1).float()
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    summed = torch.zeros(uniq.numel(), g.shape[1], dtype=torch.float32,
                         device=g.device)
    summed.index_add_(0, inv, g)
    return uniq, summed


@torch.no_grad()
def row_sparse_apply(weight, ids, row_grads, update_fn):
    """``weight``'s rows at ``ids`` replaced by ``update_fn(rows,
    grads)`` over the distinct ids (the repeats' gradients summed, in
    f32), in place: no dense gradient is made.  ``row_grads``:
    ``ids.shape + (D,)``.  Returns ``(weight, unique_ids)``."""
    uniq, summed = _unique_sum(ids, row_grads)
    rows = weight.index_select(0, uniq)
    weight.index_copy_(0, uniq, update_fn(rows, summed).to(weight.dtype))
    return weight, uniq


class RowSparseAdagrad:
    """Adagrad on only the rows an id touched (the reference's sparse
    Adagrad rule): a row's accumulator grows by the mean square of its
    summed gradient, and the row moves by ``lr * g / (sqrt(acc) +
    eps)``.  ``table``: the parameter (this rank's rows of a
    :class:`ShardedEmbedding`; ids index it)."""

    def __init__(self, table: torch.Tensor, learning_rate=0.01,
                 epsilon=1e-8):
        self._table = table
        self._lr = learning_rate
        self._eps = epsilon
        self._acc = torch.zeros(table.shape[0], dtype=torch.float32,
                                device=table.device)

    @torch.no_grad()
    def step_rows(self, ids, row_grads):
        """``ids``: the occurrences; ``row_grads``: their gradient rows
        (``ids.shape + (D,)``).  Returns the distinct ids."""
        w = self._table.data if isinstance(self._table, torch.nn.Parameter) \
            else self._table
        uniq, summed = _unique_sum(ids, row_grads)
        rows = w.index_select(0, uniq).float()
        acc_rows = self._acc.index_select(0, uniq) + \
            (summed * summed).mean(-1)
        new_rows = rows - self._lr * summed / (
            torch.sqrt(acc_rows)[:, None] + self._eps)
        w.index_copy_(0, uniq, new_rows.to(w.dtype))
        self._acc.index_copy_(0, uniq, acc_rows)
        return uniq
