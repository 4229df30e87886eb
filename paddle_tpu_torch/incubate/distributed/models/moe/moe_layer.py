"""MoELayer and expert parallelism (the counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``).

The JAX layer routes with GShard's dense dispatch and combine einsums
and lets its compiler turn them into all-to-alls where the experts are
sharded over a mesh axis.  The port routes by index
(:func:`.functional.route`): each kept choice of a token is a row of an
expert's ``(capacity, D)`` buffer, filled by a scatter-add of the
token's activations (its dispatch) and read back by a gather weighted by
the choice's gate value (its combine); the expert products are
``torch.bmm`` (``ExpertMlp``, stacked ``(E, D, Dff)`` weights) or each
expert of a ``LayerList`` on its buffer.

Expert parallelism (``moe_group``, ``ep`` ranks; the tokens split over
its data group ``moe_group.data_group``, both made from a mesh by
:func:`expert_parallel_groups`: the JAX dryrun's mesh ``{"dp": n / ep,
"ep": ep}`` with the batch split over dp and replicated over ep).  Rank ``j`` of the
expert group holds experts ``[j E / ep, (j + 1) E / ep)``
(``ExpertMlp``'s weights are that window of the JAX ``(E, ...)``
leaves, spec ``("ep", None, None)``, names and global shapes the JAX
ones).  A forward pass:

 - routes its own tokens with the global semantics: each pass's counts
   are all-gathered over the data group, a token's position adds the
   counts of the data ranks before it, the capacity and the auxiliary
   loss count every rank's tokens (the gate probabilities summed over
   the group, differentiably);
 - fills the buffers of every expert with its own tokens and all-reduces
   its experts' buffers over the data group (the reduce to the owner;
   the backward passes each rank the gradient of its own rows);
 - runs its experts, then all-gathers their outputs over ``moe_group``
   (the backward keeps this rank's experts' rows: every rank of the
   expert group computes the same combine);
 - combines its own tokens.

Outputs, ``l_aux`` and the gradients are then the replicated layer's on
the global batch, once each rank's gradients are averaged over the data
group (as ``DataParallel`` does).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .....distributed import collective as _c
from .....distributed.fleet.meta_parallel.mp_ops import _mp_allreduce
from .....nn.functional import gelu
from .....nn.initializer import Constant, Uniform
from .functional import route
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate

__all__ = ["MoELayer", "ExpertMlp", "expert_parallel_groups"]


def _degree(group) -> int:
    return 1 if group is None else group.nranks


class ExpertMlp(torch.nn.Module):
    """``E`` feed-forward experts with stacked weights ``w1`` (E, D,
    Dff), ``b1`` (E, 1, Dff), ``w2`` (E, Dff, D), ``b2`` (E, 1, D), the
    JAX names.  ``moe_group``: the expert-parallel group; rank ``j``
    keeps experts ``[j E / ep, (j + 1) E / ep)`` (drawn whole, so the
    generator ends where the unsharded layer's does), each parameter
    marked with ``expert_axis`` 0 and its ``global_shape``."""

    def __init__(self, num_expert, d_model, d_hidden, activation="gelu", *,
                 generator, moe_group=None):
        super().__init__()
        self.num_expert = num_expert
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.activation = activation
        n = _degree(moe_group)
        if num_expert % n:
            raise ValueError(f"{num_expert} experts do not split over {n} "
                             f"expert-parallel ranks")
        self.local = num_expert // n
        first = 0 if moe_group is None else moe_group.rank * self.local
        bound1 = 1.0 / math.sqrt(d_model)
        bound2 = 1.0 / math.sqrt(d_hidden)
        for name, shape, init in (
                ("w1", (num_expert, d_model, d_hidden),
                 Uniform(-bound1, bound1)),
                ("b1", (num_expert, 1, d_hidden), Constant(0.0)),
                ("w2", (num_expert, d_hidden, d_model),
                 Uniform(-bound2, bound2)),
                ("b2", (num_expert, 1, d_model), Constant(0.0))):
            full = init(shape, generator)
            p = torch.nn.Parameter(full[first:first + self.local].clone())
            p.expert_axis, p.global_shape = 0, shape
            setattr(self, name, p)

    def forward(self, xe):
        """xe: (local experts, C, D) -> (local experts, C, D)."""
        h = torch.bmm(xe, self.w1) + self.b1
        if self.activation == "gelu":
            h = gelu(h, approximate=True)      # jax.nn.gelu's default
        else:
            h = torch.relu(h)
        return torch.bmm(h, self.w2) + self.b2


class _GatherExperts(torch.autograd.Function):
    """The expert group's outputs concatenated on the expert axis; the
    backward keeps this rank's rows (every rank of the group computes the
    same combine, so the gradient is the same on each)."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        parts: list = []
        _c.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // ctx.group.nranks
        return g.narrow(0, ctx.group.rank * n, n).contiguous(), None


class _SumOverRanks(torch.autograd.Function):
    """A sum over the group; its gradient is summed over the group too
    (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        _c.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _c.all_reduce(g, group=ctx.group)
        return g, None


def expert_parallel_groups(mesh, rank: int, ep_axis: str = "ep",
                           data_axis: str = "dp"):
    """The expert-parallel group and the data group of ``rank`` in
    ``mesh`` (:class:`...distributed.mesh.Mesh`): the ranks that differ
    from it only on ``ep_axis``, and only on ``data_axis`` (None, None
    for a rank outside the mesh).  The expert group carries its data
    group as ``.data_group``, which :class:`MoELayer` reads.  Every rank
    of the process group calls it (the groups are made on all ranks in
    one order)."""
    import numpy as np
    out = {ep_axis: None, data_axis: None}
    for axis in (ep_axis, data_axis):
        k = mesh.axis_names.index(axis)
        lines = np.moveaxis(mesh.ranks, k, -1).reshape(
            -1, mesh.ranks.shape[k])
        for line in lines:
            g = _c.new_group([int(r) for r in line])
            if rank in line:
                out[axis] = g
    if out[ep_axis] is not None:
        out[ep_axis].data_group = out[data_axis]
    return out[ep_axis], out[data_axis]


class MoELayer(torch.nn.Module):
    """The JAX layer's signature: ``gate`` a dict (``{"type": "gshard" |
    "switch" | "naive", "top_k": k}``) or a :class:`BaseGate`,
    ``experts`` an :class:`ExpertMlp` or a list of modules (a
    ``ModuleList``, the JAX ``LayerList``).  The load-balancing loss of
    the last forward pass is ``self.l_aux`` (and ``gate.get_loss()``).

    ``moe_group``: the expert-parallel group (an :class:`ExpertMlp`
    built over the same group holds this rank's experts), with the ranks
    holding the other tokens of the batch as its ``data_group``
    (:func:`expert_parallel_groups`; module docstring); an expert group
    without one must span the world.  ``generator`` draws a gate built
    from a dict.  ``mp_group`` and ``recompute_interval`` are accepted
    and unused, as in the JAX layer; ``moe_axis`` names the mesh axis of
    the experts, which with no ``moe_group`` builds the groups from the
    global mesh."""

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, capacity_factor=1.2,
                 moe_axis=None, *, generator=None, **kwargs):
        super().__init__()
        self.d_model = d_model
        if moe_group is None and moe_axis is not None:
            from .....distributed import get_rank
            from .....distributed.mesh import get_mesh
            mesh = get_mesh()
            if mesh.shape.get(moe_axis, 1) > 1:
                moe_group, _ = expert_parallel_groups(mesh, get_rank(),
                                                      moe_axis)
        data_group = getattr(moe_group, "data_group", None)
        if _degree(moe_group) > 1 and not hasattr(moe_group, "data_group"):
            from .....distributed import get_world_size
            if get_world_size() > moe_group.nranks:
                raise ValueError(
                    f"the expert group of {moe_group.nranks} ranks has no "
                    f"data group in a world of {get_world_size()}: build "
                    f"both with expert_parallel_groups(mesh, rank), or set "
                    f"moe_group.data_group to the ranks holding the other "
                    f"tokens")
        if isinstance(experts, (list, tuple)):
            experts = torch.nn.ModuleList(experts)
        self.experts = experts
        if isinstance(experts, ExpertMlp):
            self.num_expert = experts.num_expert
            if _degree(moe_group) != experts.num_expert // experts.local:
                raise ValueError(
                    f"the ExpertMlp holds {experts.local} of "
                    f"{experts.num_expert} experts: build it over the "
                    f"layer's moe_group ({_degree(moe_group)} ranks)")
        else:
            self.num_expert = len(experts)
            if _degree(moe_group) > 1:
                raise NotImplementedError(
                    "expert parallelism over a list of expert modules is "
                    "not ported: use ExpertMlp")
        if gate is None:
            gate = {"type": "gshard", "top_k": 2}
        if isinstance(gate, dict):
            if generator is None:
                raise ValueError("a gate built from a dict draws its weight "
                                 "from generator=")
            typ = gate.get("type", "gshard")
            top_k = gate.get("top_k", 2)
            if typ == "switch" or top_k == 1:
                gate = SwitchGate(d_model, self.num_expert,
                                  generator=generator)
            elif typ == "naive":
                gate = NaiveGate(d_model, self.num_expert, topk=top_k,
                                 generator=generator)
            else:
                gate = GShardGate(d_model, self.num_expert,
                                  generator=generator)
        if not isinstance(gate, BaseGate):
            raise TypeError(f"gate must be a dict or a BaseGate, got "
                            f"{type(gate).__name__}")
        self.gate = gate
        self.top_k = getattr(gate, "top_k", 2)
        self.capacity_factor = capacity_factor
        self.moe_axis = moe_axis
        self.moe_group = moe_group if _degree(moe_group) > 1 else None
        self.data_group = data_group if _degree(data_group) > 1 else None
        self.l_aux = None

    def _capacity(self, num_tokens):
        cap = int(math.ceil(self.top_k * self.capacity_factor * num_tokens
                            / self.num_expert))
        return max(cap, 4)

    def _exchange(self, raw):
        """(offset, totals) of one pass's counts over the data group."""
        parts: list = []
        _c.all_gather(parts, raw.contiguous(), group=self.data_group)
        counts = torch.stack(parts)
        me = self.data_group.rank
        return counts[:me].sum(0), counts.sum(0)

    def forward(self, inp):
        shape = inp.shape
        d = shape[-1]
        xt = inp.reshape(-1, d)
        t = xt.shape[0]
        dg = self.data_group
        total = t * _degree(dg)
        cap = self._capacity(total)
        logits = self.gate(xt)
        choices, weights, aux = route(
            logits, cap, self.top_k,
            exchange=self._exchange if dg is not None else None,
            total_tokens=total,
            gate_sum=(lambda s: _SumOverRanks.apply(s, dg))
            if dg is not None else None)
        self.l_aux = aux
        self.gate.set_loss(aux)
        e = self.num_expert
        rows = torch.arange(t, device=xt.device)
        tokens = torch.cat([rows[c.keep] for c in choices])
        slots = torch.cat([c.expert[c.keep] * cap + c.pos[c.keep]
                           for c in choices])
        w = torch.cat([wt[c.keep] for c, wt in zip(choices, weights)])
        # dispatch: each kept choice's activations into its expert's row
        xe = xt.new_zeros(e * cap, d).index_add(0, slots, xt[tokens])
        mg = self.moe_group
        if mg is not None or dg is not None:
            n_local = e // _degree(mg)
            first = 0 if mg is None else mg.rank * n_local
            xe = xe.narrow(0, first * cap, n_local * cap)
            xe = _mp_allreduce(xe, dg)            # every data rank's rows
        if isinstance(self.experts, ExpertMlp):
            ye = self.experts(xe.view(-1, cap, d)).reshape(-1, d)
        else:
            ye = torch.cat([expert(xe[i * cap:(i + 1) * cap])
                            for i, expert in enumerate(self.experts)])
        if mg is not None:
            ye = _GatherExperts.apply(ye, mg)
        # combine: each kept choice's expert output, weighted
        y = xt.new_zeros(t, d).index_add(0, tokens,
                                         ye[slots] * w[:, None].to(ye.dtype))
        return y.reshape(shape)
