"""Graph pattern-matching fusion pass: transformer clusters to the block
kernels (the counterpart of ``paddle_tpu/ops/fusion_pass.py``).

The JAX pass re-traces a step to a jaxpr and rewrites closed clusters of
equations.  The port has no jaxpr: it traces the model's ``forward`` with
``torch.fx`` at the level of the port's own API.  The port's ``Linear``,
``LayerNorm``, ``Embedding`` and ``Dropout`` layers stay leaf calls, the
port's functionals (``F.linear``, ``F.gelu``,
``F.scaled_dot_product_attention``, ...), ``recompute`` and BERT's
``additive_attention_mask`` stay single calls, and optional arguments left at None are fixed as None.  So a
recomputed block is one node, as ``remat2`` is one equation to the JAX
matchers, and nothing inside it is rewritten.

Patterns, matched in the JAX priority order (attention, then gelu, then
the LayerNorm family, so an MLP's fc1 goes to the gelu cluster and the
LayerNorm before it stays a bare ``layer_norm``):

==================== ======================================================
``attention_block``   ``F.scaled_dot_product_attention`` with no mask and
                      no active dropout -> :func:`fused_attention_block`
                      (the flash kernels at every length)
``matmul_bias_gelu``  a ``Linear`` or ``F.linear`` whose only user is
                      ``F.gelu`` (either form) ->
                      :func:`fused_matmul_bias_gelu`
``ln_matmul``         a LayerNorm (with or without a residual) whose only
                      user takes it as the x of a ``Linear`` or
                      ``F.linear`` -> :func:`fused_ln_matmul`;
                      ``torch.matmul`` never matches, as the JAX GPT
                      head's einsum does not
``residual_ln``       a LayerNorm called with ``residual=``, or fed by an
                      ``add`` whose only user it is (the add is absorbed:
                      the kernel sums in f32)
``layer_norm``        any other LayerNorm
==================== ======================================================

A cluster is taken only when it is closed: every user of an interior
node is inside the cluster (``_closed`` of the JAX pass).  Reads of an
interior node's ``shape``, ``dtype`` or ``device`` are not uses of its
values (a jaxpr has static shapes and shows none); they are redirected to
a node with the same metadata.  An fx graph carries no shapes, so where
the JAX matcher also asks both addends of an absorbed add to have the
LayerNorm input's shape, the port's cluster checks at run time, and for
a broadcast addend it adds first and normalizes without a residual.

:func:`wrap` returns a module that runs the rewritten graph on the SAME
``Parameter`` objects under the SAME names, so ``state_dict``,
``params_from_numpy`` and an optimizer's state by name are unchanged.
The graph is traced at the first call for each training mode and each
set of arguments given, and kept.  ``PT_FUSION_PASS=0`` turns the pass
off (the wrapped module then runs the model as it is) and
``PT_FUSION_DISABLE=pat1,pat2`` leaves patterns out.  There is no silent
fallback: when the pass is on and the trace or the rewrite fails, the
call raises.  A rewritten cluster takes the kernels on CUDA tensors and
their plain versions on CPU tensors, like every wrapper of the port, so
:func:`summary` keeps the JAX keys with ``fallbacks`` always empty.
"""
from __future__ import annotations

import inspect
import math
import operator
import os

import torch
import torch.fx as fx

from ..observability.telemetry import get_telemetry
from . import fused_kernels as fk

__all__ = ["PATTERNS", "Cluster", "FusedModule", "fusion_enabled",
           "disabled_patterns", "match", "count_patterns", "wrap", "summary",
           "reset_stats"]

PATTERNS = ("attention_block", "matmul_bias_gelu", "ln_matmul",
            "residual_ln", "layer_norm")

_FALSY = {"0", "false", "no", "off"}
_META_ATTRS = {"shape", "dtype", "device"}


def fusion_enabled() -> bool:
    """False when ``PT_FUSION_PASS`` is 0, false, no or off."""
    return os.environ.get(
        "PT_FUSION_PASS", "1").strip().lower() not in _FALSY


def disabled_patterns() -> set:
    """The patterns ``PT_FUSION_DISABLE`` (comma-separated) leaves out."""
    raw = os.environ.get("PT_FUSION_DISABLE", "")
    return {t.strip() for t in raw.split(",") if t.strip()}


# -- stats -------------------------------------------------------------------

_stats = {"rewrites": {}, "fallbacks": {}, "traces": 0}


def reset_stats():
    _stats["rewrites"] = {}
    _stats["fallbacks"] = {}
    _stats["traces"] = 0


def summary():
    """Pass stats of this process: pattern -> rewrite count,
    ``fallbacks`` (always empty: the port has no fallback route), and
    the number of graphs traced."""
    return {"rewrites": dict(_stats["rewrites"]),
            "fallbacks": dict(_stats["fallbacks"]),
            "traces": _stats["traces"]}


def _note_rewrite(pattern):
    """One cluster rewritten: the stats and ``pt_fusion_rewrites_total``
    (the port has no fallback route, so ``pt_fusion_fallbacks_total``
    stays empty)."""
    _stats["rewrites"][pattern] = _stats["rewrites"].get(pattern, 0) + 1
    get_telemetry().fusion_rewrite(pattern)


# -- the trace -----------------------------------------------------------------

class _Tracer(fx.Tracer):
    """Traces at the level of the port's API: its layers are leaves; its
    functionals, ``recompute`` and the attention mask's conversion single
    calls."""

    def __init__(self):
        from ..distributed.fleet import recompute
        from ..incubate.models.bert import additive_attention_mask
        from ..nn import functional as F
        super().__init__(autowrap_modules=(math, F),
                         autowrap_functions=(recompute,
                                             additive_attention_mask))

    def is_leaf_module(self, m, qualname):
        from ..nn import Dropout, Embedding, LayerNorm, Linear
        return isinstance(m, (Linear, LayerNorm, Embedding, Dropout)) or \
            super().is_leaf_module(m, qualname)


def _bind(model, args, kwargs):
    """The call's arguments by name, defaults applied, and the ones fixed
    in the trace: everything but tensors and generators (None for the
    optional arguments left out)."""
    bound = inspect.signature(model.forward).bind(*args, **kwargs)
    bound.apply_defaults()
    concrete = {n: v for n, v in bound.arguments.items()
                if not isinstance(v, (torch.Tensor, torch.Generator))}
    return bound, concrete


# -- what the nodes are ----------------------------------------------------------

def _functional(name):
    from ..nn import functional as F
    return getattr(F, name)


def _module(root, node, kind):
    if node.op != "call_module":
        return None
    from .. import nn
    m = root.get_submodule(node.target)
    return m if isinstance(m, getattr(nn, kind)) else None


def _call_args(node, fn):
    """``node``'s arguments by the parameter names of ``fn``."""
    return inspect.signature(fn).bind(*node.args, **node.kwargs).arguments


def _as_linear(root, node):
    """``(x, weight, bias)`` of a Linear layer call or an ``F.linear``
    call (weight and bias as attribute paths of ``root`` or nodes)."""
    if _module(root, node, "Linear") is not None:
        return node.args[0], f"{node.target}.weight", f"{node.target}.bias"
    if node.op == "call_function" and node.target is _functional("linear"):
        a = _call_args(node, node.target)
        return a["x"], a["weight"], a.get("bias")
    return None


def _as_layer_norm(root, node):
    """``dict(x, weight, bias, eps, residual)`` of a LayerNorm layer call
    over the last axis."""
    m = _module(root, node, "LayerNorm")
    if m is None or len(m._normalized_shape) != 1:
        return None
    a = _call_args(node, m.forward)
    return {"x": a["x"], "weight": f"{node.target}.weight",
            "bias": f"{node.target}.bias", "eps": float(m._epsilon),
            "residual": a.get("residual")}


def _is_meta_use(node):
    """A read of a node's shape, dtype or device, not of its values."""
    return node.op == "call_function" and node.target is getattr and \
        node.args[1] in _META_ATTRS


def _data_users(node):
    return [u for u in node.users if not _is_meta_use(u)]


class Cluster:
    """One matched, rewritable subgraph: its ``nodes`` in graph order (the
    last is the root, whose value the cluster computes), the ``call``
    that replaces it and that call's arguments (nodes, attribute paths of
    the root module, constants), and where metadata reads of each
    interior node go (``meta_to``)."""
    __slots__ = ("pattern", "nodes", "call", "args", "meta_to")

    def __init__(self, pattern, nodes, call, args, meta_to=None):
        self.pattern = pattern
        self.nodes = list(nodes)
        self.call = call
        self.args = tuple(args)
        self.meta_to = dict(meta_to or {})

    @property
    def root(self):
        return self.nodes[-1]


def _closed(cl):
    """No interior value escapes: every data user of a node other than
    the root is inside the cluster, and its metadata reads have a node
    to go to."""
    inside = set(cl.nodes)
    for n in cl.nodes[:-1]:
        if any(u not in inside for u in _data_users(n)):
            return False
        if len(_data_users(n)) != len(n.users) and n not in cl.meta_to:
            return False
    return True


# -- the calls a cluster becomes ------------------------------------------------

def _rows(x):
    return x.reshape(-1, x.shape[-1])


def _attention_call(q, k, v, is_causal):
    """Attention of ``(B, S, H, D)`` q, k and v by the flash kernels."""
    out = fk.fused_attention_block(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=is_causal)
    return out.transpose(1, 2)


def _mbg_call(x, weight, bias, approximate):
    y = fk.fused_matmul_bias_gelu(_rows(x), weight, bias,
                                  approximate=approximate)
    return y.reshape(*x.shape[:-1], weight.shape[1])


def _residual(x, add):
    """``(x, residual)`` for the LayerNorm kernels: the absorbed add's two
    addends when they agree in shape and dtype, else their sum and
    none."""
    if add is None:
        return x, None
    a, b = add
    if a.shape == b.shape and a.dtype == b.dtype:
        return a, b
    return a + b, None


def _ln_call(x, weight, bias, epsilon, residual, add):
    """A LayerNorm whose input add was absorbed (``add`` its addends, x
    None)."""
    x, residual = _residual(x, add)
    y = fk.fused_layer_norm(_rows(x), weight, bias, epsilon,
                            None if residual is None else _rows(residual))
    return y.reshape(x.shape)


def _ln_matmul_call(x, ln_weight, ln_bias, epsilon, residual, add, weight,
                    bias):
    if add is not None:
        x, residual = _residual(x, add)
    y = fk.fused_ln_matmul(_rows(x), weight, ln_weight, ln_bias, bias,
                           None if residual is None else _rows(residual),
                           epsilon=epsilon)
    return y.reshape(*x.shape[:-1], weight.shape[1])


# -- matchers ------------------------------------------------------------------

def _match_attention(root, node, claimed):
    from ..nn import functional as F
    if node.op != "call_function" or \
            node.target is not F.scaled_dot_product_attention:
        return None
    a = _call_args(node, node.target)
    dropout_p, training = a.get("dropout_p", 0.0), a.get("training", True)
    causal = a.get("is_causal", False)
    if a.get("attn_mask") is not None or any(
            isinstance(v, fx.Node) for v in (dropout_p, training, causal)):
        return None
    if dropout_p > 0.0 and training:
        return None
    return Cluster("attention_block", [node], _attention_call,
                   (a["query"], a["key"], a["value"], bool(causal)))


def _match_mbg(root, node, claimed):
    if node.op != "call_function" or node.target is not _functional("gelu"):
        return None
    a = _call_args(node, node.target)
    lin = a["x"]
    approx = a.get("approximate", False)
    if not isinstance(lin, fx.Node) or lin in claimed or \
            isinstance(approx, fx.Node):
        return None
    parts = _as_linear(root, lin)
    if parts is None or _data_users(lin) != [node]:
        return None
    x, weight, bias = parts
    return Cluster("matmul_bias_gelu", [lin, node], _mbg_call,
                   (x, weight, bias, bool(approx)))


def _sole_add(node, claimed):
    """``node`` when it is a tensor ``+`` of two nodes, else None."""
    if isinstance(node, fx.Node) and node.op == "call_function" and \
            node.target is operator.add and \
            len(node.args) == 2 and not node.kwargs and \
            all(isinstance(v, fx.Node) for v in node.args) and \
            node not in claimed:
        return node
    return None


def _match_ln(root, node, claimed):
    ln = _as_layer_norm(root, node)
    if ln is None or node in claimed:
        return None
    x, residual = ln["x"], ln["residual"]
    nodes, meta_to = [node], {}
    add = None
    if residual is None:
        add = _sole_add(x, claimed)
        if add is not None and _data_users(add) == [node]:
            nodes.insert(0, add)
            meta_to[add] = add.args[0]
        else:
            add = None
    users = _data_users(node)
    lin = users[0] if len(users) == 1 and users[0] not in claimed else None
    parts = _as_linear(root, lin) if lin is not None else None
    # an absorbed add is erased with the cluster: the call gets its addends
    ln_args = (None, ln["weight"], ln["bias"], ln["eps"], residual,
               tuple(add.args)) if add is not None else \
        (x, ln["weight"], ln["bias"], ln["eps"], residual, None)
    if parts is not None and parts[0] is node:
        nodes.append(lin)
        meta_to[node] = add.args[0] if add is not None else x
        return Cluster("ln_matmul", nodes, _ln_matmul_call,
                       ln_args + parts[1:], meta_to)
    pattern = "layer_norm" if add is None and residual is None \
        else "residual_ln"
    if add is None:   # already the LayerNorm kernels: kept as it is
        return Cluster(pattern, nodes, None, ())
    return Cluster(pattern, nodes, _ln_call, ln_args, meta_to)


def match(graph: fx.Graph, root: torch.nn.Module, disabled=None):
    """The rewritable clusters of ``graph`` (traced from ``root``),
    highest-priority pattern first, non-overlapping and closed, in graph
    order."""
    if disabled is None:
        disabled = disabled_patterns()
    clusters, claimed = [], set()
    nodes = list(graph.nodes)
    order = {n: i for i, n in enumerate(nodes)}

    def take(cl):
        if cl is None or cl.pattern in disabled:
            return
        if claimed & set(cl.nodes) or not _closed(cl):
            return
        claimed.update(cl.nodes)
        clusters.append(cl)

    for matcher in (_match_attention, _match_mbg, _match_ln):
        for n in nodes:
            take(matcher(root, n, claimed))
    clusters.sort(key=lambda c: order[c.root])
    return clusters


def count_patterns(model, *args, **kwargs):
    """Pattern -> match count for ``model(*args, **kwargs)`` without
    running it."""
    _, concrete = _bind(model, args, kwargs)
    counts = {}
    for cl in match(_Tracer().trace(model, concrete_args=concrete), model):
        counts[cl.pattern] = counts.get(cl.pattern, 0) + 1
    return counts


def _rewrite(graph, clusters):
    """Replace each cluster by one call of its ``call`` at its root (an
    argument that was an earlier cluster's root becomes that cluster's
    call)."""
    replaced = {}
    for cl in clusters:
        if cl.call is None:
            continue
        node = cl.root
        with graph.inserting_before(node):
            args = tuple(graph.get_attr(a) if isinstance(a, str) else a
                         for a in cl.args)
            args = fx.node.map_arg(args, lambda n: replaced.get(n, n))
            new = graph.call_function(cl.call, args)
        node.replace_all_uses_with(new)
        replaced[node] = new
        for n, dest in cl.meta_to.items():
            for u in list(n.users):
                if _is_meta_use(u):
                    u.replace_input_with(n, new if dest is node else dest)
        for n in reversed(cl.nodes):
            graph.erase_node(n)
    graph.lint()


# -- the wrapped module ----------------------------------------------------------

class FusedModule(torch.nn.Module):
    """``model`` with the fusion pass applied: it holds the model's own
    children, parameters and buffers under their names, and runs the
    rewritten graph of each kind of call (traced at its first call)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        for name, child in model.named_children():
            self.add_module(name, child)
        for name, p in model.named_parameters(recurse=False):
            self.register_parameter(name, p)
        for name, b in model.named_buffers(recurse=False):
            self.register_buffer(name, b)
        # kept out of the module tree: the same parameters, once
        self.__dict__["model"] = model
        self.__dict__["_graphs"] = {}
        self.train(model.training)

    def train(self, mode: bool = True):
        super().train(mode)
        self.model.train(mode)
        return self

    def forward(self, *args, **kwargs):
        if not fusion_enabled():
            return self.model(*args, **kwargs)
        bound, concrete = _bind(self.model, args, kwargs)
        disabled = disabled_patterns()
        key = (self.training, tuple((n, repr(v)) for n, v in concrete.items()),
               tuple(sorted(disabled)))
        gm = self._graphs.get(key)
        if gm is None:
            graph = _Tracer().trace(self.model, concrete_args=concrete)
            clusters = match(graph, self.model, disabled)
            _rewrite(graph, clusters)
            gm = fx.GraphModule(self.model, graph)
            self._graphs[key] = gm
            _stats["traces"] += 1
            for cl in clusters:
                _note_rewrite(cl.pattern)
        return gm(*bound.arguments.values())


def wrap(model: torch.nn.Module) -> FusedModule:
    """``model`` under the fusion pass (:class:`FusedModule`).  Raises
    ``NotImplementedError`` for a tensor-parallel model (one with the
    mp layers of ``distributed.fleet``): the pass does not trace through
    their collectives yet."""
    from ..distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                                   RowParallelLinear,
                                                   VocabParallelEmbedding)
    mp = (ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    if any(isinstance(m, mp) for m in model.modules()):
        raise NotImplementedError(
            "the fusion pass on tensor-parallel models is not ported yet "
            "(ROADMAP Queue 1: the fusion pass on mp models); build the "
            "step with fusion=False")
    return FusedModule(model)
