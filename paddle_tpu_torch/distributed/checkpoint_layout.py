"""Where each tensor of a hybrid-parallel step lies in a sharded
checkpoint: the JAX package's layout of the same step at the same mesh.

The JAX package's ``build_train_step`` state holds each parameter, slot
and master as one global array with a ``PartitionSpec``
(``paddle_tpu/distributed/train_step.py``); its ``save_sharded`` writes
each device's replica-0 shard.  A rank of the port holds the same data
the JAX device at its mesh coordinates holds, so :func:`checkpoint_tree`
gives each of its tensors as a :class:`.checkpoint.ShardWindow` of the
JAX leaf:

 - the leaf's name: the parameter's, or, with pipeline stages, for a
   block's parameter the stacked ``__ppstack__.<name in the block>``,
   shaped ``[n_blocks, ...]`` at one virtual stage and ``[v, pp * Lv,
   ...]`` at ``v`` (stage ``s`` holds the rows of its virtual stages
   ``{g * pp + s}``: one window a leaf, its blocks stacked);
 - its spec, the JAX one: the parameter's tensor-parallel annotation
   (and at ``p_g_os`` its fsdp dimension) resolved against the mesh,
   ``("pp", ...)`` or ``(None, "pp", ...)`` in front when stacked; a
   slot's or a master's the ZeRO spec over that at ``os`` / ``os_g``
   (``zero_spec``, on the stacked shape);
 - the window, read from the spec at the rank's mesh coordinates
   (``spec_window``), and checked against the shape of the tensor the
   rank holds;
 - who writes it: the replica-0 holder, the rank whose coordinate is 0
   on every mesh axis of size above 1 that the spec does not name (dp,
   sep, and sharding or mp where the leaf is not split on them); a
   parameter outside the blocks of a pipelined model lives on one stage,
   or, tied (the word embedding), on the first and the last, and the
   first writes it;
 - the step count: replicated, written by rank 0.

Each rank also writes its generators' states (the dropout streams differ
by data, sep, mp rank and stage) under ``rng.<layout>.rank<r>``: a step
at the same layout restores them, one at another cannot.
"""
from __future__ import annotations

import logging
from typing import Dict

import torch

from .auto_parallel.spec_layout import place_axis, spec_axes
from .checkpoint import ShardWindow, spec_window
from .sharding.group_sharded import global_shape, is_window

__all__ = ["jax_param_spec", "jax_zero_spec", "layout_name",
           "checkpoint_tree", "load_tree", "generators_of",
           "module_windows"]

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

PP_STACK = "__ppstack__."


def jax_param_spec(p, mesh_shape: Dict[str, int]) -> tuple:
    """The spec the JAX package gives parameter ``p`` (this rank's
    slice of it): its layer's tensor-parallel annotation (``mp_axis``)
    and, stored as a stage-3 window, its fsdp dimension, each kept where
    the mesh has that axis above size 1; ``()`` for an unannotated
    parameter."""
    axis = getattr(p, "mp_axis", None)
    entries = None
    if axis is not None:
        entries = [None] * p.dim()
        entries[axis] = "mp"
    if is_window(p):
        entries = entries or [None] * p.dim()
        entries[p.zero_dim] = "sharding"
    if entries is None:
        return ()
    return tuple(e if e is not None and mesh_shape.get(e, 1) > 1 else None
                 for e in entries)


def jax_zero_spec(spec: tuple, shape, n: int) -> tuple:
    """The JAX package's ``zero_spec``: :func:`place_axis`'s placement of
    ``"sharding"``, but ``spec`` itself (not padded) where it places
    nothing new."""
    z = place_axis(spec, tuple(shape), n, "sharding")
    if any("sharding" in spec_axes(e) for e in spec) or \
            not any("sharding" in spec_axes(e) for e in z):
        return tuple(spec)
    return z


def layout_name(hcg, zero=None, virtual_stages: int = 1) -> str:
    """The step's parallel layout, as the key of its generators' states
    (a dropout stream carries over only to the same layout)."""
    level = getattr(zero, "level", None) or "none"
    return (f"dp{hcg.get_data_parallel_world_size()}_"
            f"mp{hcg.get_model_parallel_world_size()}_"
            f"pp{hcg.get_pipe_parallel_world_size()}_v{virtual_stages}_"
            f"sharding{hcg.get_sharding_parallel_world_size()}_{level}_"
            f"sep{hcg.get_sep_parallel_world_size()}")


def generators_of(step) -> list:
    """The step's generators: the run's, then the others its model
    draws from (the tensor-parallel local stream)."""
    return [step.generator] + list(getattr(step.eager, "generators", ()))


class _Layout:
    """The mesh arithmetic of one rank of ``step``."""

    def __init__(self, step, model):
        hcg = step.hcg
        self.mesh = hcg.mesh
        self.coords = self.mesh.coords(hcg.global_rank)
        self.sizes = self.mesh.shape
        self.mp = hcg.get_model_parallel_world_size()
        self.n = hcg.get_sharding_parallel_world_size()
        self.zero = step.zero
        pipe = getattr(model, "pipeline", None)
        self.pp, _, self.v = pipe if pipe is not None else (1, 0, 1)
        self.blocks = {}                # name -> (block index, name in it)
        if self.pp > 1:
            prefixes, _ = model.pipeline_blocks()
            self.n_blocks = len(prefixes)
            for name in step.params:
                for i, pre in enumerate(prefixes):
                    if name.startswith(pre):
                        self.blocks[name] = (i, name[len(pre):])
        self.tied = {} if self.zero is None else self.zero.kinds

    def leaf_of(self, name):
        b = self.blocks.get(name)
        return name if b is None else PP_STACK + b[1]

    def stacked_shape(self, block_shape):
        if self.v == 1:
            return (self.n_blocks,) + tuple(block_shape)
        return (self.v, self.n_blocks // self.v) + tuple(block_shape)

    def row(self, block: int) -> tuple:
        """A block's index in the stacked leaf."""
        if self.v == 1:
            return (block,)
        per = self.n_blocks // self.v
        return (block // per, block % per)

    def write(self, spec, name=None) -> bool:
        """Replica 0 of the window: coordinate 0 on every axis of size
        above 1 that ``spec`` does not name; a pipelined model's
        parameter outside the blocks is written by its one stage (the
        first of a tied pair)."""
        named = {a for e in spec for a in spec_axes(e)}
        free = [a for a, size in self.sizes.items()
                if size > 1 and a not in named]
        if name is not None and self.pp > 1 and name not in self.blocks:
            free = [a for a in free if a != "pp"]
            if not self.tied.get(name, (None, None, True))[2]:
                return False
        return all(self.coords[a] == 0 for a in free)

    def window(self, name, tensors, spec, shape) -> ShardWindow:
        """The :class:`ShardWindow` of ``tensors`` ({param name: this
        rank's tensor of the leaf}) in the leaf of ``shape`` (the leaf's
        global shape: stacked for a block's) under ``spec``."""
        win = spec_window(spec, shape, self.mesh, self.coords)
        lo = [a for a, _ in win]
        if name in self.blocks:
            parts = []
            for k, t in tensors.items():
                idx = self.row(self.blocks[k][0])
                rel = tuple(i - lo[d] for d, i in enumerate(idx))
                parts.append((rel, t))
            parts.sort(key=lambda it: it[0])
            lead = len(parts[0][0])
            n_rows = 1
            for a, b in win[:lead]:
                n_rows *= b - a
            if len(parts) != n_rows:
                raise ValueError(f"{name}: {len(parts)} blocks on this rank "
                                 f"for window {win}")
        else:
            [(_, t)] = tensors.items()
            parts, lead = [((), t)], 0
        want = tuple(b - a for a, b in win[lead:])
        for rel, t in parts:
            if tuple(t.shape) != want or any(
                    not 0 <= i < b - a for i, (a, b) in zip(rel, win)):
                raise ValueError(
                    f"{name}: a tensor of shape {tuple(t.shape)} at {rel} "
                    f"does not fill window {win} of the leaf {tuple(shape)} "
                    f"(spec {spec})")
        return ShardWindow(parts=parts, window=win, global_shape=shape,
                           spec=spec, write=self.write(spec, name))


def checkpoint_tree(step, model) -> dict:
    """``step``'s state (a :class:`..train.HybridTrainStep` over
    ``model``, unwrapped) as :class:`ShardWindow` leaves in the JAX
    layout (module docstring): ``{"params", "opt_tree": {"slots",
    "master", "step"}, "rng": {layout: {"rank<r>": {"<i>": state}}}}``.
    The windows refer to the live tensors."""
    lay = _Layout(step, model)
    specs, shapes = {}, {}
    for name, p in step.params.items():
        spec = jax_param_spec(p, lay.sizes)
        shape = global_shape(p, lay.mp)
        if name in lay.blocks:
            spec = (("pp",) if lay.v == 1 else (None, "pp")) + tuple(spec)
            shape = lay.stacked_shape(shape)
        specs[name], shapes[name] = spec, shape

    def grouped(tensors: Dict[str, torch.Tensor], spec_of) -> dict:
        by_leaf: Dict[str, Dict[str, torch.Tensor]] = {}
        for k, t in tensors.items():
            by_leaf.setdefault(lay.leaf_of(k), {})[k] = t
        out = {}
        for leaf, ts in by_leaf.items():
            k = next(iter(ts))
            out[leaf] = lay.window(k, ts, spec_of(k), shapes[k])
        return out

    def opt_spec(k):
        level = getattr(lay.zero, "level", None)
        if level in ("os", "os_g"):
            return jax_zero_spec(specs[k], shapes[k], lay.n)
        return specs[k]

    state = step.state
    tree = {"params": grouped(step.params, specs.__getitem__),
            "opt_tree": {
                "slots": {s: grouped(ts, opt_spec)
                          for s, ts in state["slots"].items()},
                "master": grouped(state["master"], opt_spec),
                "step": ShardWindow(state["step"], [], (), (),
                                    write=lay.write(()))}}
    layout = layout_name(step.hcg, lay.zero, lay.v)
    tree["rng"] = {layout: {f"rank{step.hcg.global_rank}": {
        str(i): g.get_state() for i, g in enumerate(generators_of(step))}}}
    return tree


def load_tree(step, model, tree: dict, template=None) -> bool:
    """Copy ``tree`` (what ``load_sharded`` returned for
    :func:`checkpoint_tree`'s ``template``: each leaf this rank's
    window, or the whole leaf) into ``step``'s live tensors in place,
    and its generators' states when the tree has them for this layout
    and rank (a leaf the checkpoint lacked comes back as the template's
    own object).  Raises ``KeyError`` for a window the tree lacks;
    returns whether the generators were restored (a log line says why
    not)."""
    from ..framework.random import restore_generator_state
    want = template if template is not None else \
        checkpoint_tree(step, model)

    def walk(w, got, path):
        if isinstance(w, dict):
            for k, sub in w.items():
                walk(sub, (got or {}).get(k) if isinstance(got, dict)
                     else None, path + (k,))
            return
        if not isinstance(got, torch.Tensor):
            raise KeyError(f"the checkpoint has no leaf "
                           f"{'/'.join(path)!r}")
        if tuple(got.shape) == tuple(w.global_shape) != w.shape:
            got = got[tuple(slice(a, b) for a, b in w.window)]
        w.assign(got)

    walk({"params": want["params"], "opt_tree": want["opt_tree"]},
         {"params": tree.get("params"), "opt_tree": tree.get("opt_tree")},
         ())
    [(layout, ranks)] = want["rng"].items()
    [(rank, states)] = ranks.items()
    got = tree.get("rng")
    got = got.get(layout, {}).get(rank) if isinstance(got, dict) else None
    if not isinstance(got, dict) or any(
            not isinstance(got.get(i), torch.Tensor) or got.get(i) is t
            for i, t in states.items()):
        saved = sorted(tree["rng"]) if isinstance(tree.get("rng"), dict) \
            else "the single-process layout"
        logger.warning(
            "checkpoint: the dropout generators were saved at layout %s, "
            "this step is %s %s: they are not restored (the weights and "
            "the optimizer state are)", saved, layout, rank)
        return False
    for i, g in enumerate(generators_of(step)):
        restore_generator_state(g, got[str(i)])
    return True



def module_windows(module, mesh, rank: int) -> dict:
    """``module``'s parameters as :class:`ShardWindow` leaves on
    ``mesh`` for ``rank``: an expert-parallel parameter (``expert_axis``,
    ``global_shape``: an :class:`~..incubate.distributed.models.moe.ExpertMlp`
    window) with the JAX dryrun's spec ``("ep", None, ...)``, every other
    one replicated; each written by its replica-0 holder."""
    coords = mesh.coords(rank)
    out = {}
    for name, p in module.named_parameters():
        axis = getattr(p, "expert_axis", None)
        shape = tuple(getattr(p, "global_shape", p.shape))
        spec = () if axis is None else tuple(
            "ep" if d == axis else None for d in range(p.dim()))
        win = spec_window(spec, shape, mesh, coords)
        named = {a for e in spec for a in spec_axes(e)}
        write = all(coords[a] == 0 for a, size in mesh.shape.items()
                    if size > 1 and a not in named)
        out[name] = ShardWindow(p.detach(), win, shape, spec, write=write)
    return out
