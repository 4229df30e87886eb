"""The auto-parallel annotations (the counterpart of
``paddle_tpu/distributed/auto_parallel_api.py``): ``ProcessMesh``, the
placements ``Shard`` / ``Replicate`` / ``Partial``, ``shard_tensor``,
``shard_layer``, ``dtensor_from_fn`` and ``reshard``.

The JAX package has one controller: a ``NamedSharding`` there is the
whole array, laid out over the devices.  The port runs one process per
rank, so a distributed tensor is the window this rank holds, as in
Paddle's dynamic mode:

 - :class:`ProcessMesh`: an N-D grid of ranks (``process_ids`` are
   ranks of the world, not devices) with named dimensions;
 - :func:`shard_tensor`: every rank passes the whole tensor and gets back
   its window, the one the JAX ``NamedSharding`` of the same placements
   puts on the device at this rank's place in the mesh
   (:func:`_placements_to_spec`, then
   :func:`.checkpoint.spec_window`, the rule of the port's checkpoint
   windows).  The returned tensor carries ``process_mesh``,
   ``placements`` and ``global_shape``.  A rank outside the mesh gets the
   whole tensor.  ``Partial`` on a mesh dimension: each rank passes its
   partial value and the values are reduced over that dimension's ranks
   at once (``reduce_type`` sum, avg, max or min), so the result is
   replicated there (the JAX package treats it as replicated after the
   reduction);
 - :func:`reshard`: a tensor's windows moved to other placements with
   the port's collectives (the windows all-gathered over the mesh's
   ranks, then this rank's new window sliced out); on gloo, CUDA tensors
   go as the collectives take them.  Every rank of the mesh calls it.

The mesh's group is the world's when the mesh holds every rank, else a
new group of its ranks (made by every rank of the world, as
``new_group`` requires, at the first collective on that mesh).
"""
from __future__ import annotations

import types
from typing import Optional

import numpy as np
import torch

__all__ = ["ProcessMesh", "Shard", "Replicate", "Partial", "shard_tensor",
           "shard_layer", "dtensor_from_fn", "reshard"]


class Shard:
    """Placement: split over tensor dimension ``dim``."""

    def __init__(self, dim):
        self.dim = dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim


class Replicate:
    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("replicate")

    def is_shard(self, dim=None):
        return False


class Partial:
    """A pending reduction (``reduce_type``: sum, avg, max or min),
    reduced at once (module docstring)."""

    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, other):
        return isinstance(other, Partial) and \
            other.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("partial", self.reduce_type))

    def is_shard(self, dim=None):
        return False


class ProcessMesh:
    """An N-D array of ranks with named dimensions (``d0``, ``d1``, ...
    unless named)."""

    def __init__(self, mesh, dim_names=None, process_ids=None):
        arr = np.asarray(mesh, dtype=np.int64)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(f"{len(dim_names)} dim_names for a "
                             f"{arr.ndim}-D mesh")
        self._ranks = arr
        self._shape = list(arr.shape)
        self._dim_names = list(dim_names)
        self._process_ids = sorted(arr.flatten().tolist())
        if len(set(self._process_ids)) != len(self._process_ids):
            raise ValueError(f"a rank appears twice in the mesh {arr.tolist()}")
        self._group = None
        self._lines = {}        # mesh dim -> the groups along it

    @property
    def shape(self):
        return self._shape

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def process_ids(self):
        return self._process_ids

    @property
    def mesh(self):
        """The grid of ranks."""
        return self._ranks

    @property
    def ndim(self):
        return len(self._shape)

    def get_dim_size(self, name):
        return self._shape[self._dim_names.index(name)]

    def coords(self, rank: int) -> Optional[dict]:
        """``rank``'s index on each named dimension; None when it is not
        in the mesh."""
        where = np.argwhere(self._ranks == rank)
        if not len(where):
            return None
        return dict(zip(self._dim_names, (int(i) for i in where[0])))

    def _spec_mesh(self):
        """The mesh as :func:`.checkpoint.spec_window` reads one."""
        return types.SimpleNamespace(
            shape=dict(zip(self._dim_names, self._shape)))

    def group(self):
        """The process group of the mesh's ranks."""
        from . import collective as _c
        if self._group is None:
            world = _c.get_group(0)
            if sorted(world.ranks) == self._process_ids:
                self._group = world
            else:
                self._group = _c.new_group(self._process_ids)
        return self._group

    def __eq__(self, other):
        return isinstance(other, ProcessMesh) and \
            self._shape == other._shape and \
            self._dim_names == other._dim_names and \
            np.array_equal(self._ranks, other._ranks)

    def __hash__(self):
        return hash((tuple(self._shape), tuple(self._dim_names)))

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dims={self._dim_names})"


def _placements_to_spec(placements, ndim, mesh: ProcessMesh) -> tuple:
    """The JAX ``PartitionSpec`` of ``placements`` as a tuple: one entry
    a tensor dimension, the mesh dimension names that split it (a tuple
    when more than one, in mesh order), None when none does."""
    axes = [None] * ndim
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d = pl.dim % ndim
            name = mesh.dim_names[mesh_dim]
            if axes[d] is None:
                axes[d] = name
            elif isinstance(axes[d], tuple):
                axes[d] = axes[d] + (name,)
            else:
                axes[d] = (axes[d], name)
    return tuple(axes)


def _rank() -> int:
    from .env import get_rank
    return get_rank()


def _window(shape, spec, mesh: ProcessMesh, rank: int):
    """Rank ``rank``'s window (``[[lo, hi], ...]``) of a tensor of
    ``shape`` under ``spec`` on ``mesh``; the whole tensor for a rank
    outside the mesh."""
    from .checkpoint import spec_window
    coords = mesh.coords(rank)
    if coords is None:
        return [[0, int(n)] for n in shape]
    return spec_window(spec, tuple(shape), mesh._spec_mesh(), coords)


def _slice(t: torch.Tensor, win) -> torch.Tensor:
    return t[tuple(slice(a, b) for a, b in win)]


def _annotate(t: torch.Tensor, mesh, placements, global_shape):
    t.process_mesh = mesh
    t.placements = list(placements)
    t.global_shape = tuple(global_shape)
    return t


def _reduce_partials(t: torch.Tensor, mesh: ProcessMesh, placements
                     ) -> torch.Tensor:
    """``t`` reduced over the ranks of each ``Partial`` mesh dimension
    (those that share this rank's index on every other dimension)."""
    from . import collective as _c
    coords = mesh.coords(_rank())
    for mesh_dim, pl in enumerate(placements):
        if not isinstance(pl, Partial) or mesh.shape[mesh_dim] == 1:
            continue
        op = {"sum": _c.ReduceOp.SUM, "avg": _c.ReduceOp.AVG,
              "mean": _c.ReduceOp.AVG, "max": _c.ReduceOp.MAX,
              "min": _c.ReduceOp.MIN}[pl.reduce_type]
        # one group per line of the mesh along mesh_dim; every rank of the
        # mesh makes every line's group, in the same order
        lines = np.moveaxis(mesh.mesh, mesh_dim, -1).reshape(
            -1, mesh.shape[mesh_dim])
        if mesh_dim not in mesh._lines:
            mesh._lines[mesh_dim] = [
                _c.new_group(sorted(int(r) for r in line)) for line in lines]
        mine = None
        for line, g in zip(lines, mesh._lines[mesh_dim]):
            if coords is not None and _rank() in line:
                mine = g
        if mine is not None:
            t = t.clone()
            _c.all_reduce(t, op=op, group=mine)
    return t


def shard_tensor(data, mesh: ProcessMesh, placements, dtype=None,
                 place=None, stop_gradient=None):
    """This rank's window of ``data`` (the whole tensor, the same on
    every rank) under ``placements`` on ``mesh`` (module docstring).
    ``dtype`` casts; ``place`` moves (a device); ``stop_gradient`` sets
    ``requires_grad`` to its negation."""
    t = data if isinstance(data, torch.Tensor) else \
        torch.as_tensor(np.asarray(data))
    if dtype is not None:
        t = t.to(getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    if place is not None:
        t = t.to(place)
    if len(placements) != mesh.ndim:
        raise ValueError(f"{len(placements)} placements for a {mesh.ndim}-D "
                         f"mesh")
    if any(isinstance(p, Partial) for p in placements):
        t = _reduce_partials(t, mesh, placements)
    spec = _placements_to_spec(placements, t.dim(), mesh)
    win = _window(t.shape, spec, mesh, _rank())
    out = _slice(t, win)
    if isinstance(data, torch.nn.Parameter):
        out = torch.nn.Parameter(out.detach().clone(),
                                 requires_grad=data.requires_grad)
    if stop_gradient is not None and out.is_leaf:
        out.requires_grad_(not stop_gradient)
    return _annotate(out, mesh, placements, t.shape)


def dtensor_from_fn(fn, mesh: ProcessMesh, placements, *args, **kwargs):
    """``shard_tensor`` of ``fn(*args, **kwargs)``."""
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def _full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's window: the
    windows all-gathered over the mesh's ranks and placed."""
    from . import collective as _c
    mesh = getattr(t, "process_mesh", None)
    placements = getattr(t, "placements", None)
    if mesh is None or placements is None:
        return t
    shape = t.global_shape
    spec = _placements_to_spec(placements, len(shape), mesh)
    if all(e is None for e in spec):
        return t
    if mesh.coords(_rank()) is None:
        return t
    parts: list = []
    _c.all_gather(parts, t.detach(), group=mesh.group())
    full = torch.empty(shape, dtype=t.dtype, device=t.device)
    for rank, part in zip(mesh.group().ranks, parts):
        _slice(full, _window(shape, spec, mesh, rank)).copy_(part)
    return full


def reshard(tensor, mesh: ProcessMesh, placements):
    """``tensor`` (a :func:`shard_tensor` window, or a whole tensor) as
    this rank's window under ``placements`` on ``mesh`` (module
    docstring)."""
    t = tensor if isinstance(tensor, torch.Tensor) else \
        torch.as_tensor(np.asarray(tensor))
    full = _full(t)
    if any(isinstance(p, Partial) for p in placements):
        raise ValueError("reshard to a Partial placement: a whole tensor "
                         "has no pending reduction")
    spec = _placements_to_spec(placements, full.dim(), mesh)
    out = _slice(full, _window(full.shape, spec, mesh, _rank())).detach()
    out = out.clone() if out.data_ptr() == t.data_ptr() else out
    out.requires_grad_(t.requires_grad)
    return _annotate(out, mesh, placements, full.shape)


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn=None,
                input_fn=None, output_fn=None):
    """``shard_fn(name, sublayer, mesh)`` on every sublayer (by default
    each parameter annotated as replicated on the mesh), and
    ``input_fn(inputs, mesh)`` / ``output_fn(outputs, mesh)`` as hooks
    around ``layer``'s forward.  Returns ``layer``."""
    if shard_fn is None:
        def shard_fn(name, sublayer, mesh):
            for p in sublayer.parameters(recurse=False):
                _annotate(p, mesh, [Replicate()] * mesh.ndim, p.shape)
    for name, sub in layer.named_modules():
        shard_fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda lyr, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda lyr, inp, out: output_fn(out, process_mesh))
    return layer
