"""The hybrid mesh as a grid of ranks (the counterpart of
``paddle_tpu/distributed/mesh.py``, without JAX).

The JAX package's mesh is a ``jax.sharding.Mesh`` of devices whose named
axes its compiler partitions over.  The port runs one process per rank,
so its mesh is bookkeeping: a numpy grid of global ranks with the same
axis names and order, ``HYBRID_AXES``, outermost first.  Rank ``r``'s
coordinates are its index in that grid (row-major), as
:class:`..topology.CommunicateTopology` numbers ranks.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .env import get_world_size

__all__ = ["HYBRID_AXES", "Mesh", "build_mesh", "init_mesh", "get_mesh",
           "set_mesh", "mesh_axis_size"]

# outermost to innermost; 'ep' is the expert-parallel axis (MoE), 'mp' the
# innermost, as in the JAX package
HYBRID_AXES = ("dp", "pp", "sharding", "sep", "ep", "mp")


class Mesh:
    """``ranks``: an integer array with one axis a name of
    ``axis_names``; ``shape``: axis name -> size."""

    def __init__(self, ranks: np.ndarray, axis_names=HYBRID_AXES):
        self.ranks = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{self.ranks.ndim}-D ranks for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def coords(self, rank: int) -> Dict[str, int]:
        """``rank``'s index on each axis."""
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def __repr__(self):
        return f"Mesh({self.shape})"


_GLOBAL_MESH: Optional[Mesh] = None


def build_mesh(degrees: Optional[dict] = None,
               world_size: Optional[int] = None) -> Mesh:
    """A mesh from per-axis degrees (``{"dp": 2, "mp": 4}``): missing axes
    get size 1, and one axis may be -1 to take the ranks left over.
    ``world_size`` defaults to this process's world."""
    degrees = dict(degrees or {})
    n = get_world_size() if world_size is None else int(world_size)
    sizes, infer = [], None
    for ax in HYBRID_AXES:
        d = int(degrees.pop(ax, 1))
        if d == -1:
            infer, d = len(sizes), 1
        sizes.append(d)
    if degrees:
        raise ValueError(f"unknown mesh axes {sorted(degrees)}; "
                         f"valid: {HYBRID_AXES}")
    prod = int(np.prod(sizes))
    if infer is not None:
        if n % prod:
            raise ValueError(f"{n} ranks not divisible by {prod}")
        sizes[infer] = n // prod
        prod = n
    if prod > n:
        raise ValueError(f"mesh {dict(zip(HYBRID_AXES, sizes))} needs {prod} "
                         f"ranks, have {n}")
    return Mesh(np.arange(prod).reshape(sizes), HYBRID_AXES)


def init_mesh(degrees: Optional[dict] = None,
              world_size: Optional[int] = None) -> Mesh:
    global _GLOBAL_MESH
    _GLOBAL_MESH = build_mesh(degrees, world_size)
    return _GLOBAL_MESH


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_mesh(create_default: bool = True) -> Optional[Mesh]:
    """The global mesh; a pure-dp mesh over the world when none was set
    (and ``create_default``)."""
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None and create_default:
        _GLOBAL_MESH = build_mesh({"dp": -1})
    return _GLOBAL_MESH


def mesh_axis_size(axis: str) -> int:
    m = get_mesh()
    return m.shape.get(axis, 1) if m is not None else 1
