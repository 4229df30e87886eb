"""The ZeRO / fsdp placement rule (the port's own copy of
``place_axis`` and ``spec_axes`` from
``paddle_tpu/distributed/auto_parallel/spec_layout.py``).

A spec is the JAX package's ``PartitionSpec`` as a plain tuple: one
entry a dimension, each ``None`` (replicated), an axis name, or a tuple
of axis names.  The port's ranks hold their slices, so the rule is read
against the *global* shape and the parameter's tensor-parallel entry
(``("mp"`` on its ``split_axis``), as the JAX package reads it on its
one logical array: the same dimension then carries the same window on
both sides.
"""
from __future__ import annotations

__all__ = ["spec_axes", "place_axis"]


def spec_axes(entry) -> tuple:
    """Mesh axis names of one spec entry (str, tuple or None; a list, as
    a checkpoint index writes a tuple, too)."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def place_axis(spec, shape, n: int, axis: str) -> tuple:
    """``spec`` with ``axis`` on the largest dimension of ``shape`` that
    is free in ``spec`` and divisible by ``n`` (the first of equal ones);
    ``spec`` as it is when ``n <= 1``, when ``axis`` is already in it, or
    when no free dimension divides.  Returns a tuple as long as
    ``shape`` (``spec`` padded with ``None``)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if n <= 1 or any(axis in spec_axes(e) for e in entries):
        return tuple(entries)
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if entries[d] is None and shape[d] % n == 0:
            entries[d] = axis
            return tuple(entries)
    return tuple(entries)
