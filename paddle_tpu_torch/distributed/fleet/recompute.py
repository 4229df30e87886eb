"""Activation recompute per block (the counterpart of
``paddle_tpu/distributed/fleet/recompute.py`` under its default policy,
``jax.checkpoint`` with nothing saved inside the block).

``torch.utils.checkpoint`` keeps only the block's inputs and reruns the
block in the backward pass.  It restores the default CPU and CUDA
generators for the rerun, but the port's dropouts draw from the run's
own generator (:mod:`...framework.random`), so the rerun would draw new
masks and the gradients would silently belong to another forward.  So
:func:`recompute` snapshots that generator's state before the block and
replays it for the rerun, leaving the generator where the forward left
it: recompute on and off give the same loss and gradients, as
``jax.checkpoint`` does by replaying a key.  The same holds inside a
captured step (:mod:`...jit.capture`): there the state read and set on
the host places the graph's draws, so each replay's rerun draws what
that replay's forward drew.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ...framework.random import replay

__all__ = ["recompute", "recompute_sequential"]


def recompute(function: Callable, *args,
              generator: Optional[torch.Generator] = None,
              replay_generators: Sequence[torch.Generator] = ()):
    """``function(*args, generator=generator)``, keeping only ``args`` for
    the backward pass, which reruns it with ``generator`` and the
    ``replay_generators`` the block also draws from (a tensor-parallel
    block's local dropout stream) replayed."""
    gens = []
    for g in (generator, *replay_generators):
        if g is not None and not any(g is o for o in gens):
            gens.append(g)
    snapshots = [g.get_state() for g in gens]
    ran = False

    def run(*inputs):
        nonlocal ran
        if not ran or not gens:
            ran = True
            return function(*inputs, generator=generator)
        with contextlib.ExitStack() as stack:
            for g, state in zip(gens, snapshots):
                stack.enter_context(replay(g, state))
            return function(*inputs, generator=generator)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def recompute_sequential(ctx, functions, *args,
                         generator: Optional[torch.Generator] = None):
    """``functions`` (a ``Sequential`` or a list of layers) run in order,
    in ``ctx["segments"]`` segments each recomputed in the backward pass
    (:func:`recompute`; the JAX package's ``recompute_sequential``).  A
    layer's tuple output is the next layer's arguments."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    n = len(layers)
    seg = max(n // max(segments, 1), 1)
    out = args
    for i in range(0, n, seg):
        chunk = layers[i:i + seg]

        def run_chunk(*xs, generator=None, _chunk=chunk):
            y = xs
            for layer in _chunk:
                y = layer(*y)
                if not isinstance(y, tuple):
                    y = (y,)
            return y[0] if len(y) == 1 else y

        out = recompute(run_chunk, *out, generator=generator)
        if not isinstance(out, tuple):
            out = (out,)
    return out[0] if len(out) == 1 else out
