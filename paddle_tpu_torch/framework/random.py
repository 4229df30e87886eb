"""Random state of a training run: one explicit ``torch.Generator``.

The counterpart of ``paddle_tpu/framework/random.py``.  The JAX package
folds keys from one global seed, and ``jax.checkpoint`` replays a key as
a value, so a recomputed block draws the same dropout masks.  Here the
trainer owns one ``torch.Generator`` on the run's device: the model's
initializers draw from it, then every dropout of every step.  Recompute
replays a block's draws by restoring the generator's state
(:func:`replay`); ``torch.utils.checkpoint`` saves and restores only the
default CPU and CUDA generators, never an explicit one.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

from ..device import resolve_device

__all__ = ["make_generator", "replay"]


def make_generator(seed: int,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> torch.Generator:
    """A generator on ``device`` (``cuda`` unless the CPU is asked for)
    seeded with ``seed``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))


@contextlib.contextmanager
def replay(generator: torch.Generator, state: torch.Tensor) -> Iterator[None]:
    """Run the body with ``generator`` at ``state`` (from
    ``generator.get_state()``), then give it back the state it had."""
    current = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(current)
