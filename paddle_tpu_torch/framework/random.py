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

__all__ = ["make_generator", "replay", "restore_generator_state"]


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


def restore_generator_state(generator: torch.Generator,
                            state: torch.Tensor) -> None:
    """Set ``generator`` to ``state`` (a ``get_state()`` of a generator of
    the same kind, as a checkpoint carries it).  Raises ``ValueError``
    naming both device types when ``state`` is another kind's (a CPU
    run's state restored into a CUDA generator, or the reverse).  The
    generator object stays the same, so the CUDA graphs it is registered
    with draw from the restored state at their next replay."""
    state = state.detach().to("cpu", torch.uint8).contiguous()
    want = generator.get_state().numel()
    if state.numel() != want:
        kind = generator.device.type
        other = "cpu" if kind == "cuda" else "cuda"
        raise ValueError(
            f"cannot restore a generator state of {state.numel()} bytes "
            f"into a {kind} generator, whose state has {want}: the "
            f"checkpoint was written by a run on another device type "
            f"({other}, not {kind})")
    generator.set_state(state)
