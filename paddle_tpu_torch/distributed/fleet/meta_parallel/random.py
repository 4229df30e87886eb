"""The dropout streams of a tensor-parallel model (the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/random.py``), on explicit
``torch.Generator`` objects.

Two streams, as Megatron and Paddle keep them:

 - the global stream (``GLOBAL_RNG``), the same on every model-parallel
   rank: dropout on replicated activations (the embeddings' output, the
   hidden states after a row-parallel reduce).  If it differed between
   mp ranks, their copies of the replicated activations would drift
   apart, without an error;
 - the local stream (``MODEL_PARALLEL_RNG``), different on each mp rank:
   dropout on each rank's own attention heads.

Both differ between data ranks (the dp x sharding ranks, which each
take their slice of the batch) and between pipeline stages (each
stage's blocks draw from that stage's streams).  Over sequence
parallelism the global stream differs between sep ranks too (each holds
other positions of the hidden states), while the local stream is the
same on every sep rank: the ring's dropout hash takes its seed from it
and draws, on each rank, that rank's part of one mask over the whole
sequence.
:func:`model_parallel_random_seed` sets them from one seed: the global
stream is the run's generator (``generator``, whose draws made the
weights, so its state is the same on every rank), re-seeded with
``seed + DP_SEED_OFFSET + data_rank * sep + sep_rank + PP_SEED_OFFSET *
stage`` when there is more than one data rank, stage or sep rank
(``data_rank = dp_rank * sharding + sharding_rank``); the local stream
is a generator seeded ``seed + 1024 + rank`` (the JAX package's local
seed; ``rank`` the global rank of this rank's sep peer 0), or, with one
mp rank, the global stream itself, or at a sep degree above 1 a
generator that draws what the global stream would at sep 1.  At dp = mp
= sep = 1 both are the run's generator, so the model draws its masks as
the unsharded model does.
"""
from __future__ import annotations

import contextlib
import random as _pyrandom
from typing import Dict, Iterator, Optional

import torch

from ....framework.random import make_generator
from ... import collective as _c

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "GLOBAL_RNG", "MODEL_PARALLEL_RNG",
           "DP_SEED_OFFSET", "PP_SEED_OFFSET"]

GLOBAL_RNG = "global_seed"
MODEL_PARALLEL_RNG = "model_parallel_rng"
#: added to the seed of the global stream of dp rank ``r`` (with ``r``)
DP_SEED_OFFSET = 1 << 20
#: times the pipeline stage, added to the seed of the global stream
PP_SEED_OFFSET = 1 << 16


class RNGStatesTracker:
    """Named generators."""

    def __init__(self):
        self._gens: Dict[str, torch.Generator] = {}

    def reset(self) -> None:
        self._gens.clear()

    def add(self, name: str, seed: int, device=None) -> torch.Generator:
        """A new generator on ``device`` (``cuda`` unless the CPU is asked
        for) seeded ``seed``, under ``name``."""
        return self.set(name, make_generator(seed, device))

    def set(self, name: str, generator: torch.Generator) -> torch.Generator:
        self._gens[name] = generator
        return generator

    def get(self, name: str) -> Optional[torch.Generator]:
        return self._gens.get(name)

    def generators(self) -> list:
        """The distinct generators, in the order they were added."""
        out = []
        for g in self._gens.values():
            if not any(g is o for o in out):
                out.append(g)
        return out

    def get_states_tracker(self) -> Dict[str, torch.Tensor]:
        return {k: g.get_state() for k, g in self._gens.items()}

    def set_states_tracker(self, states: Dict[str, torch.Tensor]) -> None:
        for k, s in states.items():
            self._gens[k].set_state(s)

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG
                  ) -> Iterator[torch.Generator]:
        """The generator of ``name``, for the dropouts of the block."""
        if name not in self._gens:
            raise KeyError(f"no generator {name!r}: call "
                           f"model_parallel_random_seed() first")
        yield self._gens[name]


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


def model_parallel_random_seed(seed: Optional[int] = None, *,
                               generator: Optional[torch.Generator] = None,
                               device=None) -> RNGStatesTracker:
    """Set the tracker's two streams from ``seed`` (see the module
    docstring).  ``seed`` None: rank 0 draws one and every rank takes it.
    ``generator``: the run's generator (a new one seeded ``seed`` on
    ``device`` when None).  Returns the tracker."""
    from ..fleet import get_hybrid_communicate_group
    if seed is None:
        box = [_pyrandom.randint(0, 2 ** 31 - 1)]
        if _c.is_initialized():
            _c.broadcast_object_list(box, src=0)
        seed = box[0]
    hcg = get_hybrid_communicate_group()
    data, data_rank, pp, stage, sep, sep_rank = (1, 0, 1, 0, 1, 0)
    rank = 0
    if hcg is not None:
        sh = hcg.get_sharding_parallel_world_size()
        data = hcg.get_data_parallel_world_size() * sh
        data_rank = hcg.get_data_parallel_rank() * sh + \
            hcg.get_sharding_parallel_rank()
        pp, stage = hcg.get_pipe_parallel_world_size(), hcg.get_stage_id()
        sep = hcg.get_sep_parallel_world_size()
        sep_rank = hcg.get_sep_parallel_rank()
        rank = hcg.get_global_rank()
        if sep > 1:
            rank = hcg.topology().get_rank_from_stage(rank, sep=0)
    mp = 1 if hcg is None else hcg.get_model_parallel_world_size()
    glob = generator if generator is not None else make_generator(seed,
                                                                  device)
    local = glob
    if sep > 1 and mp == 1:
        # the sep ranks' shared stream: what glob draws at sep 1
        local = make_generator(seed, glob.device)
        local.set_state(glob.get_state())
        if data > 1 or pp > 1:
            local.manual_seed(seed + DP_SEED_OFFSET + data_rank +
                              PP_SEED_OFFSET * stage)
    if data > 1 or pp > 1 or sep > 1:
        glob.manual_seed(seed + DP_SEED_OFFSET + data_rank * sep + sep_rank +
                         PP_SEED_OFFSET * stage)
    _TRACKER.reset()
    _TRACKER.set(GLOBAL_RNG, glob)
    if mp > 1:
        _TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024 + rank, glob.device)
    else:
        _TRACKER.set(MODEL_PARALLEL_RNG, local)
    return _TRACKER
