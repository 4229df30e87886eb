"""Samplers (the counterpart of ``paddle_tpu/io/sampler.py``), with the
JAX package's numpy draws: the same seeds give the same indices, index
for index.

:class:`RandomSampler` draws from an injected ``np.random.RandomState``
or ``np.random.Generator``, else from numpy's global stream.
:class:`DistributedBatchSampler`'s permutation is ``RandomState(epoch)``,
a pure function of the epoch.  Both batch samplers keep a mid-epoch
``state_dict`` (the cursor, and the epoch) and skip resumed batches at
the index level, fetching no data for them; a cursor at the end of an
epoch rolls over to the next.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "SubsetRandomSampler", "BatchSampler",
           "DistributedBatchSampler"]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation (or ``num_samples`` draws with ``replacement``) from
    ``generator`` (a ``RandomState`` or ``Generator``), else from numpy's
    global stream."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = self.generator if self.generator is not None else np.random
        if self.replacement:
            if hasattr(rng, "randint"):          # RandomState, np.random
                idx = rng.randint(0, n, self.num_samples)
            else:                                # np.random.Generator
                idx = rng.integers(0, n, self.num_samples)
            return iter(idx.tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        super().__init__(None)
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Lists of ``batch_size`` indices from ``sampler`` (by default a
    :class:`RandomSampler` with ``shuffle``, else a
    :class:`SequenceSampler`)."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle
        self._cursor = 0       # index batches handed out this epoch
        self._resume_skip = 0  # batches to drop at the next __iter__

    def __iter__(self):
        skip = self._resume_skip
        self._resume_skip = 0
        self._cursor = skip
        batch = []
        produced = 0
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                produced += 1
                if produced > skip:    # skipped batches fetch no data
                    self._cursor += 1
                    yield batch
                batch = []
        if batch and not self.drop_last:
            produced += 1
            if produced > skip:
                self._cursor += 1
                yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def state_dict(self):
        """The mid-epoch position; the DataLoader puts its *delivered*
        count in ``cursor`` (prefetch runs this one ahead)."""
        return {"cursor": self._cursor}

    def load_state_dict(self, state):
        cursor = int(state.get("cursor", 0))
        if cursor >= len(self):     # saved at the end of an epoch
            cursor = 0
        self._resume_skip = cursor


def _world():
    """``torch.distributed``'s world size and rank once it is
    initialised, else 1 and 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """This rank's batches of a dataset padded to a multiple of
    ``num_replicas`` (``torch.distributed``'s world size and rank by
    default).  With ``shuffle`` each epoch's permutation is
    ``RandomState(epoch)``, so the epoch and the cursor fix the
    mid-epoch state."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, me = _world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self._iter_epoch = 0   # epoch of the permutation in flight
        self._cursor = 0
        self._resume_skip = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        self._iter_epoch = self.epoch
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(
                n).tolist()
            self.epoch += 1
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        skip = self._resume_skip
        self._resume_skip = 0
        self._cursor = skip
        # skipped batches are dropped as indices: no data fetched
        indices = indices[skip * self.batch_size:]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                self._cursor += 1
                yield batch
                batch = []
        if batch and not self.drop_last:
            self._cursor += 1
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def state_dict(self):
        """The epoch whose permutation is in flight and the cursor (the
        DataLoader puts its delivered count there)."""
        return {"epoch": self._iter_epoch, "cursor": self._cursor}

    def load_state_dict(self, state):
        epoch = int(state.get("epoch", 0))
        cursor = int(state.get("cursor", 0))
        if cursor >= len(self):     # saved at the end of an epoch
            epoch += 1
            cursor = 0
        self.epoch = epoch
        self._iter_epoch = epoch
        self._resume_skip = cursor
