"""Datasets (the counterpart of ``paddle_tpu/io/dataset.py``): plain
classes with the JAX package's names, no ``torch.utils.data``.

:class:`TensorDataset` holds torch tensors (numpy arrays are converted
once, without a copy) and returns a tuple of row views.
:func:`random_split` draws its permutation from numpy's global stream,
as the JAX package does, so a seeded split is the same in both.
"""
from __future__ import annotations

import bisect
import math

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "ConcatDataset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of ``tensors`` (torch tensors or numpy arrays sharing dim 0)."""

    def __init__(self, tensors):
        self.tensors = [t if isinstance(t, torch.Tensor)
                        else torch.from_numpy(np.asarray(t)) for t in tensors]
        n = len(self.tensors[0])
        assert all(len(t) == n for t in self.tensors), \
            "all tensors must share dim 0"

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    """Samples of several datasets of one length, concatenated field by
    field into one tuple."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        assert all(len(d) == n for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (list, tuple))
                       else [sample])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in
                                           self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint :class:`Subset` s of ``lengths`` (counts, or fractions
    summing to 1, the remainder dealt round-robin), from one permutation
    drawn from numpy's global stream (``generator`` is accepted and not
    read, as in the JAX package)."""
    total = len(dataset)
    if all(isinstance(n, float) for n in lengths) and \
            abs(sum(lengths) - 1.0) < 1e-6:
        counts = [int(math.floor(total * f)) for f in lengths]
        for i in range(total - sum(counts)):
            counts[i % len(counts)] += 1
        lengths = counts
    if sum(lengths) != total:
        raise ValueError("sum of lengths must equal dataset size")
    perm = np.random.permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out
