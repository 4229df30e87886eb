"""The input pipeline (the counterpart of ``paddle_tpu/io``): datasets,
samplers and the DataLoader with worker processes and a mid-epoch
resume."""
from .dataloader import DataLoader, default_collate_fn, get_worker_info
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info",
           "ChainDataset", "ComposeDataset", "ConcatDataset", "Dataset",
           "IterableDataset", "Subset", "TensorDataset", "random_split",
           "BatchSampler", "DistributedBatchSampler", "RandomSampler",
           "Sampler", "SequenceSampler", "SubsetRandomSampler",
           "WeightedRandomSampler"]
