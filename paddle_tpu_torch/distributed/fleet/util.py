"""Fleet's job-level helpers (the counterpart of
``paddle_tpu/distributed/fleet/util.py``): reductions and gathers of
host values over the workers (the port's collectives on the world),
a barrier, the contiguous split of a file list over the workers, and
printing on one rank."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["UtilBase"]


class UtilBase:
    def __init__(self, role_maker=None):
        self.role_maker = role_maker

    def _worker(self):
        from .fleet import worker_index, worker_num
        if self.role_maker is not None:
            return (self.role_maker.worker_index(),
                    self.role_maker.worker_num())
        return worker_index(), worker_num()

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        """``input`` (a number or array) reduced over the workers
        (``mode``: sum, max or min); a numpy array."""
        from ..collective import ReduceOp, all_reduce
        op = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX,
              "min": ReduceOp.MIN}[mode]
        a = np.asarray(input)
        t = torch.from_numpy(np.array(a))
        all_reduce(t, op=op)
        return t.numpy()

    def all_gather(self, input, comm_world="worker"):
        """Every worker's ``input`` (any picklable value), in rank
        order."""
        from ..collective import all_gather_object
        return all_gather_object([], input)

    def barrier(self, comm_world="worker"):
        from ..collective import barrier
        barrier()

    def get_file_shard(self, files):
        """``files`` split contiguously over the workers, the first ones
        taking one more each when they do not divide."""
        if not isinstance(files, list):
            raise TypeError("files should be a list of file need to be read.")
        idx, n = self._worker()
        per, rem = divmod(len(files), n)
        begin = idx * per + min(idx, rem)
        return files[begin:begin + per + (1 if idx < rem else 0)]

    def print_on_rank(self, message, rank_id):
        idx, _ = self._worker()
        if idx == rank_id:
            print(message)
