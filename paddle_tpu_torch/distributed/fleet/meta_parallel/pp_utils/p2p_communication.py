"""Point-to-point sends and receives between pipeline stages (the
reference Paddle's ``pp_utils/p2p_communication.py``; the JAX package
moves activations by ``ppermute`` inside its compiled schedule).

One exchange is every send and receive of one rank in one tick of the
schedule, issued together by :func:`...collective.batch_isend_irecv`
(grouped on NCCL, so two stages that send to each other in the same
tick cannot block each other; on gloo a CUDA tensor goes through a host
copy, :func:`...collective.host_staged`).  An activation's shape and
dtype travel once a schedule, ahead of the first activation of each
virtual stage (:func:`encode_meta`), in an exchange of their own.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .... import collective as _c

__all__ = ["P2PCommunicator", "encode_meta", "decode_meta", "META_LEN"]

#: a meta message: ndim, dtype code, then the shape, zero padded
META_LEN = 10
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)


def encode_meta(t: torch.Tensor) -> torch.Tensor:
    if t.dim() > META_LEN - 2:
        raise ValueError(f"an activation of {t.dim()} dimensions does not "
                         f"fit the pipeline's meta message")
    if t.dtype not in _DTYPES:
        raise ValueError(f"the pipeline does not send {t.dtype}")
    meta = [t.dim(), _DTYPES.index(t.dtype), *t.shape]
    meta += [0] * (META_LEN - len(meta))
    return torch.tensor(meta, dtype=torch.int64, device=t.device)


def decode_meta(meta: torch.Tensor) -> Tuple[tuple, torch.dtype]:
    m = [int(v) for v in meta.tolist()]
    return tuple(m[2:2 + m[0]]), _DTYPES[m[1]]


class P2PCommunicator:
    """Exchanges over ``group`` (the pipe group; peers are global
    ranks)."""

    def __init__(self, group):
        self.group = group

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
        """Send each ``(tensor, dst)`` and receive into each
        ``(tensor, src)``, all issued together; returns when all are
        done."""
        ops: List[_c.P2POp] = []
        for t, dst in sends:
            ops.append(_c.P2POp(_c.isend, t.contiguous(), dst, self.group))
        for t, src in recvs:
            ops.append(_c.P2POp(_c.irecv, t, src, self.group))
        if ops:
            for task in _c.batch_isend_irecv(ops):
                task.wait()
