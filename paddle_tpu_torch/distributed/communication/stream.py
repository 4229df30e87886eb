"""``paddle.distributed.communication.stream`` (the counterpart of
``paddle_tpu/distributed/communication/stream.py``): the collectives of
:mod:`..collective` with Paddle's ``use_calc_stream``.

Paddle issues a collective on its communication stream, or, with
``use_calc_stream=True``, on the compute stream.  On the card the port's
compute stream is the current stream: with ``use_calc_stream`` the
operation is issued synchronously, its result ordered with the current
stream when the call returns (the task is already done).  As in Paddle,
``use_calc_stream`` is only legal with ``sync_op``.
"""
from __future__ import annotations

from .. import collective as _c

__all__ = ["all_reduce", "all_gather", "alltoall", "alltoall_single",
           "broadcast", "gather", "reduce", "reduce_scatter", "scatter",
           "send", "recv"]


def _check_stream(sync_op, use_calc_stream):
    if use_calc_stream and not sync_op:
        raise RuntimeError(
            "use_calc_stream can only be True in sync op behavior")


def all_reduce(tensor, op=_c.ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    _check_stream(sync_op, use_calc_stream)
    return _c.all_reduce(tensor, op=op, group=group, sync_op=sync_op)


def all_gather(tensor_or_tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    _check_stream(sync_op, use_calc_stream)
    return _c.all_gather(tensor_or_tensor_list, tensor, group=group,
                         sync_op=sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             use_calc_stream=False):
    _check_stream(sync_op, use_calc_stream)
    return _c.alltoall(out_tensor_list, in_tensor_list, group=group,
                       sync_op=sync_op)


def alltoall_single(out_tensor, in_tensor, out_split_sizes=None,
                    in_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    _check_stream(sync_op, use_calc_stream)
    return _c.alltoall_single(in_tensor, out_tensor,
                              in_split_sizes=in_split_sizes,
                              out_split_sizes=out_split_sizes,
                              group=group, sync_op=sync_op)


def broadcast(tensor, src, group=None, sync_op=True, use_calc_stream=False):
    _check_stream(sync_op, use_calc_stream)
    return _c.broadcast(tensor, src=src, group=group, sync_op=sync_op)


def reduce(tensor, dst=0, op=_c.ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=False):
    _check_stream(sync_op, use_calc_stream)
    return _c.reduce(tensor, dst=dst, op=op, group=group, sync_op=sync_op)


def reduce_scatter(tensor, tensor_list=None, op=_c.ReduceOp.SUM, group=None,
                   sync_op=True, use_calc_stream=False):
    _check_stream(sync_op, use_calc_stream)
    return _c.reduce_scatter(tensor, tensor_list, op=op, group=group,
                             sync_op=sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True,
            use_calc_stream=False):
    _check_stream(sync_op, use_calc_stream)
    return _c.scatter(tensor, tensor_list, src=src, group=group,
                      sync_op=sync_op)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True,
           use_calc_stream=False):
    _check_stream(sync_op, use_calc_stream)
    return _c.gather(tensor, gather_list, dst=dst, group=group,
                     sync_op=sync_op)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    _check_stream(sync_op, use_calc_stream)
    return _c.send(tensor, dst=dst, group=group, sync_op=sync_op)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    _check_stream(sync_op, use_calc_stream)
    return _c.recv(tensor, src=src, group=group, sync_op=sync_op)
